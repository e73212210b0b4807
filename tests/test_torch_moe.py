"""The port's Mixture-of-Experts (``models/moe.py``) against the JAX package's on
``MoeConfig.tiny_moe`` (4 experts, top-2, 4-bit g=32 experts built once by the
JAX ``init_moe_params`` and carried across by ``params_from_numpy``).

Tolerances: ``moe_ffn`` with f32 activations in no-drop mode, and under the
adversarial routing (every token to the same two experts), within abs 1e-6 (f32
rounding) of an oracle with no dispatch (every expert on the whole batch
through the port's own ``qmatmul``, mixed per token), and with
the same routes as JAX, within abs 1e-3 of the output's largest value of the
JAX ``moe_ffn``: the two packages' plain matmuls sum gate|up in other orders,
and the down projection takes its activations in bf16, so a difference of
1e-7 can move one activation by a bf16 step (2^-8 of it).  With a capacity
that drops routes, the same, a dropped route adding exactly zero (a token
whose routes all drop gives exact zeros); dense experts (bf16 activations)
within one bf16 step of JAX.  Model logits, bucketed prefill and
one decode step, within rel 2e-2 of JAX's.  The engine's greedy tokens on the
linear, int8, paged and speculative paths equal a raw greedy decode of the
same model on the same cache kind.  Ties in the router go to the lower expert
index, as ``jax.lax.top_k`` orders them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xbitops_tpu import formats as jformats
from xbitops_tpu.io import load_packed as jload_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.models import moe as jmoe
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.formats import QTensor, dequant_qtensor_reference
from xbitops_tpu_torch.io import save_packed
from xbitops_tpu_torch.io.checkpoint import load_llama
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama, moe
from xbitops_tpu_torch.ops.qmatmul import qmatmul

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jmoe.MoeConfig.tiny_moe()
CFG = moe.MoeConfig.tiny_moe()
H = CFG.hidden_size


@pytest.fixture(scope="module")
def jparams():
    # jitted: one compile instead of one per op
    init = jax.jit(jmoe.init_moe_params, static_argnums=(1, 2, 3))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JCFG, 4, 32))


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jparams, CFG, "cpu")


def _hx(seed, shape, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(dtype)


def _oracle(hx, layer, cfg):
    """No dispatch: every expert runs on the whole batch (the rows that the
    no-drop dispatch gives it, M = N, so that the plain matmul sums each row
    as there), then per token, per route, the softmax over the top-k router
    logits weighs the expert's row (no capacity)."""
    x = hx.reshape(-1, hx.shape[-1])
    idx, probs = moe.route(x, layer["router"], cfg.experts_per_token)
    ffn = cfg.intermediate_size
    ys = []
    for e in range(cfg.n_experts):
        gu = qmatmul(x, layer["w_experts_gateup"].layer(e), out_dtype=x.dtype)
        act = (torch.nn.functional.silu(gu[:, :ffn].float()) * gu[:, ffn:].float()).to(x.dtype)
        ys.append(qmatmul(act, layer["w_experts_down"].layer(e), out_dtype=torch.float32))
    out = torch.zeros(x.shape, dtype=torch.float32)
    for n in range(x.shape[0]):
        for p, e in zip(probs[n], idx[n].tolist()):
            out[n] += p * ys[e][n]
    return out.reshape(hx.shape)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_params_from_numpy_carries_moe_weights(jparams, model, tmp_path):
    """Router and stacked experts arrive bit for bit; every expert view
    dequantizes to JAX's expert; the packed round trip keeps them, and the
    JAX package reads the directory back."""
    jl = jparams["layers"][0]
    b = model.blocks[0]
    assert isinstance(b.moe, moe.MoeFFN) and not hasattr(b, "w_gateup")
    w = b.weights()
    assert set(w) == {"wqkv", "wo", "router", "w_experts_gateup", "w_experts_down"}
    assert torch.equal(w["router"], torch.from_numpy(jl["router"].copy()))
    gu = w["w_experts_gateup"]
    assert gu.planes[0].shape[0] == CFG.n_experts and gu.shape == (H, 2 * CFG.intermediate_size)
    for e in range(CFG.n_experts):
        one = jax.tree.map(lambda a: a[e], jax.tree.map(jnp.asarray, jl["w_experts_down"]))
        want = np.asarray(jformats.dequant_qtensor_reference(one, out_dtype=jnp.float32))
        got = dequant_qtensor_reference(w["w_experts_down"].layer(e), out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
    save_packed(model, str(tmp_path))
    back = load_llama(str(tmp_path), CFG, device="cpu")
    for name, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], t), name
    jback = jload_packed(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jback["layers"][1]["w_experts_gateup"].planes[0]),
                                  jparams["layers"][1]["w_experts_gateup"].planes[0])


def _cases():
    row = _hx(12, (1, 1, H))
    return {
        "nodrop": (_hx(11, (2, 7, H)), None),
        # every token to the same two experts: 9 tokens x 2 routes
        "adversarial": (np.broadcast_to(row, (1, 9, H)).copy(), None),
        # capacity 1 a expert: most routes drop
        "drops": (_hx(4, (1, 6, H)), CFG.n_experts / (6 * CFG.experts_per_token)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_moe_ffn_matches_jax_and_oracle(jparams, model, case):
    hx, cf = _cases()[case]
    cfg, jcfg = (dataclasses.replace(c, capacity_factor=cf) for c in (CFG, JCFG))
    layer = model.blocks[0].weights()
    got = moe.moe_ffn(torch.from_numpy(hx), layer, cfg)
    jl = jax.tree.map(jnp.asarray, jparams["layers"][0])
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(hx), jl, jcfg), np.float32)
    x = hx.reshape(-1, H)
    jidx = jax.lax.top_k(jnp.asarray(x) @ jl["router"], CFG.experts_per_token)[1]
    assert moe.route(torch.from_numpy(x), layer["router"], 2)[0].tolist() == \
        np.asarray(jidx).tolist()
    _close(got, want, rtol=0, atol=1e-3 * float(np.abs(want).max()))
    if cf is None:
        _close(got, _oracle(torch.from_numpy(hx), layer, cfg), rtol=0, atol=1e-6)
        return
    # capacity C = 1: only each expert's first route is kept
    x = torch.from_numpy(hx).reshape(-1, H)
    idx, _ = moe.route(x, layer["router"], cfg.experts_per_token)
    first = {}
    for n, e in enumerate(idx.reshape(-1).tolist()):
        first.setdefault(e, n // cfg.experts_per_token)
    kept = set(first.values())
    dropped = [n for n in range(x.shape[0]) if n not in kept]
    assert dropped, "the case must drop every route of some token"
    assert torch.count_nonzero(got.reshape(-1, H)[dropped]) == 0
    # token 0 keeps both its routes: its output is the no-drop output's
    _close(got[0, 0], moe.moe_ffn(torch.from_numpy(hx), layer, CFG)[0, 0], rtol=0,
           atol=1e-3 * float(got.abs().max()))
    # the adversarial batch at capacity factor 1 drops too, and differs from no-drop
    adv = torch.from_numpy(_cases()["adversarial"][0])
    full = moe.moe_ffn(adv, layer, CFG)
    cut = moe.moe_ffn(adv, layer, dataclasses.replace(CFG, capacity_factor=1.0))
    assert (full - cut).abs().max() > 1e-3


def test_moe_ffn_dense_experts_match_jax():
    """Stacked dense experts (``bits=None``): the JAX ``moe_ffn`` dense branch,
    bf16 activations, within one bf16 step of the output's largest value."""
    jp = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(1), JCFG, bits=None))
    layer = params_from_numpy(jp, CFG, "cpu").blocks[1].weights()
    assert layer["w_experts_gateup"].shape == (CFG.n_experts, H, 2 * CFG.intermediate_size)
    hx = torch.from_numpy(_hx(5, (2, 5, H))).to(torch.bfloat16)
    got = moe.moe_ffn(hx, layer, CFG).float()
    jl = jax.tree.map(jnp.asarray, jp["layers"][1])
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(hx.float().numpy(), jnp.bfloat16), jl, JCFG),
                      np.float32)
    _close(got, want, rtol=0, atol=float(np.abs(want).max()) * 2 ** -7)


def test_route_ties_take_the_lower_index():
    router = torch.zeros((4, 4))
    router[0] = torch.tensor([1.0, 3.0, 3.0, 3.0])
    idx, probs = moe.route(torch.tensor([[1.0, 0, 0, 0]]), router, 2)
    assert idx.tolist() == [[1, 2]] and torch.allclose(probs, torch.tensor([[0.5, 0.5]]))
    jidx = jax.lax.top_k(jnp.asarray([[1.0, 3.0, 3.0, 3.0]]), 2)[1]
    assert np.asarray(jidx).tolist() == idx.tolist()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tiny_moe_prefill_and_decode_logits_match_jax(jparams, model):
    tokens = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 6))

    @jax.jit  # one compile for both forwards
    def prefill_then_decode(p, toks):
        lg, cache = jllama.prefill(p, JCFG, toks, jllama.KVCache.init(JCFG, 2))
        nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
        return lg, nxt, jllama.decode_step(p, JCFG, nxt, cache)[0]

    jlog, nxt, jdec = prefill_then_decode(jax.tree.map(jnp.asarray, jparams),
                                          jnp.asarray(tokens, jnp.int32))
    nxt = np.array(nxt)
    cache = llama.KVCache.init(CFG, 2, "cpu")
    log, cache = llama.prefill(model, torch.from_numpy(tokens), cache)
    dec, _ = llama.decode_step(model, torch.from_numpy(nxt), cache)
    assert _rel(log.float(), jlog) < 2e-2 and _rel(dec.float(), jdec) < 2e-2


@pytest.mark.parametrize("bits", [4, None, "random"])
def test_init_moe_params_builds_a_model_that_runs(bits):
    """``init_moe_params`` (quantized, dense, and with ``synth.random_moe_params``'
    random packed bits) builds a MoE model whose forward runs; a seed gives
    the same model again."""
    from xbitops_tpu_torch.utils import synth

    def build():
        if bits == "random":
            return synth.random_moe_params(CFG, bits=4, group_size=32, device="cpu", seed=0)
        return moe.init_moe_params(torch.Generator().manual_seed(0), CFG, bits=bits,
                                   group_size=32)

    m = build()
    ffn = m.blocks[1].moe
    assert set(ffn.weights()) == {"router", "w_experts_gateup", "w_experts_down"}
    assert ffn.router.dtype == torch.float32 and ffn.router.shape == (H, CFG.n_experts)
    gu, down = ffn.weights()["w_experts_gateup"], ffn.weights()["w_experts_down"]
    assert moe.n_stacked(gu) == moe.n_stacked(down) == CFG.n_experts
    if bits is None:
        assert gu.dtype == torch.bfloat16
        assert gu.shape == (CFG.n_experts, H, 2 * CFG.intermediate_size)
    else:
        assert isinstance(gu, QTensor) and gu.layer(3).K_logical == H
        assert down.layer(0).K_logical == CFG.intermediate_size and down.group_size == 32
    tokens = torch.tensor([[5, 9, 2, 7]])
    logits, cache = llama.prefill(m, tokens, llama.KVCache.init(CFG, 1, "cpu"))
    assert logits.shape == (1, 4, CFG.vocab_size) and bool(torch.isfinite(logits.float()).all())
    assert cache.lengths.tolist() == [4]
    again = build()
    assert torch.equal(again.embed, m.embed) and torch.equal(again.blocks[1].moe.router,
                                                             ffn.router)


PROMPTS = [[3, 1, 4], [2, 7], [9, 9, 8, 1, 30, 41, 5]]
ENGINES = {
    "linear": dict(kv_quant=False),
    "int8": dict(kv_quant=True),
    "paged": dict(kv_quant=False, paged=True, page_size=16),
    "spec": dict(kv_quant=False, spec_tokens=2, decode_burst=1),
}


def _raw_greedy(model, prompt, n, quantized):
    """Greedy decode of one prompt alone on its own cache."""
    cache = llama.KVCache.init(CFG, 1, "cpu", quantized=quantized)
    padded = torch.zeros((1, 8), dtype=torch.long)  # the int8 cache takes whole words
    padded[0, : len(prompt)] = torch.tensor(prompt)
    lg, cache = llama.prefill_slots(model, padded, torch.tensor([len(prompt)]),
                                    torch.tensor([0]), cache)
    seq = [int(lg[0].argmax())]
    for _ in range(n - 1):
        lg, cache = llama.decode_step(model, torch.tensor([seq[-1]]), cache)
        seq.append(int(lg[0].argmax()))
    return seq


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_greedy_equals_raw_decode(model, kind):
    """The engine runs a MoE model with no branch of its own: its greedy
    tokens equal a raw greedy decode, request by request (3 requests on 2
    slots, bursts of 2; the verify of γ=2 one step at a time)."""
    kw = dict(dict(decode_burst=2), **ENGINES[kind])
    eng = Engine(model, CFG, slots=2, prefill_buckets=[8], **kw)
    out = eng.generate([Request(prompt=p, max_new_tokens=5, id=i) for i, p in enumerate(PROMPTS)])
    for c, p in zip(out, PROMPTS):
        assert c.tokens == _raw_greedy(model, p, 5, kw["kv_quant"]), (kind, c.id)
    if kind == "spec":
        assert eng.spec_stats["drafted"] > 0
