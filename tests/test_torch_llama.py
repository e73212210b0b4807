"""The port's Llama against the JAX package's on the tiny config (2 layers,
hidden 256, head_dim 128, S=64, so JAX takes its flash-decode path): the same
packed weights (converted through ``io.convert``) and the same tokens give
logits within rel 2e-2 of the largest logit, for per-layer and stacked
parameters.  The two frameworks round bf16 at different places, so tokens are
compared only in the engine test.

Chunked prefill (``prefill_slots_chunk``) runs at S=256 with chunks of 128, so
that JAX takes its flash-prefill Pallas kernel (interpret mode), on the bf16 and
the packed int8 cache.  The int8 cache is compared dequantized, within 2
quanta: a 1-ulp bf16 difference in k between the frameworks can move a byte.

``prefill_a8``: a forward of 48 rows runs the blocks' projections on int8
activations in both packages (logits within the same rel 2e-2, and not those
of the bf16-activation forward); one of 16 rows is below the threshold and
bit-identical to ``prefill_a8=False``.  ``init_params``, dense weights and
``perplexity`` are held to the JAX package's on its own weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu.utils.evaluate import perplexity as jperplexity
from xbitops_tpu_torch.io.convert import kvcache_from_numpy, params_from_numpy
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils.evaluate import perplexity, sequence_nll

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
# the JAX reference, jitted with the config static (one compile per function)
jprefill_slots = jax.jit(jllama.prefill_slots, static_argnums=1)
jprefill = jax.jit(jllama.prefill, static_argnums=1)
jdecode_step = jax.jit(jllama.decode_step, static_argnums=1)


@pytest.fixture(scope="module")
def jparams():
    # random packed 4-bit weights, jitted: one compile instead of one per op
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


PREFILL_TOKENS = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
PREFILL_LENS = np.asarray([9, 16], np.int32)
PREFILL_SLOTS = np.asarray([1, 0], np.int32)
ACTIVE = ([True, True], [False, True], [True, True])


@pytest.fixture(scope="module")
def jax_slots_run(jparams):
    """The JAX model's prefill_slots and three decode steps (per-layer params),
    once per module: [(logits, lengths, tokens fed)] per call.  The stacked
    layout computes the same function, so both layouts are held to it."""
    jcache = jllama.KVCache.init(JCFG, 2)
    jl, jcache = jprefill_slots(jparams, JCFG, jnp.asarray(PREFILL_TOKENS),
                               jnp.asarray(PREFILL_LENS), jnp.asarray(PREFILL_SLOTS), jcache)
    run = [(np.asarray(jl), np.asarray(jcache.lengths), None)]
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[::-1].copy()  # slot order
    for active in ACTIVE:
        jl, jcache = jdecode_step(jparams, JCFG, jnp.asarray(tok), jcache,
                                  active=jnp.asarray(active))
        run.append((np.asarray(jl), np.asarray(jcache.lengths), tok))
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    return run


def _close(got: torch.Tensor, want):
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_configs_agree():
    for name in ("llama2_7b", "llama2_13b", "llama3_8b", "mistral_7b", "tiny"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(llama.LlamaConfig, name)()
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == t.__dict__, name


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_prefill_slots_and_decode_match_jax(jparams, model, jax_slots_run, layout):
    if layout == "stacked":
        model = params_from_numpy(
            jax.tree.map(np.asarray, jllama.stack_layers(jparams)), CFG, "cpu")
    cache = llama.KVCache.init(CFG, 2, "cpu")
    tl, cache2 = llama.prefill_slots(
        model, torch.from_numpy(PREFILL_TOKENS), torch.from_numpy(PREFILL_LENS),
        torch.from_numpy(PREFILL_SLOTS), cache)
    assert cache2 is cache
    jl, jlens, _ = jax_slots_run[0]
    _close(tl, jl)
    np.testing.assert_array_equal(cache.lengths.numpy(), jlens)
    for active, (jl, jlens, tok) in zip(ACTIVE, jax_slots_run[1:]):
        act = np.asarray(active)
        tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache,
                                  active=torch.from_numpy(act))
        _close(tl[act], jl[act])
        np.testing.assert_array_equal(cache.lengths.numpy(), jlens)


def test_prefill_through_cache_matches_jax(jparams, model):
    """``prefill`` (all rows from position 0, attending the cache) and one
    decode step that appends through the kernel path."""
    tokens = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    jl, jcache = jprefill(jparams, JCFG, jnp.asarray(tokens), jllama.KVCache.init(JCFG, 2))
    cache = llama.KVCache.init(CFG, 2, "cpu")
    tl, _ = llama.prefill(model, torch.from_numpy(tokens), cache)
    _close(tl, jl)
    tok, active = np.asarray([3, 200], np.int32), np.asarray([True, True])
    jl, _ = jdecode_step(jparams, JCFG, jnp.asarray(tok), jcache, active=jnp.asarray(active))
    tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache, active=torch.from_numpy(active))
    _close(tl, jl)


def test_prefill_slot_is_one_row_of_prefill_slots(model):
    tokens = torch.tensor([[4, 8, 15, 16, 23, 42, 0, 0]])
    a, b = llama.KVCache.init(CFG, 3, "cpu"), llama.KVCache.init(CFG, 3, "cpu")
    la, _ = llama.prefill_slot(model, tokens[0], 6, 2, a)
    lb, _ = llama.prefill_slots(model, tokens, torch.tensor([6]), torch.tensor([2]), b)
    assert torch.equal(la, lb[0]) and torch.equal(a.k, b.k)
    assert a.lengths.tolist() == [0, 0, 6]


def test_use_kernel_false_matches_default(model):
    """On the CPU both switches run plain versions; they agree closely."""
    tokens = torch.tensor([[5, 9, 2, 7]])
    a, b = llama.KVCache.init(CFG, 1, "cpu"), llama.KVCache.init(CFG, 1, "cpu")
    la, _ = llama.prefill(model, tokens, a)
    lb, _ = llama.prefill(model, tokens, b, use_kernel=False)
    _close(la, lb.float().numpy())
    la, _ = llama.decode_step(model, torch.tensor([4]), a)
    lb, _ = llama.decode_step(model, torch.tensor([4]), b, use_kernel=False)
    _close(la, lb.float().numpy())
    _close(a.k, b.k.float().numpy())


def test_unported_paths_raise(model):
    """The paged cache is ported: a forward on it equals the forward on the
    linear cache.  (Unaligned writes are too: ``tests/test_torch_spec.py``.)"""
    paged = llama.KVCache.init_paged(CFG, 1, 4, 16, device="cpu")
    assert paged.paged and paged.S == CFG.max_seq_len and paged.k.shape[1:4] == (4, 2, 16)
    paged.page_table[0, 0] = 3
    tokens = torch.tensor([[5, 9, 2, 7]])
    lp, _ = llama.prefill(model, tokens, paged)
    ll, _ = llama.prefill(model, tokens, llama.KVCache.init(CFG, 1, "cpu"))
    assert torch.equal(lp, ll) and paged.k[:, 3].abs().sum() > 0 and paged.k[:, :3].abs().sum() == 0


JCFG256 = jllama.LlamaConfig.tiny(seq=256)
CFG256 = llama.LlamaConfig.tiny(seq=256)
jprefill_slots_chunk = jax.jit(jllama.prefill_slots_chunk, static_argnums=1)
CHUNK = 128
LONG_LENS = np.asarray([200, 256 - 3], np.int32)
LONG_SLOTS = np.asarray([2, 0], np.int32)
LONG_TOKENS = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 256)).astype(np.int32)


@pytest.fixture(scope="module")
def model256(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG256, "cpu")


def _dequant(cache, layer_lens):
    """The cache's k and v as f32 [L, B, Hkv, S, D], positions past each
    slot's length zeroed."""
    k, v = cache.k, cache.v
    if cache.quantized:
        k = llama._unpack_kv_words(cache.k, cache.k_scale)
        v = llama._unpack_kv_words(cache.v, cache.v_scale)
    live = torch.arange(k.shape[3])[None, :] < torch.as_tensor(layer_lens)[:, None].long()
    live = live[None, :, None, :, None]
    return (k.float() * live).numpy(), (v.float() * live).numpy()


def _cache_close(cache, jcache):
    """Same lengths; k/v agree on the live positions: bf16 within rel 2e-2 of
    the largest value; int8 within 2 quanta of each row's scale in layer 0,
    whose input is the same in both frameworks, and within 2 quanta plus the
    bf16 gate in later layers, whose inputs have drifted by that much."""
    jc = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    lens = cache.lengths.tolist()
    assert lens == jc.lengths.tolist()
    for got, want in zip(_dequant(cache, lens), _dequant(jc, lens)):
        if cache.quantized:
            quantum = np.abs(want).max(axis=-1, keepdims=True) / 127.0
            err = np.abs(got - want)
            assert (err[0] <= 2 * quantum[0] + 1e-6).all()
            assert (err <= 2 * quantum + 2e-2 * np.abs(want).max()).all()
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16cache", "int8cache"])
def test_prefill_slots_chunk_matches_jax(jparams, model256, quantized):
    """Two long prompts in two chunks of 128 (the second row's prompt ends
    mid-chunk, the first row's too), then one decode step."""
    jcache = jllama.KVCache.init(JCFG256, 3, quantized=quantized)
    cache = llama.KVCache.init(CFG256, 3, "cpu", quantized=quantized)
    cache.lengths[:] = torch.tensor([7, 9, 250])  # stale lengths of recycled slots
    jcache = jcache.__class__(jcache.k, jcache.v, jnp.asarray([7, 9, 250], jnp.int32),
                              jcache.k_scale, jcache.v_scale)
    for ci in range(2):
        tok = LONG_TOKENS[:, ci * CHUNK : (ci + 1) * CHUNK]
        starts = np.full(2, ci * CHUNK, np.int32)
        resets = np.full(2, ci == 0)
        jl, jcache = jprefill_slots_chunk(
            jparams, JCFG256, jnp.asarray(tok), jnp.asarray(starts), jnp.asarray(LONG_LENS),
            jnp.asarray(LONG_SLOTS), jcache, resets=jnp.asarray(resets))
        tl, cache2 = llama.prefill_slots_chunk(
            model256, torch.from_numpy(tok), torch.from_numpy(starts),
            torch.from_numpy(LONG_LENS), torch.from_numpy(LONG_SLOTS), cache,
            resets=torch.from_numpy(resets))
        assert cache2 is cache
        np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    _close(tl, jl)  # both prompts end in the second chunk
    assert cache.lengths.tolist() == [253, 9, 200]
    _cache_close(cache, jcache)
    tok = np.asarray([3, 0, 200], np.int32)
    active = np.asarray([True, False, True])
    jl, jcache = jax.jit(jllama.decode_step, static_argnums=1)(
        jparams, JCFG256, jnp.asarray(tok), jcache, active=jnp.asarray(active))
    tl, _ = llama.decode_step(model256, torch.from_numpy(tok), cache,
                              active=torch.from_numpy(active))
    _close(tl[active], np.asarray(jl)[active])


def test_prefill_slot_chunk_is_one_row_of_prefill_slots_chunk(model256):
    tokens = torch.from_numpy(LONG_TOKENS[:1, :CHUNK].astype(np.int64))
    a, b = (llama.KVCache.init(CFG256, 2, "cpu", quantized=True) for _ in range(2))
    la, _ = llama.prefill_slot_chunk(model256, tokens[0], 0, 100, 1, a, reset=True)
    lb, _ = llama.prefill_slots_chunk(model256, tokens, torch.tensor([0]), torch.tensor([100]),
                                      torch.tensor([1]), b, resets=torch.tensor([True]))
    assert torch.equal(la, lb[0]) and torch.equal(a.k, b.k) and torch.equal(a.k_scale, b.k_scale)
    assert a.lengths.tolist() == [0, 100]


def test_int8_prefill_and_decode_match_jax(jparams, model):
    """Bucketed admission (whole words) and three decode steps (one byte of a
    word each) on the packed int8 cache."""
    jcache = jllama.KVCache.init(JCFG, 2, quantized=True)
    cache = llama.KVCache.init(CFG, 2, "cpu", quantized=True)
    assert cache.quantized and cache.S == CFG.max_seq_len
    assert cache.k.dtype == torch.int32 and cache.k.shape == tuple(jcache.k.shape)
    assert cache.k_scale.dtype == torch.bfloat16
    assert cache.k_scale.shape == tuple(jcache.k_scale.shape)
    jl, jcache = jprefill_slots(jparams, JCFG, jnp.asarray(PREFILL_TOKENS),
                                jnp.asarray(PREFILL_LENS), jnp.asarray(PREFILL_SLOTS), jcache)
    tl, _ = llama.prefill_slots(
        model, torch.from_numpy(PREFILL_TOKENS), torch.from_numpy(PREFILL_LENS),
        torch.from_numpy(PREFILL_SLOTS), cache)
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[::-1].copy()  # slot order
    for active in ACTIVE:
        jl, jcache = jdecode_step(jparams, JCFG, jnp.asarray(tok), jcache,
                                  active=jnp.asarray(active))
        act = np.asarray(active)
        tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache,
                                  active=torch.from_numpy(act))
        _close(tl[act], np.asarray(jl)[act])
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _cache_close(cache, jcache)


def test_int8_use_kernel_false_matches_default(model):
    tokens = torch.tensor([[5, 9, 2, 7]])
    a, b = (llama.KVCache.init(CFG, 1, "cpu", quantized=True) for _ in range(2))
    la, _ = llama.prefill(model, tokens, a)
    lb, _ = llama.prefill(model, tokens, b, use_kernel=False)
    _close(la, lb.float().numpy())
    la, _ = llama.decode_step(model, torch.tensor([4]), a)
    lb, _ = llama.decode_step(model, torch.tensor([4]), b, use_kernel=False)
    _close(la, lb.float().numpy())
    assert torch.equal(a.k, b.k) and torch.equal(a.v_scale, b.v_scale)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16cache", "int8cache"])
def test_chunk_overhanging_capacity_writes_its_valid_part(model, quantized):
    """A chunk whose span runs past S (start 48 + chunk 48 > S = 64) writes
    the rows that fit; the logits equal the bucketed admission's of the same
    prompt."""
    prompt = np.random.default_rng(9).integers(0, CFG.vocab_size, 60)
    C, n = 48, 60
    chunked = llama.KVCache.init(CFG, 2, "cpu", quantized=quantized)
    for start in (0, C):
        piece = np.zeros(C, np.int64)
        part = prompt[start : start + C]
        piece[: len(part)] = part
        lc, _ = llama.prefill_slot_chunk(model, torch.from_numpy(piece), start, n, 1, chunked,
                                         reset=start == 0)
    whole = llama.KVCache.init(CFG, 2, "cpu", quantized=quantized)
    padded = np.zeros(64, np.int64)
    padded[:n] = prompt
    lw, _ = llama.prefill_slot(model, torch.from_numpy(padded), n, 1, whole)
    assert chunked.lengths.tolist() == whole.lengths.tolist() == [0, n]
    _close(lc, lw.float().numpy())
    for got, want in zip(_dequant(chunked, [0, n]), _dequant(whole, [0, n])):
        assert np.abs(want[:, 1, :, C:n]).max() > 0  # the second chunk's rows are there
        quantum = np.abs(want).max(axis=-1, keepdims=True) / 127.0
        assert (np.abs(got - want) <= 2e-2 * np.abs(want).max() + 2 * quantum).all()


JCFG8 = dataclasses.replace(JCFG, prefill_a8=True)
CFG8 = dataclasses.replace(CFG, prefill_a8=True)


def test_prefill_a8_matches_jax_above_the_threshold(jparams, model):
    model8 = model.with_config(CFG8)
    tokens = np.random.default_rng(6).integers(0, CFG.vocab_size, (2, 48)).astype(np.int32)
    jl, _ = jprefill(jparams, JCFG8, jnp.asarray(tokens), jllama.KVCache.init(JCFG, 2))
    tl8, _ = llama.prefill(model8, torch.from_numpy(tokens), llama.KVCache.init(CFG, 2, "cpu"))
    _close(tl8, jl)
    tl, _ = llama.prefill(model, torch.from_numpy(tokens), llama.KVCache.init(CFG, 2, "cpu"))
    assert not torch.equal(tl8, tl)  # the int8 path ran
    # and stays within the int8 activation rounding, grown through two layers
    assert (tl8.float() - tl.float()).abs().max() < 0.1 * tl.float().abs().max()
    plain, _ = llama.prefill(model8, torch.from_numpy(tokens),
                             llama.KVCache.init(CFG, 2, "cpu"), use_kernel=False)
    _close(tl8, plain.float().numpy())  # the fake-quant plain path


def test_prefill_a8_is_inert_below_the_threshold(model):
    assert llama.A8_MIN_T == 32
    model8 = model.with_config(CFG8)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 16)))
    a, b = llama.KVCache.init(CFG, 2, "cpu"), llama.KVCache.init(CFG, 2, "cpu")
    la, _ = llama.prefill(model8, tokens, a)
    lb, _ = llama.prefill(model, tokens, b)
    assert torch.equal(la, lb) and torch.equal(a.k, b.k)
    la, _ = llama.decode_step(model8, torch.tensor([3, 200]), a)  # decode stays bf16
    lb, _ = llama.decode_step(model, torch.tensor([3, 200]), b)
    assert torch.equal(la, lb)


def test_with_config_shares_weights_and_cuts_depth(model):
    cut = model.with_config(dataclasses.replace(CFG, num_layers=1))
    assert len(cut.blocks) == 1 and cut.cfg.num_layers == 1
    assert cut.blocks[0].wqkv.plane0.data_ptr() == model.blocks[0].wqkv.plane0.data_ptr()
    assert cut.lm_head.scales.data_ptr() == model.lm_head.scales.data_ptr()


@pytest.fixture(scope="module")
def jdense():
    return jllama.init_params(jax.random.PRNGKey(1), JCFG, bits=None)


def _jquantized(jdense):
    def qz(w):
        return xb.quantize_array(jnp.asarray(w, jnp.float32), 4, 32)

    layers = [dict(layer, **{k: qz(layer[k]) for k in ("wqkv", "w_gateup", "wo", "w_down")})
              for layer in jdense["layers"]]
    return dict(jdense, layers=layers, lm_head=qz(jdense["lm_head"]))


def test_perplexity_matches_jax_dense_quantized_and_a8(jdense):
    """The JAX package's dense tiny weights and their 4-bit (g=32) quantized
    form, carried across: log perplexity within 1e-2 of JAX's for the dense
    model (dense bf16 projections), the quantized one and its W4A8 prefill;
    W4A8 within 0.05 of W4A16, and not equal to it."""
    stream = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (2, 48), 0, CFG.vocab_size))
    jq = _jquantized(jdense)
    tokens = torch.from_numpy(stream.copy())
    logs = {}
    for name, jp, jcfg, cfg in (("dense", jdense, JCFG, CFG), ("w4a16", jq, JCFG, CFG),
                                ("w4a8", jq, JCFG8, CFG8)):
        want = jperplexity(jp, jcfg, jnp.asarray(stream))
        m = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        got = perplexity(m, tokens)
        assert abs(np.log(got) - np.log(want)) < 1e-2, (name, got, want)
        logs[name] = np.log(got)
    assert isinstance(m.blocks[0].wqkv, llama.QLinear)
    assert logs["w4a8"] != logs["w4a16"]
    assert abs(logs["w4a8"] - logs["w4a16"]) < 0.05
    nll = sequence_nll(m, tokens)
    assert nll.shape == (2,) and nll.dtype == torch.float32 and bool(torch.isfinite(nll).all())


@pytest.mark.parametrize("bits,fuse,act_order", [(4, True, False), (None, True, False),
                                                  (3, False, True)])
def test_init_params_builds_a_model_that_runs(bits, fuse, act_order):
    gen = torch.Generator().manual_seed(0)
    m = llama.init_params(gen, CFG, bits=bits, group_size=32, fuse=fuse, act_order=act_order)
    names = {n for n, _ in m.blocks[0].named_children()}
    assert names == ({"wqkv", "wo", "w_gateup", "w_down"} if fuse else
                     {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})
    kind = llama.DenseLinear if bits is None else llama.QLinear
    assert isinstance(m.blocks[1].w_down, kind) and isinstance(m.lm_head, kind)
    if bits is None:
        assert m.lm_head.weight.dtype == torch.bfloat16
        assert m.lm_head.weight.shape == (CFG.hidden_size, CFG.vocab_size)
    else:
        qt = m.blocks[0].wo.qtensor
        assert qt.bits == bits and qt.group_size == 32 and (qt.perm is not None) == act_order
    tokens = torch.tensor([[5, 9, 2, 7]])
    logits, cache = llama.prefill(m, tokens, llama.KVCache.init(CFG, 1, "cpu"))
    assert logits.shape == (1, 4, CFG.vocab_size) and bool(torch.isfinite(logits.float()).all())
    assert cache.lengths.tolist() == [4]
    again = llama.init_params(torch.Generator().manual_seed(0), CFG, bits=bits, group_size=32,
                              fuse=fuse, act_order=act_order)
    assert torch.equal(again.embed, m.embed)
    # tp=2 packs the same draws for two ranks (parallel/): row-sharded wo
    tp2 = llama.init_params(torch.Generator().manual_seed(0), CFG, bits=bits, group_size=32,
                            fuse=fuse, act_order=act_order, tp=2)
    assert torch.equal(tp2.embed, m.embed)
    if bits is not None:
        assert tp2.blocks[0].wo.qtensor.planes[0].shape[0] == 2
    with pytest.raises(ValueError):  # 4 heads do not split 3 ways
        llama.init_params(gen, CFG, tp=3)
