"""The port's speculative decoding against the JAX package's, on the tiny
config: the model's part.  The engine's is ``tests/test_torch_spec_engine.py``.

- ``forward(kv_unaligned=True)``, T=5 rows a slot starting at positions 0-3
  mod 4, a chain across S, an inactive slot (position S) and, on the paged
  cache, a chain into a page of -1, on the four cache forms (bf16 / int8,
  linear / paged): the write alone leaves every cache tensor EXACTLY equal to
  the JAX forward's (words, scales and bf16 rows) when both get the same k/v
  rows (JAX's own projections replaced through its ``Runtime``); the whole
  forward gives logits within rel 2e-2 and the same lengths.
- ``spec_verify_step``: greedy tokens, accepted counts and lengths equal to
  JAX's on one cache (drafts all right, some right, at the capacity edge, an
  inactive slot), bf16 and int8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xbitops_tpu.models import llama as jllama
from xbitops_tpu_torch.io.convert import kvcache_from_numpy, params_from_numpy
from xbitops_tpu_torch.kernels.kv_append import _unpack_kv_words
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
S = CFG.max_seq_len  # 64


@pytest.fixture(scope="module")
def jparams():
    # the JAX engine tests' model (8-bit, groups of 32), jitted: one compile
    return jax.jit(jllama.init_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 8, 32)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


# --- forward(kv_unaligned=True) on the four cache forms ---

B, T, PSZ = 5, 5, 16
STARTS = np.asarray([4, 13, 30, 61, 7], np.int32)  # 0, 1, 2, 3 mod 4; 61: across S
ACTIVE = np.asarray([True, True, True, True, False])
# slot 1's chain 13..17 crosses into its page 1, which it does not hold
TABLE = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
TABLE[1, 1] = -1
N_PAGES = B * 4 + 1  # page 20 is nobody's
POSITIONS = np.minimum(np.where(ACTIVE[:, None], STARTS[:, None] + np.arange(T), S), S)
FORMS = [(False, False), (True, False), (False, True), (True, True)]
FORM_IDS = ["bf16", "int8", "bf16paged", "int8paged"]


def _random_caches(quantized: bool, paged: bool, seed: int = 0):
    """The same cache of random contents in both packages (JAX's, and the
    port's through ``kvcache_from_numpy``)."""
    rng = np.random.default_rng(seed)
    if paged:
        jc = jllama.KVCache.init_paged(JCFG, B, N_PAGES, page_size=PSZ, quantized=quantized)
        jc = dataclasses.replace(jc, page_table=jnp.asarray(TABLE))
    else:
        jc = jllama.KVCache.init(JCFG, B, quantized=quantized)
    fields = {"lengths": jnp.asarray(STARTS)}
    for name in ("k", "v"):
        t = getattr(jc, name)
        if quantized:
            fields[name] = jnp.asarray(rng.integers(-2**31, 2**31, t.shape).astype(np.int32))
            s = getattr(jc, name + "_scale")
            fields[name + "_scale"] = jnp.asarray(
                rng.uniform(0.001, 0.03, s.shape).astype(np.float32)).astype(s.dtype)
        else:
            x = rng.standard_normal(t.shape).astype(np.float32)
            fields[name] = jnp.asarray(x).astype(t.dtype)
    jc = dataclasses.replace(jc, **fields)
    return jc, kvcache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _assert_caches_equal(cache, jcache):
    want = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for name in ("k", "v", "k_scale", "v_scale", "page_table"):
        got, exp = getattr(cache, name), getattr(want, name)
        assert (got is None) == (exp is None), name
        if got is not None:
            assert got.dtype == exp.dtype and torch.equal(got, exp), name


class _GivenProjections(jllama.Runtime):
    """The JAX Runtime with every block projection replaced: q|k|v are the
    given arrays, one a layer in call order, the MLP and ``wo`` give zeros."""

    def __init__(self, qkv):
        self.qkv = list(qkv)

    def col(self, x, w, **kw):
        if w == "wqkv":
            return jnp.asarray(self.qkv.pop(0))
        return jnp.zeros(x.shape[:-1] + (2 * JCFG.intermediate_size,), x.dtype)

    def row(self, x, w, **kw):
        return jnp.zeros(x.shape[:-1] + (JCFG.hidden_size,), x.dtype)


@pytest.mark.parametrize("quantized,paged", FORMS, ids=FORM_IDS)
def test_unaligned_write_equals_jax_exactly(quantized, paged):
    """Given the same k/v rows, the port's per-t write leaves the cache bit
    for bit as the JAX forward's per-element scatter (bf16) or per-t byte
    read-modify-write (int8) leaves it: neighbours of a word kept, positions
    at S and in a page of -1 dropped."""
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    qdim, kvdim = H * D, Hkv * D
    rng = np.random.default_rng(1)
    qkv = [jnp.asarray(rng.standard_normal((B, T, qdim + 2 * kvdim)).astype(np.float32))
           .astype(jnp.bfloat16) for _ in range(CFG.num_layers)]
    ones = jnp.ones((CFG.hidden_size,), jnp.float32)
    params = dict(
        embed=jnp.zeros((CFG.vocab_size, CFG.hidden_size), jnp.bfloat16),
        lm_head=jnp.zeros((CFG.hidden_size, CFG.vocab_size), jnp.bfloat16), ln_final=ones,
        layers=[dict(wqkv="wqkv", wo="wo", w_gateup="w_gateup", w_down="w_down",
                     ln_attn=ones, ln_mlp=ones) for _ in range(CFG.num_layers)])
    jc, cache = _random_caches(quantized, paged)
    tokens = jnp.zeros((B, T), jnp.int32)
    _, jc = jllama.forward(params, JCFG, tokens, jc, jnp.asarray(POSITIONS),
                           rt=_GivenProjections(qkv), kv_unaligned=True)
    positions = torch.from_numpy(POSITIONS).long()
    for li, x in enumerate(qkv):
        k = jllama._rope(x[..., qdim : qdim + kvdim].reshape(B, T, Hkv, D),
                         jnp.asarray(POSITIONS), JCFG.rope_theta)
        v = x[..., qdim + kvdim :].reshape(B, T, Hkv, D)
        k, v = (torch.tensor(np.asarray(t.astype(jnp.float32))).bfloat16() for t in (k, v))
        llama._write_unaligned(cache, li, k, v, positions, use_kernel=True)
    _assert_caches_equal(cache, jc)
    # the write did write: the first active position of slot 0 changed
    assert not torch.equal(cache.k, _random_caches(quantized, paged)[1].k)


def _close(got: torch.Tensor, want, tol=2e-2):
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("quantized,paged", FORMS, ids=FORM_IDS)
def test_unaligned_forward_matches_jax(jparams, model, quantized, paged):
    jc, cache = _random_caches(quantized, paged, seed=2)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, (B, T)).astype(np.int32)
    jlogits, jc = jax.jit(jllama.forward, static_argnums=1, static_argnames="kv_unaligned")(
        jparams, JCFG, jnp.asarray(tokens), jc, jnp.asarray(POSITIONS), kv_unaligned=True)
    logits, out = model(torch.from_numpy(tokens), cache, torch.from_numpy(POSITIONS).long(),
                        kv_unaligned=True)
    assert out is cache
    _close(logits, jlogits)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jc.lengths))
    assert cache.lengths.tolist() == [9, 18, 35, 64, 7]
    want = kvcache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for name in ("k", "v"):
        got, exp = getattr(cache, name), getattr(want, name)
        if quantized:  # a 1-ulp bf16 difference in k between the frameworks can move a byte
            got, exp = (_unpack_kv_words(c.k if name == "k" else c.v,
                                         c.k_scale if name == "k" else c.v_scale)
                        for c in (cache, want))
            quantum = exp.abs().amax(dim=-1, keepdim=True) / 127.0
            assert ((got - exp).abs() <= 2 * quantum + 1e-6).all()
        else:
            _close(got, exp.float().numpy())


def test_kv_unaligned_writes_row_i_to_slot_i(model):
    cache = llama.KVCache.init(CFG, 2, "cpu")
    with pytest.raises(ValueError):
        model(torch.zeros(1, 2, dtype=torch.long), cache, torch.arange(2)[None],
              slot_ids=torch.tensor([1]), kv_unaligned=True)


# --- spec_verify_step ---

@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_spec_verify_step_matches_jax(jparams, model, quantized):
    """Slot 0: every draft right; slot 1: the first two; slot 2 at the
    capacity edge (length 62: two positions left); slot 3 inactive."""
    lens = np.asarray([10, 20, 62, 5], np.int32)
    # seeds whose verify has no near-tie of two tokens (queue 3's test rule)
    prompts = np.random.default_rng(5).integers(0, CFG.vocab_size, (4, S)).astype(np.int32)
    jprefill = jax.jit(jllama.prefill_slots, static_argnums=1)
    jverify = jax.jit(jllama.spec_verify_step, static_argnums=1)
    _, jc = jprefill(jparams, JCFG, jnp.asarray(prompts), jnp.asarray(lens),
                     jnp.arange(4, dtype=jnp.int32),
                     jllama.KVCache.init(JCFG, 4, quantized=quantized))
    active = jnp.asarray([True, True, True, False])
    toks = np.random.default_rng(6).integers(0, CFG.vocab_size, (4, T)).astype(np.int32)
    for t in range(T - 1):  # drafts that continue the model's own greedy choice
        g, _, _ = jverify(jparams, JCFG, jnp.asarray(toks), jc, active=active)
        toks[:, t + 1] = np.asarray(g)[:, t]
    toks[1, 3] = (toks[1, 3] + 1) % CFG.vocab_size
    jg, jacc, jc2 = jverify(jparams, JCFG, jnp.asarray(toks), jc, active=active)
    cache = kvcache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    g, acc, out = llama.spec_verify_step(model, torch.from_numpy(toks), cache,
                                         active=torch.tensor([True, True, True, False]))
    assert out is cache
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jc2.lengths))
    assert acc.tolist()[:2] == [T - 1, 2] and cache.lengths.tolist() == [15, 23, 64, 5]
