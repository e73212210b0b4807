"""The port's fp16 and f32 KV caches against the JAX package's, on the CPU at a
small size (the tiny config, one layer): the same numpy inputs go through the JAX
functions (Pallas in interpret mode) and through the port, which runs its
plain versions here.  Every case runs for both types.

- ``KVCache.init`` / ``init_paged(dtype=)``: shapes and dtypes equal JAX's;
  any other type raises ``ValueError`` (as does ``Engine(cache_dtype=)``);
- the plain versions of #4 (``kv_append_dense``), #2 (``decode_attention``
  with its append, linear and paged) and #9 (``prefill_attention``) on such
  caches against the JAX kernels: appended rows equal, attention within abs
  2e-2 (bf16 queries, bf16 outputs on both sides; #9 on the live queries, as
  ``tests/test_torch_prefill_attention.py`` compares them);
- the model: ``prefill_slots_chunk`` (two chunks), ``decode_step`` and
  ``spec_verify_step`` on one cache: logits within rel 2e-2 of JAX's, lengths
  and verify tokens equal, live cache rows within 2e-2 of their largest.  The
  rows are the bf16 k/v of each framework's projections, which differ in
  their last bit here and there (a 1-ulp difference is 1.6e-2 at |x| ~ 2), so
  the rows cannot meet a tighter gate against JAX; the cast itself is held
  exactly, against the port's own bf16 cache: an f32 cache holds the bf16
  rows exactly, so every f32 logit and row equals the bf16 cache's, and an
  fp16 cache's first rows are the bf16 rows rounded to fp16;
- ``pp.stage_cache`` and ``model_tp.shard_cache`` keep the type and the rows;
- ``Engine(cache_dtype=)``: greedy tokens of the linear and the paged engine
  equal the JAX engine's (linear for f32, paged for fp16; the JAX engine's
  two give the same tokens).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xbitops_tpu.engine import Engine as JEngine
from xbitops_tpu.engine import Request as JRequest
from xbitops_tpu.kernels.decode_attention import decode_attention as jdecode
from xbitops_tpu.kernels.kv_append import kv_append_dense as jappend
from xbitops_tpu.kernels.prefill_attention import prefill_attention as jprefill_att
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.kernels.decode_attention import decode_attention
from xbitops_tpu_torch.kernels.kv_append import kv_append_dense
from xbitops_tpu_torch.kernels.prefill_attention import prefill_attention
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.parallel import model_tp, pp
from xbitops_tpu_torch.parallel.mesh import Mesh
from xbitops_tpu_torch.utils.synth import scatter_pages

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
# the tiny config cut to one layer: every JAX program here compiles for each
# cache type, and the file has to stay under a minute alone
JCFG = dataclasses.replace(jllama.LlamaConfig.tiny(), num_layers=1)
CFG = dataclasses.replace(llama.LlamaConfig.tiny(), num_layers=1)
DTYPES = {"f16": (jnp.float16, torch.float16), "f32": (jnp.float32, torch.float32)}
jprefill_chunk = jax.jit(jllama.prefill_slots_chunk, static_argnums=1)
jdecode_step = jax.jit(jllama.decode_step, static_argnums=1)
jverify = jax.jit(jllama.spec_verify_step, static_argnums=1)


def _t(a):
    """numpy (bf16, float or int) -> torch, keeping the bits."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _close(got, want, tol=2e-2):
    """Within ``tol`` of the largest value of ``want``."""
    want = _f32(want)
    err = np.abs(_f32(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def jparams():
    # random packed 4-bit weights, jitted: one compile instead of one per op
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.mark.parametrize("name", list(DTYPES))
def test_kvcache_init_matches_jax(name):
    jdt, tdt = DTYPES[name]
    pairs = [(jllama.KVCache.init(JCFG, 3, dtype=jdt), llama.KVCache.init(CFG, 3, "cpu", dtype=tdt)),
             (jllama.KVCache.init_paged(JCFG, 3, 7, page_size=16, dtype=jdt),
              llama.KVCache.init_paged(CFG, 3, 7, 16, device="cpu", dtype=tdt))]
    for jc, c in pairs:
        assert c.k.dtype == c.v.dtype == tdt and not c.quantized
        for field in ("k", "v", "lengths"):
            got, want = getattr(c, field), getattr(jc, field)
            assert tuple(got.shape) == tuple(want.shape)
            assert np.dtype(str(got.dtype).replace("torch.", "")) == np.dtype(want.dtype)
            assert not got.any()
        assert c.S == jc.S


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.float8_e4m3fn])
def test_other_dtypes_raise(model, dtype):
    with pytest.raises(ValueError, match="bfloat16, torch.float16 or torch.float32"):
        llama.KVCache.init(CFG, 2, "cpu", dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16, torch.float16 or torch.float32"):
        llama.KVCache.init_paged(CFG, 2, 4, 16, device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16, torch.float16 or torch.float32"):
        Engine(model, CFG, slots=2, cache_dtype=dtype)


def _rows(rng, shape, dtype):
    return _t(rng.standard_normal(shape, dtype=np.float32).astype(np.dtype(dtype)))


@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_kernels_match_jax(name):
    """#4, #2 with its append (linear, then paged) and #9 on one random cache."""
    jdt, tdt = DTYPES[name]
    np_dt = np.dtype(jdt)
    rng = np.random.default_rng(3 + (tdt == torch.float32))
    L, B, H, Hkv, S, D = 2, 3, 4, 2, 64, 128
    k, v = (_rows(rng, (L, B, Hkv, S, D), np_dt) for _ in range(2))
    kn, vn = (_rows(rng, (B, Hkv, D), BF16) for _ in range(2))
    pos = torch.tensor([4, 63, 64], dtype=torch.int32)  # 64: writes nothing

    # #4: the new bf16 rows cast to the cache's type, equal
    jk, jv = jappend(jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(kn.float().numpy(),
                     jnp.bfloat16), jnp.asarray(vn.float().numpy(), jnp.bfloat16),
                     jnp.asarray(pos.numpy()), jnp.int32(1))
    k1, v1 = k.clone(), v.clone()
    kv_append_dense(k1, v1, kn, vn, pos, 1)
    assert k1.dtype == tdt
    np.testing.assert_array_equal(k1.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(jv))

    # #2 with the fused append
    q = _rows(rng, (B, H, D), BF16)
    lens = torch.clamp(pos.long() + 1, max=S).to(torch.int32)
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    jnew = (jnp.asarray(kn.float().numpy(), jnp.bfloat16),
            jnp.asarray(vn.float().numpy(), jnp.bfloat16), jnp.asarray(pos.numpy()))
    jout, jk2, jv2 = jdecode(jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                             jnp.asarray(lens.numpy()), layer_idx=jnp.int32(1), kv_new=jnew)
    k2, v2 = k.clone(), v.clone()
    out, rk, _ = decode_attention(q, k2, v2, lens, layer_idx=1, kv_new=(kn, vn, pos))
    assert rk is k2 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv2))
    assert np.abs(_f32(out) - _f32(jout)).max() <= 2e-2

    # #2 paged: the same cache cut into pages of 16 behind a shuffled table,
    # appended through it: the pools hold JAX's appended rows, the output is
    # the linear one's (held to JAX's above)
    P, n_pages = S // 16, B * (S // 16) + 2
    table = torch.from_numpy(rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32))
    cut = lambda ts: [torch.stack([scatter_pages(x, table, n_pages) for x in t]) for t in ts]
    pools = cut((k, v))
    out_p, *_ = decode_attention(q, *pools, lens, layer_idx=1, kv_new=(kn, vn, pos),
                                 page_table=table)
    assert pools[0].dtype == tdt
    assert all(torch.equal(a, b) for a, b in zip(pools, cut((_t(np.asarray(jk2)),
                                                             _t(np.asarray(jv2))))))
    assert torch.equal(out_p, out)

    # #9: a chunk of 64 queries of two rows (one padded past 40) against layer 1
    T = 64
    qc = _rows(rng, (2, T, H, D), BF16)
    cpos = torch.from_numpy(np.stack([np.arange(T), np.where(np.arange(T) < 40, np.arange(T), S)])
                            .astype(np.int32))
    slots = torch.tensor([0, 2], dtype=torch.int32)
    jo = jprefill_att(jnp.asarray(qc.float().numpy(), jnp.bfloat16), jnp.asarray(k.numpy()),
                      jnp.asarray(v.numpy()), jnp.asarray(cpos.numpy()),
                      jnp.asarray(slots.numpy()), layer_idx=jnp.int32(1))
    o = prefill_attention(qc, k, v, cpos, slots, layer_idx=1)
    # the JAX kernel zeroes only a q-tile of nothing but padding: compare the
    # live queries, and the port's padding ones are exactly 0
    live = cpos < S
    assert o.dtype == torch.bfloat16 and (o[~live] == 0).all()
    assert np.abs(_f32(o)[live.numpy()] - _f32(jo)[live.numpy()]).max() <= 2e-2


def _live_close(cache, jcache, tol=2e-2):
    """k and v within ``tol`` of their largest value, over each slot's first
    ``lengths`` positions (JAX's prefill also writes padding rows past a
    slot's length, the port's does not)."""
    live = torch.arange(cache.k.shape[3])[None] < cache.lengths.long()[:, None]
    mask = live[None, :, None, :, None].expand_as(cache.k).numpy()
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert got.dtype == torch.from_numpy(np.zeros(1, np.asarray(want).dtype)).dtype
        _close(_f32(got)[mask], _f32(want)[mask], tol)


@pytest.mark.parametrize("name", list(DTYPES))
def test_forward_paths_match_jax(jparams, model, name):
    """Two chunks of prefill (slot 1: 20 tokens, slot 0: 12), a decode step,
    then a verify of 3 tokens a slot with slot 1 inactive, all on one cache,
    beside JAX's on its own and the port's bf16 cache on the same inputs."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, CFG.vocab_size, (2, 32)).astype(np.int32)
    jc = jllama.KVCache.init(JCFG, 2, dtype=jdt)
    c = llama.KVCache.init(CFG, 2, "cpu", dtype=tdt)
    cb = llama.KVCache.init(CFG, 2, "cpu")  # bf16

    def check(jl, tl, bl):
        _close(tl, jl)
        np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
        if tdt == torch.float32:  # the f32 cache holds the bf16 rows exactly
            assert torch.equal(tl, bl) and torch.equal(c.k, cb.k.float())
        _live_close(c, jc)

    for starts, lens, slots, resets, cols in (
            ([0, 0], [20, 12], [1, 0], [True, True], slice(0, 16)),
            ([16, 0], [20, 0], [1, 2], [False, False], slice(16, 32))):  # slot 2: inert
        args = [np.asarray(a, np.int32) for a in (starts, lens, slots)]
        chunk = np.stack([prompts[0, cols] if s == 1 else prompts[1, :16]
                          for s in slots]).astype(np.int32)
        jl, jc = jprefill_chunk(jparams, JCFG, jnp.asarray(chunk), *map(jnp.asarray, args), jc,
                                resets=jnp.asarray(resets))
        targs = [torch.from_numpy(a) for a in (chunk, *args)]
        tl, out = llama.prefill_slots_chunk(model, *targs, c, resets=torch.tensor(resets))
        bl, _ = llama.prefill_slots_chunk(model, *targs, cb, resets=torch.tensor(resets))
        assert out is c
        rows = slice(None) if slots[1] < 2 else slice(0, 1)
        check(np.asarray(jl)[rows], tl[rows], bl[rows])
        if resets[0] and tdt == torch.float16:  # first rows: the bf16 ones rounded to fp16
            assert torch.equal(c.k, cb.k.to(torch.float16))
    assert c.lengths.tolist() == [12, 20]

    tok = np.asarray([3, 200], np.int32)
    jl, jc = jdecode_step(jparams, JCFG, jnp.asarray(tok), jc)
    tl, _ = llama.decode_step(model, torch.from_numpy(tok), c)
    bl, _ = llama.decode_step(model, torch.from_numpy(tok), cb)
    check(jl, tl, bl)

    toks = np.stack([np.asarray(jnp.argmax(jl, -1)), [7, 9], [1, 2]], axis=1).astype(np.int32)
    active = np.asarray([True, False])
    jg, jacc, jc = jverify(jparams, JCFG, jnp.asarray(toks), jc, active=jnp.asarray(active))
    g, acc, _ = llama.spec_verify_step(model, torch.from_numpy(toks), c,
                                       active=torch.from_numpy(active))
    np.testing.assert_array_equal(g[:1].numpy(), np.asarray(jg)[:1])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
    _live_close(c, jc)

    # a pipeline stage's part and a tensor-parallel rank's keep the type and
    # the rows (held to JAX's above)
    two = llama.KVCache(k=torch.cat([c.v, c.k]), v=torch.cat([c.k, c.v]), lengths=c.lengths)
    staged = pp.stage_cache(two, Mesh(("pipe",), (2,), (1,), (None,)))  # the second stage's
    assert staged.k.dtype == tdt and torch.equal(staged.k, c.k) and torch.equal(staged.v, c.v)
    assert staged.lengths.tolist() == c.lengths.tolist()
    shard = model_tp.shard_cache(c, Mesh(("model",), (2,), (1,), (None,)))
    assert shard.v.dtype == tdt and torch.equal(shard.v, c.v[:, :, 1:])


def _requests(cls, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, CFG.vocab_size, n).tolist(), max_new_tokens=5)
            for n in (5, 9, 14)]


@pytest.mark.parametrize("name", list(DTYPES))
def test_engine_matches_jax_engine(jparams, model, name):
    jdt, tdt = DTYPES[name]
    kw = dict(slots=2, kv_quant=False, prefill_buckets=[16])
    jpaged = dict(paged=True, page_size=16) if tdt == torch.float16 else {}
    want = JEngine(jparams, JCFG, cache_dtype=jdt, **kw, **jpaged).generate(_requests(JRequest))
    for paged in ({}, dict(paged=True, page_size=16)):
        eng = Engine(model, CFG, cache_dtype=tdt, **kw, **paged)
        got = eng.generate(_requests(Request))
        assert eng.cache.k.dtype == tdt
        assert [c.tokens for c in got] == [c.tokens for c in want]
        assert all(len(c.tokens) == 5 for c in got)
