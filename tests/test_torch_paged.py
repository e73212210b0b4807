"""The port's paged KV cache against the JAX package's, on the CPU at a small
size (the tiny config, 2 slots, pages of 16 positions): the same numpy inputs go
through the JAX functions (Pallas in interpret mode) and through the port,
which runs its plain versions here.

- ``decode_attention(page_table=...)`` against the JAX entry within abs 2e-2
  (bf16 queries) or 1e-4 (f32 queries on the int8 pool), and equal to the
  port's linear form on the gathered cache exactly;
- ``prefill_attention(page_table=...)`` against the JAX eager path (its
  ``_attention`` over the gathered pages, which is what its ``forward`` runs on
  a paged cache) within the same tolerances, and equal to the port's linear
  plain version on the gathered cache exactly;
- the writes: the port's index arithmetic equals the JAX ``_paged_word``'s,
  drops included, and the same rows written to a linear cache and to a pool
  give the same cache exactly, with no byte of the pool changed where a row
  has no page, lies past the capacity or names a slot out of range;
- the model (``prefill_slots``, ``prefill_slots_chunk``, ``decode_step``) on a
  paged cache: logits within rel 2e-2 of JAX's and equal to those over the
  port's linear cache; the pools agree with JAX's on the live positions (bf16
  within rel 2e-2, int8 dequantized within 2 quanta plus that gate: the
  frameworks round k and v at different places);
- the engine: tokens of ``Engine(paged=True)`` equal the port's linear engine's
  and the JAX paged engine's; a pool under pressure defers and resumes; the
  errors; every page is back when ``generate`` returns;
- a JAX paged cache converted by ``kvcache_from_numpy`` decodes in the port.
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
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.io.convert import kvcache_from_numpy, params_from_numpy
from xbitops_tpu_torch.kernels.decode_attention import decode_attention
from xbitops_tpu_torch.kernels.kv_append import (
    gather_pages,
    kv_append_dense,
    kv_append_packed,
    paged_rows,
)
from xbitops_tpu_torch.kernels.prefill_attention import prefill_attention
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils.synth import scatter_pages

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
PSZ = 16
P = CFG.max_seq_len // PSZ


def _t(a):
    """numpy (bf16, float or int) -> torch, keeping the bits."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(t):
    """torch -> jax, keeping the bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(BF16))
    return jnp.asarray(t.numpy())


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _linear_cache(rng, lead, B, Hkv, S, D, int8):
    """A random linear cache (torch): k, v, or words, words, scales, scales."""
    if int8:
        words = [rng.integers(-2**31, 2**31, lead + (B, Hkv, S // 4, D)).astype(np.int32)
                 for _ in range(2)]
        scales = [rng.uniform(lo, hi, lead + (B, 4, Hkv, S // 4)).astype(BF16)
                  for lo, hi in ((0.002, 0.01), (0.005, 0.02))]
        return [_t(a) for a in words + scales]
    return [_t(rng.standard_normal(lead + (B, Hkv, S, D), dtype=np.float32).astype(BF16))
            for _ in range(2)]


def _table(rng, B, pages, n_pages, live_pages):
    """A shuffled table [B, pages]: slot b gets ``live_pages[b]`` pages, -1 after."""
    order = iter(rng.permutation(n_pages).tolist())
    table = np.full((B, pages), -1, np.int32)
    for b, n in enumerate(live_pages):
        table[b, :n] = [next(order) for _ in range(n)]
    return torch.from_numpy(table)


def _pools(linear, table, n_pages):
    """Cut linear cache tensors (flat [B, ...] or stacked [L, B, ...]) into pools."""
    out = []
    for i, t in enumerate(linear):
        stacked = t.dim() == 5
        layers = t if stacked else t[None]
        pool = torch.stack([scatter_pages(x, table, n_pages, scales=i >= 2) for x in layers])
        out.append(pool if stacked else pool[0])
    return out


@pytest.mark.parametrize(
    "int8,qdtype,tol", [(False, BF16, 2e-2), (True, BF16, 2e-2), (True, np.float32, 1e-4)],
    ids=["bf16pool", "int8pool", "int8pool-f32q"])
@pytest.mark.parametrize(
    "L,B,H,Hkv,pages,psz,lens,window",
    [
        (None, 2, 8, 2, 4, 64, [70, 256], None),  # flat pool, GQA, one slot partly full
        (3, 3, 4, 4, 6, 16, [1, 96, 37], None),  # stacked, MHA, len 1 / len == S / ragged
        (2, 3, 8, 2, 8, 16, [100, 128, 9], 40),  # a window that starts inside a page
        (1, 2, 4, 1, 4, 16, [64, 20], 500),  # a window >= P * psz is dropped
    ],
)
def test_decode_attention_paged_matches_jax(L, B, H, Hkv, pages, psz, lens, window, int8,
                                            qdtype, tol):
    D, S = 128, pages * psz
    rng = np.random.default_rng(S + B + int8)
    lead = () if L is None else (L,)
    li = None if L is None else L - 1
    q = _t(rng.standard_normal((B, H, D), dtype=np.float32).astype(qdtype))
    linear = _linear_cache(rng, lead, B, Hkv, S, D, int8)
    n_pages = B * pages + 2
    table = _table(rng, B, pages, n_pages, [-(-n // psz) for n in lens])
    assert (table == -1).any()
    pools = _pools(linear, table, n_pages)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    kw = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    jkw = {n: _j(t) for n, t in kw.items()}
    want = jdecode(_j(q), _j(pools[0]), _j(pools[1]), _j(lens_t), window=window,
                   layer_idx=None if li is None else jnp.int32(li), page_table=_j(table), **jkw)
    got = decode_attention(q, pools[0], pools[1], lens_t, layer_idx=li, window=window,
                           page_table=table, **kw)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol)
    assert np.abs(_f32(got)).max() > 0.01
    # the port's linear form on the gathered cache: the same numbers in the same order
    gathered = [gather_pages(t if li is None else t[li], table, scales=i >= 2)
                for i, t in enumerate(pools)]
    lin = decode_attention(q, gathered[0], gathered[1], lens_t, window=window,
                           **(dict(k_scale=gathered[2], v_scale=gathered[3]) if int8 else {}))
    assert torch.equal(got, lin)
    # and on the cache the pools were cut from (it differs only past the live rows)
    pick = (lambda t: t) if li is None else (lambda t: t[li])
    lin = decode_attention(q, pick(linear[0]), pick(linear[1]), lens_t, window=window,
                           **(dict(k_scale=pick(linear[2]), v_scale=pick(linear[3]))
                              if int8 else {}))
    assert torch.equal(got, lin)


def test_decode_attention_paged_inactive_slot_and_append():
    """An inactive slot arrives with length S and a row of -1: it reads page 0
    and writes nothing.  ``kv_new`` appends through the table first."""
    B, H, Hkv, D, pages, psz, n_pages = 3, 4, 2, 128, 4, 16, 13
    S = pages * psz
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((B, H, D), dtype=np.float32).astype(BF16))
    linear = _linear_cache(rng, (2,), B, Hkv, S, D, False)
    table = _table(rng, B, pages, n_pages, [2, 0, 4])
    pools = _pools(linear, table, n_pages)
    before = [t.clone() for t in pools]
    new = [_t(rng.standard_normal((B, Hkv, D), dtype=np.float32).astype(BF16)) for _ in range(2)]
    pos = torch.tensor([20, S, 63])
    lens = torch.clamp(pos + 1, max=S).int()
    out, rk, rv = decode_attention(q, pools[0], pools[1], lens, layer_idx=1,
                                   kv_new=(new[0], new[1], pos), page_table=table)
    assert rk is pools[0] and rv is pools[1]  # in place
    kv_append_dense(linear[0], linear[1], new[0], new[1], pos, 1)
    lin = decode_attention(q, linear[0], linear[1], lens, layer_idx=1)
    assert torch.equal(out[[0, 2]], lin[[0, 2]])
    assert torch.isfinite(out.float()).all()
    for pool, old, new_rows in zip(pools, before, new):
        assert torch.equal(pool[0], old[0])  # the other layer
        assert torch.equal(pool[1, table[0, 1], :, 4], new_rows[0])
        assert torch.equal(pool[1, table[2, 3], :, 15], new_rows[2])
        changed = (pool[1] != old[1]).flatten(1).any(dim=1).nonzero().flatten().tolist()
        assert sorted(changed) == sorted([int(table[0, 1]), int(table[2, 3])])


@pytest.mark.parametrize(
    "int8,dtype,tol", [(False, BF16, 2e-2), (True, BF16, 2e-2), (True, np.float32, 1e-4)],
    ids=["bf16pool", "int8pool", "int8pool-f32q"])
@pytest.mark.parametrize("stacked,window", [(True, None), (False, None), (True, 24)])
def test_prefill_attention_paged_matches_jax_eager(int8, dtype, tol, stacked, window):
    """Row 0 starts at 0 and ends mid-chunk, row 1 fills the last chunk of its
    slot, row 2 is inert (slot out of range, nothing but padding)."""
    N, T, H, Hkv, D, B, pages, psz = 3, 32, 4, 2, 128, 4, 6, 16
    S, n_pages = pages * psz, 20
    rng = np.random.default_rng(T + int8 + stacked)
    q = _t(rng.standard_normal((N, T, H, D), dtype=np.float32).astype(dtype))
    linear = _linear_cache(rng, (2,) if stacked else (), B, Hkv, S, D, int8)
    li = 1 if stacked else None
    starts, lens = [0, S - T, 0], [T - 5, S, 0]
    pos = np.asarray(starts)[:, None] + np.arange(T)[None]
    pos = np.where(pos < np.asarray(lens)[:, None], pos, S).astype(np.int32)
    slots = np.asarray([2, 0, B], np.int32)
    table = _table(rng, B, pages, n_pages, [pages, 0, 2, 0])  # slots 1 and 3 hold nothing
    pools = _pools(linear, table, n_pages)
    kw = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    got = prefill_attention(q, pools[0], pools[1], _t(pos), _t(slots), layer_idx=li,
                            window=window, page_table=table, **kw)
    assert got.shape == q.shape and got.dtype == q.dtype
    live = pos < S
    assert (_f32(got)[~live] == 0).all() and (~live[0]).any() and not live[2].any()

    # the JAX eager path: gather the rows' pages into one context, then _attention
    layer = [_j(t if li is None else t[li]) for t in pools]
    safe = jnp.maximum(_j(table)[jnp.clip(jnp.asarray(slots), 0, B - 1)], 0)
    kg, vg = (jnp.moveaxis(t[safe], 1, 2).reshape(N, Hkv, -1, D) for t in layer[:2])
    if int8:
        ksg, vsg = (jnp.moveaxis(t[safe], 1, 3).reshape(N, 4, Hkv, -1) for t in layer[2:])
        kg, vg = jllama._unpack_kv_words(kg, ksg), jllama._unpack_kv_words(vg, vsg)
    s_idx = jnp.arange(S)[None, None, :]
    mask = s_idx <= jnp.asarray(pos)[:, :, None]
    if window is not None:
        mask &= jnp.asarray(pos)[:, :, None] - s_idx < window
    want = jllama._attention(_j(q), kg, vg, mask, D ** -0.5)
    np.testing.assert_allclose(_f32(got)[live], _f32(want)[live], atol=tol)
    assert np.abs(_f32(got)[live]).max() > 0.01

    # the port's linear plain version on the gathered cache
    gathered = [gather_pages(t if li is None else t[li], table, scales=i >= 2)
                for i, t in enumerate(pools)]
    lin = prefill_attention(q, gathered[0], gathered[1], _t(pos), _t(slots), window=window,
                            **(dict(k_scale=gathered[2], v_scale=gathered[3]) if int8 else {}))
    assert torch.equal(got, lin)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
def test_paged_rows_match_jax_paged_word(int8):
    """The port's index arithmetic against ``_paged_word``: the same page and
    word for every position that has a page, and the same drops (a position
    past the capacity, a -1 entry)."""
    B, pages, psz, n_pages = 3, 4, 16, 9
    rng = np.random.default_rng(0)
    table = _table(rng, B, pages, n_pages, [4, 1, 2])
    pool = jnp.zeros((1, n_pages, 2, psz // 4, 8), jnp.int32)
    rows = np.asarray([2, 0, 1, 1], np.int32)
    for pos in (np.asarray([31, 63, 5, 16], np.int32),  # slot 1 has one page: 16 has none
                np.asarray([[0, 4, 8], [60, 64, 68], [12, 16, 20], [40, 44, 48]], np.int32)):
        jpage, jword = jllama._paged_word(_j(table), jnp.asarray(rows), jnp.asarray(pos), pool)
        ok, page, row = paged_rows(table, _t(rows), _t(pos), psz, n_pages)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jpage) < n_pages)
        assert ok.any() and not ok.all()
        np.testing.assert_array_equal(page[ok].numpy(), np.asarray(jpage)[ok.numpy()])
        np.testing.assert_array_equal((row[ok] // 4).numpy(), np.asarray(jword)[ok.numpy()])
        np.testing.assert_array_equal((row[ok] % 4).numpy(), (pos % 4)[ok.numpy()])
    ok, _, _ = paged_rows(table, torch.tensor([-1, B, 0]), torch.tensor([0, 0, -3]), psz, n_pages)
    assert not ok.any()  # a slot out of range, a negative position


def _given_rows(table, rows_per_page):
    return (table >= 0).repeat_interleave(rows_per_page, dim=1)


def _assert_pool_is_linear(cache, lin, li):
    """Layer ``li`` of the paged cache, gathered, equals the linear cache on
    every page that was given out."""
    names = ("k", "v", "k_scale", "v_scale") if cache.quantized else ("k", "v")
    for i, name in enumerate(names):
        axis = 3 if i >= 2 else 2  # scales [B, 4, Hkv, S/4]; else [B, Hkv, rows, D]
        got = gather_pages(getattr(cache, name)[li], cache.page_table, scales=i >= 2)
        got, want = got.movedim(axis, 1), getattr(lin, name)[li].movedim(axis, 1)
        given = _given_rows(cache.page_table, got.shape[1] // cache.page_table.shape[1])
        assert torch.equal(got[given], want[given]), name
        assert want[given].float().abs().sum() > 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
def test_paged_writes_equal_linear_writes(int8):
    """The same rows written to a linear cache and to a pool, by the append
    wrappers (T == 1, row i -> slot i) and by ``_write_rows`` (T == 1 and T > 1
    with slot ids): the gathered pool equals the linear cache on every given
    page, and a row with no page, past the capacity or with a slot out of
    range changes no byte of the pool."""
    cfg = dataclasses.replace(CFG, num_kv_heads=3)
    B, Hkv, D, n_pages = 3, 3, cfg.head_dim, 10
    rng = np.random.default_rng(1 + int8)
    lin = llama.KVCache.init(cfg, B, "cpu", quantized=int8)
    cache = llama.KVCache.init_paged(cfg, B, n_pages, PSZ, device="cpu", quantized=int8)
    cache.page_table.copy_(_table(rng, B, P, n_pages, [4, 1, 2]))
    assert cache.paged and cache.page_size == PSZ and cache.S == lin.S == cfg.max_seq_len
    unused = sorted(set(range(n_pages)) - set(cache.page_table.flatten().tolist()))

    def rows(*shape):
        return _t(rng.standard_normal(shape + (Hkv, D), dtype=np.float32).astype(BF16))

    def snapshot():
        return [t.clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                if t is not None]

    # the append wrappers, layer 1: slot 1 has no page for 17, slot 2 is past the capacity
    pos = torch.tensor([33, 17, 64])
    k, v = rows(B), rows(B)
    for c in (lin, cache):
        if int8:
            q, s = llama._quant_kv(torch.stack((k, v)))
            kv_append_packed(c.k, c.v, c.k_scale, c.v_scale, q[0], q[1], s[0], s[1], pos, 1,
                             c.page_table)
        else:
            kv_append_dense(c.k, c.v, k, v, pos, 1, c.page_table)
    _assert_pool_is_linear(cache, lin, 1)
    assert cache.k[0].abs().sum() == 0 and cache.k[1].abs().sum() > 0

    # _write_rows with T == 1 and slot ids: a slot out of range, a -1 entry
    before = snapshot()
    llama._write_rows(cache, 0, rows(2, 1), rows(2, 1), torch.tensor([[5], [20]]),
                      torch.tensor([B, 1]))
    assert all(torch.equal(a, b) for a, b in zip(snapshot(), before))
    k, v = rows(3, 1), rows(3, 1)
    for c in (lin, cache):
        llama._write_rows(c, 0, k, v, torch.tensor([[6], [3], [-1 if c is cache else 64]]),
                          torch.tensor([2, 1, 0]))
    _assert_pool_is_linear(cache, lin, 0)

    # _write_rows with T > 1: rows that end mid-page, cross pages, overhang the
    # slot's pages (slot 2 holds 32 positions) and an inert row
    T = 24
    starts = torch.tensor([[8], [0], [16], [0]])
    lens = torch.tensor([[64], [9], [40], [0]])
    positions = starts + torch.arange(T)[None]
    positions = torch.where(positions < lens, positions, cache.S)
    slots = torch.tensor([0, 1, 2, B])
    k, v = rows(4, T), rows(4, T)
    for c in (lin, cache):
        llama._write_rows(c, 1, k, v, positions, slots)
    _assert_pool_is_linear(cache, lin, 1)
    for t in snapshot():
        assert t[:, unused].abs().sum() == 0  # pages no slot holds
    # slot 2 wrote positions 16..31 and dropped 32..39, which the linear cache took
    rows_per_page = lin.k.shape[3] // P
    assert lin.k[1, 2, :, 2 * rows_per_page : 2 * rows_per_page + 2].abs().sum() > 0


@pytest.fixture(scope="module")
def jparams():
    # random packed 4-bit weights, jitted: one compile instead of one per op
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def test_init_paged_matches_jax_and_checks():
    for quantized in (False, True):
        jc = jllama.KVCache.init_paged(JCFG, 2, 7, page_size=PSZ, quantized=quantized)
        c = llama.KVCache.init_paged(CFG, 2, 7, PSZ, device="cpu", quantized=quantized)
        assert c.paged and c.quantized == quantized and c.page_size == jc.page_size == PSZ
        assert c.S == jc.S == CFG.max_seq_len
        for name in ("k", "v", "lengths", "k_scale", "v_scale", "page_table"):
            got, want = getattr(c, name), getattr(jc, name)
            assert (got is None) == (want is None), name
            if got is not None:
                assert tuple(got.shape) == tuple(want.shape), name
                np.testing.assert_array_equal(_f32(got), _f32(want))
        assert c.page_table.dtype == torch.int32 and (c.page_table == -1).all()
    with pytest.raises(ValueError, match="multiple of page_size"):
        llama.KVCache.init_paged(CFG, 2, 7, 24, device="cpu")
    with pytest.raises(ValueError, match="page_size % 4"):
        llama.KVCache.init_paged(CFG, 2, 7, 2, device="cpu", quantized=True)
    with pytest.raises(ValueError):
        llama.KVCache.init(CFG, 1, "cpu").page_size


def _close(got, want):
    want = _f32(want)
    err = np.abs(_f32(got) - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())


def _live_rows(cache):
    """k and v of a paged cache as f32 [L, B, Hkv, S, D] through its table,
    positions past each slot's length zeroed."""
    out = []
    for words, scales in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        t = torch.stack([gather_pages(x, cache.page_table) for x in words])
        if cache.quantized:
            sc = torch.stack([gather_pages(x, cache.page_table, scales=True) for x in scales])
            t = llama._unpack_kv_words(t, sc)
        live = torch.arange(t.shape[3])[None, :] < cache.lengths[:, None].long()
        out.append((t.float() * live[None, :, None, :, None]).numpy())
    return out


TOKENS = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 32)).astype(np.int32)
MODEL_TABLE = np.asarray([[5, 2, 4, -1], [0, -1, -1, -1]], np.int32)  # 7 pages, 6 unused


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16pool", "int8pool"])
def test_model_on_a_paged_cache_matches_jax_and_the_linear_cache(jparams, model, quantized):
    """A bucketed admission of two prompts (9 tokens into slot 1, 16 into slot
    0), one chunk that continues slot 0's prompt from 16 to 28 beside an inert
    row, then two decode steps, the second with slot 1 inactive."""
    jcache = jllama.KVCache.init_paged(JCFG, 2, 7, page_size=PSZ, quantized=quantized)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(MODEL_TABLE))
    cache = llama.KVCache.init_paged(CFG, 2, 7, PSZ, device="cpu", quantized=quantized)
    cache.page_table.copy_(torch.from_numpy(MODEL_TABLE))
    lin = llama.KVCache.init(CFG, 2, "cpu", quantized=quantized)

    def check(jl, tl, ll, rows=slice(None)):
        _close(tl[rows], np.asarray(jl)[rows])
        assert torch.equal(tl[rows], ll[rows])
        np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
        assert cache.lengths.tolist() == lin.lengths.tolist()

    lens, slots = np.asarray([9, 16], np.int32), np.asarray([1, 0], np.int32)
    jl, jcache = jax.jit(jllama.prefill_slots, static_argnums=1)(
        jparams, JCFG, jnp.asarray(TOKENS[:, :16]), jnp.asarray(lens), jnp.asarray(slots), jcache)
    args = (torch.from_numpy(TOKENS[:, :16]), torch.from_numpy(lens), torch.from_numpy(slots))
    tl, out = llama.prefill_slots(model, *args, cache)
    assert out is cache
    ll, _ = llama.prefill_slots(model, *args, lin)
    check(jl, tl, ll)

    starts, lens, slots = (np.asarray(a, np.int32) for a in ([16, 0], [28, 0], [0, 2]))
    chunk = np.stack([TOKENS[1, 16:32], np.zeros(16, np.int32)])
    resets = np.asarray([False, False])
    jl, jcache = jax.jit(jllama.prefill_slots_chunk, static_argnums=1)(
        jparams, JCFG, jnp.asarray(chunk), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(slots), jcache, resets=jnp.asarray(resets))
    args = tuple(torch.from_numpy(a) for a in (chunk, starts, lens, slots))
    tl, _ = llama.prefill_slots_chunk(model, *args, cache, resets=torch.from_numpy(resets))
    ll, _ = llama.prefill_slots_chunk(model, *args, lin, resets=torch.from_numpy(resets))
    check(jl, tl, ll, rows=slice(0, 1))
    assert cache.lengths.tolist() == [28, 9]

    tok = np.asarray([3, 200], np.int32)
    for active in ([True, True], [True, False]):
        act = np.asarray(active)
        jl, jcache = jax.jit(jllama.decode_step, static_argnums=1)(
            jparams, JCFG, jnp.asarray(tok), jcache, active=jnp.asarray(act))
        tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache,
                                  active=torch.from_numpy(act))
        ll, _ = llama.decode_step(model, torch.from_numpy(tok), lin, active=torch.from_numpy(act))
        check(jl, tl, ll, rows=act)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert cache.lengths.tolist() == [30, 10]

    # the pools against JAX's, on the live positions; the pages no slot holds stay zero
    jc = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for got, want in zip(_live_rows(cache), _live_rows(jc)):
        if quantized:
            quantum = np.abs(want).max(axis=-1, keepdims=True) / 127.0
            assert (np.abs(got - want) <= 2 * quantum + 2e-2 * np.abs(want).max()).all()
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
        assert np.abs(want).max() > 0
    for t, jt in ((cache.k, jc.k), (cache.v, jc.v)):
        assert t[:, [1, 3, 6]].abs().sum() == 0 and jt[:, [1, 3, 6]].abs().sum() == 0
        written = t.flatten(2).abs().sum(-1) > 0
        assert torch.equal(written, jt.flatten(2).abs().sum(-1) > 0)


_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(0, CFG.vocab_size, n).tolist() for n in (3, 9, 20)]


def _same_completions(got, want):
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [(c.id, c.prompt_len, c.finish_reason) for c in got] == [
        (c.id, c.prompt_len, c.finish_reason) for c in want]


def _all_pages_back(eng, n_pages):
    assert sorted(eng._free_pages) == list(range(n_pages))
    assert (eng._table == -1).all() and (eng.cache.page_table == -1).all()
    assert not any(eng._slot_pages)


def test_paged_engine_matches_linear_and_jax_paged_engine(jparams, model):
    """3 requests on 2 slots, bursts of 4: the tokens of the paged engine are
    those of the port's linear engine and of the JAX paged engine.  (The
    prompts are ones whose greedy path has no near-tie between the
    frameworks.)"""
    kw = dict(slots=2, decode_burst=4, kv_quant=False)
    want = JEngine(jparams, JCFG, paged=True, page_size=PSZ, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=6) for p in PROMPTS])
    reqs = lambda: [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    linear = Engine(model, CFG, **kw).generate(reqs())
    eng = Engine(model, CFG, paged=True, page_size=PSZ, **kw)
    assert eng.cache.paged and eng.cache.k.shape[1] == 2 * P  # the default pool
    got = eng.generate(reqs())
    _same_completions(got, linear)
    _same_completions(got, want)
    _all_pages_back(eng, 2 * P)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("chunk", [48, 16], ids=["bucketed", "chunked"])
def test_paged_engine_under_pool_pressure(model, kv_quant, chunk):
    """A pool of 5 pages of 16 for 2 slots of 64 serves a 40-token prompt
    beside two short ones: the long prompt takes 3 pages (in one bucket of 48,
    or in 3 chunks of 16); the 10-token request takes the last free page at
    its 16th position, so the long one, at its 48th, sits steps out until that
    request has finished, and resumes; the third request waits for a slot.
    The tokens and finish reasons are the linear engine's."""
    reqs = lambda: [
        Request(prompt=list(range(2, 42)), max_new_tokens=12),
        Request(prompt=list(range(50, 60)), max_new_tokens=20),
        Request(prompt=[7, 7], max_new_tokens=8),
    ]
    kw = dict(slots=2, prefill_buckets=[4, 8, chunk], prefill_chunk=chunk, kv_quant=kv_quant)
    linear = Engine(model, CFG, **kw).generate(reqs())
    eng = Engine(model, CFG, paged=True, page_size=PSZ, pool_pages=5, **kw)
    got = eng.generate(reqs())
    _same_completions(got, linear)
    assert [c.finish_reason for c in got] == ["length"] * 3
    assert eng.cache.quantized == kv_quant and eng.cache.k.shape[1] == 5
    assert eng.loop_stats["chunks"] == (3 if chunk == 16 else 0)
    assert eng.loop_stats["deferred_slot_steps"] > 0  # the long request waited for a page
    _all_pages_back(eng, 5)


def test_paged_engine_admission_waits_for_pages(model):
    """Two prompts of 30 tokens need 2 pages each and the pool has 3: the
    second is admitted only when the first has finished, though a slot is
    free."""
    reqs = lambda: [Request(prompt=list(range(1 + i, 31 + i)), max_new_tokens=3)
                    for i in range(2)]
    kw = dict(slots=2, prefill_buckets=[32])
    linear = Engine(model, CFG, **kw).generate(reqs())
    eng = Engine(model, CFG, paged=True, page_size=PSZ, pool_pages=3, **kw)
    _same_completions(eng.generate(reqs()), linear)
    assert eng.loop_stats["admission_waits"] > 0
    _all_pages_back(eng, 3)


def test_paged_engine_errors(model):
    eng = Engine(model, CFG, slots=1, prefill_buckets=[4, 8, 64], paged=True, page_size=PSZ,
                 pool_pages=2)
    with pytest.raises(RuntimeError, match="pool too small"):
        eng.generate([Request(prompt=list(range(1, 50)), max_new_tokens=2)])
    with pytest.raises(ValueError, match="page_size % 4"):
        Engine(model, CFG, paged=True, page_size=2, kv_quant=True)
    with pytest.raises(ValueError, match="multiple of page_size"):
        Engine(model, CFG, paged=True, page_size=24)
    no_flash = dataclasses.replace(CFG, flash_decode=False)
    with pytest.raises(ValueError, match="flash decode"):
        Engine(model.with_config(no_flash), no_flash, paged=True, page_size=PSZ)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_auto_kv_quant_matches_jax_engine(jparams, model, paged):
    """``kv_quant=None`` at ``max_seq_len`` 1024 and head_dim 128: both
    engines pick the int8 cache for the linear layout and the bf16 pool for
    the paged one (the reference's rule starts with ``not paged``)."""
    jcfg = dataclasses.replace(JCFG, max_seq_len=1024)
    cfg = dataclasses.replace(CFG, max_seq_len=1024)
    assert cfg.head_dim == 128 and cfg.max_seq_len >= 1024
    kw = dict(slots=2, kv_quant=None, paged=paged, page_size=256)
    want = JEngine(jparams, jcfg, **kw).kv_quant
    eng = Engine(model.with_config(cfg), cfg, **kw)
    assert eng.kv_quant == want == (not paged)
    assert eng.cache.quantized == (not paged) and eng.cache.paged == paged


def test_paged_engine_pool_exhausted(model):
    """One slot alone on a pool of one page: its prompt fits, its 17th
    position has no page and nothing can free one."""
    eng = Engine(model, CFG, slots=1, paged=True, page_size=PSZ, pool_pages=1)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.generate([Request(prompt=list(range(1, 13)), max_new_tokens=20)])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16pool", "int8pool"])
def test_kvcache_from_numpy_continues_a_jax_paged_prefill(jparams, model, quantized):
    """Prefill in the JAX package on a paged cache, one decode step in the port."""
    lens, slots = np.asarray([12, 16], np.int32), np.asarray([1, 0], np.int32)
    jcache = jllama.KVCache.init_paged(JCFG, 2, 7, page_size=PSZ, quantized=quantized)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(MODEL_TABLE))
    jl, jcache = jax.jit(jllama.prefill_slots, static_argnums=1)(
        jparams, JCFG, jnp.asarray(TOKENS[:, :16]), jnp.asarray(lens), jnp.asarray(slots), jcache)
    cache = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache.paged and cache.quantized == quantized and cache.page_size == PSZ
    assert cache.S == CFG.max_seq_len and cache.lengths.tolist() == [16, 12]
    assert cache.page_table.dtype == torch.int32
    np.testing.assert_array_equal(cache.page_table.numpy(), MODEL_TABLE)
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(cache, name), getattr(jcache, name)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(_f32(got), _f32(want))
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[::-1].copy()  # slot order
    jl2, _ = jax.jit(jllama.decode_step, static_argnums=1)(
        jparams, JCFG, jnp.asarray(tok), jcache)
    tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache)
    _close(tl, jl2)
    assert cache.lengths.tolist() == [17, 13]
