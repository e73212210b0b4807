"""The port's packed int8 KV cache against the JAX package's, on the same numpy
inputs: the quantize / pack / unpack helpers and the packed append bit for
bit (the JAX Pallas kernel in interpret mode), and int8 decode attention
within abs 2e-2 on bf16 queries, 1e-4 on f32 ones (the two frameworks sum in
different orders).  The port runs its plain versions here."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xbitops_tpu.kernels.decode_attention import decode_attention as jdecode
from xbitops_tpu.kernels.kv_append import kv_append_packed as jappend_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu_torch.kernels.decode_attention import decode_attention
from xbitops_tpu_torch.kernels.kv_append import kv_append_packed, kv_append_packed_reference
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16


def _t(a):
    """numpy (bf16, float or int) -> torch, keeping the bits."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.view(torch.int16).numpy().view(BF16) if t.dtype == torch.bfloat16 else t.numpy()


def _same_bits(t: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = _np(t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _packed_cache(rng, L, B, Hkv, S, D):
    """A random packed cache (numpy): words, then bf16 scales."""
    k = rng.integers(-2**31, 2**31, (L, B, Hkv, S // 4, D)).astype(np.int32)
    v = rng.integers(-2**31, 2**31, (L, B, Hkv, S // 4, D)).astype(np.int32)
    ks = rng.uniform(0.005, 0.02, (L, B, 4, Hkv, S // 4)).astype(BF16)
    vs = rng.uniform(0.005, 0.02, (L, B, 4, Hkv, S // 4)).astype(BF16)
    return k, v, ks, vs


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_quant_kv_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 3, 128)) * 3).astype(dtype)
    x[0, 0, 0] = 0  # an all-zero row: the scale's floor
    jq, js = jllama._quant_kv(jnp.asarray(x))
    q, s = llama._quant_kv(_t(x))
    _same_bits(q, jq)
    _same_bits(s, js)
    assert q.min() >= 1 and q.max() <= 255


def test_pack_and_unpack_bit_exact():
    rng = np.random.default_rng(1)
    q = rng.integers(1, 256, (2, 16, 3, 128)).astype(np.int32)
    s = rng.uniform(0.001, 0.05, (2, 16, 3)).astype(np.float32)
    jw = jllama._pack_kv_words(jnp.asarray(q))
    jsc = jllama._pack_kv_scales(jnp.asarray(s))
    w, sc = llama._pack_kv_words(_t(q)), llama._pack_kv_scales(_t(s))
    _same_bits(w, jw)
    _same_bits(sc.contiguous(), jsc)
    assert (np.asarray(jw) < 0).any()  # byte 3 reaches the sign bit
    jsc16 = jsc.astype(jnp.bfloat16)
    _same_bits(llama._unpack_kv_words(w, sc.to(torch.bfloat16)),
               jllama._unpack_kv_words(jw, jsc16))
    # round trip: position 4w + j, head h comes back as (q - 128) * scale
    deq = llama._unpack_kv_words(w, sc)  # [B, H, T, D]
    want = (q - 128).astype(np.float32) * s[..., None]
    np.testing.assert_array_equal(deq.numpy(), want.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("layer", [0, 1])
def test_kv_append_packed_matches_jax_exactly(layer):
    L, B, Hkv, S, D = 2, 6, 2, 32, 128
    rng = np.random.default_rng(3 + layer)
    k, v, ks, vs = _packed_cache(rng, L, B, Hkv, S, D)
    kq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    vq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    ksn = rng.uniform(0.001, 0.05, (B, Hkv)).astype(np.float32)
    vsn = rng.uniform(0.001, 0.05, (B, Hkv)).astype(np.float32)
    pos = np.asarray([4, 9, 18, 31, S, 0], np.int32)  # pos % 4 = 0, 1, 2, 3; S: no-op
    want = jappend_packed(*map(jnp.asarray, (k, v, ks, vs, kq, vq, ksn, vsn, pos)),
                          jnp.int32(layer), interpret=True)
    got = [_t(a) for a in (k, v, ks, vs)]
    out = kv_append_packed(*got, *map(_t, (kq, vq, ksn, vsn, pos)), layer)
    for g, o, w, before in zip(got, out, want, (k, v, ks, vs)):
        assert o is g  # in place
        _same_bits(g, w)
        np.testing.assert_array_equal(_np(g)[1 - layer].view(np.uint8),
                                      before[1 - layer].view(np.uint8))
        np.testing.assert_array_equal(_np(g)[layer, 4].view(np.uint8),
                                      before[layer, 4].view(np.uint8))  # the slot at S
    assert not np.array_equal(_np(got[0])[layer, 3], k[layer, 3])


def test_kv_append_packed_takes_f32_scales_and_int64_positions_as_jax():
    """The packed append as the decode path hands it its rows (``_new_row``:
    int32 bytes, f32 scales) with int64 positions, as the engine's are: its
    plain version writes what JAX's kernel writes, bit for bit (the f32
    scales rounded to bf16 as JAX rounds them), the words of all four byte
    lanes and a position past S (no write)."""
    L, B, Hkv, S, D = 1, 5, 3, 16, 64
    rng = np.random.default_rng(11)
    k, v, ks, vs = _packed_cache(rng, L, B, Hkv, S, D)
    kq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    vq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    ksn = rng.uniform(0.001, 0.05, (B, Hkv)).astype(np.float32)
    vsn = rng.uniform(0.001, 0.05, (B, Hkv)).astype(np.float32)
    pos = np.asarray([3, 6, 9, 12, S], np.int64)
    want = jappend_packed(*map(jnp.asarray, (k, v, ks, vs, kq, vq, ksn, vsn)),
                          jnp.asarray(pos.astype(np.int32)), jnp.int32(0), interpret=True)
    got = [_t(a) for a in (k, v, ks, vs)]
    new = [_t(a) for a in (kq, vq, ksn, vsn, pos)]
    assert new[2].dtype == torch.float32 and new[4].dtype == torch.int64
    kv_append_packed_reference(*got, *new, 0)
    for g, w in zip(got, want):
        _same_bits(g, w)


def test_kv_append_packed_reference_guards():
    """Positions outside [0, S) write nothing, negative ones included."""
    rng = np.random.default_rng(5)
    k, v, ks, vs = (_t(a) for a in _packed_cache(rng, 1, 3, 1, 8, 128))
    before = [t.clone() for t in (k, v, ks, vs)]
    new = torch.full((3, 1, 128), 200, dtype=torch.int32)
    sc = torch.ones(3, 1)
    kv_append_packed_reference(k, v, ks, vs, new, new, sc, sc, torch.tensor([-1, 8, 100]), 0)
    for t, b in zip((k, v, ks, vs), before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("qdtype,tol", [(BF16, 2e-2), (np.float32, 1e-4)])
@pytest.mark.parametrize(
    "L,B,H,Hkv,S,positions,window,append",
    [
        (2, 3, 8, 2, 64, [0, 63, 64], None, True),  # GQA, len 1 / len == S / pos >= S
        (1, 4, 4, 4, 128, [20, 100, 5, 127], 16, True),  # MHA, window
        (2, 2, 4, 1, 96, [40, 95], 200, False),  # window >= S is dropped; no append
        (1, 3, 4, 2, 64, [17, 2, 33], None, False),  # ragged, stacked with one layer
    ],
)
def test_decode_attention_int8_matches_jax(L, B, H, Hkv, S, positions, window, append,
                                           qdtype, tol):
    D = 128
    rng = np.random.default_rng(S + B)
    q = rng.standard_normal((B, H, D), dtype=np.float32).astype(qdtype)
    k, v, ks, vs = _packed_cache(rng, L, B, Hkv, S, D)
    ks, vs = (ks.astype(np.float32) * 0.5).astype(BF16), vs
    kq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    vq = rng.integers(1, 256, (B, Hkv, D)).astype(np.int32)
    ksn = rng.uniform(0.001, 0.01, (B, Hkv)).astype(np.float32)
    vsn = rng.uniform(0.005, 0.02, (B, Hkv)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    lens = np.minimum(pos + 1, S).astype(np.int32)
    li = L - 1
    jkw = dict(layer_idx=jnp.int32(li), window=window, k_scale=jnp.asarray(ks),
               v_scale=jnp.asarray(vs))
    tkw = dict(layer_idx=li, window=window)
    cache = [_t(a) for a in (k, v, ks, vs)]
    if append:
        jout, *jcache = jdecode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            kv_new=tuple(map(jnp.asarray, (kq, vq, ksn, vsn, pos))), **jkw)
        out, *rcache = decode_attention(
            _t(q), cache[0], cache[1], _t(lens), k_scale=cache[2], v_scale=cache[3],
            kv_new=tuple(map(_t, (kq, vq, ksn, vsn, pos))), **tkw)
        for r, c, j in zip(rcache, cache, jcache):
            assert r is c  # in place
            _same_bits(c, j)
    else:
        jout = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), **jkw)
        out = decode_attention(_t(q), cache[0], cache[1], _t(lens), k_scale=cache[2],
                               v_scale=cache[3], **tkw)
    assert out.dtype == _t(q).dtype
    np.testing.assert_allclose(
        _np(out).astype(np.float32), np.asarray(jout).astype(np.float32), atol=tol)


def test_decode_attention_int8_flat_cache_and_guards():
    """A flat [B, Hkv, S/4, D] cache (no layer index); the same tensors read as
    a pool of B pages of S positions behind a table give the same output."""
    B, H, Hkv, S, D = 2, 4, 2, 64, 128
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k, v, ks, vs = (a[0] for a in _packed_cache(rng, 1, B, Hkv, S, D))
    lens = np.asarray([33, 64], np.int32)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = decode_attention(_t(q), _t(k), _t(v), _t(lens), k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    table = torch.tensor([[0], [1]], dtype=torch.int32)
    paged = decode_attention(_t(q), _t(k), _t(v), _t(lens), k_scale=_t(ks), v_scale=_t(vs),
                             page_table=table)
    assert torch.equal(paged, got)
    swapped = decode_attention(_t(q), _t(k), _t(v), _t(lens), k_scale=_t(ks), v_scale=_t(vs),
                               page_table=table.flip(0))
    assert not torch.equal(swapped, got)
    with pytest.raises(ValueError):
        decode_attention(_t(q), _t(k), _t(v), _t(lens), k_scale=_t(ks))
