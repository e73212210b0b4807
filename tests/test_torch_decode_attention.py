"""The port's decode attention (with the fused append) and KV append against
the JAX package's (Pallas in interpret mode), on the same numpy inputs.

Appended cache rows must match exactly; attention outputs (bf16) within abs
2e-2.  Covers GQA, ragged lengths including len == S, positions >= S as a
no-op, and the sliding window."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xbitops_tpu.kernels.decode_attention import decode_attention as jdecode
from xbitops_tpu.kernels.kv_append import kv_append_dense as jappend
from xbitops_tpu_torch.kernels.decode_attention import decode_attention
from xbitops_tpu_torch.kernels.kv_append import kv_append_dense
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16


def _bf16(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32).astype(BF16)


def _t(a):
    """numpy (bf16 or int) -> torch, keeping the bits."""
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.view(torch.int16).numpy().view(BF16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize(
    "L,B,H,Hkv,S,positions,window",
    [
        (2, 3, 8, 2, 64, [0, 63, 64], None),  # GQA, len 1 / len == S / pos >= S
        (1, 4, 4, 4, 128, [20, 100, 5, 127], 16),  # MHA, window
        (2, 2, 4, 1, 96, [40, 95], 200),  # window >= S is dropped
    ],
)
def test_decode_attention_append_matches_jax(L, B, H, Hkv, S, positions, window):
    D = 128
    rng = np.random.default_rng(S + B)
    q = _bf16(rng, (B, H, D))
    k = _bf16(rng, (L, B, Hkv, S, D))
    v = _bf16(rng, (L, B, Hkv, S, D))
    kn = _bf16(rng, (B, Hkv, D))
    vn = _bf16(rng, (B, Hkv, D))
    pos = np.asarray(positions, np.int32)
    lens = np.minimum(pos + 1, S).astype(np.int32)
    li = L - 1
    jout, jk, jv = jdecode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        layer_idx=jnp.int32(li), window=window,
        kv_new=(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos)),
    )
    tk, tv = _t(k), _t(v)
    out, rk, rv = decode_attention(
        _t(q), tk, tv, _t(lens), layer_idx=li, window=window,
        kv_new=(_t(kn), _t(vn), _t(pos)),
    )
    assert rk is tk and rv is tv  # in place
    np.testing.assert_array_equal(_np(tk).view(np.int16), np.asarray(jk).view(np.int16))
    np.testing.assert_array_equal(_np(tv).view(np.int16), np.asarray(jv).view(np.int16))
    np.testing.assert_allclose(
        _np(out).astype(np.float32), np.asarray(jout).astype(np.float32), atol=2e-2)


def test_decode_attention_flat_cache_matches_jax():
    """A flat [B, Hkv, S, D] cache (no layer index), without append."""
    B, H, Hkv, S, D = 2, 4, 2, 64, 128
    rng = np.random.default_rng(7)
    q, k, v = _bf16(rng, (B, H, D)), _bf16(rng, (B, Hkv, S, D)), _bf16(rng, (B, Hkv, S, D))
    lens = np.asarray([33, 64], np.int32)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    got = decode_attention(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(
        _np(got).astype(np.float32), np.asarray(want).astype(np.float32), atol=2e-2)


def test_kv_append_matches_jax_exactly():
    L, B, Hkv, S, D = 2, 4, 2, 32, 128
    rng = np.random.default_rng(3)
    k, v = _bf16(rng, (L, B, Hkv, S, D)), _bf16(rng, (L, B, Hkv, S, D))
    kn, vn = _bf16(rng, (B, Hkv, D)), _bf16(rng, (B, Hkv, D))
    pos = np.asarray([0, 31, 32, 17], np.int32)  # 32 >= S: no-op
    jk, jv = jappend(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                     jnp.asarray(pos), jnp.int32(1))
    tk, tv = _t(k), _t(v)
    kv_append_dense(tk, tv, _t(kn), _t(vn), _t(pos), 1)
    np.testing.assert_array_equal(_np(tk).view(np.int16), np.asarray(jk).view(np.int16))
    np.testing.assert_array_equal(_np(tv).view(np.int16), np.asarray(jv).view(np.int16))
    assert not np.array_equal(_np(tk).view(np.int16), k.view(np.int16))


def test_kv_append_slot_guard():
    """A prefill row aimed at a slot outside [0, B) writes nothing (a negative
    slot must not land in slot 0), and a row at a position >= S writes
    nothing."""
    L, B, Hkv, S, D = 1, 2, 1, 16, 128
    cache = llama.KVCache.init(dataclasses.replace(llama.LlamaConfig.tiny(), num_layers=L,
                                                   num_kv_heads=Hkv, max_seq_len=S), B, "cpu")
    new = torch.ones(3, 2, Hkv, D, dtype=torch.bfloat16)
    positions = torch.tensor([[3, 4], [4, 5], [5, S]])
    llama._write_rows(cache, 0, new, new, positions, torch.tensor([-1, 2, 1]))
    for t in (cache.k, cache.v):
        assert t[0, 0].abs().sum() == 0
        assert t[0, 1, :, 5].eq(1).all() and t[0, 1].abs().sum() == D
