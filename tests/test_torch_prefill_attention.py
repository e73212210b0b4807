"""The port's chunked-prefill attention (its plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode, on the same numpy
inputs: bf16 and packed int8 caches, stacked and flat, GQA, a sliding window,
ragged chunk starts, a prompt that ends mid-chunk and an inert row (slot out
of range, all positions padding).  Outputs agree within abs 2e-2 on bf16
inputs and 1e-4 on f32 ones (the frameworks sum in different orders, and JAX
rounds probabilities to bf16 on the dense bf16 path).

The port returns exact zeros for every padding query.  The JAX kernel zeroes
only a q-tile that holds nothing but padding, so the two are compared on the
live queries and the port's padding rows are checked to be zero."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xbitops_tpu.kernels.prefill_attention import prefill_attention as jprefill_attention
from xbitops_tpu_torch.kernels.prefill_attention import (
    prefill_attention,
    prefill_attention_reference,
)
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
N, H, HKV, D, S, B = 3, 4, 2, 128, 256, 4


def _t(a):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(t):
    return t.float().numpy()


def _case(T, dtype, int8, stacked, seed=0):
    """q, the cache (k, v[, ks, vs]) of L = 2 layers or flat, positions, slots.
    Row 0 starts at 0 and ends mid-chunk, row 1 starts later and fills its
    chunk, row 2 is inert."""
    rng = np.random.default_rng(seed + T)
    q = rng.standard_normal((N, T, H, D), dtype=np.float32).astype(dtype)
    lead = (2,) if stacked else ()
    if int8:
        k = rng.integers(-2**31, 2**31, lead + (B, HKV, S // 4, D)).astype(np.int32)
        v = rng.integers(-2**31, 2**31, lead + (B, HKV, S // 4, D)).astype(np.int32)
        ks = rng.uniform(0.002, 0.01, lead + (B, 4, HKV, S // 4)).astype(BF16)
        vs = rng.uniform(0.005, 0.02, lead + (B, 4, HKV, S // 4)).astype(BF16)
        cache = (k, v, ks, vs)
    else:
        cache = tuple(rng.standard_normal(lead + (B, HKV, S, D), dtype=np.float32).astype(dtype)
                      for _ in range(2))
    starts, lens = [0, S - T, 0], [T - 5, S, 0]
    pos = np.asarray(starts)[:, None] + np.arange(T)[None]
    pos = np.where(pos < np.asarray(lens)[:, None], pos, S).astype(np.int32)
    slots = np.asarray([2, 0, B], np.int32)  # B: out of range
    return q, cache, pos, slots


@pytest.mark.parametrize("T", [16, 128])
@pytest.mark.parametrize("dtype,tol", [(BF16, 2e-2), (np.float32, 1e-4)])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16cache", "int8cache"])
@pytest.mark.parametrize("stacked,window", [(True, None), (False, None), (True, 40)])
def test_prefill_attention_matches_jax(T, dtype, tol, int8, stacked, window):
    q, cache, pos, slots = _case(T, dtype, int8, stacked)
    kw = dict(window=window)
    jkw = dict(kw, interpret=True)
    if stacked:
        kw["layer_idx"], jkw["layer_idx"] = 1, jnp.int32(1)
    if int8:
        jkw.update(k_scale=jnp.asarray(cache[2]), v_scale=jnp.asarray(cache[3]))
        kw.update(k_scale=_t(cache[2]), v_scale=_t(cache[3]))
    want = np.asarray(jprefill_attention(
        jnp.asarray(q), jnp.asarray(cache[0]), jnp.asarray(cache[1]), jnp.asarray(pos),
        jnp.asarray(slots), **jkw)).astype(np.float32)
    got = prefill_attention(_t(q), _t(cache[0]), _t(cache[1]), _t(pos), _t(slots), **kw)
    assert got.shape == q.shape and got.dtype == _t(q).dtype
    live = pos < S
    np.testing.assert_allclose(_f32(got)[live], want[live], atol=tol)
    assert np.abs(_f32(got)[live]).max() > 0.01
    assert (_f32(got)[~live] == 0).all()  # padding queries, mid-chunk ones too
    assert (~live[0]).any() and live[0].any() and not live[2].any()


def test_reference_is_causal_per_query_and_reads_the_slot():
    """Query t of a row sees exactly positions <= its own in its own slot."""
    T = 16  # row 0 holds 11 live queries
    q, (k, v), pos, slots = _case(T, np.float32, False, False, seed=3)
    k, v = _t(k), _t(v)
    base = prefill_attention_reference(_t(q), k, v, _t(pos), _t(slots))
    k2, v2 = k.clone(), v.clone()
    k2[2, :, 6:], v2[2, :, 6:] = 7.0, -7.0  # slot 2 (row 0) past position 5
    k2[1], v2[1] = 5.0, 5.0  # a slot no row names
    out = prefill_attention_reference(_t(q), k2, v2, _t(pos), _t(slots))
    assert torch.equal(out[0, :6], base[0, :6]) and torch.equal(out[1], base[1])
    assert not torch.equal(out[0, 6], base[0, 6])


def test_matches_eager_attention_over_dequantized_rows():
    """The int8 plain version equals the model's eager attention over the
    dequantized rows of the slots."""
    T = 16
    q, (k, v, ks, vs), pos, slots = _case(T, np.float32, True, False, seed=5)
    got = prefill_attention_reference(_t(q), _t(k), _t(v), _t(pos), _t(slots), _t(ks), _t(vs))
    rows = _t(slots).long().clamp(0, B - 1)
    kc = llama._unpack_kv_words(_t(k)[rows], _t(ks)[rows])
    vc = llama._unpack_kv_words(_t(v)[rows], _t(vs)[rows])
    mask = torch.arange(S)[None, None, :] <= _t(pos).long()[:, :, None]
    want = llama._attention(_t(q), kc, vc, mask, D ** -0.5)
    live = torch.from_numpy(pos < S)
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=1e-5)


def test_guards():
    q, (k, v), pos, slots = _case(16, np.float32, False, False)
    with pytest.raises(ValueError):
        prefill_attention(_t(q), _t(k), _t(v), _t(pos), _t(slots), window=0)
    with pytest.raises(ValueError):
        prefill_attention(_t(q), _t(k), _t(v), _t(pos), _t(slots), k_scale=torch.zeros(1))
