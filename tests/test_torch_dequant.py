"""The port's ``dequant`` op against the JAX package's (Pallas kernel in
interpret mode), on the same numpy inputs, mirroring ``tests/test_dequant_op.py``.

On the CPU the port runs its kernel's plain version, whose f32 arithmetic
(``wq*s`` then ``-sz``, one rounding to the output type) is the JAX op's: f32,
bf16 and fp16 outputs are compared EXACTLY.  Against the C++ fp16 oracle and
the interchange-layout oracle the gate is the reference library's: abs 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from xbitops_tpu import formats as jformats
from xbitops_tpu.ops.dequant import dequant_qtensor as jdequant_qtensor
from xbitops_tpu.utils import cpp_oracle
import xbitops_tpu_torch as xt
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io.convert import qtensor_from_numpy
from xbitops_tpu_torch.kernels import common

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

BITS = [1, 2, 3, 4, 5, 6, 7, 8]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _pair(bits, K=256, N=256, g=64, seed=0, **kw):
    w = np.random.default_rng(seed).standard_normal((K, N), dtype=np.float32) * 0.1
    jqt = xb.quantize_array(jnp.asarray(w), bits, g, **kw)
    return jqt, qtensor_from_numpy(jax.tree.map(np.asarray, jqt), "cpu")


@pytest.fixture(scope="module")
def pairs():
    return {bits: _pair(bits, seed=bits) for bits in BITS}


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_dequant_qtensor_matches_jax_exactly(pairs, bits):
    jqt, qt = pairs[bits]
    want = _f32(jdequant_qtensor(jqt, out_dtype=jnp.float32))
    common.reset_counts()
    got = xt.dequant_qtensor(qt, out_dtype=torch.float32)
    assert not any(common.launches.values()) and not any(common.plain_on_cuda.values())
    np.testing.assert_array_equal(got.numpy(), want)
    plain = xt.dequant_qtensor(qt, out_dtype=torch.float32, use_kernel=False)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("bits", BITS)
def test_dequant_matches_cpp_fp16_oracle(bits):
    K, N, g = 256, 128, 64
    w = np.random.default_rng(bits).standard_normal((K, N), dtype=np.float32) * 0.05
    wq, scales, zeros = formats.quantize(w, bits, g)
    s16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, s16, zeros, bits)
    got = xt.dequant(torch.from_numpy(qweight), torch.from_numpy(s16), torch.from_numpy(qzeros),
                     g, bits, K)
    assert got.dtype == torch.float16 and got.shape == (K, N)  # default: the scales' dtype
    want = cpp_oracle.dequant_f16(qweight, s16, qzeros, bits, g, K)
    assert np.abs(got.float().numpy() - want.astype(np.float32)).max() <= 1e-3


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
def test_low_precision_outputs_match_jax_exactly(pairs, out_dtype):
    jqt, qt = pairs[4]
    want = _f32(jdequant_qtensor(jqt, out_dtype=JDT[out_dtype]))
    got = xt.dequant_qtensor(qt, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_group_larger_than_tile():
    jqt, qt = _pair(4, K=512, N=128, g=256, seed=1, tile_k=64)
    assert qt.groups_per_tile == 1 and qt.group_size > qt.tile_k
    want = _f32(jdequant_qtensor(jqt, out_dtype=jnp.float32))
    np.testing.assert_array_equal(xt.dequant_qtensor(qt, torch.float32).numpy(), want)


@pytest.mark.parametrize("bits", [2, 4, 5])
def test_public_dequant_from_gptq(bits):
    """GPTQ arrays in, dense weight out: equal to the JAX op, and within abs
    1e-3 of both packages' interchange-layout oracles."""
    K, N, g = 256, 128, 64
    w = np.random.default_rng(bits).standard_normal((K, N), dtype=np.float32) * 0.05
    wq, scales, zeros = formats.quantize(w, bits, g)
    for a, b in zip((wq, scales, zeros), jformats.quantize(w, bits, g)):
        np.testing.assert_array_equal(a, b)
    s16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    jq = jformats.gptq_pack(wq, scales, zeros, bits)
    np.testing.assert_array_equal(qweight, jq[0])
    np.testing.assert_array_equal(qzeros, jq[2])
    targs = (torch.from_numpy(qweight), torch.from_numpy(s16), torch.from_numpy(qzeros))
    jargs = (jnp.asarray(qweight), jnp.asarray(s16), jnp.asarray(qzeros))
    got = xt.dequant(*targs, g, bits, K, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, _f32(xb.dequant(*jargs, g, bits, K, out_dtype=jnp.float32)))
    ref = formats.dequant_reference(*targs, g, bits, K, out_dtype=torch.float32).numpy()
    jref = _f32(jformats.dequant_reference(*jargs, g, bits, K, out_dtype=jnp.float32))
    np.testing.assert_array_equal(ref, jref)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        formats.gptq_unpack_weight(targs[0], bits, K).numpy(), wq.astype(np.int32))
    np.testing.assert_array_equal(
        formats.gptq_unpack_zeros(targs[2], bits, N).numpy(), zeros.astype(np.int32))


def test_public_dequant_add_zero_bias():
    K, N, g, bits = 128, 128, 32, 4
    rng = np.random.default_rng(9)
    wq = rng.integers(0, 16, (K, N)).astype(np.uint8)
    zeros = rng.integers(0, 15, (K // g, N)).astype(np.uint8)
    scales = (rng.random((K // g, N), dtype=np.float32) + 0.5).astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    got = xt.dequant(torch.from_numpy(qweight), torch.from_numpy(scales),
                     torch.from_numpy(qzeros), g, bits, K, add_zero_bias=1,
                     out_dtype=torch.float32).numpy()
    want = _f32(xb.dequant(jnp.asarray(qweight), jnp.asarray(scales), jnp.asarray(qzeros),
                           g, bits, K, add_zero_bias=1, out_dtype=jnp.float32))
    np.testing.assert_array_equal(got, want)
    gid = np.arange(K) // g
    sz = (scales * (zeros + 1).astype(np.float16)).astype(np.float16)
    expect = wq.astype(np.float32) * scales[gid].astype(np.float32) - sz[gid].astype(np.float32)
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=0)


def test_public_dequant_act_order_g_idx():
    """``g_idx``: rows sort into contiguous groups (a stable sort), the order
    is kept as ``perm`` and dequant scatters the rows back."""
    K, N, g, bits = 128, 128, 32, 4
    rng = np.random.default_rng(11)
    w = rng.standard_normal((K, N), dtype=np.float32)
    perm = rng.permutation(K)
    wq_s, scales, zeros = formats.quantize(w[perm], bits, g)
    g_idx = np.empty(K, np.int32)
    g_idx[perm] = np.arange(K) // g
    wq = np.empty_like(wq_s)
    wq[perm] = wq_s
    s16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    targs = (torch.from_numpy(qweight), torch.from_numpy(s16), torch.from_numpy(qzeros))
    jargs = (jnp.asarray(qweight), jnp.asarray(s16), jnp.asarray(qzeros))
    jqt = jformats.from_gptq(*jargs, bits, g, K, g_idx=jnp.asarray(g_idx))
    qt = formats.from_gptq(*targs, bits, g, K, g_idx=torch.from_numpy(g_idx))
    np.testing.assert_array_equal(qt.perm.numpy(), np.asarray(jqt.perm))
    got = xt.dequant(*targs, g, bits, K, g_idx=torch.from_numpy(g_idx), out_dtype=torch.float32)
    want = _f32(xb.dequant(*jargs, g, bits, K, g_idx=jnp.asarray(g_idx), out_dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = formats.dequant_reference(*targs, g, bits, K, g_idx=torch.from_numpy(g_idx),
                                    out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-3, rtol=0)
    assert np.abs(got.numpy() - w).max() <= 0.51 * scales.max()


def test_validation_errors():
    q = torch.zeros((32, 128), dtype=torch.int32)
    s = torch.ones((4, 128), dtype=torch.float16)
    z = torch.zeros((4, 16), dtype=torch.int32)
    assert xt.dequant(q, s, z, 64, 4, 256).shape == (256, 128)
    for args, msg in (((q, s, z, 8, 4, 256), "group_size must be >= 16"),
                      ((q, s, z, 64, 9, 256), "bits must be in"),
                      ((q, s, z, 64, 4, 512), "qweight rows"),
                      ((q, s[:3], z, 64, 4, 256), "scales rows"),
                      ((q, s, z[:, :8], 64, 4, 256), "qzeros shape")):
        with pytest.raises(ValueError, match=msg):
            xt.dequant(*args)
