"""The port's int8-activation matmul (``qmatmul(a8=True)``) and ``gemv`` against
the JAX package's (Pallas kernels in interpret mode), on the same numpy inputs,
mirroring ``tests/test_qmatmul_op.py``.

Both sides quantize activations per row to int8 with the same f32 operations
(``aq`` and ``a_scale`` are compared EXACTLY) and multiply integers, so the
grouped form agrees to the f32 folds of its groups (rel 1e-5 / abs 3e-4, the
reference's precise gate) and the per-channel form, whose only f32 operations
are one rescale, to abs 1e-4.  ``gemv`` rounds activations to bf16 on both
sides: rel 1e-2 / abs 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
import xbitops_tpu_torch as xt
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io.convert import qtensor_from_numpy
from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.qgemv_kernel import (
    a8_per_channel,
    qmatmul_kernel,
    qmatmul_kernel_a8_reference,
)
from xbitops_tpu_torch.ops.dense import dense_matmul
from xbitops_tpu_torch.ops.qmatmul import quantize_activations

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

GROUPED = dict(rtol=1e-5, atol=3e-4)
PER_CHANNEL = dict(rtol=1e-5, atol=1e-4)


def _case(M, K, N, bits, g, seed, **kw):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    a = rng.standard_normal((M, K), dtype=np.float32) * 0.5
    jqt = xb.quantize_array(jnp.asarray(w), bits, g, **kw)
    return a, jqt, qtensor_from_numpy(jax.tree.map(np.asarray, jqt), "cpu")


def _both(a, jqt, qt, **kw):
    want = np.asarray(xb.qmatmul(jnp.asarray(a), jqt, out_dtype=jnp.float32, a8=True, **kw))
    tkw = {k: int(v) if k == "layer" else v for k, v in kw.items()}
    got = xt.qmatmul(torch.from_numpy(a), qt, out_dtype=torch.float32, a8=True, **tkw).numpy()
    return got, want


# bits 2/4/8: one plane; 3/7: planes combined into one integer before the dot
@pytest.mark.parametrize("bits", [2, 4, 8, 3, 7])
def test_a8_grouped_matches_jax(bits):
    a, jqt, qt = _case(24, 512, 256, bits, 128, seed=bits)
    assert not a8_per_channel(qt)
    common.reset_counts()
    got, want = _both(a, jqt, qt)
    assert not any(common.launches.values()) and not any(common.plain_on_cuda.values())
    np.testing.assert_allclose(got, want, **GROUPED)
    fake, jfake = _both(a, jqt, qt, use_kernel=False)  # the fake-quant path
    np.testing.assert_allclose(fake, jfake, **GROUPED)
    np.testing.assert_allclose(got, fake, **GROUPED)
    full = xt.qmatmul(torch.from_numpy(a), qt, out_dtype=torch.float32, use_kernel=False).numpy()
    assert np.abs(got - full).max() < 0.03 * np.abs(full).max()  # int8 activation rounding


@pytest.mark.parametrize("bits", [4, 8])
def test_a8_per_channel_matches_jax(bits):
    a, jqt, qt = _case(40, 512, 256, bits, 512, seed=5 + bits)
    assert a8_per_channel(qt) and jqt.group_size >= jqt.K
    got, want = _both(a, jqt, qt)
    np.testing.assert_allclose(got, want, **PER_CHANNEL)
    fake, jfake = _both(a, jqt, qt, use_kernel=False)
    np.testing.assert_allclose(fake, jfake, **PER_CHANNEL)
    np.testing.assert_allclose(got, fake, **PER_CHANNEL)


def test_a8_activation_quantization_is_exact():
    """``aq`` and ``a_scale``: the op's formula in jnp and the port's, bit for
    bit (a true division, round half to even), ties and an all-zero row
    included."""
    a = np.random.default_rng(0).standard_normal((16, 256)).astype(np.float32)
    a[3] = 0.0
    a[4, :8] = np.asarray([127, 63.5, 0.5, 1.5, 2.5, -0.5, -1.5, -63.5], np.float32)
    a[4, 8:] = 0.25
    af = jnp.asarray(a)
    jscale = jnp.maximum(jnp.max(jnp.abs(af), axis=1, keepdims=True), 1e-30) / 127.0
    jq = jnp.round(af / jscale).astype(jnp.int8)
    aq, a_scale = quantize_activations(torch.from_numpy(a))
    assert aq.dtype == torch.int8 and a_scale.shape == (16, 1)
    np.testing.assert_array_equal(a_scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(aq.numpy(), np.asarray(jq))
    assert aq[4, :8].tolist() == [127, 64, 0, 2, 2, 0, -2, -64] and not aq[3].any()


def test_a8_stacked_layer():
    a, q0, _ = _case(32, 256, 128, 4, 128, seed=0)
    _, q1, _ = _case(32, 256, 128, 4, 128, seed=1)
    jst = jax.tree.map(lambda x, y: jnp.stack([x, y]), q0, q1)
    st = qtensor_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    for li in (0, 1):
        got, want = _both(a, jst, st, layer=jnp.int32(li))
        np.testing.assert_allclose(got, want, **GROUPED)


def test_a8_act_order_padded_k_and_n():
    a, jqt, qt = _case(33, 200, 200, 4, 128, seed=3, act_order=True)
    assert qt.perm is not None and qt.K != 200 and qt.N_logical == 200
    got, want = _both(a.reshape(3, 11, 200), jqt, qt)
    assert got.shape == (3, 11, 200)
    np.testing.assert_allclose(got, want, **GROUPED)


@pytest.mark.parametrize("K,per_channel", [(1024, True), (200, False)])
def test_a8_after_requantize(K, per_channel):
    """requantize_a8, then the a8 matmul: per channel when K is a tile
    multiple, the grouped form when K had to pad (the JAX rule)."""
    a, jqt, qt = _case(64, K, 256, 4, 128 if per_channel else 40, seed=23)
    jrq, rq = xb.requantize_a8(jqt), xt.requantize_a8(qt)
    assert a8_per_channel(rq) == per_channel
    got, want = _both(a, jrq, rq)
    np.testing.assert_allclose(got, want, **(PER_CHANNEL if per_channel else GROUPED))
    four, _ = _both(a, jqt, qt)
    assert np.abs(got - four).max() < 0.03 * np.abs(four).max()  # the 8-bit column grid


def test_a8_plain_version_integer_part_is_exact():
    """The plain versions sum the integer products in float64: at K = 2048 a
    per-channel sum passes float32's 2**24 and is still exact."""
    rng = np.random.default_rng(4)
    K, N = 2048, 128
    wq = torch.full((K, N), 255, dtype=torch.int32)
    ones = torch.ones((1, N))
    qt = formats.make_qtensor(wq, ones, torch.zeros((1, N), dtype=torch.int32), 8, K)
    assert a8_per_channel(qt) and qt.scales.dtype == torch.float32
    aq = torch.from_numpy(rng.integers(100, 128, (4, K)).astype(np.int8))
    got = qmatmul_kernel(aq, qt, out_dtype=torch.float32, a8=True)
    want = (aq.long().sum(dim=1, keepdim=True) * 255).float().expand(4, N)
    assert want.min() > 2 ** 24 and torch.equal(got, want)
    assert torch.equal(got, qmatmul_kernel_a8_reference(aq, qt))
    with pytest.raises(ValueError):
        qmatmul_kernel(aq, qt, out_dtype=torch.float32, a8=True, precise=True)
    with pytest.raises(ValueError):
        qmatmul_kernel(aq.float(), qt, out_dtype=torch.float32, a8=True)


def test_gemv_reference_api():
    M, K, N, g, bits = 1, 256, 128, 64, 4
    rng = np.random.default_rng(21)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    a = (rng.standard_normal((M, K), dtype=np.float32) * 0.5).astype(np.float16)
    wq, scales, zeros = formats.quantize(w, bits, g)
    s16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    want = np.asarray(xb.gemv(jnp.asarray(a), jnp.asarray(qweight), jnp.asarray(s16),
                              jnp.asarray(qzeros), g, bits, K, out_dtype=jnp.float32))
    targs = (torch.from_numpy(qweight), torch.from_numpy(s16), torch.from_numpy(qzeros))
    got = xt.gemv(torch.from_numpy(a), *targs, g, bits, K, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    ref_w = formats.dequant_reference(*targs, g, bits, K, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, a.astype(np.float32) @ ref_w, rtol=1e-2, atol=1e-2)
    out = xt.gemv(torch.from_numpy(a), *targs, g, bits, K)  # default: the activations' dtype
    assert out.dtype == torch.float16 and out.shape == (M, N)
    plain = xt.gemv(torch.from_numpy(a), *targs, g, bits, K, out_dtype=torch.float32,
                    use_kernel=False).numpy()
    np.testing.assert_allclose(plain, a.astype(np.float32) @ ref_w, rtol=1e-5, atol=3e-4)


def test_dense_matmul_matches_jax():
    """The a16w16 comparator: bf16 operands, f32 sums, the input's dtype."""
    from xbitops_tpu.ops.dense import dense_matmul as jdense

    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 5, 256), dtype=np.float32)
    w = rng.standard_normal((256, 128), dtype=np.float32) * 0.1
    want = np.asarray(jdense(jnp.asarray(a), jnp.asarray(w)))
    got = dense_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
