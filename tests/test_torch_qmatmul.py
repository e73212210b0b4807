"""The port's ``qmatmul`` against the JAX package's (Pallas kernel in interpret
mode, and ``use_kernel=False``), on the same numpy inputs.

Tolerances are the reference's: precise (f32 activations) rel 1e-5 / abs 3e-4;
bf16 activations rel 2e-2 (both sides round activations to bf16 and sum in
f32; the JAX kernel also folds a +128 bias into its zero term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from xbitops_tpu_torch.io.convert import qtensor_from_numpy
from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.qgemv_kernel import qmatmul_kernel
from xbitops_tpu_torch.ops.qmatmul import qmatmul

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

PRECISE = dict(rtol=1e-5, atol=3e-4)


def _bf16_close(got, want):
    # rel 2e-2 of the output's scale, per element
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def _pair(K, N, bits, g, seed, **kw):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    jqt = xb.quantize_array(jnp.asarray(w), bits, g, **kw)
    return jqt, qtensor_from_numpy(jax.tree.map(np.asarray, jqt), "cpu")


@pytest.fixture(scope="module")
def weights():
    return {bits: _pair(512, 256, bits, 128, seed=bits) for bits in range(1, 9)}


# every width: one plane (1, 2, 4, 8 bits), two (3, 5, 6) and three (7);
# widths 1, 2, 5, 6 and 7 at the decode batch of 8 rows
@pytest.mark.parametrize("M,bits", [(m, b) for m in (1, 8, 33) for b in (3, 4, 8)]
                         + [(8, b) for b in (1, 2, 5, 6, 7)])
def test_qmatmul_matches_jax(weights, bits, M):
    jqt, qt = weights[bits]
    a = np.random.default_rng(M).standard_normal((M, 512), dtype=np.float32)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    want = np.asarray(xb.qmatmul(ja, jqt, out_dtype=jnp.float32, precise=True))
    got = qmatmul(ta, qt, out_dtype=torch.float32, precise=True).numpy()
    np.testing.assert_allclose(got, want, **PRECISE)
    want = np.asarray(xb.qmatmul(ja, jqt, out_dtype=jnp.float32))
    got = qmatmul(ta, qt, out_dtype=torch.float32).numpy()
    _bf16_close(got, want)
    want = np.asarray(xb.qmatmul(ja, jqt, out_dtype=jnp.float32, use_kernel=False))
    got = qmatmul(ta, qt, out_dtype=torch.float32, use_kernel=False).numpy()
    np.testing.assert_allclose(got, want, **PRECISE)


def test_qmatmul_act_order_padded_k_and_n():
    """Act-order perm gather, K padded to the tile (200 -> 256) and the
    N_logical cut (200 of 256 columns); leading dims fold into M."""
    jqt, qt = _pair(200, 200, 4, 128, seed=3, act_order=True)
    assert jqt.perm is not None and jqt.K != jqt.K_logical and jqt.N_logical == 200
    a = np.random.default_rng(0).standard_normal((2, 3, 200), dtype=np.float32)
    want = np.asarray(xb.qmatmul(jnp.asarray(a), jqt, out_dtype=jnp.float32, precise=True))
    got = qmatmul(torch.from_numpy(a), qt, out_dtype=torch.float32, precise=True).numpy()
    assert got.shape == (2, 3, 200)
    np.testing.assert_allclose(got, want, **PRECISE)


def test_qmatmul_stacked_layer():
    """``layer=`` reads one layer of a stacked QTensor."""
    q0, _ = _pair(256, 128, 4, 128, seed=10)
    q1, _ = _pair(256, 128, 4, 128, seed=11)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), q0, q1)
    st = qtensor_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    a = np.random.default_rng(1).standard_normal((8, 256), dtype=np.float32)
    want = np.asarray(xb.qmatmul(jnp.asarray(a), jst, out_dtype=jnp.float32,
                                 precise=True, layer=jnp.int32(1)))
    got = qmatmul(torch.from_numpy(a), st, out_dtype=torch.float32, precise=True, layer=1)
    np.testing.assert_allclose(got.numpy(), want, **PRECISE)


def test_qmatmul_cpu_takes_plain_path_and_rejects_a8(weights):
    _, qt = weights[4]
    common.reset_counts()
    out = qmatmul(torch.ones(2, 512, dtype=torch.bfloat16), qt)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 256)
    assert common.launches["qgemv"] == 0 and common.plain_on_cuda["qgemv"] == 0
    # a8 on the CPU takes the plain version too; the kernel entry rejects a8
    # activations that the op has not quantized to int8
    out = qmatmul(torch.ones(2, 512), qt, a8=True)
    assert out.dtype == torch.float32 and out.shape == (2, 256)
    assert not any(common.launches.values()) and not any(common.plain_on_cuda.values())
    with pytest.raises(ValueError):
        qmatmul_kernel(torch.ones(2, 512), qt, out_dtype=torch.float32, a8=True)
