"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (nvcc builds the kernels at first use) and skip
without one.  They import neither JAX nor the JAX package, so they run where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: fused matmul rel 1e-5 / abs 3e-4 with f32 activations and rel 2e-2
(of the output's largest value) with bf16 ones; appended cache rows exact;
attention outputs abs 2e-2 in bf16.
"""

import dataclasses

import pytest
import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from xbitops_tpu_torch.kernels.kv_append import kv_append_dense, kv_append_dense_reference
from xbitops_tpu_torch.ops.qmatmul import qmatmul
from xbitops_tpu_torch.utils import synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# (bits, group_size, K, tile_k): paired and slot layouts, one or several groups
# per tile, groups longer than a tile, K padded to the tile.
QCASES = [(b, 128, 512, None) for b in range(1, 9)] + [
    (4, 40, 640, None), (5, 40, 1280, None), (4, 64, 200, None),
    (3, 512, 1024, 256), (8, 32, 96, 32),
]


@pytest.mark.parametrize("bits,g,K,tile_k", QCASES)
@pytest.mark.parametrize("M", [1, 8, 9, 40])
def test_qmatmul_kernel_matches_plain(dev, bits, g, K, tile_k, M):
    gen = _gen(dev, bits * 100 + M)
    qt = synth.random_qtensor(gen, K, 160, bits, g, tile_k=tile_k)
    a = torch.randn(M, K, device=dev, generator=gen)
    ref = qmatmul(a, qt, use_kernel=False)
    got = qmatmul(a, qt, precise=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)
    a16 = a.to(torch.bfloat16)
    ref = qmatmul(a16, qt, out_dtype=torch.float32, use_kernel=False)
    got = qmatmul(a16, qt)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_qmatmul_kernel_f32_scales_perm_n_logical_layer(dev):
    gen = _gen(dev, 7)
    qts = [synth.random_qtensor(gen, 300, 256, 4, 128) for _ in range(2)]
    st = dataclasses.replace(
        qts[0],
        planes=tuple(torch.stack(p) for p in zip(*(q.planes for q in qts))),
        scales=torch.stack([q.scales.float() for q in qts]),
        scale_zeros=torch.stack([q.scale_zeros.float() for q in qts]),
        perm=torch.stack([torch.randperm(300, device=dev, generator=gen) for _ in qts]),
        N_logical=250,
    )
    a = torch.randn(3, 5, 300, device=dev, generator=gen)
    for li in (0, 1):
        ref = qmatmul(a, st, layer=li, use_kernel=False)
        got = qmatmul(a, st, layer=li, precise=True)
        assert got.shape == (3, 5, 250)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("D,H,Hkv,S", [(128, 8, 8, 600), (128, 32, 4, 257), (64, 8, 1, 255),
                                       (256, 4, 2, 1000)])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_kernel_matches_plain(dev, D, H, Hkv, S, window):
    gen = _gen(dev, D + S)
    B, L = 5, 2
    k = torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    kn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    vn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    pos = torch.tensor([0, S - 1, S, 255 % S, S // 2], device=dev)  # S: inactive
    lens = torch.clamp(pos + 1, max=S)
    k2, v2 = k.clone(), v.clone()
    out, rk, rv = decode_attention(q, k, v, lens, layer_idx=1, kv_new=(kn, vn, pos),
                                   window=window)
    assert rk is k and rv is v
    kv_append_dense_reference(k2, v2, kn, vn, pos, 1)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    ref = decode_attention_reference(q, k2[1], v2[1], lens, window)
    assert (out.float() - ref.float()).abs().max() <= 2e-2
    zero = decode_attention(q, k[0], v[0], torch.zeros(B, dtype=torch.int32, device=dev))
    assert zero.abs().max() == 0  # a slot with no live rows attends nothing


def test_kv_append_kernel_guards(dev):
    k = torch.zeros(2, 4, 2, 16, 128, dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    new = torch.randn(4, 2, 128, device=dev).to(torch.bfloat16)
    pos = torch.tensor([3, -1, 16, 40], device=dev)  # rows 1-3 out of [0, S)
    k2, v2 = k.clone(), v.clone()
    kv_append_dense(k, v, new, new, pos, 1)
    kv_append_dense_reference(k2, v2, new, new, pos, 1)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert torch.equal(k[1, 0, :, 3], new[0])  # the only row in bounds
    k[1, 0, :, 3] = 0
    assert k.abs().max() == 0


def test_wrappers_count_and_reject(dev):
    common.reset_counts()
    q = torch.zeros(1, 4, 96, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 1, 4, 8, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # head_dim 96 is not built
        decode_attention(q, k, k, torch.ones(1, device=dev), layer_idx=0)
    with pytest.raises(ValueError):  # the kernel cache is bf16
        kv_append_dense(k.half(), k.half(), k[0, 0, :, 0].half()[None], k[0, 0, :, 0].half()[None],
                        torch.zeros(1, device=dev), 0)
    qt = synth.random_qtensor(_gen(dev, 0), 256, 128, 4, 128)
    qmatmul(torch.ones(2, 256, device=dev), qt)
    assert common.launches["qgemv"] == 1 and common.plain_on_cuda["qgemv"] == 0
    qmatmul(torch.ones(2, 256, device=dev), qt, use_kernel=False)
    assert common.launches["qgemv"] == 1 and common.plain_on_cuda["qgemv"] == 1
