"""Fused dequantize + matmul ``a[M, K] @ dequant(qt)[K, N]``: the CUDA kernel
(``csrc/qgemv.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``xbitops_tpu/kernels/qgemv_kernel.py:_kernel``
(bf16 and precise forms).  The source note in ``csrc/qgemv.cu`` says what
bounds it on the card and how the design answers.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from xbitops_tpu_torch.formats import QTensor, dequant_qtensor_reference
from xbitops_tpu_torch.kernels import common


def qmatmul_kernel_reference(
    a: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16, precise: bool = False
) -> torch.Tensor:
    """Plain version of :func:`qmatmul_kernel`: the kernel's arithmetic
    (activations rounded to bf16 unless ``precise``, f32 sums) over the
    dense dequantized weight."""
    common.count_plain("qgemv", a)
    a = a.to(torch.float32 if precise else torch.bfloat16).float()
    w = dequant_qtensor_reference(_padded_view(qt), out_dtype=torch.float32)
    return (a @ w).to(out_dtype)


def _padded_view(qt: QTensor) -> QTensor:
    """The same weight seen with all ``K`` packed rows and ``N`` columns
    (no logical slicing, no permutation): the kernel's own view."""
    return dataclasses.replace(qt, K_logical=qt.K, N_logical=None, perm=None)


CHUNK = 256  # K rows a block stages at a time (csrc/qgemv.cu kChunk)
# Split-K target in blocks per SM.  Sweep of 1/2/4/8 at the five 7B shapes,
# M=8 (H100 80GB HBM3, 700 W): 4 and 8 tie and beat 2 by ~11% summed over a
# decode step's matmuls; 4 makes fewer partial sums.  PERF.md has the table.
BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _k_splits(M: int, K: int, N: int, sms: int):
    """(splits, rows per split): split K until the grid has about
    ``BLOCKS_PER_SM`` blocks per SM; decode shapes have too few otherwise."""
    tm, cols = (8, 128 if N % 4 == 0 else 32) if M <= 8 else (32, 32)
    blocks = -(-N // cols) * -(-M // tm)
    chunks = -(-K // CHUNK)
    want = min(chunks, max(1, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-chunks // want) * CHUNK
    return -(-K // per), per


def qmatmul_kernel(
    a: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16, precise: bool = False
) -> torch.Tensor:
    """``a (M, K) @ dequant(qt) (K, N) -> (M, N)`` without materialising the weight.

    ``a`` must already be padded to ``qt.K`` columns and permuted (the public
    op ``ops.qmatmul`` does both).  Activations enter in bf16, or in f32 when
    ``precise``; sums are f32.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if not a.is_cuda:
        return qmatmul_kernel_reference(a, qt, out_dtype, precise)
    req = common.require
    M, K = a.shape
    req(K == qt.K, f"activation K={K} != packed K={qt.K}")
    req(1 <= len(qt.planes) <= 3, "1-3 planes")
    req(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype {out_dtype}")
    req(qt.scales.dtype in (torch.float16, torch.float32), f"scales {qt.scales.dtype}")
    req(qt.scale_zeros.dtype == qt.scales.dtype, "scale_zeros dtype != scales dtype")
    N = qt.N
    for p in qt.planes:
        req(p.is_cuda and p.device == a.device, "planes must be on a's device")
        req(p.dtype == torch.int32 and p.dim() == 2 and p.is_contiguous(),
            "planes must be contiguous int32 [K/(32/pb), N]")
    for s in (qt.scales, qt.scale_zeros):
        req(s.device == a.device and s.is_contiguous() and s.dim() == 3
            and s.shape[0] == qt.K // qt.tile_k and s.shape[2] == N,
            "scales must be contiguous [K/tile_k, gt_pad, N] on a's device")
    req(qt.K % qt.tile_k == 0 and qt.tile_k % 32 == 0, f"tile_k={qt.tile_k}")
    a = a.to(torch.float32 if precise else torch.bfloat16).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0:
        return out
    pb = list(qt.plane_bits) + [0] * (3 - len(qt.planes))
    ptrs = [p.data_ptr() for p in qt.planes] + [None] * (3 - len(qt.planes))
    splits, per = _k_splits(M, K, N, _sm_count(a.device.index))
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    err = common.lib().xb_qgemv(
        a.data_ptr(), int(precise), M, K, N,
        ptrs[0], ptrs[1], ptrs[2], pb[0], pb[1], pb[2], int(qt.paired),
        qt.scales.data_ptr(), qt.scale_zeros.data_ptr(),
        int(qt.scales.dtype == torch.float16),
        qt.tile_k, qt.groups_per_tile, qt.scales.shape[1], splits, per,
        None if part is None else part.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), common.stream_ptr(a),
    )
    common.check(err, "qgemv")
    common.launches["qgemv"] += 1
    return out
