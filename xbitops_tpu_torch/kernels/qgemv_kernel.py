"""Fused dequantize + matmul ``a[M, K] @ dequant(qt)[K, N]``: the CUDA kernels
and their plain PyTorch versions.

``csrc/qgemv.cu`` replaces the Pallas kernel
``xbitops_tpu/kernels/qgemv_kernel.py:_kernel`` (bf16 and precise forms);
``csrc/qgemv_a8.cu`` replaces ``_kernel_a8`` and ``_kernel_a8_perchannel``
(int8 activations, integer products).  The note at the top of each source says
what bounds it on the card and how the design answers.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from xbitops_tpu_torch.formats import (
    QTensor,
    dequant_qtensor_reference,
    unpack_planes_reference,
)
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
    a: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16, precise: bool = False,
    a8: bool = False,
) -> torch.Tensor:
    """``a (M, K) @ dequant(qt) (K, N) -> (M, N)`` without materialising the weight.

    ``a`` must already be padded to ``qt.K`` columns and permuted (the public
    op ``ops.qmatmul`` does both).  Activations enter in bf16, or in f32 when
    ``precise``; sums are f32.  With ``a8`` they are int8 (quantized per row
    by the op, which applies their scale to this f32 output) and the products
    are integer: see :func:`qmatmul_kernel_a8`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if a8:
        common.require(not precise, "a8 is integer-exact; `precise` does not apply")
        common.require(out_dtype == torch.float32, "the a8 kernels write f32")
        return qmatmul_kernel_a8(a, qt)
    if not a.is_cuda:
        return qmatmul_kernel_reference(a, qt, out_dtype, precise)
    req = common.require
    M, K = a.shape
    req(K == qt.K, f"activation K={K} != packed K={qt.K}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype {out_dtype}")
    qargs = common.qtensor_args(qt, a.device)
    N = qt.N
    a = a.to(torch.float32 if precise else torch.bfloat16).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0:
        return out
    splits, per = _k_splits(M, K, N, _sm_count(a.device.index))
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    err = common.lib().xb_qgemv(
        a.data_ptr(), int(precise), M, K, N, *qargs, splits, per,
        None if part is None else part.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), common.stream_ptr(a),
    )
    common.check(err, "qgemv")
    common.launches["qgemv"] += 1
    return out


def a8_per_channel(qt: QTensor) -> bool:
    """Whether the a8 matmul of ``qt`` takes the per-channel kernel: one scale
    group spans all packed rows (the JAX package's rule).  A per-channel
    weight whose K had to pad to a tile multiple has ``group_size < K`` and
    takes the grouped kernel."""
    return qt.group_size >= qt.K


def _a8_name(qt: QTensor) -> str:
    return "qgemv_a8_perchannel" if a8_per_channel(qt) else "qgemv_a8"


def qmatmul_kernel_a8_reference(aq: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version of :func:`qmatmul_kernel_a8`, with the kernels' algebra.

    The integer dots run in float64, which holds them exactly (a per-channel
    sum reaches 127 * 255 * K, past float32's 2**24).  Per channel, the
    rescale repeats the kernel's f32 operations one for one; grouped, the
    groups fold in f32 in K order (the kernel may fuse each multiply-add)."""
    common.count_plain(_a8_name(qt), aq)
    wq = unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    M, N = aq.shape[0], qt.N
    if a8_per_channel(qt):
        d = (aq.double() @ wq.double()).to(torch.int64)
        asum = aq.sum(dim=1, keepdim=True, dtype=torch.int64)
        s, sz = qt.scales[0, 0].float(), qt.scale_zeros[0, 0].float()
        return d.float() * s - asum.float() * sz
    g_tile = qt.tile_k // qt.groups_per_tile  # K rows per scale row
    off = 128 if qt.bits == 8 else 0  # width 8 enters the dot minus 128
    acc = torch.zeros((M, N), dtype=torch.float32, device=aq.device)
    for u in range(qt.K // g_tile):
        t, gi = divmod(u, qt.groups_per_tile)
        rows = slice(u * g_tile, (u + 1) * g_tile)
        a_g = aq[:, rows]
        d = a_g.double() @ (wq[rows] - off).double()
        asum = a_g.sum(dim=1, keepdim=True, dtype=torch.int64).float()
        s, sz = qt.scales[t, gi].float(), qt.scale_zeros[t, gi].float()
        acc = acc + d.float() * s - asum * (sz - off * s)
    return acc


def qmatmul_kernel_a8(aq: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``aq int8 (M, K)`` times the integer weight values of ``qt`` with the
    scales applied to the integer dots, f32 ``(M, N)``:
    ``sum_g s_g * (aq_g . wq_g) - (sum aq_g) * sz_g``.  One scale group over
    all of K (:func:`a8_per_channel`) takes the per-channel kernel, which
    keeps one integer sum over K and rescales once."""
    req = common.require
    req(aq.dtype == torch.int8 and aq.dim() == 2, "a8 activations must be int8 [M, K]")
    if not aq.is_cuda:
        return qmatmul_kernel_a8_reference(aq, qt)
    M, K = aq.shape
    req(K == qt.K, f"activation K={K} != packed K={qt.K}")
    req(K < 66000, "int32 sums over K need K < 66000")
    qargs = common.qtensor_args(qt, aq.device)
    aq = aq.contiguous()
    out = torch.empty((M, qt.N), dtype=torch.float32, device=aq.device)
    if M == 0:
        return out
    err = common.lib().xb_qgemv_a8(
        aq.data_ptr(), M, K, qt.N, *qargs, int(a8_per_channel(qt)), out.data_ptr(),
        common.stream_ptr(aq))
    name = _a8_name(qt)
    common.check(err, name)
    common.launches[name] += 1
    return out
