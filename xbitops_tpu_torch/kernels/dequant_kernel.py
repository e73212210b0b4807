"""Dequantize packed planes to a dense ``[K, N]`` matrix: the CUDA kernel
(``csrc/dequant.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``xbitops_tpu/kernels/dequant_kernel.py:_kernel``.
The note at the top of ``csrc/dequant.cu`` says what bounds it on the card and
how the design answers.
"""

from __future__ import annotations

import torch

from xbitops_tpu_torch.formats import QTensor, dequant_qtensor_reference
from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.qgemv_kernel import _padded_view

_OUT_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def dequant_kernel_reference(qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`dequant_kernel`: ``wq * s - sz`` in f32, one
    rounding to ``out_dtype``, all packed rows and columns in stored order."""
    common.count_plain("dequant", qt.planes[0])
    return dequant_qtensor_reference(_padded_view(qt), out_dtype=out_dtype)


def dequant_kernel(qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``(K, N)`` weight of ``qt`` in ``out_dtype`` (bf16, fp16 or f32),
    in padded, stored row order: the public op ``ops.dequant`` cuts the
    padding and undoes an act-order permutation.  Bit-identical to the plain
    version.  CPU planes take the plain version; CUDA planes launch the kernel
    or raise."""
    if not qt.planes[0].is_cuda:
        return dequant_kernel_reference(qt, out_dtype)
    common.require(out_dtype in _OUT_TYPES, f"out_dtype {out_dtype}")
    dev = qt.planes[0].device
    qargs = common.qtensor_args(qt, dev)
    out = torch.empty((qt.K, qt.N), dtype=out_dtype, device=dev)
    err = common.lib().xb_dequant(
        qt.K, qt.N, *qargs, out.data_ptr(), _OUT_TYPES[out_dtype], common.stream_ptr(out))
    common.check(err, "dequant")
    common.launches["dequant"] += 1
    return out
