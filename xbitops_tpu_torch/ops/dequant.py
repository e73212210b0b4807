"""Public ``dequant`` op: unpack 1-8-bit packed weights to fp16 / bf16 / f32
(port of ``xbitops_tpu/ops/dequant.py``).

``dequant`` takes the GPTQ interchange layout, as the reference library's
``dequant`` does, with its validation rules; ``dequant_qtensor`` is the fast
path on a weight already converted to a :class:`QTensor`.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.kernels.dequant_kernel import dequant_kernel


def _validate(qweight, scales, qzeros, group_size, bits, in_features):
    # the reference library's guards, except that 1-bit is supported here
    if group_size < 16:
        raise ValueError(f"group_size must be >= 16, got {group_size}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    expect_rows = (in_features * bits + 31) // 32
    if qweight.shape[0] != expect_rows:
        raise ValueError(
            f"qweight rows {qweight.shape[0]} != ceil(K*bits/32) = {expect_rows}"
        )
    if scales.shape[0] != -(-in_features // group_size):
        raise ValueError("scales rows != ceil(K/group_size)")
    if tuple(qzeros.shape) != (scales.shape[0], (scales.shape[1] * bits + 31) // 32):
        raise ValueError("qzeros shape mismatch")


def dequant_qtensor(
    qt: QTensor, out_dtype=torch.bfloat16, use_kernel: bool = True
) -> torch.Tensor:
    """Dense ``(K_logical, N_logical)`` weight of a packed QTensor, rows in
    logical order.  ``use_kernel=False`` is the plain path; otherwise CPU
    planes run the kernel's plain version and CUDA planes launch the kernel
    or raise.  Both give the same bits."""
    if not use_kernel:
        return formats.dequant_qtensor_reference(qt, out_dtype=out_dtype)
    w = dequant_kernel(qt, out_dtype=out_dtype)
    w = w[: qt.K_logical, : qt.shape[1]]
    if qt.perm is not None:
        w = torch.zeros_like(w).index_copy_(0, qt.perm, w)
    return w


def dequant(
    qweight: torch.Tensor,
    scales: torch.Tensor,
    qzeros: torch.Tensor,
    group_size: int,
    bits: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[torch.Tensor] = None,
    out_dtype=None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Drop-in analog of the reference library's ``dequant``: the GPTQ
    interchange layout in, the dense ``(K, N)`` weight out, in ``out_dtype``
    (default: the scales' dtype).

    This wrapper repacks on every call; for repeated use convert once with
    :func:`xbitops_tpu_torch.formats.from_gptq` and call
    :func:`dequant_qtensor`."""
    _validate(qweight, scales, qzeros, group_size, bits, in_features)
    out_dtype = out_dtype or scales.dtype
    qt = formats.from_gptq(
        qweight, scales, qzeros, bits, group_size, in_features,
        add_zero_bias=add_zero_bias, g_idx=g_idx,
    )
    return dequant_qtensor(qt, out_dtype=out_dtype, use_kernel=use_kernel)
