"""Public fused quantized matmul: activations x packed QTensor."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xbitops_tpu_torch.formats import QTensor, dequant_qtensor_reference
from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.qgemv_kernel import qmatmul_kernel


def qmatmul(
    a: torch.Tensor,
    qt: QTensor,
    out_dtype=None,
    precise: bool = False,
    use_kernel: bool = True,
    layer: Optional[int] = None,
    a8: bool = False,
) -> torch.Tensor:
    """``a[..., K] @ dequant(qt)[K, N] -> [..., N]`` without materialising the
    dense weight (port of ``xbitops_tpu/ops/qmatmul.py:qmatmul``).

    Leading dims of ``a`` fold into M.  Act-order QTensors gather the
    activation columns through ``qt.perm``; K pads with zero columns up to the
    packed ``qt.K``; the output is cut to ``N_logical`` columns.  ``layer``
    picks one layer of a stacked QTensor (a view).  ``precise`` keeps the
    activations in f32 (default: bf16), sums are f32 either way.

    ``use_kernel=False`` is the plain path: f32 activations times the dense
    dequantized weight.  Otherwise a CPU tensor runs the kernel's plain
    version and a CUDA tensor launches the kernel or raises.
    """
    if a8:
        raise NotImplementedError("W4A8 (a8=True) is not ported yet")
    out_dtype = out_dtype or a.dtype
    if layer is not None:
        qt = qt.layer(layer)
    *lead, K = a.shape
    if K != qt.K_logical:
        raise ValueError(f"a K={K} != weight K={qt.K_logical}")
    M = 1
    for d in lead:
        M *= d
    Nl = qt.shape[1]
    a2 = a.reshape(M, K)
    if not use_kernel:
        common.count_plain("qgemv", a)
        w = dequant_qtensor_reference(qt, out_dtype=torch.float32)
        return (a2.float() @ w).reshape(*lead, Nl).to(out_dtype)
    if qt.perm is not None:
        a2 = a2[:, qt.perm]
    if qt.K != K:  # padded packed rows: zero activations contribute nothing
        a2 = F.pad(a2, (0, qt.K - K))
    kernel_out = torch.float32 if out_dtype == torch.float16 else out_dtype
    out = qmatmul_kernel(a2, qt, out_dtype=kernel_out, precise=precise)
    return out[:, :Nl].reshape(*lead, Nl).to(out_dtype)
