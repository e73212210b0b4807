"""Public fused quantized matmul ops (port of ``xbitops_tpu/ops/qmatmul.py``).

``qmatmul`` is the native surface (activations x packed QTensor); ``gemv``
takes the GPTQ interchange layout, as the reference library's ``gemv`` does,
at every width 1-8 and group size >= 16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xbitops_tpu_torch import formats
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
    activation columns through ``qt.perm``; the packed rows past K (``qt.K``
    pads K to a tile multiple) meet zeros; the output is cut to ``N_logical``
    columns.  ``layer``
    picks one layer of a stacked QTensor (a view).  ``precise`` keeps the
    activations in f32 (default: bf16), sums are f32 either way.

    ``a8=True`` (W4A8-style, for admission's large M): the activations are
    quantized per row to int8 (absmax), the products are integer and the
    scale returns on the kernel's f32 output.  The weight side stays exact;
    only the activations round (about 1/254 of a row's largest value).

    ``use_kernel=False`` is the plain path: f32 activations (with ``a8``,
    rounded to their int8 grid) times the dense dequantized weight.  Otherwise
    a CPU tensor runs the kernel's plain version and a CUDA tensor launches
    the kernel or raises.
    """
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
        af = a2.float()
        if a8:  # round the activations as the kernel path does
            aq, a_scale = quantize_activations(af)
            af = aq.float() * a_scale
        return (af @ w).reshape(*lead, Nl).to(out_dtype)
    if qt.perm is not None:
        a2 = a2[:, qt.perm]
    if a8:  # padded packed rows: zero activations contribute nothing
        aq, a_scale = quantize_activations(F.pad(a2.float(), (0, qt.K - K)))
        out = qmatmul_kernel(aq, qt, out_dtype=torch.float32, a8=True) * a_scale
        return out[:, :Nl].reshape(*lead, Nl).to(out_dtype)
    kernel_out = torch.float32 if out_dtype == torch.float16 else out_dtype
    out = qmatmul_kernel(a2, qt, out_dtype=kernel_out, precise=precise)
    return out[:, :Nl].reshape(*lead, Nl).to(out_dtype)


def quantize_activations(af: torch.Tensor):
    """Per-row absmax int8: ``af[M, K]`` (f32) ``~= a_scale * aq``.  Returns
    ``aq`` int8 and ``a_scale`` f32 ``[M, 1]``.  The quotient is a true
    division and rounds half to even, so ``aq`` is the JAX package's bit for
    bit."""
    a_scale = torch.clamp(af.abs().amax(dim=1, keepdim=True), min=1e-30) / 127.0
    return torch.round(af / a_scale).to(torch.int8), a_scale


def gemv(
    input_a: torch.Tensor,
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
    """Drop-in analog of the reference library's ``gemv``: fused dequantize +
    GEMV/GEMM from the GPTQ interchange layout.

    This wrapper repacks the weight on every call; in a hot loop convert once
    with :func:`xbitops_tpu_torch.formats.from_gptq` and call :func:`qmatmul`."""
    qt = formats.from_gptq(
        qweight, scales, qzeros, bits, group_size, in_features,
        add_zero_bias=add_zero_bias, g_idx=g_idx,
    )
    return qmatmul(input_a, qt, out_dtype=out_dtype or input_a.dtype, use_kernel=use_kernel)
