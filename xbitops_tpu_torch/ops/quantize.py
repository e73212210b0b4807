"""On-device quantization: float weight -> packed QTensor (port of
``xbitops_tpu/ops/quantize.py``).

Asymmetric per-group min/max with GPTQ conventions (``w ~= (wq - z) * s``),
so a model can be quantized on the fly and a full-model conversion never
leaves the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.ops.dequant import dequant_qtensor


def quantize_array(
    w: torch.Tensor,
    bits: int,
    group_size: int = 128,
    sym: bool = False,
    tile_k: Optional[int] = None,
    scale_store_dtype=torch.float16,
    scale_round_dtype=None,
    row_shards: int = 1,
    act_order: bool = False,
    storage_bits=None,
) -> QTensor:
    """Quantize ``w[K, N]`` to ``bits`` with per-group scale and zero, packed
    on ``w``'s device.

    Scales round through ``scale_round_dtype`` (default fp16, the stored
    type) BEFORE q and zero are chosen, so they compensate the stored value.
    ``act_order`` quantizes rows in descending-salience order (a stable sort)
    and keeps the order as ``perm``: matmuls gather activations, the weights
    stay put.  ``storage_bits``: see ``formats.resolve_storage_bits``.

    ``row_shards > 1`` packs for row-parallel tensor parallelism
    (``formats.make_row_sharded_qtensor``: a leading shard axis); with
    ``act_order`` each K-shard sorts its own rows, so the gather stays inside
    a rank, and ``perm`` is ``[row_shards, K / row_shards]`` of shard-local
    indices."""
    K, N = w.shape
    w = w.float()
    perm = None
    if act_order:
        salience = w.abs().sum(dim=1)
        if row_shards > 1:
            if K % row_shards:
                raise ValueError(f"K={K} must divide into {row_shards} shards")
            Ks = K // row_shards
            perm = torch.argsort(-salience.reshape(row_shards, Ks), dim=1, stable=True)
            w = w[(perm + torch.arange(row_shards, device=w.device)[:, None] * Ks).reshape(-1)]
        else:
            perm = torch.argsort(-salience, stable=True)
            w = w[perm]
    Kp = formats._round_up(K, group_size)
    G = Kp // group_size
    maxq = (1 << bits) - 1
    wg = torch.nn.functional.pad(w, (0, 0, 0, Kp - K)).reshape(G, group_size, N)
    if scale_round_dtype is None:
        scale_round_dtype = torch.float16
    if sym:
        amax = wg.abs().amax(dim=1)
        scale = torch.clamp(amax / (maxq / 2), min=1e-8)
        scale = scale.to(scale_round_dtype).float()
        zero = torch.full((G, N), float((maxq + 1) // 2), device=w.device)
    else:
        lo = torch.clamp(wg.amin(dim=1), max=0.0)
        hi = torch.clamp(wg.amax(dim=1), min=0.0)
        scale = torch.clamp((hi - lo) / maxq, min=1e-8)
        scale = scale.to(scale_round_dtype).float()
        zero = torch.clamp(torch.round(-lo / scale), 0, maxq)
    q = torch.clamp(torch.round(wg / scale[:, None, :] + zero[:, None, :]), 0, maxq)
    wq = q.reshape(Kp, N).to(torch.int32)[:K]
    if row_shards > 1:
        return formats.make_row_sharded_qtensor(
            wq, scale.to(scale_round_dtype), zero.to(torch.int32), bits, group_size, row_shards,
            tile_k=tile_k, scale_store_dtype=scale_store_dtype, storage_bits=storage_bits,
            perm=perm)
    return formats.make_qtensor(
        wq, scale.to(scale_round_dtype), zero.to(torch.int32), bits, group_size,
        add_zero_bias=0, tile_k=tile_k, perm=perm, scale_store_dtype=scale_store_dtype,
        storage_bits=storage_bits,
    )


def requantize_a8(qt: QTensor, tile_k: Optional[int] = None) -> QTensor:
    """Re-quantize a grouped QTensor to 8 bits with PER-CHANNEL scales: the
    layout whose a8 matmul keeps one integer sum over all of K and rescales
    once (``kernels.qgemv_kernel.a8_per_channel``), where a grouped weight
    folds every group into f32.

    Cost: 8 stored bits a weight; a caller that keeps the 4-bit tensor for
    decode holds both.  Accuracy: one more rounding, against the COLUMN's
    range, (col max - min)/255 per element.  Act-order inputs requantize in
    logical row order (no ``perm`` afterwards).  The dense f32 weight comes
    from :func:`dequant_qtensor`: on the card, the dequant kernel."""
    wd = dequant_qtensor(qt, out_dtype=torch.float32)
    return quantize_array(wd, 8, group_size=wd.shape[0], tile_k=tile_k)
