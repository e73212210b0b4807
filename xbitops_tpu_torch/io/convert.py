"""Bring weights and KV caches of the JAX package into the port.

Both packages share the packed layout (format v3), so conversion is a copy: the
caller hands over the JAX parameter tree after ``jax.tree.map(np.asarray, ...)``
and this module reads the QTensor fields by name, so it needs no JAX import.
fp16 scales stored as int16 bit patterns become ``float16`` views.  A leaf may
also be a ``torch.Tensor`` already (``io.checkpoint.load_packed`` makes those).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.models.llama import KVCache, Llama, LlamaBlock, LlamaConfig

_PROJECTIONS = ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate", "w_up", "w_down",
                "router", "w_experts_gateup", "w_experts_down")


def _is_qtensor(x: Any) -> bool:
    return all(hasattr(x, f) for f in ("planes", "scales", "scale_zeros", "bits", "tile_k"))


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _scales(a, device) -> torch.Tensor:
    t = _tensor(a, device)
    if t.dtype == torch.int16:  # fp16 bit patterns (the JAX FP16_BITS store)
        return t.view(torch.float16)
    return t


def qtensor_from_numpy(qt: Any, device) -> QTensor:
    """A QTensor (numpy leaves, any object with the QTensor fields) -> port QTensor."""
    return QTensor(
        planes=tuple(_tensor(p, device) for p in qt.planes),
        scales=_scales(qt.scales, device),
        scale_zeros=_scales(qt.scale_zeros, device),
        bits=int(qt.bits),
        group_size=int(qt.group_size),
        tile_k=int(qt.tile_k),
        K=int(qt.K),
        K_logical=int(qt.K_logical),
        perm=None if qt.perm is None else _tensor(qt.perm, device).long(),
        N_logical=None if qt.N_logical is None else int(qt.N_logical),
        value_bits=None if qt.value_bits is None else int(qt.value_bits),
    )


def _weight(x, device, li=None):
    if _is_qtensor(x):
        qt = qtensor_from_numpy(x, device)
        return qt if li is None else qt.layer(li)
    t = _tensor(x, device)
    return t if li is None else t[li]


def params_from_numpy(params: dict, cfg: LlamaConfig, device) -> Llama:
    """JAX Llama params (numpy leaves) -> :class:`Llama` on ``device``.

    Takes the per-layer list layout and the stacked (``stack_layers``) one; a
    stacked tree becomes per-layer modules that view one stacked tensor.  A
    MoE layer (``models.moe``: ``router``, QTensors or dense tensors with a
    leading expert axis) carries across as it is; ``cfg`` is then a
    ``MoeConfig``."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        per_layer = [{k: _weight(v, device) for k, v in layer.items()} for layer in layers]
    else:
        stacked = {k: _weight(v, device) for k, v in layers.items()}
        n = cfg.num_layers

        def pick(x, li):
            return x.layer(li) if isinstance(x, QTensor) else x[li]

        per_layer = [{k: pick(v, li) for k, v in stacked.items()} for li in range(n)]
    blocks = []
    for layer in per_layer:
        unknown = set(layer) - set(_PROJECTIONS) - {"ln_attn", "ln_mlp"}
        if unknown:
            raise NotImplementedError(f"layer weights {sorted(unknown)} are not ported")
        blocks.append(LlamaBlock(
            cfg, {k: v for k, v in layer.items() if k in _PROJECTIONS},
            layer["ln_attn"], layer["ln_mlp"],
        ))
    return Llama(
        cfg,
        embed=_tensor(params["embed"], device),
        blocks=blocks,
        ln_final=_tensor(params["ln_final"], device),
        lm_head=_weight(params["lm_head"], device),
    )


def kvcache_from_numpy(cache: Any, device) -> KVCache:
    """The JAX package's ``KVCache`` (numpy leaves, any object with its
    fields) -> the port's, dense (bf16, fp16 or f32) or packed int8, linear or paged (pools, scale
    pools and page table): both keep the same layout, so a request can prefill
    in one package and decode in the other."""
    quantized = cache.k_scale is not None
    table = getattr(cache, "page_table", None)
    if table is not None:
        table = np.asarray(table)
        slots, n_pages = cache.lengths.shape[0], cache.k.shape[1]
        if table.ndim != 2 or table.shape[0] != slots or table.max(initial=-1) >= n_pages:
            raise ValueError(f"page_table {table.shape} does not fit a cache of {slots} slots "
                             f"and {n_pages} pool pages")
    return KVCache(
        k=_tensor(cache.k, device),
        v=_tensor(cache.v, device),
        lengths=_tensor(cache.lengths, device).to(torch.int32),
        k_scale=_tensor(cache.k_scale, device) if quantized else None,
        v_scale=_tensor(cache.v_scale, device) if quantized else None,
        page_table=None if table is None else _tensor(table, device).to(torch.int32),
    )
