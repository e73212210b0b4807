"""Tensor-parallel execution of the quantized Llama, one rank a process (port
of ``xbitops_tpu/parallel/model_tp.py``).

Megatron's layout, one sum a pair of matmuls:

- q|k|v, gate|up (fused: columns interleaved per shard, ``[q0|k0|v0|q1|..]``)
  and lm_head are column-parallel; rank ``r`` holds column shard ``r``;
- wo and w_down are row-parallel (packed row-sharded); rank ``r`` holds row
  shard ``r`` and its block sums the partial products over the axis;
- the KV cache holds kv heads ``[r Hkv/tp, (r+1) Hkv/tp)``; the embedding and
  the norms are replicated.

:func:`shard_params` turns a model packed for ``tp`` (``llama.init_params(tp=)``,
``load_autogptq(tp=)``, ``load_llama(tp=)``, or :func:`pack_for_tp` of a
``tp=1`` model) into the rank's shard: an ordinary :class:`~llama.Llama` of
``cfg.local(tp)`` whose projections carry their ``parallel.tp.Role``.  Its
forwards are the single-rank code (``llama.forward`` and the step functions
over it): that is the whole trick, as ``TPRuntime`` inside ``shard_map`` is in
the JAX package.  The ``tp_*`` functions below take the rank's shard and its
cache and check that the shard is ``cfg``'s for the mesh; ``data_axis`` (a
dp x tp mesh) gives each data replica its rows of the batch and gathers the
logits.  ``Engine(mesh=)`` calls them through :func:`step_functions`.  Every
rank runs the same calls on the same inputs.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig, linear_weight
from xbitops_tpu_torch.parallel.mesh import Mesh, all_gather
from xbitops_tpu_torch.parallel.tp import Role, local_weight

__all__ = ["pack_for_tp", "shard_params", "shard_cache", "tp_forward", "tp_decode_step",
           "tp_spec_verify_step", "tp_prefill_slot", "tp_prefill_slot_chunk", "tp_prefill_slots",
           "tp_prefill_slots_chunk", "tp_prefill", "step_functions"]

_COL_KEYS = {"wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gateup"}
_ROW_KEYS = {"wo", "w_down"}


def _fused_sizes(cfg: LlamaConfig, key: str):
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"wqkv": (qdim, kvdim, kvdim), "w_gateup": (cfg.intermediate_size,) * 2}.get(key)


def pack_for_tp(model: Llama, tp: int) -> Llama:
    """A ``tp=1`` model packed for a ``tp``-way model axis with the same
    values: the fused columns interleaved per shard
    (``concat_qtensors(order=)``), wo and w_down repacked row-sharded
    (``formats.row_shard_qtensor``: every stored value copied).  An act-order
    row weight stays whole (it runs gathered).  The model ``init_params(tp=)``
    or ``load_autogptq(tp=)`` gives directly; this one serves models built
    another way (``utils/synth``)."""
    cfg = model.cfg
    cfg.local(tp)
    blocks = []
    for b in model.blocks:
        if hasattr(b, "moe"):
            raise ValueError("MoE layers shard over the expert axis (models.moe.shard_experts)")
        proj = {}
        for key, w in b.weights().items():
            sizes = _fused_sizes(cfg, key)
            if sizes is not None:
                order = llama.interleave_order(sizes, tp)
                w = (formats.concat_qtensors([w], order=order) if isinstance(w, QTensor)
                     else w[:, torch.from_numpy(order).to(w.device)])
            elif key in _ROW_KEYS and isinstance(w, QTensor) and w.perm is None:
                w = formats.row_shard_qtensor(w, tp)
            proj[key] = w
        blocks.append(LlamaBlock(cfg, proj, b.ln_attn, b.ln_mlp))
    return Llama(cfg, model.embed, blocks, model.ln_final, linear_weight(model.lm_head))


def shard_params(model: Llama, mesh: Mesh, axis: str = "model") -> Llama:
    """This rank's shard of a model packed for ``mesh.shape[axis]`` ranks (see
    the module docstring): copies of its columns and row shards, the
    embedding and the norms shared with ``model``.  Raises ``ValueError`` for
    a row weight that is not row-sharded (unless act-order: it runs gathered),
    a row-sharded one of another shard count, or a column count that does not
    split into lane-aligned shards."""
    n = mesh.shape[axis]
    cfg = model.cfg
    local_cfg = cfg.local(n)
    blocks = []
    for b in model.blocks:
        if hasattr(b, "moe"):
            raise ValueError("MoE layers shard over the expert axis (models.moe.shard_experts)")
        proj, roles = {}, {}
        for key, w in b.weights().items():
            if key in _COL_KEYS:
                proj[key] = local_weight(w, mesh, col_axis=axis)
                roles[key] = Role(mesh, axis, "column")
            elif key in _ROW_KEYS:
                if isinstance(w, QTensor) and not formats.is_row_sharded(w) and w.perm is not None:
                    # the gathered path: act-order and not row-sharded, nothing else
                    roles[key] = Role(mesh, axis, "row_gathered", w.shape[1])
                else:
                    roles[key] = Role(mesh, axis, "row")
                proj[key] = local_weight(w, mesh, row_axis=axis)
            else:
                raise ValueError(f"layer weight {key!r} has no tensor-parallel layout")
        block = LlamaBlock(local_cfg, proj, b.ln_attn, b.ln_mlp)
        for key, role in roles.items():
            getattr(block, key).role = role
        blocks.append(block)
    head = linear_weight(model.lm_head)
    out = Llama(local_cfg, model.embed, blocks, model.ln_final,
                local_weight(head, mesh, col_axis=axis))
    out.lm_head.role = Role(mesh, axis, "column_gather", head.shape[1])
    return out


def _slice(t: torch.Tensor, dim: int, r: int, n: int) -> torch.Tensor:
    w = t.shape[dim] // n
    return t.narrow(dim, r * w, w).clone()


def shard_cache(cache: llama.KVCache, mesh: Mesh, axis: str = "model",
                data_axis: Optional[str] = None) -> llama.KVCache:
    """This rank's part of a full cache: its kv heads (k, v ``[L, B|pages,
    Hkv, ..]``, scales ``[L, B|pages, 4, Hkv, ..]``) and, with ``data_axis``,
    its slots (a paged cache's pool stays whole; its table rows and lengths
    split).  A new cache of a rank is ``KVCache.init`` of its shard's
    ``cfg.local(tp)``."""
    n, r = mesh.shape[axis], mesh.index(axis)
    fields = dict(k=_slice(cache.k, 2, r, n), v=_slice(cache.v, 2, r, n),
                  lengths=cache.lengths.clone(),
                  page_table=None if cache.page_table is None else cache.page_table.clone())
    if cache.quantized:
        fields.update(k_scale=_slice(cache.k_scale, 3, r, n),
                      v_scale=_slice(cache.v_scale, 3, r, n))
    if data_axis is not None:
        nd, d = mesh.shape[data_axis], mesh.index(data_axis)
        fields["lengths"] = _slice(fields["lengths"], 0, d, nd)
        if cache.paged:
            fields["page_table"] = _slice(fields["page_table"], 0, d, nd)
        else:
            for key in ("k", "v", "k_scale", "v_scale"):
                if fields.get(key) is not None:
                    fields[key] = _slice(fields[key], 1, d, nd)
    return llama.KVCache(**fields)


def _check(model: Llama, cfg: LlamaConfig, mesh: Mesh, axis: str) -> None:
    if model.cfg != cfg.local(mesh.shape[axis]):
        raise ValueError("the model is not this mesh's shard of cfg (use shard_params)")


def _rows(mesh: Mesh, data_axis: Optional[str], B: int) -> Optional[slice]:
    if data_axis is None:
        return None
    nd, d = mesh.shape[data_axis], mesh.index(data_axis)
    if B % nd:
        raise ValueError(f"batch {B} does not split over {nd} data replicas")
    return slice(d * (B // nd), (d + 1) * (B // nd))


def tp_forward(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, cache: llama.KVCache,
               positions, axis: str = "model",
               data_axis: Optional[str] = None) -> Tuple[torch.Tensor, llama.KVCache]:
    """The sharded forward: the logits of every row on every rank, the cache
    (this rank's heads, and with ``data_axis`` its rows) written in place."""
    _check(model, cfg, mesh, axis)
    rows = _rows(mesh, data_axis, tokens.shape[0])
    if rows is None:
        return model(tokens, cache, positions)
    logits, cache = model(tokens[rows], cache, positions[rows])
    return all_gather(logits, mesh, data_axis, dim=0), cache


def tp_decode_step(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, cache: llama.KVCache,
                   axis: str = "model", data_axis: Optional[str] = None, active=None):
    """Sharded :func:`~llama.decode_step`: logits ``[B, V]`` on every rank."""
    _check(model, cfg, mesh, axis)
    rows = _rows(mesh, data_axis, tokens.shape[0])
    if rows is None:
        return llama.decode_step(model, tokens, cache, active=active)
    logits, cache = llama.decode_step(model, tokens[rows], cache,
                                      active=None if active is None else active[rows])
    return all_gather(logits, mesh, data_axis, dim=0), cache


def tp_spec_verify_step(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens,
                        cache: llama.KVCache, axis: str = "model", active=None):
    """Sharded :func:`~llama.spec_verify_step`: the accept and roll-back run on
    every rank on the same logits, so the ranks agree."""
    _check(model, cfg, mesh, axis)
    return llama.spec_verify_step(model, tokens, cache, active=active)


def tp_prefill_slots_chunk(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, starts,
                           true_lens, slots, cache: llama.KVCache, axis: str = "model",
                           resets=None):
    """Sharded :func:`~llama.prefill_slots_chunk`."""
    _check(model, cfg, mesh, axis)
    return llama.prefill_slots_chunk(model, tokens, starts, true_lens, slots, cache,
                                     resets=resets)


def tp_prefill_slots(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, true_lens, slots,
                     cache: llama.KVCache, axis: str = "model"):
    """Sharded :func:`~llama.prefill_slots`."""
    _check(model, cfg, mesh, axis)
    return llama.prefill_slots(model, tokens, true_lens, slots, cache)


def tp_prefill_slot_chunk(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, start: int,
                          true_len: int, slot: int, cache: llama.KVCache, axis: str = "model",
                          reset: bool = False):
    """Sharded :func:`~llama.prefill_slot_chunk`: the logits [V] on every rank."""
    _check(model, cfg, mesh, axis)
    return llama.prefill_slot_chunk(model, tokens, start, true_len, slot, cache, reset=reset)


def tp_prefill_slot(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, true_len: int,
                    slot: int, cache: llama.KVCache, axis: str = "model"):
    """Sharded :func:`~llama.prefill_slot`: the logits [V] on every rank."""
    _check(model, cfg, mesh, axis)
    return llama.prefill_slot(model, tokens, true_len, slot, cache)


def step_functions(cfg: LlamaConfig, mesh: Mesh, axis: str = "model") -> SimpleNamespace:
    """The step functions an engine calls, with ``llama``'s signatures:
    ``decode_step``, ``spec_verify_step``, ``prefill_slots`` and
    ``prefill_slots_chunk``, each the ``tp_*`` function above for ``cfg``
    over ``mesh``'s ``axis``."""
    def bind(fn):
        return lambda model, *args, **kw: fn(model, cfg, mesh, *args, axis=axis, **kw)

    return SimpleNamespace(decode_step=bind(tp_decode_step),
                           spec_verify_step=bind(tp_spec_verify_step),
                           prefill_slots=bind(tp_prefill_slots),
                           prefill_slots_chunk=bind(tp_prefill_slots_chunk))


def tp_prefill(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens, cache: llama.KVCache,
               axis: str = "model", data_axis: Optional[str] = None):
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    return tp_forward(model, cfg, mesh, tokens, cache, positions, axis, data_axis)
