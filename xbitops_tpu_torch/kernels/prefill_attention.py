"""Chunked-prefill attention: a chunk of queries against the cache rows of
their slots, causal by global position, over the dense cache (bf16, fp16 or
f32 rows; q and the output bf16) or the packed int8 cache: the CUDA kernel
(``csrc/prefill_attention.cu``) and its plain PyTorch version.  Its launches
count under ``prefill_attention`` (bf16 and int8), ``prefill_attention_f16``
and ``prefill_attention_f32``, each with ``_paged``.

Replaces the Pallas kernels ``xbitops_tpu/kernels/prefill_attention.py``
``_kernel_v2`` and ``_kernel_v1`` (entry ``prefill_attention``).  The chunk's
own rows must already be in the cache when it runs: the model writes k/v
before it attends, so the chunk's queries see themselves and each other
through the cache.

With ``page_table`` int32 ``[B, P]`` the cache is paged (pools
``[(L,) n_pages, Hkv, psz(/4), D]``, see ``kernels/kv_append.py``) and the
kernel reads each slot's pages in place.  The JAX package computes this case
on its eager path, gathering each slot's pages into one context per layer;
the port's model routes it here on the card instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.kv_append import (
    _unpack_kv_words,
    check_cache,
    check_pool,
    gather_pages,
    stacked_view,
)

NEG_INF = -1e30


def _kernel_name(int8: bool, paged: bool, dtype=torch.bfloat16) -> str:
    """The counter of a form; ``dtype`` is a dense cache's row type."""
    form = "" if int8 else common.dense_suffix(dtype)
    return "prefill_attention" + form + ("_paged" if paged else "")


def prefill_attention_reference(q, k, v, positions, slot_ids, k_scale=None, v_scale=None,
                                window: Optional[int] = None, page_table=None):
    """Plain version, in f32, over ONE layer's cache: k/v [B, Hkv, S, D], or
    with ``k_scale``/``v_scale`` [B, 4, Hkv, S/4] the packed int8 words
    [B, Hkv, S/4, D], dequantized first.  It reads every row of the slots and
    forms the [N, H, T, S] probabilities, which the kernel never does.  With
    ``page_table`` [B, P] they are one layer's pools: the pages of table row
    ``slot_ids[n]`` are gathered first (entries clamped into the pool), and
    the rest is the same, so the result equals the linear form's on the
    gathered cache exactly."""
    paged = page_table is not None
    if q.is_cuda:
        common.count_plain(_kernel_name(k_scale is not None, paged, k.dtype), q)
    N, T, H, D = q.shape
    rows = slot_ids.long().clamp(0, (page_table if paged else k).shape[0] - 1)
    if paged:
        tbl = page_table[rows]
        kc, vc = gather_pages(k, tbl), gather_pages(v, tbl)
        if k_scale is not None:
            kc = _unpack_kv_words(kc, gather_pages(k_scale, tbl, scales=True))
            vc = _unpack_kv_words(vc, gather_pages(v_scale, tbl, scales=True))
    else:
        kc, vc = k[rows], v[rows]
        if k_scale is not None:
            kc, vc = _unpack_kv_words(kc, k_scale[rows]), _unpack_kv_words(vc, v_scale[rows])
    Hkv, S = kc.shape[1], kc.shape[2]
    rep = H // Hkv
    kf = kc.float().repeat_interleave(rep, dim=1)  # query head h*rep+r -> kv head h
    vf = vc.float().repeat_interleave(rep, dim=1)
    pos = positions.long()[:, :, None]  # [N, T, 1]
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    live = (s_idx <= pos) & (pos < S)
    if window is not None:
        live &= s_idx > pos - window
    live = live[:, None]  # [N, 1, T, S]
    scores = torch.einsum("nqhd,nhkd->nhqk", q.float(), kf) * D ** -0.5
    scores = torch.where(live, scores, NEG_INF)
    p = torch.where(live, torch.softmax(scores, dim=-1), 0.0)
    return torch.einsum("nhqk,nhkd->nqhd", p, vf).to(q.dtype)


def prefill_attention(
    q: torch.Tensor,  # [N, T, H, D] chunk queries, bf16
    k: torch.Tensor,  # [(L,) B, Hkv, S, D] bf16/fp16/f32, or int8 words [(L,) B, Hkv, S/4, D]
    v: torch.Tensor,
    positions: torch.Tensor,  # int [N, T] global positions; outside [0, S): padding
    slot_ids: torch.Tensor,  # int [N] cache slot of each row (clamped into [0, B))
    layer_idx: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [(L,) B, 4, Hkv, S/4]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    page_table: Optional[torch.Tensor] = None,  # int32 [B, P]: k/v are page pools
) -> torch.Tensor:
    """``out[n, t]`` attends the cache positions ``s <= positions[n, t]``
    (and ``s > positions[n, t] - window`` with a window) of slot
    ``slot_ids[n]``, layer ``layer_idx`` of a stacked cache.  Query head
    ``h*rep + r`` uses kv head ``h``.  A padding query returns exact zeros,
    wherever in the chunk it sits; a row of nothing but padding (an inert row,
    whatever its slot id) reads nothing.  Returns [N, T, H, D] in q's dtype.

    With ``page_table`` the cache is paged: k/v are pools
    ``[(L,) n_pages, Hkv, psz(/4), D]``, the scales pools
    ``[(L,) n_pages, 4, Hkv, psz/4]``, a slot holds ``P * psz`` positions and
    row ``n`` reads the pages of table row ``slot_ids[n]`` (clamped into
    ``[0, B)``).  An entry outside ``[0, n_pages)`` is clamped into the pool;
    such a page lies past the slot's length, where no live query looks.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    int8, paged = k_scale is not None, page_table is not None
    k_all, v_all, ks_all, vs_all, li, window = stacked_view(
        k, v, k_scale, v_scale, layer_idx, window, page_table)
    if not q.is_cuda:
        scales = (ks_all[li], vs_all[li]) if int8 else (None, None)
        return prefill_attention_reference(
            q, k_all[li], v_all[li], positions, slot_ids, *scales, window=window,
            page_table=page_table)

    req = common.require
    N, T, H, D = q.shape
    if paged:
        L, n_pages, Hkv, psz, Dc, B, P = check_pool(k_all, v_all, page_table, ks_all, vs_all)
    else:
        L, B, Hkv, S, Dc = check_cache(k_all, v_all, ks_all, vs_all)
    dev = q.device
    req(Dc == D and k_all.device == dev,
        f"q {tuple(q.shape)} does not match cache {tuple(k_all.shape)}")
    req(0 <= li < L, f"layer {li} outside [0, {L})")
    req(D in (64, 128, 256), f"head_dim {D} not in (64, 128, 256)")
    req(H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    req(q.dtype == torch.bfloat16, "q must be bf16")
    req(positions.shape == (N, T), "positions must be [N, T]")
    req(slot_ids.shape == (N,), "slot_ids must be [N]")
    q = q.contiguous()
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    slots = slot_ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((N, T, H, D), dtype=torch.bfloat16, device=dev)
    head = (q.data_ptr(), k_all[li].data_ptr(), v_all[li].data_ptr(),
            ks_all[li].data_ptr() if int8 else None, vs_all[li].data_ptr() if int8 else None,
            pos.data_ptr(), slots.data_ptr())
    tail = (D, window or 0, 0 if int8 else common.DENSE_KV[k_all.dtype], float(D) ** -0.5,
            common.stream_ptr(q))
    name = _kernel_name(int8, paged, k_all.dtype)
    if paged:
        err = common.lib().xb_prefill_attention_paged(
            *head, page_table.data_ptr(), out.data_ptr(), N, T, H, Hkv, B, P, psz, n_pages,
            *tail)
    else:
        err = common.lib().xb_prefill_attention(
            *head, out.data_ptr(), N, T, H, Hkv, B, S, *tail)
    common.check(err, name)
    common.launches[name] += 1
    return out
