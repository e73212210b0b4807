"""Length-aware one-token (decode) attention over the head-major cache, bf16
or packed int8: the CUDA kernel (``csrc/decode_attention.cu``) and its plain
PyTorch version.

Replaces the Pallas kernels ``xbitops_tpu/kernels/decode_attention.py``
``_kernel_v2`` and ``_kernel`` (entry ``decode_attention``) for the dense bf16
cache and the packed int8 cache (words ``[(L,) B, Hkv, S/4, D]`` int32 and
scales ``[(L,) B, 4, Hkv, S/4]`` bf16, see ``kernels/kv_append.py``), and for
their paged forms: with ``page_table`` int32 ``[B, P]`` the k/v operands are
page pools ``[(L,) n_pages, Hkv, psz(/4), D]`` (scale pools
``[(L,) n_pages, 4, Hkv, psz/4]``) that the kernel reads in place, looking each
page up as it walks a slot's positions.
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
    kv_append_dense,
    kv_append_packed,
    stacked_view,
)

NEG_INF = -1e30
SPLIT_LEN = 256  # cache positions per thread block (split-KV)


def _kernel_name(int8: bool, paged: bool) -> str:
    return "decode_attention" + ("_int8" if int8 else "") + ("_paged" if paged else "")


def decode_attention_reference(q, k, v, lengths, window: Optional[int] = None,
                               k_scale=None, v_scale=None, page_table=None):
    """Plain version: softmax(q k^T / sqrt(D)) v over positions
    ``[max(0, len - window), len)`` of each slot, in f32.  q [B, H, D];
    k/v [B, Hkv, S, D] (one layer), or with ``k_scale``/``v_scale``
    [B, 4, Hkv, S/4] the packed int8 words [B, Hkv, S/4, D], dequantized
    first; returns [B, H, D] in q's dtype.  With ``page_table`` [B, P] they
    are one layer's pools: each slot's pages are gathered first (entries
    clamped into the pool), and the rest is the same, so the result equals the
    linear form's on the gathered cache exactly."""
    int8 = k_scale is not None
    common.count_plain(_kernel_name(int8, page_table is not None), q)
    if page_table is not None:
        k, v = gather_pages(k, page_table), gather_pages(v, page_table)
        if int8:
            k_scale = gather_pages(k_scale, page_table, scales=True)
            v_scale = gather_pages(v_scale, page_table, scales=True)
    if int8:
        k, v = _unpack_kv_words(k, k_scale), _unpack_kv_words(v, v_scale)
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)  # query head h*rep+r -> kv head h
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * D ** -0.5
    s_idx = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long().clamp(0, S)[:, None]
    live = s_idx < lens
    if window is not None:
        live &= s_idx >= (lens - window).clamp(min=0)
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(live[:, None, :], p, 0.0)
    return torch.einsum("bhs,bhsd->bhd", p, vf).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, Hkv, S, D] bf16, or [L, B, Hkv, S, D] with layer_idx
    v: torch.Tensor,
    lengths: torch.Tensor,  # int [B]: attend positions < lengths[b]
    layer_idx: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [(L,) B, 4, Hkv, S/4]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,  # int32 [B, P]: k/v are page pools
    kv_new=None,  # new rows to append first (see below)
    window: Optional[int] = None,
):
    """One-token attention of each slot over its first ``lengths[b]`` cache
    positions (of layer ``layer_idx`` of a stacked cache); returns [B, H, D].

    With ``k_scale``/``v_scale`` the cache is the packed int8 one: k/v are
    int32 words ``[(L,) B, Hkv, S/4, D]``.  ``window``: attend only
    ``[max(0, len - window), len)``; a window that covers the whole cache is
    dropped.  ``kv_new``: write the new rows at ``positions`` into the cache
    first (in place, positions >= S write nothing).  For the bf16 cache it is
    ``(k_new [B, Hkv, D], v_new, positions [B])`` and the result
    ``(out, k, v)``; for the int8 cache ``(kq [B, Hkv, D] biased int32, vq,
    ks_new [B, Hkv], vs_new, positions)`` and the result
    ``(out, k, v, k_scale, v_scale)`` -- the same tensors, updated.

    With ``page_table`` the cache is paged: k/v are pools
    ``[(L,) n_pages, Hkv, psz(/4), D]``, the scales pools
    ``[(L,) n_pages, 4, Hkv, psz/4]``, a slot holds ``P * psz`` positions and
    position ``p`` of slot ``b`` lies in page ``page_table[b, p // psz]``.  An
    entry outside ``[0, n_pages)`` (-1: no page) is clamped into the pool, so
    an inactive slot, which arrives with length ``P * psz`` and no page,
    reads page 0; its output is not meant to be used.  ``kv_new`` then
    appends through the table, and a slot without a page for its position
    writes nothing.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    or raises."""
    int8 = k_scale is not None
    k_all, v_all, ks_all, vs_all, li, window = stacked_view(
        k, v, k_scale, v_scale, layer_idx, window, page_table)
    if kv_new is not None and int8:
        kq, vq, ks_new, vs_new, positions = kv_new
        kv_append_packed(k_all, v_all, ks_all, vs_all, kq, vq, ks_new, vs_new, positions, li,
                         page_table)
    elif kv_new is not None:
        k_new, v_new, positions = kv_new
        kv_append_dense(k_all, v_all, k_new, v_new, positions, li, page_table)
    if not q.is_cuda:
        scales = (ks_all[li], vs_all[li]) if int8 else (None, None)
        out = decode_attention_reference(q, k_all[li], v_all[li], lengths, window, *scales,
                                         page_table=page_table)
    else:
        out = _launch(q, k_all, v_all, ks_all, vs_all, lengths, li, window, page_table)
    if kv_new is None:
        return out
    return (out, k, v, k_scale, v_scale) if int8 else (out, k, v)


def _launch(q, k, v, ks, vs, lengths, layer_idx, window, page_table=None):
    req = common.require
    int8, paged = ks is not None, page_table is not None
    B, H, D = q.shape
    if paged:
        L, n_pages, Hkv, psz, Dc, Bc, P = check_pool(k, v, page_table, ks, vs)
        S = P * psz
    else:
        L, Bc, Hkv, S, Dc = check_cache(k, v, ks, vs)
    req(Bc == B and Dc == D and k.device == q.device,
        f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    req(0 <= layer_idx < L, f"layer {layer_idx} outside [0, {L})")
    req(D in (64, 128, 256), f"head_dim {D} not in (64, 128, 256)")
    req(H % Hkv == 0 and H // Hkv <= 8, f"H={H}, Hkv={Hkv}: GQA ratio must be <= 8")
    req(q.dtype == torch.bfloat16, "q must be bf16")
    q = q.contiguous()
    req(lengths.shape == (B,), "lengths must be [B]")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    n_split = -(-S // SPLIT_LEN)
    part_o = torch.empty((B, H, n_split, D), dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, H, n_split), dtype=torch.float32, device=q.device)
    part_l = torch.empty((B, H, n_split), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    head = [q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr()]
    if int8:
        head += [ks[layer_idx].data_ptr(), vs[layer_idx].data_ptr()]
    head += [lens.data_ptr()] + ([page_table.data_ptr()] if paged else [])
    shape = (B, H, Hkv, P, psz, n_pages, D) if paged else (B, H, Hkv, S, D)
    name = _kernel_name(int8, paged)
    err = getattr(common.lib(), "xb_" + name)(
        *head, part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(),
        *shape, n_split, SPLIT_LEN, window or 0, float(D) ** -0.5, common.stream_ptr(q))
    common.check(err, name)
    common.launches[name] += 1
    return out
