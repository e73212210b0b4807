"""Length-aware one-token (decode) attention over the head-major cache, dense
(bf16, fp16 or f32 rows) or packed int8, with the KV append fused in: the
CUDA kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces the Pallas kernels ``xbitops_tpu/kernels/decode_attention.py``
``_kernel_v2`` and ``_kernel`` (entry ``decode_attention``) for the dense cache
of any of the three types (q and the output stay bf16) and the packed int8 cache (words ``[(L,) B, Hkv, S/4, D]`` int32 and
scales ``[(L,) B, 4, Hkv, S/4]`` bf16, see ``kernels/kv_append.py``), and for
their paged forms: with ``page_table`` int32 ``[B, P]`` the k/v operands are
page pools ``[(L,) n_pages, Hkv, psz(/4), D]`` (scale pools
``[(L,) n_pages, 4, Hkv, psz/4]``) that the kernel reads in place, looking each
page up as it walks a slot's positions.

On the card one launch a layer writes the new rows (``kv_new``), attends and
combines the splits, as the TPU kernel writes the new row inside itself.  The
launch counts under its form's name (``common.launches["decode_attention*"]``:
``decode_attention`` for bf16 rows, ``_f16``, ``_f32``, ``_int8``, each with
``_paged``) and, with ``kv_new``, under the fused append's
(``"kv_append*_fused"``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.kv_append import (
    _unpack_kv_words,
    append_name,
    check_cache,
    check_pool,
    gather_pages,
    kv_append_dense,
    kv_append_packed,
    new_rows,
    stacked_view,
)

NEG_INF = -1e30
# Cache positions a thread block takes (split-KV), in tiles of TILE positions.
# A multiple of TILE, and of 4, so that a packed int8 word lies in one split.
SPLIT_LEN = 256
TILE = 64


def _kernel_name(int8: bool, paged: bool, dtype=torch.bfloat16) -> str:
    """The counter of a form; ``dtype`` is a dense cache's row type."""
    form = "_int8" if int8 else common.dense_suffix(dtype)
    return "decode_attention" + form + ("_paged" if paged else "")


def n_splits(S: int) -> int:
    """Blocks of the kernel's grid a (slot, kv head): splits of ``SPLIT_LEN``
    positions over the slot's ``S``."""
    return -(-S // SPLIT_LEN)


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
    if q.is_cuda:
        common.count_plain(_kernel_name(int8, page_table is not None,
                                        None if int8 else k.dtype), q)
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
    q: torch.Tensor,  # [B, H, D] bf16
    k: torch.Tensor,  # [B, Hkv, S, D] bf16/fp16/f32, or [L, B, Hkv, S, D] with layer_idx
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
    first (in place, positions >= S write nothing).  For a dense cache it is
    ``(k_new [B, Hkv, D] bf16, v_new, positions [B])``, the rows cast to the
    cache's type, and the result ``(out, k, v)``; for the int8 cache ``(kq [B, Hkv, D] biased int32, vq,
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
    if q.is_cuda:
        out = _launch(q, k_all, v_all, ks_all, vs_all, lengths, li, window, page_table, kv_new)
    else:
        if kv_new is not None and int8:
            kv_append_packed(k_all, v_all, ks_all, vs_all, *kv_new, li, page_table)
        elif kv_new is not None:
            kv_append_dense(k_all, v_all, *kv_new, li, page_table)
        scales = (ks_all[li], vs_all[li]) if int8 else (None, None)
        out = decode_attention_reference(q, k_all[li], v_all[li], lengths, window, *scales,
                                         page_table=page_table)
    if kv_new is None:
        return out
    return (out, k, v, k_scale, v_scale) if int8 else (out, k, v)


@functools.lru_cache(maxsize=32)
def _stream_workspace(device: torch.device, stream: int, B: int, H: int, Hkv: int,
                      n_split: int, D: int):
    return (torch.empty(B * H * n_split * (D + 2), dtype=torch.float32, device=device),
            torch.zeros(B * Hkv, dtype=torch.int32, device=device))


def _workspace(q: torch.Tensor, B: int, H: int, Hkv: int, n_split: int, D: int):
    """The split partials and the tickets of the combine: made once per
    (device, stream, shape) and reused, since the kernel sets every counter
    back to 0 and the calls of one stream are ordered; calls on different
    streams may be in flight together and each stream has its own.  A call
    that a CUDA graph captures may be replayed on any stream, so it makes a
    workspace of its own inside the graph."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(B * H * n_split * (D + 2), dtype=torch.float32, device=q.device),
                torch.zeros(B * Hkv, dtype=torch.int32, device=q.device))
    return _stream_workspace(q.device, common.stream_ptr(q), B, H, Hkv, n_split, D)


def _launch(q, k, v, ks, vs, lengths, layer_idx, window, page_table=None, kv_new=None):
    req = common.require
    int8, paged = ks is not None, page_table is not None
    B, H, D = q.shape
    if paged:
        L, n_pages, Hkv, psz, Dc, Bc, P = check_pool(k, v, page_table, ks, vs)
        S = P * psz
    else:
        L, Bc, Hkv, S, Dc = check_cache(k, v, ks, vs)
        psz, n_pages = S, Bc
    req(Bc == B and Dc == D and k.device == q.device,
        f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    req(0 <= layer_idx < L, f"layer {layer_idx} outside [0, {L})")
    req(D in (64, 128, 256), f"head_dim {D} not in (64, 128, 256)")
    req(H % Hkv == 0 and H // Hkv <= 8, f"H={H}, Hkv={Hkv}: GQA ratio must be <= 8")
    req(q.dtype == torch.bfloat16, "q must be bf16")
    req(lengths.shape == (B,), "lengths must be [B]")
    dev, dtype = q.device, k.dtype  # dtype: a dense cache's rows (int32 for int8)
    inp = lambda t, dtypes: common.kernel_input(t, dtypes, dev)
    idx = (torch.int64, torch.int32)  # the kernel reads either as it comes
    q, lens = inp(q, (torch.bfloat16,)), inp(lengths, idx)
    flags = int(lens.dtype == torch.int64)
    new = [None] * 5  # positions, k_new, v_new, ks_new, vs_new
    if kv_new is not None:
        *rows, positions = kv_new
        req(positions.shape == (B,), "positions must be [B]")
        for t in rows[:2]:
            req(t.shape == (B, Hkv, D) and not (int8 and t.dtype.is_floating_point),
                f"new rows must be [{B}, {Hkv}, {D}]" + (", integers" if int8 else ""))
        if int8:
            new[1:3] = [inp(t, (torch.int32,)) for t in rows[:2]]
        else:
            new[1:3] = new_rows(*rows[:2], dtype, dev)
        new[0] = inp(positions, idx)
        flags |= 2 * int(new[0].dtype == torch.int64)
        if int8:
            for t in rows[2:]:
                req(t.shape == (B, Hkv), f"new scales must be [{B}, {Hkv}]")
            # f32 or bf16 scales as they come: the kernel rounds f32 to bf16
            bf16 = rows[2].dtype == rows[3].dtype == torch.bfloat16
            new[3:] = [inp(t, (torch.bfloat16 if bf16 else torch.float32,)) for t in rows[2:]]
            flags |= 4 * int(not bf16)
    n_split = n_splits(S)
    part, counters = _workspace(q, B, H, Hkv, n_split, D)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    name = _kernel_name(int8, paged, dtype)
    err = common.lib().xb_decode_attention(
        q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(),
        ptr(ks[layer_idx]) if int8 else None, ptr(vs[layer_idx]) if int8 else None,
        lens.data_ptr(), ptr(new[0]), ptr(page_table), *[ptr(t) for t in new[1:]],
        part.data_ptr(), counters.data_ptr(), out.data_ptr(), B, H, Hkv, S, psz, n_pages, D,
        n_split, SPLIT_LEN, window or 0, flags, 0 if int8 else common.DENSE_KV[dtype],
        float(D) ** -0.5, common.stream_ptr(q))
    common.check(err, name)
    common.launches[name] += 1
    if kv_new is not None:
        common.launches[append_name(int8, paged, dtype) + "_fused"] += 1
    return out
