"""In-place KV append into the head-major cache, dense (bf16, fp16 or f32 rows)
and packed int8: the CUDA kernels (``csrc/kv_append.cu``) and their plain
PyTorch versions.

Replaces the Pallas kernels ``xbitops_tpu/kernels/kv_append.py:_kernel_dense``
(entry ``kv_append_dense``) and ``:_kernel`` (entry ``kv_append_packed``).
Unlike the JAX functions, which return new arrays, these write into the cache
tensors in place.  A decode step through the decode-attention kernel writes
its new rows inside that kernel (``kernels/decode_attention.py``, ``kv_new``);
these serve the one-row writes of a step that attends eagerly.

The packed int8 cache: words ``[L, B, Hkv, S/4, D]`` int32, byte ``j`` of word
``w`` holding position ``4w + j`` as its quantized value + 128, and per
(position, head) scales ``[L, B, 4, Hkv, S/4]`` bf16 with
``scales[l, b, j, h, w]`` the scale of position ``4w + j``.  The helpers that
quantize, pack and unpack that layout are here too (plain PyTorch, as the JAX
package left them to XLA).

The dense cache's rows are bf16, fp16 or f32, as the JAX package's
``KVCache.init(dtype=)`` builds them; new rows come as bf16 (the model's
activations), and the kernel casts them to it as ``.astype`` casts.

The paged cache: k/v are page pools ``[L, n_pages, Hkv, psz, D]`` (int8:
words ``[L, n_pages, Hkv, psz/4, D]`` and scale pools
``[L, n_pages, 4, Hkv, psz/4]``) shared by the slots, and ``page_table`` int32
``[B, P]`` gives the pool page of each slot's page (-1: none).  Position ``p``
of slot ``b`` lies in page ``page_table[b, p // psz]`` at row ``p % psz``.  With
``page_table`` the two appends write there (the JAX package left these writes
to XLA scatters, ``models/llama.py:_paged_word``); a position without a page
writes nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xbitops_tpu_torch.kernels import common


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 quantization of x [..., D] (the model's [B, T, H, D]) over
    its last axis, per (token, head): returns the values BIASED by +128
    (1..255) as int32 and the f32 scales [...]."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int32)
    return q + 128, s


def _pack_kv_words(q: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] biased byte values -> head-major words [B, H, T/4, D]
    int32 (byte j of word w = position 4w + j)."""
    B, T, H, D = q.shape
    qb = (q & 255).transpose(1, 2).reshape(B, H, T // 4, 4, D)
    # byte 3 lands in the sign bits: int32 shifts wrap, as the JAX ones do
    return qb[..., 0, :] | (qb[..., 1, :] << 8) | (qb[..., 2, :] << 16) | (qb[..., 3, :] << 24)


def _pack_kv_scales(s: torch.Tensor) -> torch.Tensor:
    """[B, T, H] per-position scales -> [B, 4, H, T/4] with
    ``out[b, j, h, w] = s[b, 4w + j, h]``."""
    B, T, H = s.shape
    return s.reshape(B, T // 4, 4, H).permute(0, 2, 3, 1)


def _unpack_kv_words(words: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Packed words [..., H, W, D] and scales [..., 4, H, W] -> dequantized
    head-major [..., H, 4W, D] f32."""
    parts = [((words >> (8 * j)) & 255) - 128 for j in range(4)]  # & 255 drops the sign fill
    q = torch.stack(parts, dim=-2)  # [..., H, W, 4, D]
    sc = scales.movedim(-3, -1)  # [..., H, W, 4]
    deq = q.float() * sc.float()[..., None]
    return deq.reshape(*words.shape[:-2], -1, words.shape[-1])


def stacked_view(k, v, k_scale, v_scale, layer_idx, window, page_table=None):
    """What the attention entries share: a flat cache gets a leading layer
    axis of 1, and a window is checked and dropped when it covers the whole
    cache (for a pool: a slot's ``P * psz`` positions).  Returns
    ``(k_all, v_all, ks_all, vs_all, layer, window)``."""
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError("k_scale and v_scale go together")
    if layer_idx is None:
        k, v = k[None], v[None]
        if int8:
            k_scale, v_scale = k_scale[None], v_scale[None]
    if window is not None:
        if window < 1:
            raise ValueError("sliding window must be >= 1")
        pages = 1 if page_table is None else page_table.shape[1]
        if window >= pages * k.shape[3] * (4 if int8 else 1):
            window = None
    return k, v, k_scale, v_scale, layer_idx or 0, window


def check_cache(k_all, v_all, ks_all=None, vs_all=None):
    """Reject a stacked cache the kernels do not take; returns
    ``(L, B, Hkv, S, D)`` with S in positions.  Rows [L, B, Hkv, S, D] of
    bf16, fp16 or f32 (k and v of one type), or with scales the packed int8
    form.  A kernel reads one layer, so each layer must be contiguous, not the
    stack: a range of slots of every layer (``cache.k[:, lo:hi]``, a pipeline
    stage's microbatch) is taken."""
    req = common.require
    int8 = ks_all is not None
    L, B, Hkv, rows, D = k_all.shape
    if not int8:
        common.check_kv_dtype(k_all.dtype)
    for t in (k_all, v_all):
        req(t.dtype == (torch.int32 if int8 else k_all.dtype) and t[0].is_contiguous()
            and t.shape == k_all.shape and t.device == k_all.device,
            "k/v caches: int32 words [L, B, Hkv, S/4, D], each layer contiguous" if int8
            else "k/v caches: one dtype, [L, B, Hkv, S, D], each layer contiguous")
    if int8:
        for t in (ks_all, vs_all):
            req(t is not None and t.dtype == torch.bfloat16 and t[0].is_contiguous()
                and t.shape == (L, B, 4, Hkv, rows) and t.device == k_all.device,
                f"k/v scales: bf16 [{L}, {B}, 4, {Hkv}, {rows}], each layer contiguous")
    return L, B, Hkv, rows * (4 if int8 else 1), D


def check_pool(k_all, v_all, page_table, ks_all=None, vs_all=None):
    """:func:`check_cache` for a stacked page pool and its table; returns
    ``(L, n_pages, Hkv, psz, D, B, P)`` with psz in positions."""
    L, n_pages, Hkv, psz, D = check_cache(k_all, v_all, ks_all, vs_all)
    common.require(
        page_table.dim() == 2 and page_table.dtype == torch.int32 and page_table.is_contiguous()
        and page_table.device == k_all.device and page_table.shape[1] >= 1 and n_pages >= 1,
        "page_table: contiguous int32 [B, P] on the pool's device")
    return L, n_pages, Hkv, psz, D, page_table.shape[0], page_table.shape[1]


def paged_rows(page_table, slots, pos, psz: int, n_pages: int):
    """Where positions ``pos`` (int [n] or [n, T]) of table rows ``slots``
    [n] lie in a pool of ``n_pages`` pages of ``psz`` positions: ``(ok, page,
    row)``, each shaped like ``pos``.  ``ok`` is False where the slot is out of
    range, the position outside ``[0, P * psz)`` or the slot has no page there;
    ``page`` and ``row`` are in range everywhere, so they may index before
    ``ok`` selects."""
    B, P = page_table.shape
    slots, pos = slots.long(), pos.long()
    if pos.dim() == 2:
        slots = slots[:, None].expand_as(pos)
    ok = (slots >= 0) & (slots < B) & (pos >= 0) & (pos < P * psz)
    page = page_table[slots.clamp(0, B - 1), (pos // psz).clamp(0, P - 1)].long()
    ok &= (page >= 0) & (page < n_pages)
    return ok, page.clamp(0, n_pages - 1), pos.clamp(min=0) % psz


def gather_pages(pool, page_table, scales: bool = False):
    """A slot's pages side by side, as the linear cache would hold them: one
    layer's pool ``[n_pages, Hkv, R, D]`` -> ``[n, Hkv, P * R, D]`` for the
    table rows ``page_table`` [n, P], or with ``scales`` a scale pool
    ``[n_pages, 4, Hkv, R]`` -> ``[n, 4, Hkv, P * R]``.  An entry outside
    ``[0, n_pages)`` (-1: no page) reads page 0 or the last one; such rows lie
    past the slot's length."""
    got = pool[page_table.long().clamp(0, pool.shape[0] - 1)]  # [n, P, ...]
    n = got.shape[0]
    if scales:
        return got.movedim(1, 3).reshape(n, 4, pool.shape[2], -1)
    return got.movedim(1, 2).reshape(n, pool.shape[1], -1, pool.shape[3])


def append_name(int8: bool, paged: bool, dtype=torch.bfloat16) -> str:
    """The launch counter of an append form: ``kv_append`` (bf16 rows),
    ``kv_append_f16``, ``kv_append_f32``, ``kv_append_packed``, and each with
    ``_paged``; ``dtype`` is a dense cache's row type."""
    form = "_packed" if int8 else common.dense_suffix(dtype)
    return "kv_append" + form + ("_paged" if paged else "")


def new_rows(k_new: torch.Tensor, v_new: torch.Tensor, dtype, device):
    """New dense rows as the kernels read them: bf16, which the kernel casts to
    the cache's ``dtype``.  Rows of another type go only into a bf16 cache
    (cast to bf16 first, as the plain version casts them); into an fp16 or f32
    cache they would be rounded to bf16 on the way, so they are refused."""
    for t in (k_new, v_new):
        common.require(t.dtype == torch.bfloat16 or dtype == torch.bfloat16,
                       f"new rows into a {dtype} cache must be bf16, not {t.dtype}")
    return tuple(common.kernel_input(t, (torch.bfloat16,), device) for t in (k_new, v_new))


def kv_append_dense_reference(
    k_all, v_all, k_new, v_new, positions, layer: int, page_table=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kv_append_dense` (in place, same guards)."""
    if k_all.is_cuda:
        common.count_plain(append_name(False, page_table is not None, k_all.dtype), k_all)
    L, B, Hkv, S, D = k_all.shape
    pos = positions.long()
    if page_table is None:
        ok = (pos >= 0) & (pos < S)
        slot = torch.arange(B, device=k_all.device)
    else:  # B counts pages and S the positions of one
        ok, slot, pos = paged_rows(page_table, torch.arange(pos.shape[0], device=pos.device),
                                   pos, S, B)
    slot, pos = slot[ok], pos[ok]
    h = torch.arange(Hkv, device=k_all.device)
    idx = (slot[:, None], h[None, :], pos[:, None])
    k_all[layer].index_put_(idx, k_new[ok].to(k_all.dtype))
    v_all[layer].index_put_(idx, v_new[ok].to(v_all.dtype))
    return k_all, v_all


def kv_append_dense(
    k_all: torch.Tensor,  # [L, B, Hkv, S, D] bf16, fp16 or f32
    v_all: torch.Tensor,
    k_new: torch.Tensor,  # [B, Hkv, D] bf16, cast to the cache's type
    v_new: torch.Tensor,
    positions: torch.Tensor,  # int [B]; outside [0, S) writes nothing
    layer: int,
    page_table: Optional[torch.Tensor] = None,  # int32 [B, P]: k/v are page pools
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write row ``positions[b]`` of slot ``b`` in layer ``layer``, in place,
    cast to the cache's type (bf16, fp16 or f32); returns ``(k_all, v_all)``.
    Slots whose position lies outside ``[0, S)`` write nothing.  With ``page_table``, k/v are pools
    ``[L, n_pages, Hkv, psz, D]`` and the row goes to page
    ``page_table[b, pos // psz]``; a slot with no page there writes nothing.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if not k_all.is_cuda:
        return kv_append_dense_reference(k_all, v_all, k_new, v_new, positions, layer,
                                         page_table)
    req = common.require
    if page_table is None:
        L, B, Hkv, S, D = check_cache(k_all, v_all)
    else:
        L, n_pages, Hkv, psz, D, B, P = check_pool(k_all, v_all, page_table)
    req(0 <= layer < L, f"layer {layer} outside [0, {L})")
    for t in (k_new, v_new):
        req(t.shape == (B, Hkv, D) and t.device == k_all.device,
            f"new rows must be [{B}, {Hkv}, {D}] on the cache's device")
    req(positions.shape == (B,), "positions must be [B]")
    req(D % 8 == 0, f"head_dim {D}: rows move in 16-byte pieces")
    dev, dtype = k_all.device, k_all.dtype
    k_new, v_new = new_rows(k_new, v_new, dtype, dev)
    pos = common.kernel_input(positions, (torch.int64, torch.int32), dev)  # read as it comes
    head = (k_all[layer].data_ptr(), v_all[layer].data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), common.DENSE_KV[dtype], pos.data_ptr(),
            int(pos.dtype == torch.int64))
    name = append_name(False, page_table is not None, dtype)
    if page_table is None:
        err = common.lib().xb_kv_append(*head, B, Hkv, S, D, common.stream_ptr(k_all))
    else:
        err = common.lib().xb_kv_append_paged(
            *head, page_table.data_ptr(), P, n_pages, B, Hkv, psz, D, common.stream_ptr(k_all))
    common.check(err, name)
    common.launches[name] += 1
    return k_all, v_all


def _rmw_packed(k_all, v_all, ks_all, vs_all, kq, vq, ks, vs, positions, layer, slots=None,
                page_table=None):
    """Read-modify-write byte ``pos % 4`` of word ``pos // 4`` and set the
    scale of that position, for each new row: row i goes to slot ``slots[i]``
    (default i), or with ``page_table`` to that slot's page of the pools.
    Rows whose slot or position is out of range, or that have no page, write
    nothing."""
    L, B, Hkv, Sw, D = k_all.shape
    dev = k_all.device
    pos = positions.long()
    slot = torch.arange(pos.shape[0], device=dev) if slots is None else slots.long()
    if page_table is None:
        ok = (pos >= 0) & (pos < Sw * 4) & (slot >= 0) & (slot < B)
    else:  # B counts pages and Sw the words of one
        ok, slot, pos = paged_rows(page_table, slot, pos, Sw * 4, B)
    slot, pos = slot[ok], pos[ok]
    h = torch.arange(Hkv, device=dev)
    idx = (slot[:, None], h[None, :], (pos // 4)[:, None])
    sh = ((pos % 4) * 8).to(torch.int32)[:, None, None]
    keep = ~(torch.tensor(255, dtype=torch.int32, device=dev) << sh)
    for words, new in ((k_all[layer], kq), (v_all[layer], vq)):
        merged = (words[idx] & keep) | ((new[ok].to(torch.int32) & 255) << sh)
        words.index_put_(idx, merged)
    sidx = (slot[:, None], (pos % 4)[:, None], h[None, :], (pos // 4)[:, None])
    ks_all[layer].index_put_(sidx, ks[ok].to(ks_all.dtype))
    vs_all[layer].index_put_(sidx, vs[ok].to(vs_all.dtype))
    return k_all, v_all, ks_all, vs_all


def kv_append_packed_reference(k_all, v_all, ks_all, vs_all, kq, vq, ks, vs, positions,
                               layer: int, page_table=None):
    """Plain version of :func:`kv_append_packed` (in place, same guards)."""
    common.count_plain(append_name(True, page_table is not None), k_all)
    return _rmw_packed(k_all, v_all, ks_all, vs_all, kq, vq, ks, vs, positions, layer,
                       page_table=page_table)


def kv_append_packed(
    k_all: torch.Tensor,  # [L, B, Hkv, S/4, D] int32 words of biased bytes
    v_all: torch.Tensor,
    ks_all: torch.Tensor,  # [L, B, 4, Hkv, S/4] bf16
    vs_all: torch.Tensor,
    kq: torch.Tensor,  # [B, Hkv, D] int32 biased byte values (1..255)
    vq: torch.Tensor,
    ks: torch.Tensor,  # [B, Hkv] new scales
    vs: torch.Tensor,
    positions: torch.Tensor,  # int [B]; outside [0, S) writes nothing
    layer: int,
    page_table: Optional[torch.Tensor] = None,  # int32 [B, P]: the four are page pools
):
    """Write position ``positions[b]`` of slot ``b`` in layer ``layer`` of the
    packed int8 cache, in place: one byte of each (head, dim) word, the other
    three kept, and the position's two scales.  Returns the four cache tensors.
    With ``page_table`` they are pools (words ``[L, n_pages, Hkv, psz/4, D]``,
    scales ``[L, n_pages, 4, Hkv, psz/4]``) and the byte goes to page
    ``page_table[b, pos // psz]``; a slot with no page there writes nothing.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if not k_all.is_cuda:
        return kv_append_packed_reference(
            k_all, v_all, ks_all, vs_all, kq, vq, ks, vs, positions, layer, page_table)
    req = common.require
    if page_table is None:
        L, B, Hkv, S, D = check_cache(k_all, v_all, ks_all, vs_all)
    else:
        L, n_pages, Hkv, S, D, B, P = check_pool(k_all, v_all, page_table, ks_all, vs_all)
    dev = k_all.device
    req(0 <= layer < L, f"layer {layer} outside [0, {L})")
    for t in (kq, vq):
        req(t.shape == (B, Hkv, D) and t.device == dev and not t.dtype.is_floating_point,
            f"new values must be integers [{B}, {Hkv}, {D}] on the cache's device")
    for t in (ks, vs):
        req(t.shape == (B, Hkv) and t.device == dev,
            f"new scales must be [{B}, {Hkv}] on the cache's device")
    req(positions.shape == (B,), "positions must be [B]")
    req(D % 4 == 0, f"head_dim {D}: a word row moves in 16-byte pieces")
    # as they come, where the kernel reads them so (as `_new_row` makes them,
    # nothing runs on the card before the kernel): int32 values, f32 or bf16
    # scales (rounded to bf16 inside), int32 or int64 positions
    kq, vq = (common.kernel_input(t, (torch.int32,), dev) for t in (kq, vq))
    bf16 = ks.dtype == vs.dtype == torch.bfloat16
    ks, vs = (t.to(device=dev, dtype=torch.bfloat16 if bf16 else torch.float32).contiguous()
              for t in (ks, vs))
    pos = positions.to(device=dev, dtype=positions.dtype if positions.dtype in (
        torch.int32, torch.int64) else torch.int64).contiguous()
    head = (k_all[layer].data_ptr(), v_all[layer].data_ptr(), ks_all[layer].data_ptr(),
            vs_all[layer].data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(), vs.data_ptr(),
            int(not bf16), pos.data_ptr(), int(pos.dtype == torch.int64))
    name = append_name(True, page_table is not None)
    if page_table is None:
        err = common.lib().xb_kv_append_packed(*head, B, Hkv, S // 4, D,
                                               common.stream_ptr(k_all))
    else:
        err = common.lib().xb_kv_append_packed_paged(
            *head, page_table.data_ptr(), P, n_pages, B, Hkv, S // 4, D,
            common.stream_ptr(k_all))
    common.check(err, name)
    common.launches[name] += 1
    return k_all, v_all, ks_all, vs_all
