"""Length-aware one-token (decode) attention over the head-major bf16 cache:
the CUDA kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces the Pallas kernels ``xbitops_tpu/kernels/decode_attention.py``
``_kernel_v2`` and ``_kernel`` (entry ``decode_attention``) for the dense bf16
cache; the int8 and paged forms are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.kv_append import kv_append_dense

NEG_INF = -1e30
SPLIT_LEN = 256  # cache positions per thread block (split-KV)


def decode_attention_reference(q, k, v, lengths, window: Optional[int] = None):
    """Plain version: softmax(q k^T / sqrt(D)) v over positions
    ``[max(0, len - window), len)`` of each slot, in f32.  q [B, H, D];
    k/v [B, Hkv, S, D] (one layer); returns [B, H, D] in q's dtype."""
    common.count_plain("decode_attention", q)
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
    kv_new=None,  # (k_new [B, Hkv, D], v_new, positions [B]): append first
    window: Optional[int] = None,
):
    """One-token attention of each slot over its first ``lengths[b]`` cache
    positions (of layer ``layer_idx`` of a stacked cache); returns [B, H, D].

    ``window``: attend only ``[max(0, len - window), len)``; a window that
    covers the whole cache is dropped.  ``kv_new``: write the new rows at
    ``positions`` into the cache first (in place, positions >= S write
    nothing) and return ``(out, k, v)`` -- k and v are the same tensors,
    updated.  A CPU tensor takes the plain versions; a CUDA tensor launches
    the kernels or raises."""
    k_all, v_all = (k[None], v[None]) if layer_idx is None else (k, v)
    li = layer_idx or 0
    S = k_all.shape[3]
    if window is not None:
        if window < 1:
            raise ValueError("sliding window must be >= 1")
        if window >= S:
            window = None
    if kv_new is not None:
        k_new, v_new, positions = kv_new
        kv_append_dense(k_all, v_all, k_new, v_new, positions, li)
    if not q.is_cuda:
        out = decode_attention_reference(q, k_all[li], v_all[li], lengths, window)
    else:
        out = _launch(q, k_all, v_all, lengths, li, window)
    return out if kv_new is None else (out, k, v)


def _launch(q, k, v, lengths, layer_idx, window):
    req = common.require
    B, H, D = q.shape
    L, Bc, Hkv, S, Dc = k.shape
    req(Bc == B and Dc == D, f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    req(0 <= layer_idx < L, f"layer {layer_idx} outside [0, {L})")
    req(D in (64, 128, 256), f"head_dim {D} not in (64, 128, 256)")
    req(H % Hkv == 0 and H // Hkv <= 8, f"H={H}, Hkv={Hkv}: GQA ratio must be <= 8")
    req(q.dtype == torch.bfloat16, "q must be bf16")
    q = q.contiguous()
    for t in (k, v):
        req(t.dtype == torch.bfloat16 and t.is_contiguous() and t.shape == k.shape
            and t.device == q.device, "k/v caches: contiguous bf16 [L, B, Hkv, S, D]")
    req(lengths.shape == (B,), "lengths must be [B]")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    n_split = -(-S // SPLIT_LEN)
    part_o = torch.empty((B, H, n_split, D), dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, H, n_split), dtype=torch.float32, device=q.device)
    part_l = torch.empty((B, H, n_split), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    err = common.lib().xb_decode_attention(
        q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(),
        lens.data_ptr(), part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, D, n_split, SPLIT_LEN, window or 0,
        float(D) ** -0.5, common.stream_ptr(q),
    )
    common.check(err, "decode_attention")
    common.launches["decode_attention"] += 1
    return out
