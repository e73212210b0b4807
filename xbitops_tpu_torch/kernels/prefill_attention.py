"""Chunked-prefill attention: a chunk of queries against the cache rows of
their slots, causal by global position, over the bf16 or the packed int8
cache: the CUDA kernel (``csrc/prefill_attention.cu``) and its plain PyTorch
version.

Replaces the Pallas kernels ``xbitops_tpu/kernels/prefill_attention.py``
``_kernel_v2`` and ``_kernel_v1`` (entry ``prefill_attention``).  The chunk's
own rows must already be in the cache when it runs: the model writes k/v
before it attends, so the chunk's queries see themselves and each other
through the cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.kv_append import (
    _unpack_kv_words,
    check_cache,
    stacked_view,
)

NEG_INF = -1e30


def prefill_attention_reference(q, k, v, positions, slot_ids, k_scale=None, v_scale=None,
                                window: Optional[int] = None):
    """Plain version, in f32, over ONE layer's cache: k/v [B, Hkv, S, D], or
    with ``k_scale``/``v_scale`` [B, 4, Hkv, S/4] the packed int8 words
    [B, Hkv, S/4, D], dequantized first.  It reads every row of the slots and
    forms the [N, H, T, S] probabilities, which the kernel never does."""
    common.count_plain("prefill_attention", q)
    N, T, H, D = q.shape
    rows = slot_ids.long().clamp(0, k.shape[0] - 1)
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
    q: torch.Tensor,  # [N, T, H, D] chunk queries
    k: torch.Tensor,  # [(L,) B, Hkv, S, D] bf16, or int8 words [(L,) B, Hkv, S/4, D]
    v: torch.Tensor,
    positions: torch.Tensor,  # int [N, T] global positions; outside [0, S): padding
    slot_ids: torch.Tensor,  # int [N] cache slot of each row (clamped into [0, B))
    layer_idx: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [(L,) B, 4, Hkv, S/4]: int8 cache
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``out[n, t]`` attends the cache positions ``s <= positions[n, t]``
    (and ``s > positions[n, t] - window`` with a window) of slot
    ``slot_ids[n]``, layer ``layer_idx`` of a stacked cache.  Query head
    ``h*rep + r`` uses kv head ``h``.  A padding query returns exact zeros,
    wherever in the chunk it sits; a row of nothing but padding (an inert row,
    whatever its slot id) reads nothing.  Returns [N, T, H, D] in q's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    int8 = k_scale is not None
    k_all, v_all, ks_all, vs_all, li, window = stacked_view(
        k, v, k_scale, v_scale, layer_idx, window)
    if not q.is_cuda:
        scales = (ks_all[li], vs_all[li]) if int8 else (None, None)
        return prefill_attention_reference(
            q, k_all[li], v_all[li], positions, slot_ids, *scales, window=window)

    req = common.require
    N, T, H, D = q.shape
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
    err = common.lib().xb_prefill_attention(
        q.data_ptr(), k_all[li].data_ptr(), v_all[li].data_ptr(),
        ks_all[li].data_ptr() if int8 else None, vs_all[li].data_ptr() if int8 else None,
        pos.data_ptr(), slots.data_ptr(), out.data_ptr(), N, T, H, Hkv, B, S, D,
        window or 0, float(D) ** -0.5, common.stream_ptr(q),
    )
    common.check(err, "prefill_attention")
    common.launches["prefill_attention"] += 1
    return out
