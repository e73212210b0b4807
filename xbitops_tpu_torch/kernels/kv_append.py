"""In-place KV append into the head-major bf16 cache: the CUDA kernel
(``csrc/kv_append.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``xbitops_tpu/kernels/kv_append.py:_kernel_dense``
(entry ``kv_append_dense``).  Unlike the JAX function, which returns new
arrays, this writes into ``k_all`` / ``v_all`` in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from xbitops_tpu_torch.kernels import common


def kv_append_dense_reference(
    k_all, v_all, k_new, v_new, positions, layer: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kv_append_dense` (in place, same guards)."""
    common.count_plain("kv_append", k_all)
    L, B, Hkv, S, D = k_all.shape
    pos = positions.long()
    ok = (pos >= 0) & (pos < S)
    slot, pos = torch.arange(B, device=k_all.device)[ok], pos[ok]
    h = torch.arange(Hkv, device=k_all.device)
    idx = (slot[:, None], h[None, :], pos[:, None])
    k_all[layer].index_put_(idx, k_new[ok].to(k_all.dtype))
    v_all[layer].index_put_(idx, v_new[ok].to(v_all.dtype))
    return k_all, v_all


def kv_append_dense(
    k_all: torch.Tensor,  # [L, B, Hkv, S, D] bf16
    v_all: torch.Tensor,
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    positions: torch.Tensor,  # int [B]; outside [0, S) writes nothing
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write row ``positions[b]`` of slot ``b`` in layer ``layer``, in place;
    returns ``(k_all, v_all)``.  Slots whose position lies outside ``[0, S)``
    write nothing.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if not k_all.is_cuda:
        return kv_append_dense_reference(k_all, v_all, k_new, v_new, positions, layer)
    req = common.require
    L, B, Hkv, S, D = k_all.shape
    req(0 <= layer < L, f"layer {layer} outside [0, {L})")
    for t in (k_all, v_all):
        req(t.dtype == torch.bfloat16 and t.is_contiguous() and t.shape == k_all.shape
            and t.device == k_all.device, "k/v caches: contiguous bf16 [L, B, Hkv, S, D]")
    for t in (k_new, v_new):
        req(t.shape == (B, Hkv, D) and t.device == k_all.device,
            f"new rows must be [{B}, {Hkv}, {D}] on the cache's device")
    req(positions.shape == (B,), "positions must be [B]")
    k_new = k_new.to(torch.bfloat16).contiguous()
    v_new = v_new.to(torch.bfloat16).contiguous()
    pos = positions.to(device=k_all.device, dtype=torch.int32).contiguous()
    err = common.lib().xb_kv_append(
        k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), B, Hkv, S, D,
        common.stream_ptr(k_all),
    )
    common.check(err, "kv_append")
    common.launches["kv_append"] += 1
    return k_all, v_all
