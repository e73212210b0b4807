"""The packed quantized-weight layout (format v3), in PyTorch.

This is the same layout the JAX package packs (``xbitops_tpu/formats.py``), read
as it is so one conversion serves both packages:

- each b-bit value splits into bit-planes of power-of-two widths
  (``PLANE_DECOMP``); every plane packs ``32/pb`` values per int32 word;
- a 4-bit plane is PAIRED when :func:`paired_ok` holds: within a K-tile, local
  row ``kl = j*(tile_k/4) + 2r + h`` sits at bit ``4j + 16h`` of word row ``r``;
- every other plane is slot-strided: with ``ratio = 32/pb`` and
  ``wt = tile_k/ratio``, local row ``kl`` sits in slot ``j = kl // wt`` (bits
  ``pb*j``) of word row ``kl % wt``;
- scales and scale-zeros are stored per K-tile as ``[K/tile_k, gt_pad, N]``
  (``gt = max(1, tile_k/group_size)`` rows used, padded to a multiple of 8),
  as float16 or float32.  The JAX package keeps fp16 scales as int16 bit
  patterns (its kernels cannot load fp16); here they are plain float16
  tensors (``int16_tensor.view(torch.float16)`` at conversion).

The dequantized value is ``w[k, n] = wq[k, n] * s - sz`` with ``s``/``sz`` the
scale row of ``k``'s group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "PLANE_DECOMP",
    "QTensor",
    "default_tile_k",
    "paired_ok",
    "pack_planes",
    "unpack_planes_reference",
    "tile_scales",
    "dequant_qtensor_reference",
]

# Bit-plane decomposition of every supported width; value = sum(plane_j << off_j).
PLANE_DECOMP: dict[int, Tuple[int, ...]] = {
    1: (1,),
    2: (2,),
    3: (2, 1),
    4: (4,),
    5: (4, 1),
    6: (4, 2),
    7: (4, 2, 1),
    8: (8,),
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def min_tile_k(bits: int) -> int:
    """Smallest K-tile the JAX kernels take for ``bits``."""
    return 8 * (32 // min(PLANE_DECOMP[bits]))


def default_tile_k(K: int, group_size: int, bits: int = 1) -> int:
    """The JAX package's K-tile choice (``formats.default_tile_k``), so that
    weights packed by either package agree: prefer ``(32 / narrowest plane)
    * group_size`` rows when padding K up to it wastes at most 1/8 of K, else
    the largest group-compatible tile."""
    floor = min_tile_k(bits)
    aligned = (32 // min(PLANE_DECOMP[bits])) * group_size
    if aligned % floor == 0 and aligned <= 4096 and (_round_up(K, aligned) - K) * 8 <= K:
        return aligned

    def nests(c):
        return c % group_size == 0 or group_size % c == 0

    cands = [c for c in (1024, 512, 256, 128, 64, 32) if c >= floor]
    for c in cands:
        if K % c == 0 and nests(c):
            return c
    for c in cands:
        if nests(c):
            return c
    return math.lcm(group_size, floor)


def paired_plane_layout(bits: int) -> bool:
    """True when ``bits``' first (low) plane is the 4-bit plane."""
    return PLANE_DECOMP[bits][0] == 4


def paired_ok(bits: int, tile_k: int, group_size: int) -> bool:
    """Whether this (bits, tile_k, group_size) stores its 4-bit plane PAIRED.

    A pure function of the static metadata, exactly the JAX package's rule
    (``xbitops_tpu/formats.py:paired_ok``): group sizes that are not
    multiples of 16 keep the slot layout."""
    if not paired_plane_layout(bits):
        return False
    gt = max(1, tile_k // group_size)
    g_tile = tile_k // gt
    ph = tile_k // 4  # K rows per pair slot
    cs = min(ph, g_tile)
    for pb in PLANE_DECOMP[bits][1:]:
        cs = min(cs, tile_k // (32 // pb))
    if cs % 16 or ph % cs or g_tile % cs:
        return False
    return all((tile_k // (32 // pb)) % cs == 0 for pb in PLANE_DECOMP[bits][1:])


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns -> int32 (two's-complement wrap)."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_plane(vals: torch.Tensor, pb: int, tile_k: int) -> torch.Tensor:
    """Values ``[K, N]`` (< 2**pb) -> slot-strided words ``int32[K/(32/pb), N]``."""
    K, N = vals.shape
    ratio = 32 // pb
    if K % tile_k or tile_k % ratio:
        raise ValueError(f"K={K} and tile_k={tile_k} must be multiples of {ratio}")
    wt = tile_k // ratio
    v = vals.to(torch.int64).reshape(K // tile_k, ratio, wt, N)
    words = torch.zeros((K // tile_k, wt, N), dtype=torch.int64, device=vals.device)
    for j in range(ratio):
        words |= v[:, j] << (pb * j)
    return _to_int32(words.reshape(K // ratio, N))


def _pack_plane_paired(vals: torch.Tensor, tile_k: int) -> torch.Tensor:
    """4-bit values ``[K, N]`` -> PAIRED words ``int32[K/8, N]`` (module doc)."""
    K, N = vals.shape
    if K % tile_k or tile_k % 8:
        raise ValueError(f"K={K} and tile_k={tile_k} must be multiples of 8")
    wt = tile_k // 8
    v = vals.to(torch.int64).reshape(K // tile_k, 4, wt, 2, N)
    words = torch.zeros((K // tile_k, wt, N), dtype=torch.int64, device=vals.device)
    for j in range(4):
        for h in (0, 1):
            words |= v[:, j, :, h] << (4 * j + 16 * h)
    return _to_int32(words.reshape(K // 8, N))


def pack_planes(
    wq: torch.Tensor, bits: int, tile_k: int, paired: Optional[bool] = None
) -> Tuple[torch.Tensor, ...]:
    """Split integer values ``wq[K, N]`` into bit-planes and pack each.

    ``paired=None`` pairs whenever the width admits it; callers with a group
    size pass :func:`paired_ok`."""
    if paired is None:
        paired = paired_plane_layout(bits)
    planes = []
    shift = 0
    wq = wq.to(torch.int64)
    for pi, pb in enumerate(PLANE_DECOMP[bits]):
        pv = (wq >> shift) & ((1 << pb) - 1)
        if paired and pi == 0:
            planes.append(_pack_plane_paired(pv, tile_k))
        else:
            planes.append(_pack_plane(pv, pb, tile_k))
        shift += pb
    return tuple(planes)


def _unpack_plane(words: torch.Tensor, pb: int, tile_k: int) -> torch.Tensor:
    """Slot-strided words ``[K/ratio, N]`` -> values ``int64[K, N]``."""
    ratio = 32 // pb
    wt = tile_k // ratio
    N = words.shape[-1]
    w = words.to(torch.int64).reshape(-1, 1, wt, N)  # [T, 1, wt, N]
    shifts = (torch.arange(ratio, device=words.device) * pb).reshape(1, ratio, 1, 1)
    return ((w >> shifts) & ((1 << pb) - 1)).reshape(-1, N)


def _unpack_plane_paired(words: torch.Tensor, tile_k: int) -> torch.Tensor:
    """PAIRED 4-bit words ``[K/8, N]`` -> values ``int64[K, N]``."""
    wt = tile_k // 8
    N = words.shape[-1]
    w = words.to(torch.int64).reshape(-1, 1, wt, 1, N)  # [T, j, r, h, N]
    j = torch.arange(4, device=words.device).reshape(1, 4, 1, 1, 1)
    h = torch.arange(2, device=words.device).reshape(1, 1, 1, 2, 1)
    return ((w >> (4 * j + 16 * h)) & 15).reshape(-1, N)


def unpack_planes_reference(
    planes: Sequence[torch.Tensor], bits: int, tile_k: int, K: int,
    paired: Optional[bool] = None,
) -> torch.Tensor:
    """Reconstruct integer values ``int32[K, N]`` from packed planes."""
    if paired is None:
        paired = paired_plane_layout(bits)
    wq = None
    shift = 0
    for pi, (plane, pb) in enumerate(zip(planes, PLANE_DECOMP[bits])):
        if paired and pi == 0:
            vals = _unpack_plane_paired(plane, tile_k)
        else:
            vals = _unpack_plane(plane, pb, tile_k)
        vals = vals[:K] << shift
        wq = vals if wq is None else wq | vals
        shift += pb
    return wq.to(torch.int32)


@dataclasses.dataclass
class QTensor:
    """A packed quantized weight (layout in the module docstring).

    ``perm`` (act-order): row ``k`` of the stored tensor is row ``perm[k]`` of
    the logical one, so matmuls gather activations as ``a[..., perm]``.
    ``N_logical`` is the column count before lane padding (None = N).
    Arrays may carry a leading layer axis (stacked layers); ``qmatmul``'s
    ``layer=`` then picks one layer as a view.
    """

    planes: Tuple[torch.Tensor, ...]  # int32 [(L,) K/(32/pb), N] each
    scales: torch.Tensor  # float16 | float32 [(L,) K/tile_k, gt_pad, N]
    scale_zeros: torch.Tensor  # like scales; equals (z + bias) * s
    bits: int
    group_size: int
    tile_k: int
    K: int  # rows represented by `planes` (padded to a tile multiple)
    K_logical: int  # rows before padding
    perm: Optional[torch.Tensor] = None  # int64 [(L,) K_logical]
    N_logical: Optional[int] = None
    value_bits: Optional[int] = None

    @property
    def N(self) -> int:
        return self.planes[0].shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.K_logical, self.N_logical or self.N)

    @property
    def plane_bits(self) -> Tuple[int, ...]:
        return PLANE_DECOMP[self.bits]

    @property
    def groups_per_tile(self) -> int:
        """Scale rows used per K-tile (<= the padded row count)."""
        return max(1, self.tile_k // self.group_size)

    @property
    def paired(self) -> bool:
        return paired_ok(self.bits, self.tile_k, self.group_size)

    def layer(self, li: int) -> "QTensor":
        """Layer ``li`` of a stacked QTensor, as views (no copy)."""
        return dataclasses.replace(
            self,
            planes=tuple(p[li] for p in self.planes),
            scales=self.scales[li],
            scale_zeros=self.scale_zeros[li],
            perm=None if self.perm is None else self.perm[li],
        )

    def bytes_packed(self) -> int:
        """Device bytes one full pass over the weight reads."""
        n = sum(p.numel() * p.element_size() for p in self.planes)
        n += self.scales.numel() * self.scales.element_size()
        n += self.scale_zeros.numel() * self.scale_zeros.element_size()
        return n


def tile_scales(scales: torch.Tensor, tile_k: int, group_size: int, K: int) -> torch.Tensor:
    """Per-group scales ``[G, N]`` -> per-K-tile ``[K/tile_k, gt_pad, N]``."""
    G, N = scales.shape
    T = K // tile_k
    if tile_k % group_size == 0:
        gt = tile_k // group_size
        if G != T * gt:
            raise ValueError(f"{G} scale groups != {T} tiles x {gt}")
        out = scales.reshape(T, gt, N)
    else:
        if group_size % tile_k:
            raise ValueError(f"tile_k={tile_k} and group_size={group_size} do not nest")
        gt = 1
        idx = (torch.arange(T, device=scales.device) * tile_k) // group_size
        out = scales[idx].reshape(T, 1, N)
    gt_pad = _round_up(gt, 8)
    if gt_pad != gt:
        out = torch.nn.functional.pad(out, (0, 0, 0, gt_pad - gt))
    return out


def _expand_tiled_scales(ts: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Tiled scales ``[T, gt_pad, N]`` -> per-row ``float32[K, N]``."""
    gt = qt.groups_per_tile
    s = ts[:, :gt, :].float().reshape(-1, qt.N)
    return torch.repeat_interleave(s, qt.tile_k // gt, dim=0)


def dequant_qtensor_reference(qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``[K_logical, N_logical]`` weight in logical row order (the
    plain version every kernel of the port is checked against)."""
    wq = unpack_planes_reference(
        qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired
    ).float()
    w = wq * _expand_tiled_scales(qt.scales, qt) - _expand_tiled_scales(qt.scale_zeros, qt)
    w = w[: qt.K_logical, : qt.shape[1]]
    if qt.perm is not None:
        w = torch.zeros_like(w).index_copy_(0, qt.perm.long(), w)
    return w.to(out_dtype)
