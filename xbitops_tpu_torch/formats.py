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

The GPTQ interchange layout is read and written here too (``gptq_pack``,
``gptq_unpack_*``, ``dequant_reference``, ``from_gptq``): ``qweight
int32[ceil(K*bits/32), N]`` packs values along K, low bits first, values
straddling words for widths that do not divide 32; ``qzeros int32[G,
ceil(N*bits/32)]`` packs zero-points along N; ``w = wq*s - (z + bias)*s``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "PLANE_DECOMP",
    "POW2_STORAGE",
    "AUTO_PAD_WIDTHS",
    "QTensor",
    "quantize",
    "gptq_pack",
    "gptq_unpack_weight",
    "gptq_unpack_zeros",
    "dequant_reference",
    "resolve_storage_bits",
    "default_tile_k",
    "paired_ok",
    "pack_planes",
    "unpack_planes_reference",
    "tile_scales",
    "make_qtensor",
    "make_row_sharded_qtensor",
    "row_shard_qtensor",
    "is_row_sharded",
    "from_gptq",
    "concat_qtensors",
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

# Storage-width policy: the quantized VALUES stay b-bit but may be STORED in
# the next power-of-two width's planes, trading bytes for a single-plane
# decode.  ``"auto"`` pads the widths in AUTO_PAD_WIDTHS; that set is the JAX
# package's, chosen by its timings on a TPU v5e, and is kept for parity (a
# weight packed by either package has the same layout) until the H100
# re-derives it.  ``"packed"`` always keeps exact b-bit storage.
POW2_STORAGE = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8}
AUTO_PAD_WIDTHS = frozenset({3, 7})


def resolve_storage_bits(bits: int, storage_bits) -> int:
    """A ``storage_bits`` spec (None/"packed", "auto", or an int) -> the plane
    width the values are packed at."""
    if storage_bits in (None, "packed"):
        return bits
    if storage_bits == "auto":
        return POW2_STORAGE[bits] if bits in AUTO_PAD_WIDTHS else bits
    sb = int(storage_bits)
    if sb not in PLANE_DECOMP or sb < bits:
        raise ValueError(f"storage_bits={storage_bits} invalid for bits={bits}")
    return sb


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_group_compatible(tile_k: int, group_size: int) -> bool:
    return tile_k % group_size == 0 or group_size % tile_k == 0


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

    cands = [c for c in (1024, 512, 256, 128, 64, 32) if c >= floor]
    for c in cands:
        if K % c == 0 and _tile_group_compatible(c, group_size):
            return c
    for c in cands:
        if _tile_group_compatible(c, group_size):
            return c
    return math.lcm(group_size, floor)


def quantize(
    w: np.ndarray, bits: int, group_size: int, sym: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a float weight ``w[K, N]`` (numpy) to ``bits`` with per-group
    scale and zero, asymmetric min/max or ``sym``, GPTQ conventions.

    Returns ``(wq uint8[K, N], scales f32[G, N], zeros uint8[G, N])`` with
    ``w ~= (wq - z) * s``.  Scales round through fp16 BEFORE q and zero are
    chosen, so they compensate the value that is stored."""
    K, N = w.shape
    G = -(-K // group_size)
    maxq = (1 << bits) - 1
    wq = np.zeros((K, N), np.uint8)
    scales = np.zeros((G, N), np.float32)
    zeros = np.zeros((G, N), np.uint8)
    for g in range(G):
        blk = w[g * group_size : (g + 1) * group_size].astype(np.float64)
        if sym:
            amax = np.abs(blk).max(axis=0)
            scale = np.maximum(amax / (maxq / 2), 1e-8)
            scale = scale.astype(np.float16).astype(np.float64)
            zero = np.full(N, (maxq + 1) // 2, np.float64)
        else:
            lo = np.minimum(blk.min(axis=0), 0)
            hi = np.maximum(blk.max(axis=0), 0)
            scale = np.maximum((hi - lo) / maxq, 1e-8)
            scale = scale.astype(np.float16).astype(np.float64)
            zero = np.clip(np.round(-lo / scale), 0, maxq)
        q = np.clip(np.round(blk / scale + zero), 0, maxq)
        wq[g * group_size : (g + 1) * group_size] = q.astype(np.uint8)
        scales[g] = scale.astype(np.float32)
        zeros[g] = zero.astype(np.uint8)
    return wq, scales, zeros


def _pack_bits_np(vals: np.ndarray, bits: int, axis: int) -> np.ndarray:
    """Pack integers (< 2**bits) into int32 words along ``axis``, low bits
    first, values straddling word boundaries where bits does not divide 32."""
    vals = np.moveaxis(vals, axis, 0)
    K = vals.shape[0]
    out = np.zeros((-(-K * bits // 32),) + vals.shape[1:], np.uint64)
    for k in range(K):
        wi, off = divmod(k * bits, 32)
        v = vals[k].astype(np.uint64)
        out[wi] |= (v << off) & 0xFFFFFFFF
        if off + bits > 32:
            out[wi + 1] |= v >> (32 - off)
    return np.ascontiguousarray(np.moveaxis(out.astype(np.uint32).view(np.int32), 0, axis))


def gptq_pack(
    wq: np.ndarray, scales: np.ndarray, zeros: np.ndarray, bits: int, scale_dtype=np.float16
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer values, scales and zero-points (numpy) -> the interchange
    layout ``(qweight, scales, qzeros)``: qweight packs along K, qzeros
    along N."""
    qweight = _pack_bits_np(wq.astype(np.uint32), bits, axis=0)
    qzeros = _pack_bits_np(zeros.astype(np.uint32), bits, axis=1)
    return qweight, scales.astype(scale_dtype), qzeros


def _unpack_bits(words: torch.Tensor, bits: int, n_vals: int, axis: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits_np` on a tensor: ``n_vals`` values along
    ``axis`` as int32 (one gather per word half; handles straddling values)."""
    w = words.movedim(axis, 0).to(torch.int64) & 0xFFFFFFFF
    bitpos = torch.arange(n_vals, device=words.device) * bits
    wi, off = bitpos // 32, bitpos % 32
    shape = (-1,) + (1,) * (w.dim() - 1)
    mask = (1 << bits) - 1
    vals = (w[wi] >> off.reshape(shape)) & mask
    need_hi = (off + bits > 32).reshape(shape)
    hi = w[torch.clamp(wi + 1, max=w.shape[0] - 1)]
    shift_hi = torch.where(need_hi, (32 - off).reshape(shape), 0)
    vals = vals | torch.where(need_hi, (hi << shift_hi) & mask, 0)
    return vals.to(torch.int32).movedim(0, axis)


def gptq_unpack_weight(qweight: torch.Tensor, bits: int, K: int) -> torch.Tensor:
    """``int32[ceil(K*bits/32), N]`` -> integer values ``int32[K, N]``."""
    return _unpack_bits(qweight, bits, K, axis=0)


def gptq_unpack_zeros(qzeros: torch.Tensor, bits: int, N: int) -> torch.Tensor:
    """``int32[G, ceil(N*bits/32)]`` -> zero-points ``int32[G, N]``."""
    return _unpack_bits(qzeros, bits, N, axis=1)


def _scale_zeros(scales: torch.Tensor, zeros: torch.Tensor, add_zero_bias: int) -> torch.Tensor:
    """``s * (z + bias)`` multiplied and rounded in the scales' dtype, as the
    reference's half-precision ``-s*z`` operand is."""
    z = zeros.float() + float(add_zero_bias)
    return (scales * z.to(scales.dtype)).to(scales.dtype)


def dequant_reference(
    qweight: torch.Tensor,
    scales: torch.Tensor,
    qzeros: torch.Tensor,
    group_size: int,
    bits: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[torch.Tensor] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Plain oracle of the reference library's ``dequant`` op on the
    interchange layout: ``w = wq*s - sz`` with ``sz = s*(z + bias)`` rounded
    through the scale dtype.  With ``g_idx`` each row takes its own group
    (act-order)."""
    K, N = in_features, scales.shape[1]
    out_dtype = out_dtype or scales.dtype
    wq = gptq_unpack_weight(qweight, bits, K).float()
    sz = _scale_zeros(scales, gptq_unpack_zeros(qzeros, bits, N), add_zero_bias).float()
    if g_idx is None:
        gid = torch.arange(K, device=scales.device) // group_size
    else:
        gid = g_idx.long()
    return (wq * scales.float()[gid] - sz[gid]).to(out_dtype)


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


def _pad_to(x: torch.Tensor, rows: int, cols: int, value=0) -> torch.Tensor:
    """Pad a 2-D tensor at the bottom and right up to ``[rows, cols]``."""
    return torch.nn.functional.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]), value=value)


def make_qtensor(
    wq: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    bits: int,
    group_size: int,
    add_zero_bias: int = 0,
    tile_k: Optional[int] = None,
    perm: Optional[torch.Tensor] = None,
    scale_store_dtype=None,
    storage_bits=None,
    scale_zeros: Optional[torch.Tensor] = None,
) -> QTensor:
    """Build a QTensor from unpacked integer values ``wq[K, N]`` and per-group
    ``scales``/``zeros`` ``[G, N]`` (port of ``formats.make_qtensor``; the
    result equals the JAX package's after ``io.convert.qtensor_from_numpy``).

    ``scale_zeros = s*(z + bias)`` is rounded through the scales' dtype, then
    stored as ``scale_store_dtype`` (None: float16 for fp16 scales, else
    float32).  K pads to a tile multiple and N to a multiple of 128 with scale
    1, zero 0.  ``storage_bits``: see :func:`resolve_storage_bits`.
    ``scale_zeros`` given per group ``[G, N]`` (a repack of stored values)
    replaces the product and ``zeros`` is not read."""
    if scale_store_dtype is None:
        scale_store_dtype = torch.float16 if scales.dtype == torch.float16 else torch.float32
    K_logical, N = wq.shape
    g = group_size
    value_bits = None
    sb = resolve_storage_bits(bits, storage_bits)
    if sb != bits:
        value_bits, bits = bits, sb
    floor = min_tile_k(bits)
    tile_k = tile_k or default_tile_k(_round_up(K_logical, floor), g, bits)
    if not _tile_group_compatible(tile_k, g):
        raise ValueError(
            f"tile_k={tile_k} and group_size={g} must divide one another "
            "(tile boundaries must land on group boundaries)")
    if tile_k < floor or tile_k % floor:
        raise ValueError(f"tile_k={tile_k} must be a multiple of {floor} for bits={bits}")
    K = _round_up(K_logical, tile_k)
    Np = _round_up(N, 128)
    G = max(scales.shape[0], -(-K // g))
    wq = _pad_to(wq.to(torch.int32), K, Np)
    scales = _pad_to(scales, G, Np, value=1)
    if scale_zeros is None:
        sz = _scale_zeros(scales, _pad_to(zeros, G, Np), add_zero_bias)
    else:  # padding as a zero point of 0 gives it: s * bias with s = 1
        sz = _pad_to(scale_zeros.to(scales.dtype), G, Np, value=float(add_zero_bias))
    return QTensor(
        planes=pack_planes(wq, bits, tile_k, paired=paired_ok(bits, tile_k, g)),
        scales=tile_scales(scales.float(), tile_k, g, K).to(scale_store_dtype),
        scale_zeros=tile_scales(sz.float(), tile_k, g, K).to(scale_store_dtype),
        bits=bits,
        group_size=g,
        tile_k=tile_k,
        K=K,
        K_logical=K_logical,
        perm=None if perm is None else perm.long(),
        N_logical=N if Np != N else None,
        value_bits=value_bits,
    )


def _shard_rows(wq, scales, sz, bits, group_size, row_shards, pad_sz, tile_k, scale_store_dtype,
                storage_bits, perm) -> QTensor:
    """Pack each of ``row_shards`` contiguous K-slices of ``wq`` as its own
    QTensor with the shard-local group size ``gcd(g, K/row_shards)``, the
    per-group ``scales`` / ``sz`` rows copied onto the finer grid, each shard
    padded to its own tile; stacked on a leading shard axis."""
    K, N = wq.shape
    Ks = K // row_shards
    g_local = math.gcd(group_size, Ks)
    if g_local < 16:
        raise ValueError(f"shard-local group size gcd({group_size}, {Ks}) = {g_local} < 16")
    sb = resolve_storage_bits(bits, storage_bits)
    tile = tile_k or default_tile_k(Ks, g_local, sb)
    row0 = torch.arange(0, Ks, g_local, device=wq.device)
    shards = []
    for i in range(row_shards):
        gidx = (i * Ks + row0) // group_size
        shards.append(make_qtensor(
            wq[i * Ks : (i + 1) * Ks], scales[gidx], None, bits, g_local, pad_sz, tile_k=tile,
            scale_store_dtype=scale_store_dtype, storage_bits=sb, scale_zeros=sz[gidx]))
    first = shards[0]
    return dataclasses.replace(
        first,
        planes=tuple(torch.stack([s.planes[j] for s in shards]) for j in range(len(first.planes))),
        scales=torch.stack([s.scales for s in shards]),
        scale_zeros=torch.stack([s.scale_zeros for s in shards]),
        perm=None if perm is None else perm.long(),
    )


def make_row_sharded_qtensor(
    wq: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    bits: int,
    group_size: int,
    row_shards: int,
    add_zero_bias: int = 0,
    tile_k: Optional[int] = None,
    scale_store_dtype=None,
    storage_bits=None,
    perm: Optional[torch.Tensor] = None,
) -> QTensor:
    """Pack ``wq[K, N]`` for row-parallel execution over ``row_shards`` ranks
    (port of ``formats.make_row_sharded_qtensor``).

    A shard boundary rarely lands on a group boundary (Llama-7B's w_down at
    tp=8: 1376 rows a shard, 10.75 groups of 128), so each shard is packed on
    its own with the local group size ``g' = gcd(g, K/row_shards)`` and the
    global scales copied exactly onto the finer grid: the values are
    unchanged, only the scale rows grow.  Each shard pads to its own tile.
    The leaves carry a leading shard axis ``[row_shards, ...]`` and the static
    fields describe one shard, so that ``parallel.tp.squeeze_row_shard`` of a
    shard is a complete QTensor.  ``perm`` (``[row_shards, K/row_shards]``):
    shard-local act-order permutations of rows already permuted so."""
    if scale_store_dtype is None:
        scale_store_dtype = torch.float16 if scales.dtype == torch.float16 else torch.float32
    K, N = wq.shape
    if perm is not None and tuple(perm.shape) != (row_shards, K // row_shards):
        raise ValueError(f"perm shape {tuple(perm.shape)} != ({row_shards}, {K // row_shards})")
    if K % row_shards:
        raise ValueError(f"K={K} must divide into {row_shards} row shards")
    sz = _scale_zeros(scales, zeros, add_zero_bias)
    return _shard_rows(wq, scales, sz, bits, group_size, row_shards, add_zero_bias, tile_k,
                       scale_store_dtype, storage_bits, perm)


def _group_rows(ts: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Tiled scales ``[T, gt_pad, N]`` -> one row a group ``[ceil(K/g), N]``,
    in their stored dtype."""
    gt = qt.groups_per_tile
    rows = ts[:, :gt, :].reshape(-1, ts.shape[-1])
    return torch.repeat_interleave(rows, qt.tile_k // gt, dim=0)[:: qt.group_size]


def row_shard_qtensor(qt: QTensor, row_shards: int) -> QTensor:
    """A packed QTensor repacked for row-parallel execution over
    ``row_shards`` ranks: the layout of :func:`make_row_sharded_qtensor`, with
    every stored value, scale and scale-zero copied (no requantization), so
    the shards dequantize to the rows of ``qt`` exactly.  An act-order tensor
    is refused: its row order crosses the shards (it runs gathered)."""
    if qt.perm is not None:
        raise ValueError("an act-order QTensor cannot be row-sharded (it runs gathered)")
    if qt.planes[0].ndim != 2:
        raise ValueError("row_shard_qtensor takes one unstacked QTensor")
    if qt.K_logical % row_shards:
        raise ValueError(f"K={qt.K_logical} must divide into {row_shards} row shards")
    wq = unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    out = _shard_rows(wq[: qt.K_logical], _group_rows(qt.scales, qt),
                      _group_rows(qt.scale_zeros, qt), qt.value_bits or qt.bits, qt.group_size,
                      row_shards, 0, None, qt.scales.dtype, qt.bits, None)
    return dataclasses.replace(out, N_logical=qt.N_logical)


def is_row_sharded(qt: QTensor) -> bool:
    """Whether the leaves carry a leading shard axis (the JAX package's test:
    a stacked QTensor of layers or experts reads the same)."""
    return qt.planes[0].ndim == 3


def from_gptq(
    qweight: torch.Tensor,
    scales: torch.Tensor,
    qzeros: torch.Tensor,
    bits: int,
    group_size: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[torch.Tensor] = None,
    tile_k: Optional[int] = None,
    scale_store_dtype=None,
    storage_bits=None,
    col_perm: Optional[torch.Tensor] = None,
    fold_perm: bool = False,
) -> QTensor:
    """An interchange-layout tensor -> the packed layout.

    Act-order rows (``g_idx``) are sorted into contiguous groups here (a
    stable sort), and the order is kept as ``perm`` so that matmuls gather
    activations, not weights.  ``col_perm`` permutes the output columns
    (folding a downstream layer's row sort into this layer); ``fold_perm``
    says that was done upstream for THIS tensor's ``g_idx``: rows are still
    sorted but no ``perm`` is stored."""
    K, N = in_features, scales.shape[1]
    wq = gptq_unpack_weight(qweight, bits, K)
    zeros = gptq_unpack_zeros(qzeros, bits, N)
    if col_perm is not None:
        col_perm = col_perm.long()
        wq, scales, zeros = wq[:, col_perm], scales[:, col_perm], zeros[:, col_perm]
    perm = None
    if g_idx is not None:
        order = torch.argsort(g_idx, stable=True)
        wq = wq[order]
        perm = None if fold_perm else order
    return make_qtensor(
        wq, scales, zeros, bits, group_size, add_zero_bias, tile_k=tile_k, perm=perm,
        scale_store_dtype=scale_store_dtype, storage_bits=storage_bits)


def concat_qtensors(qts: Sequence[QTensor], order: Optional[np.ndarray] = None) -> QTensor:
    """Concatenate QTensors along N (one K): fuses q/k/v, or gate/up, into one
    matmul.  Their static metadata must match, and so must their row
    permutations: act-order tensors fuse only where they share one (as the
    parts of one tensor do), which the result keeps.  ``order`` permutes the fused
    columns (``models.llama.interleave_order``: the per-shard interleave of
    tensor parallelism); it must be a permutation of them.  The fused N pads
    to a multiple of 128 as :func:`make_qtensor` pads it (scale 1, scale-zero
    0), after the permutation."""
    first = qts[0]
    for qt in qts[1:]:
        same = (qt.bits == first.bits and qt.group_size == first.group_size
                and qt.tile_k == first.tile_k and qt.K == first.K
                and qt.K_logical == first.K_logical and qt.value_bits == first.value_bits)
        if not same:
            raise ValueError("concat_qtensors: mismatched quantization metadata")
        same_rows = (qt.perm is None) == (first.perm is None) and (
            qt.perm is None or torch.equal(qt.perm, first.perm))
        if not same_rows:
            raise ValueError("concat_qtensors: act-order tensors with other row orders "
                             "cannot be fused")

    N = sum(qt.shape[1] for qt in qts)
    if order is not None:
        order = torch.as_tensor(np.asarray(order), dtype=torch.long)
        if order.shape != (N,) or not torch.equal(order.sort().values, torch.arange(N)):
            raise ValueError(f"concat_qtensors: order is not a permutation of the {N} columns")
        order = order.to(first.planes[0].device)

    def cat(get):
        out = torch.cat([get(qt)[..., : qt.shape[1]] for qt in qts], dim=-1)
        return out if order is None else out.index_select(-1, order)

    planes = tuple(cat(lambda q, i=i: q.planes[i]) for i in range(len(first.planes)))
    scales = cat(lambda q: q.scales)
    scale_zeros = cat(lambda q: q.scale_zeros)
    N = planes[0].shape[-1]
    Np = _round_up(N, 128)
    if Np != N:
        pad = (0, Np - N)
        planes = tuple(torch.nn.functional.pad(p, pad) for p in planes)
        scales = torch.nn.functional.pad(scales, pad, value=1)
        scale_zeros = torch.nn.functional.pad(scale_zeros, pad)
    return QTensor(
        planes=planes, scales=scales, scale_zeros=scale_zeros, bits=first.bits,
        group_size=first.group_size, tile_k=first.tile_k, K=first.K,
        K_logical=first.K_logical, N_logical=N if Np != N else None, perm=first.perm,
        value_bits=first.value_bits)


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
