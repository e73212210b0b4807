"""Quantized Llama-family decoder in PyTorch (port of ``xbitops_tpu/models/llama.py``).

Every projection is a :class:`QLinear` over a packed
:class:`~xbitops_tpu_torch.formats.QTensor`, run by the fused dequant-matmul
kernel (with ``prefill_a8``, a block's projections of a forward of 32 rows or
more run its int8-activation form), or a :class:`DenseLinear` over a dense
bf16 weight (the unquantized model that quality is measured against).  The KV
cache is head-major, ``[L, B, Hkv, S, D]`` bf16, fp16 or f32 (activations stay
bf16 whatever its type) or packed int8, or a pool of
pages shared by the slots behind a page table (see :class:`KVCache`), and,
unlike the JAX package's functional updates, every
function here writes it IN PLACE and returns the same :class:`KVCache` object.
Positions ``>= S`` mark padding and inactive slots: they write nothing and
advance no length.

RMSNorm, RoPE, SiLU-times-up, the embedding, the int8 quantization of new k/v
rows and the eager attention are plain PyTorch, as the JAX package left them
to XLA.  Decode (one token per slot) attends through the decode-attention
kernel, which appends the new k/v rows first; a chunk of a long prompt
attends its slot's cache through the prefill-attention kernel; both read a
paged cache in place through its table.  A block whose weights hold a
``router`` runs the routed expert FFN of :mod:`~xbitops_tpu_torch.models.moe`
(Mixtral) in place of the MLP, through the same fused matmul on each expert's
view; the engine needs no branch of its own for it.

Speculative verify (:func:`spec_verify_step`, ``forward(kv_unaligned=True)``)
writes T rows a slot that may start at any position, also off an int8 word.
They go in T one-row appends, position t by position t, as the JAX package's
per-t read-modify-write does (on the card the append kernel, #4 or #8, once a
t: two positions of a chain may share a packed word, which #8 rewrites whole
in one thread).  The forward then attends through the prefill-attention kernel
on the card, where the JAX package attends eagerly over every row of the
slots: its Pallas kernel needs T % 128 == 0, while the CUDA kernel takes any T
and masks each query by its own position.  Off the card the eager attention
runs, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.kernels.common import check_kv_dtype
from xbitops_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from xbitops_tpu_torch.kernels.kv_append import (
    _pack_kv_scales,
    _pack_kv_words,
    _quant_kv,
    _rmw_packed,
    _unpack_kv_words,
    gather_pages,
    kv_append_dense,
    kv_append_dense_reference,
    kv_append_packed,
    kv_append_packed_reference,
    paged_rows,
)
from xbitops_tpu_torch.kernels.prefill_attention import prefill_attention
from xbitops_tpu_torch.ops.dense import dense_matmul
from xbitops_tpu_torch.ops.qmatmul import qmatmul
from xbitops_tpu_torch.ops.quantize import quantize_array


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model shape and options; the same fields as the JAX package's config."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    flash_decode: bool = True  # decode through the decode-attention kernel
    prefill_a8: bool = False  # int8 activations in the blocks' matmuls at T >= A8_MIN_T
    rope_scaling_type: Optional[str] = None  # None | "linear" | "ntk"
    rope_scaling_factor: float = 1.0
    sliding_window: Optional[int] = None

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(
            intermediate_size=14336, num_kv_heads=8, max_seq_len=8192,
            sliding_window=4096,
        )

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120, intermediate_size=13824, num_layers=40,
            num_heads=40, num_kv_heads=40,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, intermediate_size=14336, num_kv_heads=8,
            rope_theta=500000.0, max_seq_len=8192,
        )

    @staticmethod
    def tiny(vocab: int = 256, seq: int = 64) -> "LlamaConfig":
        """Test-size config: hidden 256, ffn 512, 2 layers, head_dim 128."""
        return LlamaConfig(
            vocab_size=vocab, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_seq_len=seq,
        )

    def local(self, tp: int) -> "LlamaConfig":
        """One rank's view under tensor parallelism: heads, kv heads and the
        FFN width split ``tp`` ways."""
        if self.num_heads % tp or self.num_kv_heads % tp or self.intermediate_size % tp:
            raise ValueError(f"heads {self.num_heads}, kv heads {self.num_kv_heads} and ffn "
                             f"{self.intermediate_size} must split over tp={tp}")
        return dataclasses.replace(
            self, num_heads=self.num_heads // tp, num_kv_heads=self.num_kv_heads // tp,
            intermediate_size=self.intermediate_size // tp)


def interleave_order(sizes, tp: int):
    """Column order turning a concat ``[A|B|C]`` into per-shard interleaving
    ``[A_0|B_0|C_0|A_1|B_1|C_1|...]``, so a fused column-parallel weight splits
    into self-consistent per-shard ``[q_s|k_s|v_s]`` blocks (Megatron's fused
    q|k|v layout).  int64 numpy indices."""
    import numpy as np

    offs = np.cumsum([0] + list(sizes[:-1]))
    for sz in sizes:
        if sz % tp:
            raise ValueError(f"fused block of size {sz} does not split evenly over tp={tp}; a "
                             "truncated interleave would corrupt the packed checkpoint")
    idx = []
    for s in range(tp):
        for off, sz in zip(offs, sizes):
            per = sz // tp
            idx.extend(range(off + s * per, off + (s + 1) * per))
    return np.asarray(idx, np.int64)


# Smallest cache capacity routed to the decode-attention kernel.  The value is
# the JAX package's, measured on a TPU v5e; it is kept for parity until the
# H100 re-derives it.
FLASH_MIN_S = 64

# Fewest rows of a forward (T) whose block projections take int8 activations
# under ``prefill_a8``; decode stays bf16.  The JAX package's value, kept so
# that both packages round the same forwards.
A8_MIN_T = 32


@dataclasses.dataclass
class KVCache:
    """Head-major cache with per-slot ``lengths`` (int32 [B]), updated in
    place by the model.  Either ``k, v: [L, B, Hkv, S, D]`` of ``dtype``
    (bf16, fp16 or f32: new rows are cast to it, attention reads it), or packed
    int8 (``k_scale`` set): ``k, v: [L, B, Hkv, S/4, D]`` int32 words, byte j
    of word w holding position 4w + j as its quantized value + 128, with
    per-(position, head) scales ``k_scale, v_scale: [L, B, 4, Hkv, S/4]``
    bf16.

    Paged (``page_table`` set): k/v are page POOLS
    ``[L, n_pages, Hkv, page_size(/4), D]`` shared by all slots (scale pools
    ``[L, n_pages, 4, Hkv, page_size/4]``), and ``page_table`` int32 [B, P]
    gives the pool page of each slot's page, -1 for none.  Position ``p`` of
    slot ``b`` lies in page ``page_table[b, p // page_size]`` at row
    ``p % page_size``.  A slot then costs the pages it holds, not ``S`` rows:
    the engine's allocator hands pages out as requests grow.  A position
    without a page writes nothing."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    page_table: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def paged(self) -> bool:
        return self.page_table is not None

    @property
    def page_size(self) -> int:
        """Positions of one pool page (of a paged cache)."""
        if not self.paged:
            raise ValueError("page_size: the cache is not paged")
        return self.k.shape[3] * (4 if self.quantized else 1)

    @property
    def S(self) -> int:
        """Capacity of a slot in positions (virtual for a paged cache)."""
        rows = self.k.shape[3] * (4 if self.quantized else 1)
        return self.page_table.shape[1] * rows if self.paged else rows

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, device, dtype=torch.bfloat16,
             quantized: bool = False) -> "KVCache":
        L, Hkv, D, S = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
        if quantized:
            if S % 4:
                raise ValueError("int8 KV cache needs max_seq_len % 4 == 0")
            words = (L, batch, Hkv, S // 4, D)
            scales = (L, batch, 4, Hkv, S // 4)
            return KVCache(
                k=torch.zeros(words, dtype=torch.int32, device=device),
                v=torch.zeros(words, dtype=torch.int32, device=device),
                lengths=lengths,
                k_scale=torch.zeros(scales, dtype=torch.bfloat16, device=device),
                v_scale=torch.zeros(scales, dtype=torch.bfloat16, device=device),
            )
        check_kv_dtype(dtype)
        shape = (L, batch, Hkv, S, D)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=lengths,
        )

    @staticmethod
    def init_paged(cfg: LlamaConfig, batch: int, pool_pages: int, page_size: int = 256, *,
                   device, dtype=torch.bfloat16, quantized: bool = False) -> "KVCache":
        """A paged cache: a pool of ``pool_pages`` pages of ``page_size``
        positions (memory follows the pool, not ``batch * max_seq_len``) and a
        table with no page given out.  ``page_size=256`` is the JAX package's
        default, chosen there for a TPU block."""
        if cfg.max_seq_len % page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        if quantized and page_size % 4:
            raise ValueError("int8 paged cache needs page_size % 4 == 0")
        # a pool is laid out as a linear cache of pool_pages slots of page_size positions
        paged_cfg = dataclasses.replace(cfg, max_seq_len=page_size)
        pool = KVCache.init(paged_cfg, pool_pages, device, dtype=dtype, quantized=quantized)
        pool.lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
        pool.page_table = torch.full((batch, cfg.max_seq_len // page_size), -1,
                                     dtype=torch.int32, device=device)
        return pool


class QLinear(nn.Module):
    """A projection over a packed QTensor, whose arrays it holds as buffers.

    On a rank of a tensor-parallel mesh the QTensor is the rank's shard and
    ``role`` (a ``parallel.tp.Role``) adds the collectives around the product,
    as Megatron's column- and row-parallel linears do: a row shard sums its
    partial products over the axis, lm_head gathers its columns."""

    role = None

    def __init__(self, qt: QTensor):
        super().__init__()
        self.n_planes = len(qt.planes)
        for i, p in enumerate(qt.planes):
            self.register_buffer(f"plane{i}", p)
        self.register_buffer("scales", qt.scales)
        self.register_buffer("scale_zeros", qt.scale_zeros)
        self.register_buffer("perm", qt.perm)
        self.meta = dict(
            bits=qt.bits, group_size=qt.group_size, tile_k=qt.tile_k, K=qt.K,
            K_logical=qt.K_logical, N_logical=qt.N_logical, value_bits=qt.value_bits,
        )

    @property
    def qtensor(self) -> QTensor:
        planes = tuple(getattr(self, f"plane{i}") for i in range(self.n_planes))
        return QTensor(planes, self.scales, self.scale_zeros, perm=self.perm, **self.meta)

    def forward(self, x: torch.Tensor, use_kernel: bool = True, a8: bool = False) -> torch.Tensor:
        def product(x):
            return qmatmul(x, self.qtensor, out_dtype=x.dtype, use_kernel=use_kernel, a8=a8)

        return product(x) if self.role is None else self.role(product, x)


class DenseLinear(nn.Module):
    """A projection over a dense ``[K, N]`` weight (bf16 matmul, f32 sums).
    There is no int8 path for a dense weight: ``a8`` changes nothing.
    ``role``: as :class:`QLinear`'s."""

    role = None

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", w)

    def forward(self, x: torch.Tensor, use_kernel: bool = True, a8: bool = False) -> torch.Tensor:
        if self.role is None:
            return dense_matmul(x, self.weight)
        return self.role(lambda x: dense_matmul(x, self.weight), x)


def _linear(w: Union[QTensor, torch.Tensor]) -> nn.Module:
    return QLinear(w) if isinstance(w, QTensor) else DenseLinear(w)


def linear_weight(linear: nn.Module) -> Union[QTensor, torch.Tensor]:
    """The weight a projection module holds: its QTensor, or its dense tensor."""
    return linear.qtensor if isinstance(linear, QLinear) else linear.weight


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_tables(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling_type: Optional[str] = None,
    scaling_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[..., T, 1, head_dim/2]`` of rotate-half RoPE at
    ``positions [..., T]``.  "linear" divides positions by the factor, "ntk"
    stretches theta by factor^(d/(d-2)).  A forward builds them once for all
    its layers."""
    hd = head_dim
    pos = positions.float()
    if scaling_type == "linear":
        pos = pos / float(scaling_factor)
    elif scaling_type == "ntk":
        theta = theta * float(scaling_factor) ** (hd / (hd - 2))
    elif scaling_type is not None:
        raise ValueError(f"unknown rope scaling type {scaling_type!r}")
    freqs = theta ** (
        -torch.arange(0, hd // 2, dtype=torch.float32, device=positions.device) / (hd // 2)
    )
    ang = pos[..., :, None] * freqs  # [..., T, hd/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rope(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotate-half RoPE (HF Llama convention) of x [..., T, heads, head_dim]
    with the :func:`rope_tables` of its positions."""
    cos, sin = tables
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2 :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(q, kT, vT, mask, scale):
    """Eager attention.  q [B, Tq, H, D]; kT/vT head-major [B, Hkv, Tk, D];
    mask [B, Tq, Tk] bool.  Query head h*rep + r uses kv head h."""
    H, Hkv = q.shape[2], kT.shape[1]
    rep = H // Hkv
    if rep > 1:
        kT = kT.repeat_interleave(rep, dim=1)
        vT = vT.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), kT.float())
    logits = logits * scale + torch.where(mask[:, None], 0.0, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bqhd", p, vT.float()).to(q.dtype)


def _write_rows(cache: KVCache, li: int, k, v, positions, slot_ids) -> None:
    """Write new rows k/v [n, T, Hkv, D] at ``positions`` [n, T] of cache
    slots ``slot_ids`` [n] (default: row i -> slot i) in one batched write.
    Only rows with 0 <= position < S and 0 <= slot < B are written: a chunk
    that overhangs the capacity writes the part that fits.  On a paged cache
    the slot's table row gives the pool page of each position, and a position
    whose page was not given out writes nothing.

    The int8 cache takes T > 1 rows as whole words: T and every row's first
    position are multiples of 4 and a row's valid positions are a prefix of
    it (bucket and chunk admission), so a word is written when its first
    position is valid; bytes of padding that ride along in a row's last word
    are never attended and a later append replaces them.  T == 1 rewrites one
    byte of each word."""
    n, T = positions.shape
    Hkv, S = cache.k.shape[2], cache.S
    dev = positions.device
    rows = torch.arange(n, device=dev) if slot_ids is None else slot_ids.long()
    h = torch.arange(Hkv, device=dev)

    def locate(pos):
        """``(ok, block, row)`` of positions [n, m]: the block of the cache's
        second axis (slot, or pool page) and the row inside it."""
        if cache.paged:
            return paged_rows(cache.page_table, rows, pos, cache.page_size, cache.k.shape[1])
        slot = rows[:, None].expand_as(pos)
        ok = (slot >= 0) & (slot < cache.k.shape[1]) & (pos >= 0) & (pos < S)
        return ok, slot, pos

    if not cache.quantized:
        ok, blk, row = locate(positions)
        idx = (blk[ok][:, None], h[None, :], row[ok][:, None])
        cache.k[li].index_put_(idx, k[ok].to(cache.k.dtype))
        cache.v[li].index_put_(idx, v[ok].to(cache.v.dtype))
        return
    q, s = _quant_kv(torch.stack((k, v)))  # k and v in one pass
    (kq, vq), (ks, vs) = q, s
    if T == 1:
        _rmw_packed(cache.k, cache.v, cache.k_scale, cache.v_scale, kq[:, 0], vq[:, 0],
                    ks[:, 0], vs[:, 0], positions[:, 0], li, slots=rows,
                    page_table=cache.page_table)
        return
    if T % 4:
        raise ValueError("int8 KV prefill needs T % 4 == 0")
    ok, blk, row = locate(positions[:, 0::4])  # [n, T/4]: first position of each word
    b_ok, w_ok = blk[ok], row[ok] // 4
    idx = (b_ok[:, None], h[None, :], w_ok[:, None])
    j = torch.arange(4, device=dev)
    sidx = (b_ok[:, None, None], j[None, :, None], h[None, None, :], w_ok[:, None, None])
    for words, scales, q, s in ((cache.k, cache.k_scale, kq, ks), (cache.v, cache.v_scale, vq, vs)):
        words[li].index_put_(idx, _pack_kv_words(q).transpose(1, 2)[ok])  # [m, Hkv, D]
        packed = _pack_kv_scales(s).to(scales.dtype).permute(0, 3, 1, 2)  # [n, T/4, 4, Hkv]
        scales[li].index_put_(sidx, packed[ok])


def _new_row(cache: KVCache, k, v, positions):
    """The ``kv_new`` of the append and decode kernels for one new row per
    slot, k/v [B, 1, Hkv, D]: the rows as they are, or for the int8 cache
    their biased bytes and scales; then the positions [B]."""
    if not cache.quantized:
        return k[:, 0], v[:, 0], positions[:, 0]
    q, s = _quant_kv(torch.stack((k[:, 0], v[:, 0])))  # k and v in one pass
    return q[0], q[1], s[0], s[1], positions[:, 0]


def _append_row(cache: KVCache, li: int, new, use_kernel: bool) -> None:
    """Write :func:`_new_row` rows into layer ``li``, row i to slot i (on a
    paged cache: to slot i's page)."""
    if cache.quantized:
        append = kv_append_packed if use_kernel else kv_append_packed_reference
        append(cache.k, cache.v, cache.k_scale, cache.v_scale, *new, li, cache.page_table)
    else:
        append = kv_append_dense if use_kernel else kv_append_dense_reference
        append(cache.k, cache.v, *new, li, cache.page_table)


def _write_unaligned(cache: KVCache, li: int, k, v, positions, use_kernel: bool) -> None:
    """Write k/v [B, T, Hkv, D] at ``positions`` [B, T] (row i -> slot i) that
    may start anywhere: one :func:`_append_row` a position t, never one launch
    for all T (two positions may share an int8 word, which the append kernel
    rewrites whole).  A position outside ``[0, S)``, or without a page, writes
    nothing, so a chain that runs past S loses only its tail.  No step reads
    anything back to the host: a CUDA graph can capture it.  The rows are laid
    out T-major once, and the int8 ones quantized in one pass over all T, so
    that each append takes contiguous slices."""
    kv = torch.stack((k.transpose(0, 1), v.transpose(0, 1)))  # [2, T, B, Hkv, D]
    pos = positions.t().contiguous()
    if cache.quantized:
        q, s = _quant_kv(kv)  # k and v in one pass
    for t in range(pos.shape[0]):
        if cache.quantized:
            new = q[0, t], q[1, t], s[0, t], s[1, t], pos[t]
        else:
            new = kv[0, t], kv[1, t], pos[t]
        _append_row(cache, li, new, use_kernel)


def _slot_rows(cache: KVCache, li: int, slot_ids):
    """Head-major k, v [n, Hkv, S, D] of layer ``li`` for the eager attention:
    every slot, or the slots ``slot_ids`` (clamped into range: an inert row
    reads some slot and its output is never used); the int8 cache
    dequantized to f32.  A paged cache gathers each slot's pages into one
    context of ``P * page_size`` positions; a page that was not given out
    reads some page, past the slot's length."""
    parts = [cache.k[li], cache.v[li]]
    if cache.quantized:
        parts += [cache.k_scale[li], cache.v_scale[li]]
    if cache.paged:
        tbl = cache.page_table
        if slot_ids is not None:
            tbl = tbl[slot_ids.long().clamp(0, tbl.shape[0] - 1)]
        parts = [gather_pages(t, tbl, scales=i >= 2) for i, t in enumerate(parts)]
    elif slot_ids is not None:
        rows = slot_ids.long().clamp(0, parts[0].shape[0] - 1)
        parts = [t[rows] for t in parts]
    if cache.quantized:
        return _unpack_kv_words(parts[0], parts[2]), _unpack_kv_words(parts[1], parts[3])
    return parts[0], parts[1]


class LlamaBlock(nn.Module):
    """One transformer block: attention with a fused ``wqkv`` or split
    ``wq/wk/wv`` projection, then a SiLU MLP with fused ``w_gateup`` or split
    ``w_gate/w_up`` projections, or, where ``proj`` holds a ``router``, the
    routed expert FFN of :mod:`~xbitops_tpu_torch.models.moe` (``router``,
    ``w_experts_gateup``, ``w_experts_down``)."""

    def __init__(self, cfg: LlamaConfig, proj: Dict[str, Union[QTensor, torch.Tensor]],
                 ln_attn: torch.Tensor, ln_mlp: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        proj = dict(proj)
        if "router" in proj:
            from xbitops_tpu_torch.models.moe import MoeFFN

            self.moe = MoeFFN(cfg, proj.pop("router"), proj.pop("w_experts_gateup"),
                              proj.pop("w_experts_down"))
        for name, w in proj.items():
            self.add_module(name, _linear(w))
        self.register_buffer("ln_attn", ln_attn)
        self.register_buffer("ln_mlp", ln_mlp)

    def weights(self) -> Dict[str, Union[QTensor, torch.Tensor]]:
        """The block's weights by the JAX package's layer-dict names (the
        norms apart): what :class:`LlamaBlock` is built from."""
        out = {}
        for name, child in self.named_children():
            out.update(child.weights() if name == "moe" else {name: linear_weight(child)})
        return out

    def qkv(self, x, rope, use_kernel: bool = True, a8: bool = False):
        """The attention's inputs from x [B, T, hidden] (``rope``: the
        :func:`rope_tables` of its positions): q [B, T, H, D], k and v
        [B, T, Hkv, D], q and k rotated."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qdim, kvdim = H * D, Hkv * D
        hx = rms_norm(x, self.ln_attn, cfg.rms_eps)
        if hasattr(self, "wqkv"):
            qkv = self.wqkv(hx, use_kernel, a8)
            q = qkv[..., :qdim].reshape(B, T, H, D)
            k = qkv[..., qdim : qdim + kvdim].reshape(B, T, Hkv, D)
            v = qkv[..., qdim + kvdim :].reshape(B, T, Hkv, D)
        else:
            q = self.wq(hx, use_kernel, a8).reshape(B, T, H, D)
            k = self.wk(hx, use_kernel, a8).reshape(B, T, Hkv, D)
            v = self.wv(hx, use_kernel, a8).reshape(B, T, Hkv, D)
        return _rope(q, rope), _rope(k, rope), v

    def out(self, x, att, use_kernel: bool = True, a8: bool = False, live=None,
            admit: bool = False):
        """The block's output from its input x and the attention's output att
        [B, T, H, D]: the residual through wo, then through the MLP (or the
        routed experts).  ``live`` bool [B, T] (rows at a position below S)
        and ``admit`` go to the routed experts' route counters only (None:
        nothing is counted)."""
        cfg = self.cfg
        B, T, _ = x.shape
        x = x + self.wo(att.reshape(B, T, cfg.num_heads * cfg.head_dim), use_kernel, a8)
        hx = rms_norm(x, self.ln_mlp, cfg.rms_eps)
        if hasattr(self, "moe"):
            return x + self.moe(hx, use_kernel, a8, live, admit)
        if hasattr(self, "w_gateup"):
            gu = self.w_gateup(hx, use_kernel, a8)
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        else:
            gate, up = self.w_gate(hx, use_kernel, a8), self.w_up(hx, use_kernel, a8)
        act = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
        return x + self.w_down(act, use_kernel, a8)

    def forward(self, x, positions, rope, cache: KVCache, li: int, mask, slot_ids=None,
                self_attend: bool = False, use_kernel: bool = True,
                flash_prefill: bool = False, kv_unaligned: bool = False):
        """x [B, T, hidden] at ``positions`` [B, T] (``rope``: their
        :func:`rope_tables`); writes layer ``li`` of ``cache`` in place
        (``kv_unaligned``: by :func:`_write_unaligned`).  ``mask`` None means
        a kernel attends: the prefill-attention kernel with ``flash_prefill``,
        else decode through the decode-attention kernel."""
        cfg = self.cfg
        B, T, _ = x.shape
        D = cfg.head_dim
        a8 = cfg.prefill_a8 and T >= A8_MIN_T
        q, k, v = self.qkv(x, rope, use_kernel, a8)

        S = cache.S
        scales = (dict(k_scale=cache.k_scale, v_scale=cache.v_scale) if cache.quantized else {})
        table = cache.page_table  # None: the linear cache
        one_row = T == 1 and slot_ids is None and not self_attend  # row i -> slot i
        if one_row:
            new = _new_row(cache, k, v, positions)
        if mask is None and not flash_prefill:  # decode through the kernel, which appends first
            lens = torch.clamp(positions[:, 0] + 1, max=S)
            if use_kernel:
                att = decode_attention(
                    q[:, 0], cache.k, cache.v, lens, layer_idx=li, kv_new=new,
                    window=cfg.sliding_window, page_table=table, **scales,
                )[0]
            else:
                _append_row(cache, li, new, use_kernel=False)
                att = decode_attention_reference(
                    q[:, 0], cache.k[li], cache.v[li], lens, cfg.sliding_window,
                    *(s[li] for s in scales.values()), page_table=table)
            att = att[:, None]
        else:
            if one_row:
                _append_row(cache, li, new, use_kernel)
            elif kv_unaligned:
                _write_unaligned(cache, li, k, v, positions, use_kernel)
            else:
                _write_rows(cache, li, k, v, positions, slot_ids)
            if self_attend:  # a fresh request attends only its own rows
                att = _attention(q, k.transpose(1, 2), v.transpose(1, 2), mask, D ** -0.5)
            elif flash_prefill:  # a chunk attends the visible cache rows of its slot
                rows = torch.arange(B, device=x.device) if slot_ids is None else slot_ids
                att = prefill_attention(
                    q, cache.k, cache.v, positions, rows, layer_idx=li,
                    window=cfg.sliding_window, page_table=table, **scales)
            else:  # eager, over every row of the slots
                att = _attention(q, *_slot_rows(cache, li, slot_ids), mask, D ** -0.5)
        # a MoE block counts its live rows' routes: a decode (or verify) step's, or an admission's
        live = positions < S if hasattr(self, "moe") else None
        return self.out(x, att, use_kernel, a8, live, admit=not (one_row or kv_unaligned))


class Llama(nn.Module):
    """The decoder: embedding, blocks, final norm and the lm_head (which
    keeps bf16 activations under ``prefill_a8``)."""

    def __init__(self, cfg: LlamaConfig, embed: torch.Tensor, blocks: List[LlamaBlock],
                 ln_final: torch.Tensor, lm_head: Union[QTensor, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("embed", embed)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("ln_final", ln_final)
        self.lm_head = _linear(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def with_config(self, cfg: LlamaConfig) -> "Llama":
        """The same weights (shared, not copied) under another config: another
        option (``prefill_a8``), or the first ``cfg.num_layers`` blocks.  The
        JAX package passes the config with every call; here a model holds
        it.  A rank's shard keeps its projections' parallel roles."""
        blocks = [LlamaBlock(cfg, b.weights(), b.ln_attn, b.ln_mlp)
                  for b in list(self.blocks)[: cfg.num_layers]]
        out = Llama(cfg, self.embed, blocks, self.ln_final, linear_weight(self.lm_head))
        src = dict(self.named_modules())
        for name, m in out.named_modules():
            if getattr(src.get(name), "role", None) is not None:
                m.role = src[name].role
        return out

    def forward(
        self,
        tokens: torch.Tensor,  # int [B, T]
        cache: KVCache,
        positions: torch.Tensor,  # int [B, T] absolute positions of `tokens`
        slot_ids: Optional[torch.Tensor] = None,  # int [B] cache slots of the rows
        self_attend: bool = False,
        kv_unaligned: bool = False,
        logits_rows: Optional[torch.Tensor] = None,  # int [B]: only these logits
        use_kernel: bool = True,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Run T tokens per row (T=1: decode; T>1: prefill); returns logits
        [B, T, V] (``[B, 1, V]`` with ``logits_rows``) and the cache, updated
        in place.  Rows attend the cache rows of their slot (``slot_ids``,
        default row i -> slot i) up to their position, or with
        ``self_attend`` (a fresh request) only their own new rows.
        ``kv_unaligned``: the T > 1 rows of a slot may start at any position
        (speculative verify; row i -> slot i), see the module docstring.
        ``use_kernel=False`` runs every kernel's plain version."""
        S = cache.S
        positions = positions.long()
        x = self.embed[tokens.long()].to(torch.bfloat16)
        x = self.layers(x, cache, positions, slot_ids, self_attend, kv_unaligned, use_kernel)
        logits = self.head(x, logits_rows, use_kernel)
        valid_next = torch.where(positions < S, positions + 1, 0).amax(dim=1).to(torch.int32)
        if slot_ids is None:
            torch.maximum(cache.lengths, valid_next, out=cache.lengths)
        else:
            rows = slot_ids.long()
            ok = (rows >= 0) & (rows < cache.lengths.shape[0])
            rows, vals = rows[ok], valid_next[ok]
            cache.lengths[rows] = torch.maximum(cache.lengths[rows], vals)
        return logits, cache

    def layers(self, x, cache: KVCache, positions, slot_ids=None, self_attend: bool = False,
               kv_unaligned: bool = False, use_kernel: bool = True) -> torch.Tensor:
        """The blocks of :meth:`forward` on embedded rows x [B, T, hidden]:
        the same routes (decode kernel, prefill kernel or eager attention),
        the cache's layers written in place, its lengths left as they are."""
        if kv_unaligned and (slot_ids is not None or self_attend):
            raise ValueError("kv_unaligned writes row i to slot i: no slot_ids, no self_attend")
        cfg = self.cfg
        T = x.shape[1]
        S = cache.S
        positions = positions.long()
        flash = cfg.flash_decode and cfg.head_dim % 128 == 0
        decode = T == 1 and slot_ids is None and not self_attend and flash and S >= FLASH_MIN_S
        # T > 1 against the cache (a chunk of a long prompt, or a whole prompt
        # through the cache): on the card the prefill-attention kernel reads
        # only the rows each q-tile can see; the eager path reads the slots'
        # whole allocation and, for the int8 cache, dequantizes all of it first
        flash_prefill = T > 1 and not self_attend and flash and use_kernel and x.is_cuda
        mask = None
        if self_attend:
            # mask[b, q, t]: new row t visible to query q (causal, non-pad)
            mask = (positions[:, None, :] <= positions[:, :, None]) & (positions[:, None, :] < S)
            if cfg.sliding_window is not None:
                mask &= positions[:, :, None] - positions[:, None, :] < cfg.sliding_window
        elif not decode and not flash_prefill:
            # mask[b, q, s]: cache position s visible to query q
            s_idx = torch.arange(S, device=x.device)[None, None, :]
            mask = s_idx <= positions[:, :, None]
            if cfg.sliding_window is not None:
                mask &= positions[:, :, None] - s_idx < cfg.sliding_window

        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                           cfg.rope_scaling_factor)
        for li, block in enumerate(self.blocks):
            x = block(x, positions, rope, cache, li, mask, slot_ids, self_attend, use_kernel,
                      flash_prefill, kv_unaligned)
        return x

    def head(self, x, logits_rows: Optional[torch.Tensor] = None,
             use_kernel: bool = True) -> torch.Tensor:
        """The final norm and lm_head of x [B, T, hidden]: logits [B, T, V],
        or ``[B, 1, V]`` of the rows' ``logits_rows`` [B] only."""
        x = rms_norm(x, self.ln_final, self.cfg.rms_eps)
        if logits_rows is not None:
            idx = logits_rows.long()[:, None, None].expand(x.shape[0], 1, x.shape[-1])
            x = torch.gather(x, 1, idx)  # [B, 1, h]
        return self.lm_head(x, use_kernel)


def init_params(
    gen: torch.Generator,
    cfg: LlamaConfig,
    bits: Optional[int] = 4,
    group_size: int = 128,
    dtype=torch.bfloat16,
    tp: int = 1,
    fuse: bool = True,
    act_order: bool = False,
) -> Llama:
    """A random model on ``gen``'s device: normal weights of scale
    ``fan_in ** -0.5`` quantized to ``bits`` by :func:`quantize_array`
    (``None``: kept dense in ``dtype``), q|k|v and gate|up fused (``fuse``) or
    split, unit norms (port of ``models.llama.init_params``; the two packages
    draw different numbers from a seed).

    ``tp > 1`` packs for a ``tp``-way model axis, from the same draws: wo and
    w_down row-sharded (``quantize_array(row_shards=tp)``; act-order sorts
    each K-shard's rows), the fused columns interleaved per shard
    (:func:`interleave_order`).  Such a model runs through
    ``parallel.model_tp`` (``shard_params`` gives each rank its shard)."""
    dev = gen.device
    if tp > 1:
        cfg.local(tp)  # the heads and the FFN must split

    def q(kdim, ndim, scale, row_parallel=False):
        w = torch.randn((kdim, ndim), generator=gen, device=dev) * scale
        if bits is None:
            return w.to(dtype)
        return quantize_array(w, bits, group_size, act_order=act_order,
                              row_shards=tp if row_parallel else 1)

    def q_fused(kdim, sizes, scale):
        w = torch.randn((kdim, sum(sizes)), generator=gen, device=dev) * scale
        if tp > 1:
            w = w[:, torch.from_numpy(interleave_order(sizes, tp)).to(dev)]
        if bits is None:
            return w.to(dtype)
        return quantize_array(w, bits, group_size, act_order=act_order)

    def ones():
        return torch.ones(cfg.hidden_size, dtype=torch.float32, device=dev)

    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    s = h ** -0.5
    blocks = []
    for _ in range(cfg.num_layers):
        if fuse:
            proj = dict(wqkv=q_fused(h, (qdim, kvdim, kvdim), s),
                        w_gateup=q_fused(h, (ffn, ffn), s))
        else:
            proj = dict(wq=q(h, qdim, s), wk=q(h, kvdim, s), wv=q(h, kvdim, s),
                        w_gate=q(h, ffn, s), w_up=q(h, ffn, s))
        proj.update(wo=q(qdim, h, s, row_parallel=True),
                    w_down=q(ffn, h, ffn ** -0.5, row_parallel=True))
        blocks.append(LlamaBlock(cfg, proj, ones(), ones()))
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=dev) * 0.02).to(dtype)
    return Llama(cfg, embed, blocks, ones(), q(h, cfg.vocab_size, s))


def decode_step(model: Llama, tokens, cache: KVCache, active=None, use_kernel: bool = True):
    """One decode step: tokens int [B] at positions ``cache.lengths``; returns
    logits [B, V].  ``active`` (bool [B]) masks slots: inactive slots compute
    but write nothing and advance nothing."""
    positions = cache.lengths[:, None].clone()
    if active is not None:
        positions = torch.where(active[:, None], positions, cache.S)
    logits, cache = model(tokens[:, None], cache, positions, use_kernel=use_kernel)
    return logits[:, -1, :], cache


def spec_verify_step(model: Llama, tokens, cache: KVCache, active=None,
                     use_kernel: bool = True):
    """Speculative-decoding verify (port of ``models.llama.spec_verify_step``):
    each slot's current token ``tokens[:, 0]`` and ``T - 1`` drafted tokens
    [B, T] go through ONE forward at positions ``lengths + t`` (inactive slots
    at S, every position capped at S), which writes their rows
    (``kv_unaligned``); the longest prefix of drafts that the model's greedy
    choice agrees with is accepted, and the lengths roll back to it.

    Returns ``(greedy [B, T], accepted [B], cache)``: slot b emits the drafts
    ``tokens[b, 1 : 1 + accepted[b]]`` and then ``greedy[b, accepted[b]]``,
    capped at its capacity (``lengths`` advance by ``min(accepted + 1,
    S - lengths)``; inactive slots keep theirs).  Rows past the new length
    stay written, unseen, until a later write replaces them.  Tensor ops
    only, with no read-back to the host, so a CUDA graph can capture it."""
    B, T = tokens.shape
    S = cache.S
    old = cache.lengths.clone()
    positions = old.long()[:, None] + torch.arange(T, device=tokens.device)[None]
    if active is not None:
        positions = torch.where(active[:, None], positions, S)
    positions = positions.clamp(max=S)  # drafts past the capacity are inert
    logits, cache = model(tokens, cache, positions, kv_unaligned=True, use_kernel=use_kernel)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    match = (greedy[:, :-1] == tokens[:, 1:]).to(torch.int32)
    accepted = match.cumprod(dim=1).sum(dim=1).to(torch.int32)
    new = old + torch.minimum(accepted + 1, (S - old).clamp(min=0))
    if active is not None:
        new = torch.where(active, new, old)
    cache.lengths.copy_(new)
    return greedy, accepted, cache


def prefill_slots(model: Llama, tokens, true_lens, slots, cache: KVCache,
                  use_kernel: bool = True):
    """Prefill n requests into n cache slots in one forward.

    ``tokens`` int [n, T] zero-padded, ``true_lens`` / ``slots`` int [n].  A
    row with ``true_len == 0`` and an out-of-range slot is inert.  Returns
    last-token logits [n, V] and the cache (updated in place)."""
    n, T = tokens.shape
    S = cache.S
    true_lens = true_lens.to(tokens.device).long()
    slots = slots.to(tokens.device).long()
    pos = torch.arange(T, device=tokens.device)[None]
    positions = torch.where(pos < true_lens[:, None], pos, S)
    logits, cache = model(
        tokens, cache, positions, slot_ids=slots, self_attend=True,
        logits_rows=torch.clamp(true_lens - 1, min=0), use_kernel=use_kernel,
    )
    # reset each slot's length outright: a recycled slot may hold a longer one
    ok = (slots >= 0) & (slots < cache.lengths.shape[0])
    cache.lengths[slots[ok]] = true_lens[ok].to(torch.int32)
    return logits[:, 0], cache


def prefill_slot(model: Llama, tokens, true_len: int, slot: int, cache: KVCache,
                 use_kernel: bool = True):
    """Prefill one request (``tokens`` int [T], zero-padded past ``true_len``)
    into cache slot ``slot``; returns its last-token logits [V]."""
    dev = tokens.device
    logits, cache = prefill_slots(
        model, tokens[None], torch.tensor([true_len], device=dev),
        torch.tensor([slot], device=dev), cache, use_kernel=use_kernel,
    )
    return logits[0], cache


def prefill_slots_chunk(model: Llama, tokens, starts, true_lens, slots, cache: KVCache,
                        resets=None, use_kernel: bool = True):
    """One chunk for each of n long prompts in one forward.  Unlike
    :func:`prefill_slots`, attention reads the slots' cache (the earlier
    chunks) and the chunk itself, so a prompt of any length prefills in pieces
    of a fixed size.

    ``tokens`` int [n, C] are prompt positions ``[starts, starts + C)`` of
    each row (padding past ``true_lens`` is masked out);
    ``starts``/``true_lens``/``slots`` int [n]; ``resets`` bool [n] clears a
    recycled slot's stale length (first chunk).  A row whose prompt is
    exhausted, or a padding row, is inert: ``true_len = 0`` and an
    out-of-range slot.  Returns the logits row [n, V] of each prompt's last
    token (meaningful once that row's final chunk ran) and the cache."""
    n, C = tokens.shape
    dev = tokens.device
    S = cache.S
    starts = starts.to(dev).long()
    true_lens = true_lens.to(dev).long()
    slots = slots.to(dev).long()
    pos = starts[:, None] + torch.arange(C, device=dev)[None]
    positions = torch.where(pos < true_lens[:, None], pos, S)
    if resets is not None:
        ok = (slots >= 0) & (slots < cache.lengths.shape[0]) & resets.to(dev).bool()
        cache.lengths[slots[ok]] = 0
    last_in_chunk = torch.clamp(true_lens - 1 - starts, 0, C - 1)
    logits, cache = model(tokens, cache, positions, slot_ids=slots, logits_rows=last_in_chunk,
                          use_kernel=use_kernel)
    return logits[:, 0], cache


def prefill_slot_chunk(model: Llama, tokens, start: int, true_len: int, slot: int,
                       cache: KVCache, reset: bool = False, use_kernel: bool = True):
    """One chunk (``tokens`` int [C], prompt positions ``[start, start + C)``)
    of one long prompt into cache slot ``slot``; returns the logits [V] of the
    prompt's last token (meaningful once the final chunk ran)."""
    dev = tokens.device
    logits, cache = prefill_slots_chunk(
        model, tokens[None], torch.tensor([start], device=dev),
        torch.tensor([true_len], device=dev), torch.tensor([slot], device=dev), cache,
        resets=torch.tensor([reset], device=dev), use_kernel=use_kernel,
    )
    return logits[0], cache


def prefill(model: Llama, tokens, cache: KVCache, use_kernel: bool = True):
    """Prefill a [B, T] prompt (all slots the same length) through the cache."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    return model(tokens, cache, positions, use_kernel=use_kernel)
