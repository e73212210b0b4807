"""Quantized Llama-family decoder in PyTorch (port of ``xbitops_tpu/models/llama.py``).

Every projection is a :class:`QLinear` over a packed
:class:`~xbitops_tpu_torch.formats.QTensor`, run by the fused dequant-matmul
kernel.  The KV cache is head-major ``[L, B, Hkv, S, D]`` bf16 and, unlike the
JAX package's functional updates, every function here writes it IN PLACE and
returns the same :class:`KVCache` object.  Positions ``>= S`` mark padding and
inactive slots: they write nothing and advance no length.

RMSNorm, RoPE, SiLU-times-up, the embedding and the eager attention are plain
PyTorch, as the JAX package left them to XLA.  Decode (one token per slot)
attends through the decode-attention kernel, which appends the new k/v rows
first.  Not ported yet: the int8 and paged caches, unaligned (speculative)
writes, chunked prefill against the cache, MoE layers and W4A8 prefill.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from xbitops_tpu_torch.kernels.kv_append import (
    kv_append_dense,
    kv_append_dense_reference,
)
from xbitops_tpu_torch.ops.qmatmul import qmatmul


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
    prefill_a8: bool = False  # W4A8 prefill: not ported
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


# Smallest cache capacity routed to the decode-attention kernel.  The value is
# the JAX package's, measured on a TPU v5e; it is kept for parity until the
# H100 re-derives it.
FLASH_MIN_S = 64


@dataclasses.dataclass
class KVCache:
    """Head-major cache ``k, v: [L, B, Hkv, S, D]`` with per-slot ``lengths``
    (int32 [B]).  Updated in place by the model."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def S(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, device, dtype=torch.bfloat16,
             quantized: bool = False) -> "KVCache":
        if quantized:
            raise NotImplementedError("the int8 KV cache is not ported yet")
        if dtype != torch.bfloat16:
            raise NotImplementedError("the port's KV cache is bf16")
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @staticmethod
    def init_paged(*args, **kwargs) -> "KVCache":
        raise NotImplementedError("the paged KV cache is not ported yet")


class QLinear(nn.Module):
    """A projection over a packed QTensor, whose arrays it holds as buffers."""

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

    def forward(self, x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
        return qmatmul(x, self.qtensor, out_dtype=x.dtype, use_kernel=use_kernel)


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
    Only rows with 0 <= position < S and 0 <= slot < B are written."""
    n, T = positions.shape
    B, Hkv, S = cache.k.shape[1], cache.k.shape[2], cache.S
    rows = torch.arange(n, device=positions.device) if slot_ids is None else slot_ids.long()
    slot = rows[:, None].expand(n, T)
    ok = (slot >= 0) & (slot < B) & (positions >= 0) & (positions < S)
    s_ok, p_ok = slot[ok], positions[ok].long()
    h = torch.arange(Hkv, device=positions.device)
    idx = (s_ok[:, None], h[None, :], p_ok[:, None])
    cache.k[li].index_put_(idx, k[ok].to(cache.k.dtype))
    cache.v[li].index_put_(idx, v[ok].to(cache.v.dtype))


class LlamaBlock(nn.Module):
    """One transformer block: attention with a fused ``wqkv`` or split
    ``wq/wk/wv`` projection, then a SiLU MLP with fused ``w_gateup`` or split
    ``w_gate/w_up`` projections."""

    def __init__(self, cfg: LlamaConfig, proj: Dict[str, QTensor],
                 ln_attn: torch.Tensor, ln_mlp: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        for name, qt in proj.items():
            if not isinstance(qt, QTensor):
                raise NotImplementedError(f"{name}: only packed (QTensor) weights are ported")
            self.add_module(name, QLinear(qt))
        self.register_buffer("ln_attn", ln_attn)
        self.register_buffer("ln_mlp", ln_mlp)

    def forward(self, x, positions, rope, cache: KVCache, li: int, mask, slot_ids=None,
                self_attend: bool = False, use_kernel: bool = True):
        """x [B, T, hidden] at ``positions`` [B, T] (``rope``: their
        :func:`rope_tables`); writes layer ``li`` of ``cache`` in place.
        ``mask`` None means decode through the decode-attention kernel."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qdim, kvdim = H * D, Hkv * D

        hx = rms_norm(x, self.ln_attn, cfg.rms_eps)
        if hasattr(self, "wqkv"):
            qkv = self.wqkv(hx, use_kernel)
            q = qkv[..., :qdim].reshape(B, T, H, D)
            k = qkv[..., qdim : qdim + kvdim].reshape(B, T, Hkv, D)
            v = qkv[..., qdim + kvdim :].reshape(B, T, Hkv, D)
        else:
            q = self.wq(hx, use_kernel).reshape(B, T, H, D)
            k = self.wk(hx, use_kernel).reshape(B, T, Hkv, D)
            v = self.wv(hx, use_kernel).reshape(B, T, Hkv, D)
        q = _rope(q, rope)
        k = _rope(k, rope)

        S = cache.S
        if mask is None:  # decode through the kernel, which appends first
            lens = torch.clamp(positions[:, 0] + 1, max=S)
            if use_kernel:
                att = decode_attention(
                    q[:, 0], cache.k, cache.v, lens, layer_idx=li,
                    kv_new=(k[:, 0], v[:, 0], positions[:, 0]),
                    window=cfg.sliding_window,
                )[0]
            else:
                kv_append_dense_reference(
                    cache.k, cache.v, k[:, 0], v[:, 0], positions[:, 0], li)
                att = decode_attention_reference(
                    q[:, 0], cache.k[li], cache.v[li], lens, cfg.sliding_window)
            att = att[:, None]
        else:
            if T == 1 and slot_ids is None and not self_attend:
                append = kv_append_dense if use_kernel else kv_append_dense_reference
                append(cache.k, cache.v, k[:, 0], v[:, 0], positions[:, 0], li)
            else:
                _write_rows(cache, li, k, v, positions, slot_ids)
            if self_attend:  # a fresh request attends only its own rows
                att = _attention(q, k.transpose(1, 2), v.transpose(1, 2), mask, D ** -0.5)
            else:
                att = _attention(q, cache.k[li], cache.v[li], mask, D ** -0.5)
        x = x + self.wo(att.reshape(B, T, qdim), use_kernel)

        hx = rms_norm(x, self.ln_mlp, cfg.rms_eps)
        if hasattr(self, "w_gateup"):
            gu = self.w_gateup(hx, use_kernel)
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        else:
            gate, up = self.w_gate(hx, use_kernel), self.w_up(hx, use_kernel)
        act = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
        return x + self.w_down(act, use_kernel)


class Llama(nn.Module):
    """The decoder: embedding, blocks, final norm and the packed lm_head."""

    def __init__(self, cfg: LlamaConfig, embed: torch.Tensor, blocks: List[LlamaBlock],
                 ln_final: torch.Tensor, lm_head: QTensor):
        super().__init__()
        if cfg.prefill_a8:
            raise NotImplementedError("W4A8 prefill (prefill_a8) is not ported yet")
        self.cfg = cfg
        self.register_buffer("embed", embed)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("ln_final", ln_final)
        self.lm_head = QLinear(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

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
        in place.  Rows attend the cache rows of their slot up to their
        position, or with ``self_attend`` (a fresh request) only their own
        new rows.  ``use_kernel=False`` runs every kernel's plain version."""
        if kv_unaligned:
            raise NotImplementedError("unaligned (speculative) writes are not ported yet")
        if slot_ids is not None and not self_attend:
            raise NotImplementedError(
                "chunked prefill against the cache (prefill_attention) is not ported yet")
        cfg = self.cfg
        B, T = tokens.shape
        S = cache.S
        positions = positions.long()
        x = self.embed[tokens.long()].to(torch.bfloat16)

        decode = (
            T == 1 and slot_ids is None and not self_attend and cfg.flash_decode
            and cfg.head_dim % 128 == 0 and S >= FLASH_MIN_S
        )
        mask = None
        if self_attend:
            # mask[b, q, t]: new row t visible to query q (causal, non-pad)
            mask = (positions[:, None, :] <= positions[:, :, None]) & (positions[:, None, :] < S)
            if cfg.sliding_window is not None:
                mask &= positions[:, :, None] - positions[:, None, :] < cfg.sliding_window
        elif not decode:
            # mask[b, q, s]: cache position s visible to query q
            s_idx = torch.arange(S, device=tokens.device)[None, None, :]
            mask = s_idx <= positions[:, :, None]
            if cfg.sliding_window is not None:
                mask &= positions[:, :, None] - s_idx < cfg.sliding_window

        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                           cfg.rope_scaling_factor)
        for li, block in enumerate(self.blocks):
            x = block(x, positions, rope, cache, li, mask, slot_ids, self_attend, use_kernel)

        x = rms_norm(x, self.ln_final, cfg.rms_eps)
        if logits_rows is not None:
            idx = logits_rows.long()[:, None, None].expand(B, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)  # [B, 1, h]
        logits = self.lm_head(x, use_kernel)
        valid_next = torch.where(positions < S, positions + 1, 0).amax(dim=1).to(torch.int32)
        if slot_ids is None:
            torch.maximum(cache.lengths, valid_next, out=cache.lengths)
        else:
            rows = slot_ids.long()
            ok = (rows >= 0) & (rows < cache.lengths.shape[0])
            rows, vals = rows[ok], valid_next[ok]
            cache.lengths[rows] = torch.maximum(cache.lengths[rows], vals)
        return logits, cache


def decode_step(model: Llama, tokens, cache: KVCache, active=None, use_kernel: bool = True):
    """One decode step: tokens int [B] at positions ``cache.lengths``; returns
    logits [B, V].  ``active`` (bool [B]) masks slots: inactive slots compute
    but write nothing and advance nothing."""
    positions = cache.lengths[:, None].clone()
    if active is not None:
        positions = torch.where(active[:, None], positions, cache.S)
    logits, cache = model(tokens[:, None], cache, positions, use_kernel=use_kernel)
    return logits[:, -1, :], cache


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


def prefill(model: Llama, tokens, cache: KVCache, use_kernel: bool = True):
    """Prefill a [B, T] prompt (all slots the same length) through the cache."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    return model(tokens, cache, positions, use_kernel=use_kernel)
