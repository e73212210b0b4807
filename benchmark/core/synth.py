"""Packed 4-bit weights, norms and embeddings drawn from a run's seed.

Plain PyTorch only: the program (through its public constructors) and the
plain reference both take their tensors from here, and the reference
imports nothing of the program.  Every tensor has a generator of its own,
seeded from the run's seed and the tensor's name, so that the reference can
draw one layer again after the program's state is freed.

The arithmetic is a frozen copy of the port's random packed weights
(``xbitops_tpu_torch/utils/synth.random_qtensor``): random bits in every
word, fp16 group scales uniform in [0.002, 0.01), zero points uniform in
[0.4, 0.6] of the range, ``scale_zeros = (scale * zero)`` rounded to fp16,
and a dequantized value ``q * scale - scale_zero``.  The layout is the packed
format's paired 4-bit plane (see ``reference/llama.py`` for its unpacking).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

BITS = 4
SCALE_LO, SCALE_HI = 0.002, 0.01
# A configuration file's ``weights`` may set three scales of the draws: the
# projections that write into the residual stream draw their group scales
# ``out_scale`` times smaller (wo, a dense MLP's down) or ``expert_out_scale``
# times (the experts' down), and the embedding is of scale ``embed_scale``.
# The full-size configurations set them so that each layer adds a small update
# to the residual, as a trained model's layers do, and the random model is not
# chaotic (PERF.md, the check's readings).
DEFAULT_WEIGHTS = dict(embed_scale=0.02, out_scale=1.0, expert_out_scale=1.0)


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for tensor ``name`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(tensor_seed(seed, name))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_k(K: int, group_size: int) -> int:
    """The packed format's K-tile for 4-bit weights (a copy of its rule):
    8 groups where padding K to it wastes at most 1/8 of K, else the largest
    of 1024 ... 64 that divides K and is whole groups or a part of one."""
    aligned = 8 * group_size
    if aligned % 64 == 0 and aligned <= 4096 and (_round_up(K, aligned) - K) * 8 <= K:
        return aligned
    for c in (1024, 512, 256, 128, 64):
        if K % c == 0 and (c % group_size == 0 or group_size % c == 0):
            return c
    raise ValueError(f"no K-tile for K={K}, group_size={group_size}")


@dataclass
class Packed:
    """One packed 4-bit weight ``[(E,) K, N]``: int32 words ``[(E,) K/8, N]``
    in the paired layout, fp16 ``scales`` and ``scale_zeros``
    ``[(E,) K/tile_k, gt_pad, N]``."""

    words: torch.Tensor
    scales: torch.Tensor
    scale_zeros: torch.Tensor
    K: int
    N: int
    tile_k: int
    group_size: int


def packed(seed: int, name: str, K: int, N: int, group_size: int, device,
           experts: int = 0, scale: float = 1.0) -> Packed:
    """Weight ``name``: ``[K, N]``, or ``experts`` of them stacked; its group
    scales ``scale`` times the usual."""
    tk = tile_k(K, group_size)
    if K % tk or (tk // 4) % 16:
        raise ValueError(f"K={K} does not fill tiles of {tk} in the paired layout")
    gen = generator(seed, name, device)
    lead = (experts,) if experts else ()
    words = torch.randint(-(2**31), 2**31, lead + (K // 8, N), generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    gt_pad = _round_up(max(1, tk // group_size), 8)
    shape = lead + (K // tk, gt_pad, N)
    maxq = (1 << BITS) - 1
    scales = torch.empty(shape, device=device).uniform_(scale * SCALE_LO, scale * SCALE_HI, generator=gen)
    zeros = torch.empty(shape, device=device).uniform_(0.4 * maxq, 0.6 * maxq, generator=gen)
    return Packed(words, scales.half(), (scales * zeros).half(), K, N, tk, group_size)


def norm(seed: int, name: str, n: int, device) -> torch.Tensor:
    """An RMSNorm weight: f32, uniform in [0.75, 1.25)."""
    gen = generator(seed, name, device)
    return torch.empty(n, device=device).uniform_(0.75, 1.25, generator=gen)


def embedding(seed: int, s: "Shape", device) -> torch.Tensor:
    """The token embedding, bf16 ``[vocab, hidden]`` of scale ``embed_scale``."""
    gen = generator(seed, "embed", device)
    return (torch.randn((s.vocab, s.hidden), generator=gen, device=device)
            * s.embed_scale).to(torch.bfloat16)


def router(seed: int, layer: int, hidden: int, experts: int, device) -> torch.Tensor:
    """A layer's router, f32 ``[hidden, experts]`` of scale ``hidden ** -0.5``."""
    gen = generator(seed, f"{layer}.router", device)
    return torch.randn((hidden, experts), generator=gen, device=device) * hidden ** -0.5


@dataclass(frozen=True)
class Shape:
    """The sizes of a configuration file that the weights need."""

    vocab: int
    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int  # 0: a dense MLP
    top_k: int  # experts a token takes
    window: Optional[int]  # sliding window, None: the whole prefix
    group_size: int
    embed_scale: float
    out_scale: float
    expert_out_scale: float

    @staticmethod
    def of(cfg: Dict) -> "Shape":
        q = cfg["quantization"]
        if q["bits"] != BITS:
            raise ValueError(f"only {BITS}-bit weights are drawn, not {q['bits']}")
        return Shape(
            vocab=cfg["vocab_size"], hidden=cfg["hidden_size"], ffn=cfg["intermediate_size"],
            layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
            kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
            experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
            window=cfg.get("sliding_window"), group_size=q["group_size"],
            **{**DEFAULT_WEIGHTS, **cfg.get("weights", {})})


def layer(seed: int, s: Shape, li: int, device) -> Dict[str, object]:
    """Layer ``li``'s weights: fused ``wqkv`` ``[h, (H + 2 Hkv) D]``, ``wo``,
    the MLP's fused ``w_gateup`` ``[h, 2 ffn]`` (gate columns first) and
    ``w_down``, or the router and the stacked experts, and the two norms."""
    h, qd, kvd = s.hidden, s.heads * s.head_dim, s.kv_heads * s.head_dim
    g = s.group_size
    out = dict(
        wqkv=packed(seed, f"{li}.wqkv", h, qd + 2 * kvd, g, device),
        wo=packed(seed, f"{li}.wo", qd, h, g, device, scale=s.out_scale),
        ln_attn=norm(seed, f"{li}.ln_attn", h, device),
        ln_mlp=norm(seed, f"{li}.ln_mlp", h, device),
    )
    if s.experts:
        out.update(router=router(seed, li, h, s.experts, device),
                   w_experts_gateup=packed(seed, f"{li}.experts_gateup", h, 2 * s.ffn, g,
                                           device, experts=s.experts),
                   w_experts_down=packed(seed, f"{li}.experts_down", s.ffn, h, g, device,
                                         experts=s.experts, scale=s.expert_out_scale))
    else:
        out.update(w_gateup=packed(seed, f"{li}.w_gateup", h, 2 * s.ffn, g, device),
                   w_down=packed(seed, f"{li}.w_down", s.ffn, h, g, device, scale=s.out_scale))
    return out


def head(seed: int, s: Shape, device) -> Tuple[torch.Tensor, Packed]:
    """The final norm and the lm_head ``[h, vocab]``."""
    return (norm(seed, "ln_final", s.hidden, device),
            packed(seed, "lm_head", s.hidden, s.vocab, s.group_size, device))
