"""The operations and bytes the metrics count, from a configuration's sizes
(``core/synth.Shape``) alone: the yardstick, kept with the benchmark.

Weights are 4-bit packed words with fp16 scales and scale-zeros, one of each
a group of ``group_size`` rows; the KV cache is the packed int8 one (a byte an
element, a bf16 scale a position and kv head, for k and for v).
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.core.synth import Shape


def projections(s: Shape) -> List[Tuple[int, int, int]]:
    """``(K, N, copies)`` of every packed projection of one layer: q|k|v,
    wo, then gate|up and down (``copies`` = the experts of a MoE layer)."""
    qd, kvd = s.heads * s.head_dim, s.kv_heads * s.head_dim
    e = max(1, s.experts)
    return [(s.hidden, qd + 2 * kvd, 1), (qd, s.hidden, 1),
            (s.hidden, 2 * s.ffn, e), (s.ffn, s.hidden, e)]


def packed_bytes(s: Shape, K: int, N: int) -> int:
    """Bytes a product reads of a packed ``[K, N]`` weight: the words, and
    the scale and scale-zero of each group."""
    groups = -(-K // s.group_size)
    return K * N // 2 + 2 * 2 * groups * N


def step_weight_bytes(s: Shape) -> int:
    """The packed bytes one decode step streams through the few-rows matmul:
    every projection of every layer (all experts: at 16 rows a MoE layer's
    top-2 routes reach nearly every expert) and the lm_head."""
    layer = sum(c * packed_bytes(s, K, N) for K, N, c in projections(s))
    return s.layers * layer + packed_bytes(s, s.hidden, s.vocab)


def step_launches(s: Shape) -> int:
    """Few-rows matmul launches of one decode step."""
    return s.layers * sum(c for _, _, c in projections(s)) + 1


def token_proj_flops(s: Shape) -> int:
    """2 K N of each projection one token goes through in one forward, over
    the layers, without the lm_head: the router and ``top_k`` experts of a
    MoE layer."""
    k = s.experts and s.top_k
    per = 0
    for K, N, c in projections(s):
        per += 2 * K * N * (k if c > 1 else 1)
    if s.experts:
        per += 2 * s.hidden * s.experts
    return s.layers * per


def tile_flops(s: Shape) -> int:
    """2 K N of the projections the tensor-core tile runs for one prompt
    token at admission (the router is a float32 product, not the tile)."""
    k = s.experts and s.top_k
    return s.layers * sum(2 * K * N * (k if c > 1 else 1) for K, N, c in projections(s))


def attended(s: Shape, rows: int) -> int:
    """Rows a query at position ``rows - 1`` attends: capped at the window."""
    return min(rows, s.window) if s.window else rows


def attn_flops(s: Shape, rows: int) -> int:
    """4 H D a row attended, over the layers."""
    return s.layers * 4 * s.heads * s.head_dim * attended(s, rows)


def lm_head_flops(s: Shape) -> int:
    return 2 * s.hidden * s.vocab


def admission_flops(s: Shape, prompt: int) -> int:
    """Model operations of a prompt's admission: every prompt token's forward
    with its attention, and the lm_head on its last token."""
    return (prompt * token_proj_flops(s) + sum(attn_flops(s, p + 1) for p in range(prompt))
            + lm_head_flops(s))


def decode_flops(s: Shape, prompt: int, index: int) -> int:
    """Model operations of the decode step that serves token ``index`` (>= 1):
    the forward of token ``index - 1`` at position ``prompt + index - 1``."""
    return token_proj_flops(s) + attn_flops(s, prompt + index) + lm_head_flops(s)


def request_flops(s: Shape, prompt: int, served: int) -> int:
    """Model operations of one request: every prompt token's forward with its
    attention, the lm_head where logits are taken (the prompt's last token
    and each decode step), and the decode forwards of served tokens 2 .. n."""
    if served <= 0:
        return 0
    proj = token_proj_flops(s)
    total = prompt * proj + sum(attn_flops(s, p + 1) for p in range(prompt))
    total += served * lm_head_flops(s)
    total += (served - 1) * proj + sum(attn_flops(s, prompt + i) for i in range(1, served))
    return total


def kv_row_bytes(s: Shape) -> int:
    """Bytes of one cached position of one layer: k and v, a byte an element
    and a bf16 scale a kv head."""
    return 2 * s.kv_heads * (s.head_dim + 2)


def decode_attn_bytes(s: Shape, prompt: int, index: int) -> int:
    """Bytes the decode step that serves token ``index`` (>= 1) of a request
    needs: the context rows it reads (the window's, less the new one) and the
    new row it writes, over the layers."""
    rows = attended(s, prompt + index)
    return s.layers * rows * kv_row_bytes(s)
