"""Plain PyTorch reference of the Llama-family decoder that the Mistral and
Mixtral configurations name: float32, TF32 off, no kernel, no cache, no
batching, and nothing of the program.

One whole causal forward a sequence: RMSNorm, fused q|k|v, rotate-half RoPE,
grouped-query attention over positions ``(p - sliding_window, p]`` (the whole
prefix without a window), wo, then the SiLU MLP (fused gate|up, down) or the
routed experts (f32 router logits, the top ``num_experts_per_tok``, softmax
over their logits, no capacity: every route is computed), the final norm and
the lm_head.  The packed 4-bit words are unpacked here from the format's
paired layout: within a K-tile, row ``kl = j * (tile_k / 4) + 2 r + h`` is the
nibble at bit ``4 j + 16 h`` of word row ``r``; its group is
``kl // group_size`` of the tile's scale rows.

``act`` rounds the input of every projection (not the router's); None keeps
float32.  :func:`fp8_rows` is the control's rounding (float8 e4m3 with a scale
a row).  Weights are drawn layer by layer from the seed (``core/synth.py``),
so the reference never holds more than one layer's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from benchmark.core import synth


def f32_exact() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def unpack(p: synth.Packed, expert: Optional[int] = None) -> torch.Tensor:
    """The dequantized float32 weight ``[K, N]`` (of one expert of a stack)."""
    words, scales, zeros = p.words, p.scales, p.scale_zeros
    if expert is not None:
        words, scales, zeros = words[expert], scales[expert], zeros[expert]
    K, N, tk, g = p.K, p.N, p.tile_k, p.group_size
    w = words.reshape(K // tk, 1, tk // 8, 1, N)
    j = torch.arange(4, device=w.device, dtype=torch.int32).reshape(1, 4, 1, 1, 1)
    h = torch.arange(2, device=w.device, dtype=torch.int32).reshape(1, 1, 1, 2, 1)
    q = ((w >> (4 * j + 16 * h)) & 15).reshape(K, N)
    gt = max(1, tk // g)  # scale rows a tile uses: a group each, or one for the tile
    rows = torch.arange(K, device=w.device)
    tile, grp = rows // tk, (rows % tk) // g if gt > 1 else torch.zeros_like(rows)
    s = scales[:, :gt].float()[tile, grp]
    sz = zeros[:, :gt].float()[tile, grp]
    return q.float() * s - sz


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x [T, heads, D]`` at positions 0 .. T-1."""
    T, _, D = x.shape
    inv = theta ** (-torch.arange(0, D // 2, dtype=torch.float64, device=x.device) / (D // 2))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : D // 2], x[..., D // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """``x [..., D]`` rounded to 4-bit integers with one scale a row (its
    largest magnitude to 7), back in float32: a cache one step below int8."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 7.0
    return (x / scale).round().clamp(-8, 7) * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a row (its largest
    magnitude to 448), back in float32: the control's activations."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The model of a configuration file, drawn from ``seed`` on ``device``."""

    def __init__(self, cfg: Dict, seed: int, device,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 kv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.shape = synth.Shape.of(cfg)
        self.act = act or (lambda x: x)
        self.kv = kv or (lambda x: x)
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.window = cfg.get("sliding_window")
        self.top_k = cfg.get("num_experts_per_tok", 0)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w

    def _attention(self, x: torch.Tensor, W: Dict[str, torch.Tensor]) -> torch.Tensor:
        s = self.shape
        T = x.shape[0]
        H, Hkv, D = s.heads, s.kv_heads, s.head_dim
        qkv = self._mm(rms_norm(x, W["ln_attn"], self.eps), W["wqkv"])
        q = rope(qkv[:, : H * D].reshape(T, H, D), self.theta)
        k = rope(qkv[:, H * D : (H + Hkv) * D].reshape(T, Hkv, D), self.theta)
        v = qkv[:, (H + Hkv) * D :].reshape(T, Hkv, D)
        k, v = self.kv(k), self.kv(v)
        rep = H // Hkv
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
        pos = torch.arange(T, device=x.device)
        seen = pos[None, :] <= pos[:, None]
        if self.window is not None:
            seen &= pos[:, None] - pos[None, :] < self.window
        scores = scores.masked_fill(~seen[None], float("-inf"))
        att = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
        return x + self._mm(att.reshape(T, H * D), W["wo"])

    def _mlp(self, hx: torch.Tensor, W: Dict[str, torch.Tensor]) -> torch.Tensor:
        ffn = self.shape.ffn
        gu = self._mm(hx, W["w_gateup"])
        return self._mm(torch.nn.functional.silu(gu[:, :ffn]) * gu[:, ffn:], W["w_down"])

    def _experts(self, hx: torch.Tensor, W: Dict[str, object], li: int) -> torch.Tensor:
        s = self.shape
        top_logits, top = (hx @ W["router"]).topk(self.top_k, dim=-1)
        probs = torch.softmax(top_logits, dim=-1)
        out = torch.zeros_like(hx)
        for e in range(s.experts):
            tok, slot = (top == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            gu = self._mm(hx[tok], unpack(W["w_experts_gateup"], e))
            y = self._mm(torch.nn.functional.silu(gu[:, : s.ffn]) * gu[:, s.ffn :],
                         unpack(W["w_experts_down"], e))
            out.index_add_(0, tok, y * probs[tok, slot, None])
        return out

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Float32 logits ``[len(wanted[i]), vocab]`` at positions
        ``wanted[i]`` of each token sequence ``seqs[i]``."""
        f32_exact()
        s, dev = self.shape, self.device
        embed = synth.embedding(self.seed, s, dev)
        xs = [embed[torch.tensor(list(t), device=dev)].float() for t in seqs]
        del embed
        for li in range(s.layers):
            raw = synth.layer(self.seed, s, li, dev)
            W = {k: unpack(v) if isinstance(v, synth.Packed) and k in ("wqkv", "wo", "w_gateup",
                                                                        "w_down") else v
                 for k, v in raw.items()}
            for i, x in enumerate(xs):
                x = self._attention(x, W)
                hx = rms_norm(x, W["ln_mlp"], self.eps)
                x = x + (self._experts(hx, W, li) if s.experts else self._mlp(hx, W))
                xs[i] = x
            del raw, W
        ln_final, lm_head = synth.head(self.seed, s, dev)
        w_head = unpack(lm_head)
        out = []
        for x, rows in zip(xs, wanted):
            hx = rms_norm(x[torch.tensor(list(rows), device=dev)], ln_final, self.eps)
            out.append(self._mm(hx, w_head))
        return out
