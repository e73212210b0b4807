"""Token sampling: greedy / temperature / top-k / top-p (port of
``xbitops_tpu/engine/sampling.py``).  Randomness comes from an explicit
``torch.Generator``; it gives other draws than JAX's keys for the same seed.
A row is drawn by the exponential race, argmax of p / E with E ~ Exp(1): the
draw ``torch.multinomial`` makes for one sample, from the same generator, but
without its host-side checks of the probabilities, which read them back and
so cannot run inside a CUDA graph."""

from __future__ import annotations

import torch


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B]; <= 0 means greedy
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """One token per row (int32 [B]).  Greedy rows are exact argmax whatever
    top_k / top_p say."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    temperature = temperature.to(logits.device, torch.float32)
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix with cumulative probability >= top_p; the
        # argmax always stays, so top_p <= 0 cannot empty a row
        keep = cum - probs < top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
    probs = torch.softmax(scaled, dim=-1)
    sampled = (probs / torch.empty_like(probs).exponential_(1, generator=generator)).argmax(dim=-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)
