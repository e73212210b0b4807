"""Model-quality evaluation: next-token NLL and perplexity (port of
``xbitops_tpu/utils/evaluate.py``).

"Does quantization preserve the distribution" is a model-level question: the
perplexity of a quantized model against its dense source on one token stream.
"""

from __future__ import annotations

import torch

from xbitops_tpu_torch.models import llama


def sequence_nll(model: llama.Llama, tokens: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """Mean next-token negative log-likelihood over positions 0..T-2 of
    ``tokens`` int [B, T] (on the model's device), f32 [B]."""
    B, T = tokens.shape
    cache = llama.KVCache.init(model.cfg, B, model.device)
    logits, _ = llama.prefill(model, tokens, cache, use_kernel=use_kernel)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, 2, tokens[:, 1:, None].long())[..., 0]
    return nll.mean(dim=1)


def perplexity(model: llama.Llama, tokens: torch.Tensor, use_kernel: bool = True) -> float:
    """Corpus perplexity: exp(mean NLL) over all rows of ``tokens``."""
    return float(torch.exp(sequence_nll(model, tokens, use_kernel).mean()))
