"""Dense (unquantized) matmul: the a16w16 comparator, and the projection of a
model that keeps a weight dense (port of ``xbitops_tpu/ops/dense.py``).

The JAX package computes it outside any Pallas kernel (a bf16 ``jnp.dot``),
so here too it is a library call.
"""

from __future__ import annotations

import torch


def dense_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a[..., K] @ w[K, N]`` in bf16 with f32 accumulation, in ``a``'s dtype."""
    if a.is_cuda:  # bf16 operands; cuBLAS accumulates them in f32
        return (a.to(torch.bfloat16) @ w.to(torch.bfloat16)).to(a.dtype)
    # the CPU's bf16 matmul may round partial sums: do what the card does
    return (a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()).to(a.dtype)
