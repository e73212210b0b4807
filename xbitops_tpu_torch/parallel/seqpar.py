"""Sequence (context) parallelism: ring attention and context-parallel
prefill (port of ``xbitops_tpu/parallel/seqpar.py``).

A long prompt's sequence axis is split over the ``seq`` axis of a process
mesh: rank ``c`` holds positions ``[c T/n, (c+1) T/n)``, runs every
projection on its chunk only (through the fused dequant-matmul), and its
queries meet every rank's keys on a ring (:func:`ring_attention`: the k/v
chunks and their global positions move one rank on by
:func:`~xbitops_tpu_torch.parallel.mesh.ppermute`, ``n - 1`` times).
Causality and the sliding window ride the global positions, so no mask of
``[T, T]`` is made.

:func:`sp_prefill` runs the model this way and leaves every rank with the
last token's logits and the whole dense cache (each layer's k/v chunks
gathered along T), which the one-rank ``llama.decode_step`` continues:
decode has no sequence axis to split.  Tensor parallelism composes on a
``(seq, model)`` mesh: the blocks are ``model_tp.shard_params``' shard and
sum over ``model`` as in ``model_tp``, while the chunks ring over ``seq``.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.models.llama import Llama, LlamaConfig
from xbitops_tpu_torch.parallel.mesh import Mesh, all_gather, ppermute, psum

NEG_INF = -1e30

__all__ = ["ring_attention", "sp_prefill"]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, mesh: Mesh, axis: str = "seq",
                   window: Optional[int] = None) -> torch.Tensor:
    """Causal attention with the sequence split over ``axis``: this rank's
    queries q [B, Tq, H, D] at global positions q_pos int [B, Tq] attend every
    rank's k/v chunk [B, Tc, Hkv, D] at kv_pos [B, Tc] whose position is <=
    their own (and, with ``window``, within ``window`` positions of it); query
    head ``h rep + r`` uses kv head ``h``.  Returns [B, Tq, H, D] in q's
    dtype: dense causal attention over the gathered sequence.

    An online softmax in f32 (running max, denominator and accumulator), one
    step a chunk as it comes round the ring.  It is PyTorch, as the JAX
    package's is ``jnp``: no Pallas kernel computes it there, and no library
    attention call takes the ring's chunks one at a time with their running
    sums."""
    n = mesh.shape[axis]
    D = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    qf = q.float()
    m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc, pc = k, v, kv_pos
    for step in range(n):
        kk = kc.float().repeat_interleave(rep, dim=2)
        vv = vc.float().repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kk) * D ** -0.5
        vis = pc[:, None, :] <= q_pos[:, :, None]
        if window is not None:
            vis &= q_pos[:, :, None] - pc[:, None, :] < window
        s = torch.where(vis[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhk,bkhd->bqhd", p, vv)
        m = m_new
        if step < n - 1:  # after n - 1 rotations every chunk has visited
            kc, vc, pc = (ppermute(t, mesh, axis) for t in (kc, vc, pc))
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def sp_prefill(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens: torch.Tensor,
               cache: llama.KVCache, seq_axis: str = "seq",
               tp_axis: Optional[str] = None):
    """Context-parallel prefill of whole prompts ``tokens`` int [B, T] (every
    row of length T, as ``llama.prefill``; the same tokens on every rank),
    the sequence split over ``seq_axis``, the blocks tensor-parallel over
    ``tp_axis`` (``model``: ``model_tp.shard_params``' shard there, else the
    whole model).  Writes slots ``[0, B)`` of the dense ``cache`` (bf16, fp16
    or f32 rows, this rank's kv heads) in place and sets their lengths to T.  Returns the last
    token's logits [B, V] f32 on every rank and the cache.

    Raises ``ValueError`` for a quantized or paged cache (a long quantized
    prompt goes through the engine's chunked admission), for T that does not
    split over the axis, and for T past the cache's capacity."""
    if cache.quantized or cache.paged:
        raise ValueError("sp_prefill writes dense caches only")
    sp = mesh.shape[seq_axis]
    B, T = tokens.shape
    if T % sp:
        raise ValueError(f"prompt length {T} must divide the seq axis ({sp})")
    if T > cache.S:
        raise ValueError(f"prompt length {T} exceeds cache capacity {cache.S}")
    if model.cfg != (cfg.local(mesh.shape[tp_axis]) if tp_axis else cfg):
        raise ValueError("the model is not this mesh's shard of cfg (use model_tp.shard_params)")
    c, Tl, dev = mesh.index(seq_axis), T // sp, model.device
    positions = (c * Tl + torch.arange(Tl, device=dev))[None].expand(B, Tl)
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    x = model.embed[tokens[:, c * Tl:(c + 1) * Tl].to(dev).long()].to(torch.bfloat16)
    for li, block in enumerate(model.blocks):
        q, k, v = block.qkv(x, rope)
        att = ring_attention(q, k, v, positions, positions, mesh, seq_axis,
                             window=cfg.sliding_window)
        x = block.out(x, att)
        # every rank decodes alone afterwards: gather the chunks along T, head-major
        cache.k[li, :B, :, :T] = all_gather(k, mesh, seq_axis, dim=1).transpose(1, 2)
        cache.v[li, :B, :, :T] = all_gather(v, mesh, seq_axis, dim=1).transpose(1, 2)
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)
    if c == sp - 1:  # the prompts' last tokens are the last rank's
        logits = model.head(x[:, -1:])[:, 0].float()
    cache.lengths[:B] = T
    return psum(logits, mesh, seq_axis), cache
