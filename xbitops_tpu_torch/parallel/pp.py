"""Pipeline parallelism: a model's layers split over the ``pipe`` axis of a
process mesh (port of ``xbitops_tpu/parallel/pp.py``).

Stage ``s`` of ``P`` (the rank at coordinate ``s`` on ``pipe``) holds the
contiguous blocks ``[s L/P, (s+1) L/P)`` and a cache of those layers only
(:func:`stage_model`, :func:`stage_cache`; a new one is ``KVCache.init`` of
the stage's config); the embedding, the final norm and lm_head are on every
stage.  The slots of a batch go through as ``P`` microbatches of ``B/P``
contiguous slots: in round ``r`` stage ``s`` works microbatch ``r - s``, and
after each round the hidden state moves one stage on by
:func:`~xbitops_tpu_torch.parallel.mesh.ppermute`.  :func:`pp_decode_step` and
:func:`pp_prefill_slots` drain the pipe (``2P - 1`` rounds);
:func:`pp_decode_burst` feeds each microbatch's greedy token back from the
last stage to stage 0 on the same rotation, so that the stages stay busy.

A decode microbatch of slots ``[lo, hi)`` runs the one-rank decode path on
views of those slots of the stage's cache (``cache.k[:, lo:hi]``: each
layer's rows of a slot range are contiguous), so on the card the
decode-attention kernel appends and attends in one launch a layer, as in
``llama.decode_step``, where the JAX package sends a PP round through XLA's
slot-subset attention.  Prefill rows attend their own rows eagerly, as
``llama.prefill_slots`` does.

Tensor parallelism composes on a ``(pipe, model)`` mesh: a stage is
``model_tp.shard_params`` of its blocks, and the TP collectives stay inside
the stage.  Where the JAX package runs one program on every stage, a rank
here runs only the rounds in which its stage has work, and only the last
stage runs lm_head; every rank joins every round's permute.  Paged caches are
not supported under PP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig, linear_weight
from xbitops_tpu_torch.parallel import model_tp
from xbitops_tpu_torch.parallel.mesh import Mesh, ppermute, psum

__all__ = ["stage_model", "stage_cache", "pp_decode_step", "pp_decode_burst",
           "pp_prefill_slots"]


def _layers(mesh: Mesh, pipe_axis: str, L: int) -> Tuple[int, int]:
    """This rank's stage: its layers ``[lo, hi)`` of ``L``."""
    P = mesh.shape[pipe_axis]
    if L % P:
        raise ValueError(f"{L} layers do not split over {P} pipeline stages")
    s = mesh.index(pipe_axis)
    return s * (L // P), (s + 1) * (L // P)


def stage_model(model: Llama, mesh: Mesh, pipe_axis: str = "pipe",
                tp_axis: Optional[str] = None) -> Llama:
    """This rank's stage of a whole model: its blocks (their weights shared
    with ``model``, not copied), the embedding, the final norm and lm_head;
    with ``tp_axis``, ``model_tp.shard_params`` of that (``model`` packed for
    the tp axis).  Drop ``model`` afterwards and the rank holds only its
    layers."""
    lo, hi = _layers(mesh, pipe_axis, model.cfg.num_layers)
    cfg = dataclasses.replace(model.cfg, num_layers=hi - lo)
    blocks = [LlamaBlock(cfg, b.weights(), b.ln_attn, b.ln_mlp)
              for b in list(model.blocks)[lo:hi]]
    stage = Llama(cfg, model.embed, blocks, model.ln_final, linear_weight(model.lm_head))
    return stage if tp_axis is None else model_tp.shard_params(stage, mesh, tp_axis)


def stage_cache(cache: llama.KVCache, mesh: Mesh, pipe_axis: str = "pipe",
                tp_axis: Optional[str] = None) -> llama.KVCache:
    """This rank's part of a whole cache (``[L, ...]``): a copy of its
    stage's layers, and with ``tp_axis`` of its kv heads
    (``model_tp.shard_cache``)."""
    lo, hi = _layers(mesh, pipe_axis, cache.k.shape[0])
    part = lambda t: None if t is None else t[lo:hi].clone()
    out = llama.KVCache(k=part(cache.k), v=part(cache.v), lengths=cache.lengths.clone(),
                        k_scale=part(cache.k_scale), v_scale=part(cache.v_scale))
    return out if tp_axis is None else model_tp.shard_cache(out, mesh, tp_axis)


def _setup(model: Llama, cfg: LlamaConfig, mesh: Mesh, cache: llama.KVCache, B: int,
           pipe_axis: str, tp_axis: Optional[str]):
    """``(P, s, mb)``: the stages, this rank's, the slots of a microbatch."""
    if cache.paged:
        raise ValueError("paged KV caches are not supported under PP")
    P = mesh.shape[pipe_axis]
    if B % P:
        raise ValueError(f"batch {B} must divide the pipe axis ({P})")
    lo, hi = _layers(mesh, pipe_axis, cfg.num_layers)
    local = cfg.local(mesh.shape[tp_axis]) if tp_axis else cfg
    if model.cfg != dataclasses.replace(local, num_layers=hi - lo):
        raise ValueError("the model is not this rank's stage of cfg (use stage_model)")
    return P, mesh.index(pipe_axis), B // P


def _slots(cache: llama.KVCache, j: int, mb: int) -> llama.KVCache:
    """Microbatch ``j``'s slots ``[j mb, (j+1) mb)`` of a stage's cache, as
    views of every layer: what the blocks write there lands in ``cache``."""
    rows = slice(j * mb, (j + 1) * mb)
    part = lambda t: None if t is None else t[:, rows]
    return llama.KVCache(k=part(cache.k), v=part(cache.v), lengths=cache.lengths[rows],
                         k_scale=part(cache.k_scale), v_scale=part(cache.v_scale))


def _embed(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.long()].to(torch.bfloat16)


def _drained(model: Llama, mesh: Mesh, pipe_axis: str, P: int, s: int, shape, tokens,
             run) -> None:
    """The drained schedule: ``2P - 1`` rounds.  In round ``r`` this stage
    works microbatch ``j = r - s`` when ``0 <= j < P``: ``run(j, x)`` on the
    embedded ``tokens`` of its rows (stage 0) or on the hidden state the stage
    before sent, ``shape`` [mb, T, hidden]; its output moves one stage on
    after the round (after the last, nobody reads it)."""
    mb = shape[0]
    x = torch.zeros(shape, dtype=torch.bfloat16, device=model.device)
    for r in range(2 * P - 1):
        j = r - s
        if 0 <= j < P:
            x = run(j, _embed(model, tokens[j * mb:(j + 1) * mb]) if s == 0 else x)
        if r < 2 * P - 2:
            x = ppermute(x, mesh, pipe_axis)


def pp_decode_step(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens: torch.Tensor,
                   cache: llama.KVCache, pipe_axis: str = "pipe",
                   tp_axis: Optional[str] = None, active=None):
    """One decode step of tokens int [B] with the layers split over
    ``pipe_axis`` (``model``: this rank's :func:`stage_model`, ``cache`` its
    stage's): microbatches of ``B / P`` slots flow through the stages.  The
    semantics of ``llama.decode_step``: ``active`` masks slots, and a full
    slot writes nothing.  Returns the logits [B, V] f32 on every rank and the
    cache, updated in place."""
    B = tokens.shape[0]
    P, s, mb = _setup(model, cfg, mesh, cache, B, pipe_axis, tp_axis)
    S, dev = cache.S, model.device
    lengths = cache.lengths.long()
    act = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active.bool()
    positions = torch.where(act, lengths, S)[:, None]
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)

    def run(j, x):
        rows = slice(j * mb, (j + 1) * mb)
        x = model.layers(x, _slots(cache, j, mb), positions[rows])
        if s == P - 1:
            logits[rows] = model.head(x)[:, 0].float()
        return x

    _drained(model, mesh, pipe_axis, P, s, (mb, 1, model.cfg.hidden_size), tokens[:, None], run)
    cache.lengths.copy_(torch.where(act & (lengths < S), lengths + 1, lengths))
    return psum(logits, mesh, pipe_axis), cache  # only the last stage's rows are not 0


def pp_decode_burst(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens: torch.Tensor,
                    cache: llama.KVCache, n_steps: int, pipe_axis: str = "pipe",
                    tp_axis: Optional[str] = None, active=None):
    """``n_steps`` chained greedy decode steps, software-pipelined over the
    stages (``n_steps P + P - 1`` rounds): in round ``r`` stage ``s`` works
    microbatch ``(r - s) % P`` at step ``(r - s) // P``, and a microbatch
    re-enters stage 0 with its next token the round after it leaves the last
    stage (the token rides the rotation, last stage to stage 0 in one hop).
    Once the pipe is full every stage works every round.  Returns the tokens
    int32 [n_steps, B] on every rank (0 for an inactive slot), bit-equal to
    ``n_steps`` calls of :func:`pp_decode_step` with each step's argmax, and
    the cache."""
    B = tokens.shape[0]
    P, s, mb = _setup(model, cfg, mesh, cache, B, pipe_axis, tp_axis)
    S, dev = cache.S, model.device
    len0 = cache.lengths.long()
    act = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active.bool()
    outs = torch.zeros((n_steps, B), dtype=torch.int32, device=dev)
    x = torch.zeros((mb, 1, model.cfg.hidden_size), dtype=torch.bfloat16, device=dev)
    tok = torch.zeros((mb,), dtype=torch.int32, device=dev)
    total = n_steps * P
    for r in range(total + P - 1):
        if 0 <= r - s < total:
            t, m = divmod(r - s, P)
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:  # step 0's tokens from the caller, later ones from the last stage
                x = _embed(model, tokens[rows] if t == 0 else tok)[:, None]
            row_act = act[rows]
            live = row_act & (len0[rows] + t < S)
            x = model.layers(x, _slots(cache, m, mb), torch.where(live, len0[rows] + t, S)[:, None])
            if s == P - 1:
                nxt = model.head(x)[:, 0].float().argmax(dim=-1).to(torch.int32)
                tok = torch.where(row_act, nxt, 0)
                outs[t, rows] = tok
        if r < total + P - 2:
            x = ppermute(x, mesh, pipe_axis)
            tok = ppermute(tok, mesh, pipe_axis)
    cache.lengths.copy_(torch.where(act, torch.clamp(len0 + n_steps, max=S), len0))
    return psum(outs, mesh, pipe_axis), cache


def pp_prefill_slots(model: Llama, cfg: LlamaConfig, mesh: Mesh, tokens: torch.Tensor,
                     true_lens: torch.Tensor, cache: llama.KVCache, pipe_axis: str = "pipe",
                     tp_axis: Optional[str] = None):
    """Batched admission under PP: fresh requests ``tokens`` int [B, T]
    (zero-padded past ``true_lens`` [B]) prefill into their own slots (row i
    into slot i, as ``llama.prefill_slots`` with ``slots = arange(B)``), each
    attending only its own rows.  Returns the last-token logits [B, V] f32 on
    every rank and the cache."""
    B, T = tokens.shape
    P, s, mb = _setup(model, cfg, mesh, cache, B, pipe_axis, tp_axis)
    S, dev = cache.S, model.device
    lens = true_lens.to(dev).long()
    pos = torch.arange(T, device=dev)[None]
    positions = torch.where(pos < lens[:, None], pos, S)
    last = torch.clamp(lens - 1, min=0)
    slots = torch.arange(B, device=dev)
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)

    def run(j, x):
        rows = slice(j * mb, (j + 1) * mb)
        x = model.layers(x, cache, positions[rows], slot_ids=slots[rows], self_attend=True)
        if s == P - 1:
            logits[rows] = model.head(x, last[rows])[:, 0].float()
        return x

    _drained(model, mesh, pipe_axis, P, s, (mb, T, model.cfg.hidden_size), tokens, run)
    cache.lengths.copy_(lens)
    return psum(logits, mesh, pipe_axis), cache
