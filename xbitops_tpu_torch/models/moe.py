"""Mixtral-style sparse Mixture-of-Experts FFN (port of ``xbitops_tpu/models/moe.py``).

- Expert weights are ONE stacked :class:`~xbitops_tpu_torch.formats.QTensor`
  per projection with a leading expert axis (or a dense ``[E, K, N]`` tensor);
  expert ``e`` is read in place through ``QTensor.layer(e)`` (views, no copy),
  so the fused matmul runs each expert's packed weight where it lies.
- Dispatch is scatter/gather: token ``n``'s j-th route lands in slot
  ``e * C + position_among_e`` of a buffer of ``E * C`` rows (positions
  counted row-major over (n, k)); a route past an expert's capacity ``C``
  drops.  The JAX package scatters a dropped route to row ``E * C`` with
  ``mode="drop"`` and gathers it back as zeros; an index of ``E * C`` is an
  out-of-range device assert in PyTorch, so the buffers here hold one spare
  row: dropped routes write there and read the spare row of the expert
  outputs, which is zero.
- The expert loop is a Python loop over ``E`` views and every step is a tensor
  op with no read-back to the host (no ``nonzero``, no ``.item()``, no boolean
  indexing), so a decode step with MoE layers captures into a CUDA graph.

Routing ties: the top-k routes are taken by k rounds of ``argmax`` (which
returns the FIRST maximal index), so among equal logits the lower expert index
comes first, as ``jax.lax.top_k`` orders them.

Route counters: a :class:`MoeFFN` given the live mask of its rows (a row is
live where its position is below ``S``; inactive slots and padding rows
compute too) counts on the device, into a small buffer it owns, the routes of
live rows to each expert, the forwards in which each expert got one, its
forwards and the rows its expert products ran (``E * C``), for decode steps
and admissions apart.  The counts are in-place adds of a few tiny kernels, with
no read-back, so a replayed decode graph counts every step;
:func:`route_stats` reads them back once.  The mask reaches the counters
only: routing, dispatch and the experts' arithmetic do not see it.

Expert parallelism (one rank a process, ``parallel/``): :func:`shard_experts`
gives rank ``r`` of an ``n``-rank expert axis the experts ``[r E/n, (r+1)
E/n)`` (views of the stacked QTensors, or a model built with those experts
only); the attention, the router, the embedding, lm_head and the cache are
replicated, as the JAX package's ``expert_pspecs`` places them.  Each rank
routes every token, runs its own experts on the routes they take (the others
read the spare row, zero) and the f32 combine is summed over the axis before
the cast (:class:`ExpertParallel`); :func:`ep_decode_step` and
:func:`ep_prefill_slots` run the single-rank step functions on that model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.models.llama import LlamaConfig, _linear, linear_weight
from xbitops_tpu_torch.ops.qmatmul import qmatmul
from xbitops_tpu_torch.ops.quantize import quantize_array

__all__ = ["MoeConfig", "MoeFFN", "stack_experts", "init_moe_params", "moe_ffn",
           "moe_capacity", "route", "ExpertParallel", "shard_experts", "ep_decode_step",
           "ep_prefill_slots", "DECODE", "ADMIT", "ROUTE_STATS", "route_counters",
           "reset_route_counts", "route_stats"]

Weight = Union[QTensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # capacity per expert = ceil(tokens * k / E * capacity_factor); routes past
    # an expert's capacity drop (the token keeps its other routes).  None =
    # no-drop (capacity = token count: a token's k routes go to k distinct
    # experts, so an expert sees at most N routes), the exact inference
    # semantics; checkpoint loads use it (io/gptq_loader.py).
    capacity_factor: Optional[float] = 2.0

    @staticmethod
    def mixtral_like(**kw) -> "MoeConfig":
        """Mixtral-8x7B-shaped: Llama-7B attention widths with 8 kv heads, 8
        experts of ffn 14336, top-2."""
        return MoeConfig(intermediate_size=14336, num_kv_heads=8, n_experts=8,
                         experts_per_token=2, **kw)

    @staticmethod
    def tiny_moe(vocab: int = 256, seq: int = 64) -> "MoeConfig":
        return MoeConfig(
            vocab_size=vocab, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_seq_len=seq, n_experts=4, experts_per_token=2,
        )


def stack_experts(ws: Sequence[Weight]) -> Weight:
    """Stack per-expert weights on a leading expert axis: QTensors field by
    field (read back through ``QTensor.layer(e)``), dense ``[K, N]`` tensors
    into ``[E, K, N]``."""
    if not isinstance(ws[0], QTensor):
        return torch.stack(list(ws))
    first = ws[0]
    return dataclasses.replace(
        first,
        planes=tuple(torch.stack([w.planes[i] for w in ws]) for i in range(len(first.planes))),
        scales=torch.stack([w.scales for w in ws]),
        scale_zeros=torch.stack([w.scale_zeros for w in ws]),
        perm=None if first.perm is None else torch.stack([w.perm for w in ws]),
    )


def _stack_kept(ws, experts: Optional[Sequence[int]] = None) -> Weight:
    """:func:`stack_experts` of the experts in ``experts`` (default all); the
    list is consumed as it goes, so a dropped expert's memory goes at once."""
    keep = range(len(ws)) if experts is None else experts
    kept = [w for e, w in enumerate(ws) if e in keep]
    ws.clear()
    return stack_experts(kept)


def n_stacked(w: Weight) -> int:
    return w.planes[0].shape[0] if isinstance(w, QTensor) else w.shape[0]


def moe_capacity(cfg: MoeConfig, n_tokens: int) -> int:
    """Rows an expert takes in a forward of ``n_tokens`` tokens."""
    if cfg.capacity_factor is None:
        return n_tokens
    return max(1, math.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                            / cfg.n_experts))


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits in f32 of ``x [N, h]``, the top ``k`` experts of each
    token (ties: the lower index first) and the softmax over their ``k``
    logits.  Returns ``(idx int64 [N, k], probs f32 [N, k])``."""
    logits = x.float() @ router.float()  # [N, E]
    idx, gate = [], []
    for _ in range(k):
        i = logits.argmax(dim=-1, keepdim=True)
        idx.append(i)
        gate.append(torch.gather(logits, 1, i))
        logits = logits.scatter(1, i, float("-inf"))
    return torch.cat(idx, dim=1), torch.softmax(torch.cat(gate, dim=1), dim=-1)


def _dense(a: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """A dense expert's product as the JAX package computes it: the weight in
    the activations' dtype, exact products summed in f32."""
    return (a.float() @ w.to(a.dtype).float()).to(out_dtype)


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """The expert axis of a mesh (``parallel.mesh.Mesh``) a MoE layer's
    experts are split over: this rank holds experts ``[r El, (r+1) El)``."""

    mesh: object
    axis: str


def moe_ffn(hx: torch.Tensor, layer: Dict[str, Weight], cfg: MoeConfig, a8: bool = False,
            use_kernel: bool = True, ep: Optional[ExpertParallel] = None,
            count: Optional[Callable[[torch.Tensor, int], None]] = None) -> torch.Tensor:
    """Top-k routed expert FFN of ``hx [B, T, h]`` (the post-norm residual
    input); returns ``[B, T, h]`` in ``hx``'s dtype.

    ``layer`` holds ``router`` f32 ``[h, E]`` and the stacked
    ``w_experts_gateup`` (``[h, 2 * ffn]`` an expert) and ``w_experts_down``
    (``[ffn, h]``).  gate|up comes out in ``hx``'s dtype, SiLU times up runs in
    f32 and is cast back, down comes out in f32, and the k contributions are
    weighted and summed in f32 before the final cast.  ``a8`` goes to every
    expert's :func:`qmatmul`; ``use_kernel=False`` runs the plain versions.

    ``ep``: the layer holds this rank's ``El = E / n`` experts only; routes to
    other ranks' experts add 0 here and the f32 sum is summed over the axis
    (``psum``) before the cast.

    ``count(onehot, rows)``, where given, takes each route's expert as
    ``onehot`` int64 ``[N * k, E]`` (row-major over (token, route), all ``E``
    experts under ``ep`` too) and the rows this rank's expert products run,
    ``El * C`` (:class:`MoeFFN`'s route counters)."""
    B, T, h = hx.shape
    E, k, ffn = cfg.n_experts, cfg.experts_per_token, cfg.intermediate_size
    w_gu, w_down = layer["w_experts_gateup"], layer["w_experts_down"]
    El, e0 = E, 0
    if ep is not None:
        n = ep.mesh.shape[ep.axis]
        if E % n:
            raise ValueError(f"{E} experts do not split over {n} ranks")
        El, e0 = E // n, ep.mesh.index(ep.axis) * (E // n)
    if n_stacked(w_gu) != El or n_stacked(w_down) != El:
        raise ValueError(f"expert weights stack {n_stacked(w_gu)} experts, this rank holds {El}")
    dense = not isinstance(w_gu, QTensor)
    N = B * T
    C = moe_capacity(cfg, N)
    x = hx.reshape(N, h)
    idx, probs = route(x, layer["router"], k)
    # slot of each route: the j-th route (row-major over (n, k)) to expert e
    # takes slot e * C + j; past the capacity it goes to the spare row E * C
    onehot = (idx[..., None] == torch.arange(E, device=x.device)).reshape(N * k, E).long()
    if count is not None:
        count(onehot, El * C)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1).reshape(N, k)
    # a route to another rank's expert reads the spare row too
    keep = (pos < C) & (idx >= e0) & (idx < e0 + El)
    slot = torch.where(keep, (idx - e0) * C + pos, El * C).reshape(N * k)
    xe = x.new_zeros((El * C + 1, h))
    xe.index_copy_(0, slot, x[:, None, :].expand(N, k, h).reshape(N * k, h))
    ye = []
    for e in range(El):
        xs = xe[e * C : (e + 1) * C]
        if dense:
            gu = _dense(xs, w_gu[e], hx.dtype)
        else:
            gu = qmatmul(xs, w_gu.layer(e), out_dtype=hx.dtype, use_kernel=use_kernel, a8=a8)
        act = (torch.nn.functional.silu(gu[:, :ffn].float()) * gu[:, ffn:].float()).to(hx.dtype)
        if dense:
            ye.append(_dense(act, w_down[e], torch.float32))
        else:
            ye.append(qmatmul(act, w_down.layer(e), out_dtype=torch.float32,
                              use_kernel=use_kernel, a8=a8))
    ye.append(ye[0].new_zeros((1, h)))  # the spare row: a dropped route adds 0
    y = torch.cat(ye)[slot].reshape(N, k, h)
    y = (y * probs[..., None]).sum(dim=1)
    if ep is not None:
        from xbitops_tpu_torch.parallel.mesh import psum

        y = psum(y, ep.mesh, ep.axis)
    return y.reshape(B, T, h).to(hx.dtype)


# The route counters' phases: decode steps (a verify step too) and admissions.
DECODE, ADMIT = 0, 1
# The keys :func:`route_stats` gives (and ``Engine.loop_stats`` adds).
ROUTE_STATS = ("moe_routes", "moe_admit_routes", "moe_expert_rows", "moe_admit_expert_rows",
               "moe_experts_hit", "moe_layer_forwards", "moe_busiest_share")


def _count_routes(counts: torch.Tensor, live: torch.Tensor, onehot: torch.Tensor,
                  rows: int) -> None:
    """Add one forward to a phase's counters ``counts`` int64 ``[2 E + 2]``,
    in place on the device: the live rows' routes to each expert, the
    forwards in which each expert got one, the forwards, and the ``rows``
    their expert products ran.  ``live`` bool ``[N]``: the rows whose
    position is below ``S``."""
    N, E = live.shape[0], onehot.shape[-1]
    load = (onehot.view(N, -1, E) * live.view(N, 1, 1)).sum(dim=(0, 1))
    counts[: 2 * E].add_(torch.cat((load, load.clamp(max=1))))
    counts[2 * E].add_(1)
    counts[2 * E + 1].add_(rows)


class MoeFFN(nn.Module):
    """The MoE FFN of a block: the ``router`` f32 ``[h, E]`` as a buffer and
    the stacked experts ``w_experts_gateup`` / ``w_experts_down`` held as
    projection modules (their arrays as buffers, read through expert views).
    ``role``: an :class:`ExpertParallel` where the module holds one rank's
    experts.

    ``route_counts`` int64 ``[phase, 2 E + 2]`` are its route counters
    (module docstring; ``phase`` :data:`DECODE` or :data:`ADMIT`; laid out
    as :func:`_count_routes` adds them), a buffer kept out of the state
    dict."""

    role = None

    def __init__(self, cfg: MoeConfig, router: torch.Tensor, w_gateup: Weight, w_down: Weight):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("router", router)
        self.w_experts_gateup = _linear(w_gateup)
        self.w_experts_down = _linear(w_down)
        self.register_buffer("route_counts", torch.zeros(
            (2, 2 * cfg.n_experts + 2), dtype=torch.int64, device=router.device), persistent=False)

    def weights(self) -> Dict[str, Weight]:
        return dict(router=self.router,
                    w_experts_gateup=linear_weight(self.w_experts_gateup),
                    w_experts_down=linear_weight(self.w_experts_down))

    def forward(self, hx: torch.Tensor, use_kernel: bool = True, a8: bool = False,
                live: Optional[torch.Tensor] = None, admit: bool = False) -> torch.Tensor:
        """:func:`moe_ffn` of ``hx [B, T, h]``.  ``live`` bool ``[B, T]``: count
        this forward's routes of live rows, as an admission's where ``admit``,
        else a decode step's; None counts nothing."""
        count = None
        if live is not None:
            count = functools.partial(_count_routes, self.route_counts[ADMIT if admit else DECODE],
                                      live.reshape(-1))
        return moe_ffn(hx, self.weights(), self.cfg, a8=a8, use_kernel=use_kernel, ep=self.role,
                       count=count)


def _moe_layers(model) -> List[MoeFFN]:
    return [b.moe for b in model.blocks if hasattr(b, "moe")]


def route_counters(model) -> List[torch.Tensor]:
    """The route counters of ``model``'s MoE layers (none for a dense model):
    what a caller zeros, or saves and puts back around work it does not count."""
    return [m.route_counts for m in _moe_layers(model)]


def reset_route_counts(model) -> None:
    for t in route_counters(model):
        t.zero_()


def route_stats(model) -> Dict[str, float]:
    """``model``'s route counters since :func:`reset_route_counts`, read back
    once, by the :data:`ROUTE_STATS` keys ({} for a dense model):
    ``moe_routes`` / ``moe_admit_routes``, the routes of live rows in decode
    steps / admissions; ``moe_expert_rows`` / ``moe_admit_expert_rows``, the
    rows the expert products ran, ``E * C`` a MoE layer forward;
    ``moe_experts_hit``, the experts a decode forward's live routes reached,
    summed over the forwards; ``moe_layer_forwards``, the MoE layer forwards of
    decode steps; ``moe_busiest_share``, the most-routed expert's share of a
    layer's decode routes, the mean over the layers that have any."""
    counters = route_counters(model)
    if not counters:
        return {}
    counts = torch.stack(counters).cpu()  # [L, phase, 2 E + 2]
    E = (counts.shape[-1] - 2) // 2
    dec, adm = counts[:, DECODE], counts[:, ADMIT]
    load = dec[:, :E]  # [L, E]
    total = load.sum(dim=1)
    busiest = load.amax(dim=1)[total > 0] / total[total > 0]
    return dict(
        moe_routes=float(total.sum()),
        moe_admit_routes=float(adm[:, :E].sum()),
        moe_expert_rows=float(dec[:, -1].sum()),
        moe_admit_expert_rows=float(adm[:, -1].sum()),
        moe_experts_hit=float(dec[:, E : 2 * E].sum()),
        moe_layer_forwards=float(dec[:, -2].sum()),
        moe_busiest_share=float(busiest.mean()) if busiest.numel() else 0.0,
    )


def init_moe_params(
    gen: torch.Generator,
    cfg: MoeConfig,
    bits: Optional[int] = 4,
    group_size: int = 128,
    dtype=torch.bfloat16,
    weight: Optional[Callable[[int, int, float], Weight]] = None,
    experts: Optional[Sequence[int]] = None,
):
    """A random MoE model on ``gen``'s device: Llama attention (fused q|k|v),
    a f32 router of scale ``hidden ** -0.5`` and ``E`` experts a layer
    (gate|up ``[hidden, 2 * ffn]``, down ``[ffn, hidden]``, stacked by
    :func:`stack_experts`), a ``dtype`` embedding of scale 0.02, unit norms
    (port of ``models.moe.init_moe_params``; the two packages draw different
    numbers from a seed).  Each projection is ``weight(K, N, scale)``; by
    default normal weights of scale ``fan_in ** -0.5`` quantized by
    :func:`quantize_array` (``bits=None``: dense in ``dtype``).  ``experts``
    (a range): keep only those experts of every layer (the others are drawn
    and dropped, so the kept ones equal a full build's): one rank's part under
    expert parallelism, without the memory of the rest."""
    from xbitops_tpu_torch.models.llama import Llama, LlamaBlock

    dev = gen.device
    h, ffn, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    s = h ** -0.5

    def normal(kdim, ndim, scale):
        w = torch.randn((kdim, ndim), generator=gen, device=dev) * scale
        return w.to(dtype) if bits is None else quantize_array(w, bits, group_size)

    q = weight or normal

    def ones():
        return torch.ones(h, dtype=torch.float32, device=dev)

    blocks: List[LlamaBlock] = []
    for _ in range(cfg.num_layers):
        gu = _stack_kept([q(h, 2 * ffn, s) for _ in range(E)], experts)
        down = _stack_kept([q(ffn, h, ffn ** -0.5) for _ in range(E)], experts)
        proj = dict(wqkv=q(h, qdim + 2 * kvdim, s), wo=q(qdim, h, s),
                    router=torch.randn((h, E), generator=gen, device=dev) * s,
                    w_experts_gateup=gu, w_experts_down=down)
        blocks.append(LlamaBlock(cfg, proj, ones(), ones()))
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=dev) * 0.02).to(dtype)
    return Llama(cfg, embed, blocks, ones(), q(h, cfg.vocab_size, s))


def _experts(w: Weight, e0: int, e1: int) -> Weight:
    """Experts ``[e0, e1)`` of a stacked weight, as views."""
    if not isinstance(w, QTensor):
        return w[e0:e1]
    return dataclasses.replace(
        w, planes=tuple(p[e0:e1] for p in w.planes), scales=w.scales[e0:e1],
        scale_zeros=w.scale_zeros[e0:e1], perm=None if w.perm is None else w.perm[e0:e1])


def shard_experts(model, mesh, axis: str = "expert"):
    """This rank's model under expert parallelism (``expert_pspecs``'
    placement): every MoE layer keeps the rank's ``E / n`` experts, views of
    the stacked weights (a model built with only those experts keeps them as
    they are), and runs its combine summed over ``axis``; every other weight is
    shared with ``model``."""
    from xbitops_tpu_torch.models.llama import Llama, LlamaBlock

    cfg = model.cfg
    n, r = mesh.shape[axis], mesh.index(axis)
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} ranks")
    El = cfg.n_experts // n
    blocks = []
    for b in model.blocks:
        w = b.weights()
        moe = "router" in w
        if moe and n_stacked(w["w_experts_gateup"]) == cfg.n_experts:
            for key in ("w_experts_gateup", "w_experts_down"):
                w[key] = _experts(w[key], r * El, (r + 1) * El)
        block = LlamaBlock(cfg, w, b.ln_attn, b.ln_mlp)
        if moe:
            block.moe.role = ExpertParallel(mesh, axis)
        blocks.append(block)
    return Llama(cfg, model.embed, blocks, model.ln_final, linear_weight(model.lm_head))


def _check_ep(model, cfg, mesh, axis) -> None:
    roles = [b.moe.role for b in model.blocks if hasattr(b, "moe")]
    if model.cfg != cfg or not roles or roles[0] != ExpertParallel(mesh, axis):
        raise ValueError("the model is not this mesh's expert shard of cfg (use shard_experts)")


def ep_decode_step(model, cfg: MoeConfig, mesh, tokens, cache, axis: str = "expert",
                   active=None):
    """Expert-parallel :func:`~xbitops_tpu_torch.models.llama.decode_step` on
    the rank's :func:`shard_experts` model: logits ``[B, V]`` on every rank."""
    from xbitops_tpu_torch.models import llama

    _check_ep(model, cfg, mesh, axis)
    return llama.decode_step(model, tokens, cache, active=active)


def ep_prefill_slots(model, cfg: MoeConfig, mesh, tokens, true_lens, slots, cache,
                     axis: str = "expert"):
    """Expert-parallel :func:`~xbitops_tpu_torch.models.llama.prefill_slots`."""
    from xbitops_tpu_torch.models import llama

    _check_ep(model, cfg, mesh, axis)
    return llama.prefill_slots(model, tokens, true_lens, slots, cache)
