"""GPTQ quantization (Hessian error compensation), port of ``xbitops_tpu/ops/gptq.py``.

For each input row k of a weight ``[K, N]`` (quantized along K): quantize row
k against its group's scale and zero, then push its rounding error to the
later rows, weighted by the inverse Hessian of the layer's inputs
(``H = 2 X^T X``), so that they compensate (Frantar et al., 2022).  Blocked as
the standard implementation is: a sequential pass inside each 128-row block,
then one matmul pushes the block's error to the rows after it.

The solver is plain PyTorch (``torch.linalg.cholesky``, ``inv``, a Python
loop over blocks and rows), as the JAX package leaves it to XLA.  Every matmul
of it runs in true f32: TF32 is switched off inside it (and the JAX package
forces ``Precision.HIGHEST`` for the same reason), since a 10-bit mantissa in
the Hessian or the error update moves the codes.

Act-order (``desc_act``) quantizes rows by descending Hessian diagonal (a
stable sort: tied diagonals keep their order, as ``jnp.argsort`` does); the
permutation is returned in the QTensor convention (stored row k = logical row
``perm[k]``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Tuple

import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import QTensor

__all__ = ["hessian_from_inputs", "gptq_quantize_weight", "gptq_quantize_array",
           "quantize_model_gptq", "true_f32"]


@contextlib.contextmanager
def true_f32():
    """f32 matmuls without TF32 (cuBLAS and cuDNN) inside the block; the
    previous settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def hessian_from_inputs(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GPTQ Hessian ``H = 2 X^T X`` (f32, no TF32) of inputs ``x [..., K]``,
    added to ``prev`` if given."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    with true_f32():
        h = 2.0 * (x2.T @ x2)
    return h if prev is None else prev + h


def _find_params(wg: torch.Tensor, maxq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric per-column min/max scale and zero over group rows ``wg [g, N]``."""
    lo = torch.clamp(wg.amin(dim=0), max=0.0)
    hi = torch.clamp(wg.amax(dim=0), min=0.0)
    scale = torch.clamp((hi - lo) / maxq, min=1e-8)
    # the fp16 scale BEFORE q and zero, so that they compensate the stored
    # value: with it an identity Hessian gives exactly ops.quantize's RTN
    scale = scale.half().float()
    zero = torch.clamp(torch.round(-lo / scale), 0, maxq)
    return scale, zero


def gptq_quantize_weight(
    w: torch.Tensor,  # [K, N] float
    H: torch.Tensor,  # [K, K] Hessian of the layer inputs (2 X^T X)
    bits: int,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    block_size: int = 128,
):
    """GPTQ-quantize ``w`` along K on its device.  Returns ``(wq int32 [K, N],
    scales f32 [G, N], zeros int32 [G, N], perm int64 [K] or None)``, ready
    for ``formats.make_qtensor`` (with the same ``perm``).

    Dead inputs (a zero Hessian diagonal) get a unit diagonal and a zero
    weight row; then ``percdamp`` times the mean diagonal dampens ``H``.
    ``U``, the upper Cholesky factor of ``H^-1``, weighs the error of each row
    for the later ones.  All linear algebra runs in true f32 (:func:`true_f32`)."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} must be a multiple of group_size={group_size} "
                         "(pad the weight rows first)")
    bs = min(block_size, group_size, K)
    if K % bs or group_size % bs:
        raise ValueError(f"K={K} and group_size={group_size} must be multiples "
                         f"of block_size={bs}")
    maxq = (1 << bits) - 1
    dev = w.device
    with true_f32():
        W = w.float().clone()
        H = H.to(dev).float()
        perm = None
        if act_order:
            perm = torch.argsort(-torch.diagonal(H), stable=True)
            W = W[perm]
            H = H[perm][:, perm]
        dead = torch.diagonal(H) == 0
        H = H + torch.diag(dead.float())
        W[dead] = 0.0
        H = H + torch.eye(K, device=dev) * (percdamp * torch.diagonal(H).mean())
        # U: upper factor of H^-1 = U^T U, by the JAX package's steps
        Linv = torch.linalg.inv(torch.linalg.cholesky(H))  # H = C C^T, Linv = C^-1
        U = torch.linalg.cholesky(Linv.T @ Linv).T

        Q = torch.empty((K, N), dtype=torch.float32, device=dev)
        scales, zeros = [], []
        for k0 in range(0, K, bs):
            if k0 % group_size == 0:  # from the error-compensated rows of the group
                scale, zero = _find_params(W[k0 : k0 + group_size], maxq)
                scales.append(scale)
                zeros.append(zero)
            Wb = W[k0 : k0 + bs].clone()
            Ub = U[k0 : k0 + bs, k0 : k0 + bs]
            Err = torch.empty((bs, N), dtype=torch.float32, device=dev)
            for i in range(bs):
                wr = Wb[i]
                q = torch.clamp(torch.round(wr / scale + zero), 0, maxq)
                err = (wr - (q - zero) * scale) / Ub[i, i]
                Wb[i + 1 :] -= Ub[i, i + 1 :, None] * err[None, :]  # the rest of the block
                Q[k0 + i] = q
                Err[i] = err
            if k0 + bs < K:  # the block's error to every later row
                W[k0 + bs :] -= U[k0 : k0 + bs, k0 + bs :].T @ Err
    return (Q.to(torch.int32), torch.stack(scales), torch.stack(zeros).to(torch.int32), perm)


def gptq_quantize_array(
    w: torch.Tensor,
    H: torch.Tensor,
    bits: int,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    tile_k: Optional[int] = None,
    scale_store_dtype=torch.float16,
) -> QTensor:
    """GPTQ-quantize ``w`` and pack it (``formats.make_qtensor``) in one step."""
    wq, scales, zeros, perm = gptq_quantize_weight(
        w, H, bits, group_size, act_order=act_order, percdamp=percdamp)
    return formats.make_qtensor(wq, scales, zeros, bits, group_size, tile_k=tile_k, perm=perm,
                                scale_store_dtype=scale_store_dtype)


# ---------------------------------------------------------------------------
# The whole model: calibrate and quantize a dense model layer by layer
# ---------------------------------------------------------------------------


def quantize_model_gptq(
    model,
    cfg,
    calib_tokens: torch.Tensor,  # int [B, T] calibration prompts
    bits: int = 4,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    verbose: bool = False,
    timings: Optional[dict] = None,
):
    """GPTQ-quantize a DENSE :class:`~xbitops_tpu_torch.models.llama.Llama`
    (dense ``DenseLinear`` projections, as ``load_autogptq`` gives a dense
    checkpoint), layer by layer in the standard sequential fashion: each
    projection's Hessian comes from ITS inputs, and each layer's output is
    recomputed with the already-quantized weights, so later layers compensate
    earlier quantization error.  Returns a new ``Llama`` on the same device.

    Fused (wqkv / w_gateup) and split layouts; a MoE layer (``router``) gives
    each expert the Hessian of the tokens routed to it (the whole stream if
    none is) and recombines the layer output with the router weights.  The
    embedding and the norms stay dense; a dense lm_head is quantized against
    the final activations.  The forward runs through ``qmatmul`` (on the card,
    the fused kernel at M = calibration rows).  ``timings`` (a dict), if
    given, collects the solver's seconds by weight shape ``(K, N)``."""
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops.qmatmul import qmatmul

    dev = model.device
    tokens = calib_tokens.to(dev).long()
    B, T = tokens.shape
    H_, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = model.embed[tokens].to(torch.bfloat16)
    positions = torch.arange(T, device=dev)[None].expand(B, T)
    rope = llama.rope_tables(positions, D, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    mask = positions[:, None, :] <= positions[:, :, None]  # causal [B, T, T]
    if cfg.sliding_window is not None:
        mask &= positions[:, :, None] - positions[:, None, :] < cfg.sliding_window

    def gq(w, h_in):
        t0 = time.perf_counter()
        qt = gptq_quantize_array(w.float(), h_in, bits, group_size, act_order=act_order,
                                 percdamp=percdamp)
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.setdefault(tuple(w.shape), []).append(time.perf_counter() - t0)
        return qt

    def mm(a, qt):
        return qmatmul(a, qt, out_dtype=a.dtype)

    blocks = []
    for li, block in enumerate(model.blocks):
        layer = block.weights()
        hx = llama.rms_norm(x, block.ln_attn, cfg.rms_eps)
        h_attn = hessian_from_inputs(hx)
        nl = {}
        if "wqkv" in layer:
            nl["wqkv"] = gq(layer["wqkv"], h_attn)
            qkv = mm(hx, nl["wqkv"])
            qdim, kvdim = H_ * D, Hkv * D
            q, k, v = qkv[..., :qdim], qkv[..., qdim : qdim + kvdim], qkv[..., qdim + kvdim :]
        else:
            for name in ("wq", "wk", "wv"):
                nl[name] = gq(layer[name], h_attn)
            q, k, v = mm(hx, nl["wq"]), mm(hx, nl["wk"]), mm(hx, nl["wv"])
        q = llama._rope(q.reshape(B, T, H_, D), rope)
        k = llama._rope(k.reshape(B, T, Hkv, D), rope)
        v = v.reshape(B, T, Hkv, D)
        att = llama._attention(q, k.transpose(1, 2), v.transpose(1, 2), mask,
                               D ** -0.5).reshape(B, T, H_ * D)
        nl["wo"] = gq(layer["wo"], hessian_from_inputs(att))
        x = x + mm(att, nl["wo"])

        hx2 = llama.rms_norm(x, block.ln_mlp, cfg.rms_eps)
        if "router" in layer:
            y = _quantize_moe(hx2, layer, cfg, nl, gq, mm)
            x = x + y.reshape(x.shape).to(x.dtype)
        else:
            h_mlp = hessian_from_inputs(hx2)
            ffn = cfg.intermediate_size
            if "w_gateup" in layer:
                nl["w_gateup"] = gq(layer["w_gateup"], h_mlp)
                gu = mm(hx2, nl["w_gateup"])
                gate, up = gu[..., :ffn], gu[..., ffn:]
            else:
                nl["w_gate"] = gq(layer["w_gate"], h_mlp)
                nl["w_up"] = gq(layer["w_up"], h_mlp)
                gate, up = mm(hx2, nl["w_gate"]), mm(hx2, nl["w_up"])
            act = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
            nl["w_down"] = gq(layer["w_down"], hessian_from_inputs(act))
            x = x + mm(act, nl["w_down"])
        blocks.append(llama.LlamaBlock(cfg, nl, block.ln_attn, block.ln_mlp))
        if verbose:
            kind = " (moe)" if "router" in layer else ""
            print(f"  gptq layer {li + 1}/{len(model.blocks)}{kind}", flush=True)

    lm_head = llama.linear_weight(model.lm_head)
    if not isinstance(lm_head, QTensor):  # a dense head: quantize against the final acts
        lm_head = gq(lm_head, hessian_from_inputs(llama.rms_norm(x, model.ln_final,
                                                                 cfg.rms_eps)))
    return llama.Llama(cfg, model.embed, blocks, model.ln_final, lm_head)


def _quantize_moe(hx2, layer, cfg, nl, gq, mm) -> torch.Tensor:
    """The MoE branch of :func:`quantize_model_gptq`: quantize each expert on
    the rows routed to it (selected on the host: calibration is not a graph)
    and return the layer's FFN output in f32, recombined with the router
    weights.  Fills ``nl`` with the router and the stacked experts."""
    from xbitops_tpu_torch.models.moe import route, stack_experts

    ffn = cfg.intermediate_size
    x2 = hx2.reshape(-1, hx2.shape[-1])
    idx, probs = route(x2, layer["router"], cfg.experts_per_token)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    gus, downs = [], []
    for e in range(cfg.n_experts):
        sel = torch.nonzero((idx == e).any(dim=-1))[:, 0]
        # an expert no token reaches is quantized against the whole stream
        xe = x2[sel] if sel.numel() else x2
        qgu = gq(layer["w_experts_gateup"][e], hessian_from_inputs(xe))
        gu = mm(xe, qgu)
        act = (torch.nn.functional.silu(gu[..., :ffn].float())
               * gu[..., ffn:].float()).to(x2.dtype)
        qdown = gq(layer["w_experts_down"][e], hessian_from_inputs(act))
        gus.append(qgu)
        downs.append(qdown)
        if sel.numel():
            pe = torch.where(idx[sel] == e, probs[sel], 0.0).sum(dim=-1)
            y[sel] += pe[:, None] * mm(act, qdown).float()
    nl["router"] = layer["router"]
    nl["w_experts_gateup"] = stack_experts(gus)
    nl["w_experts_down"] = stack_experts(downs)
    return y
