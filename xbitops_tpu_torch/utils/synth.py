"""Random packed models and paged caches for benchmarks and smoke runs (port
of ``xbitops_tpu/utils/synth.py``).

Speed depends on shapes, not values, so the packed QTensors are built straight
from random bits on the device, with no dense weight and no quantization pass:
a 7B model builds in seconds.  Randomness comes from an explicit
``torch.Generator`` seeded by the caller.
"""

from __future__ import annotations

from typing import Optional

import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import PLANE_DECOMP, QTensor
from xbitops_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig, QLinear
from xbitops_tpu_torch.ops.quantize import quantize_array


def random_qtensor(
    gen: torch.Generator,
    K: int,
    N: int,
    bits: int = 4,
    group_size: int = 128,
    tile_k: Optional[int] = None,
    scale_lo: float = 0.002,
    scale_hi: float = 0.01,
) -> QTensor:
    """A QTensor of random packed bits and small positive fp16 group scales,
    on ``gen``'s device.  Zero points sit near mid-range, so dequantized
    values are centred."""
    dev = gen.device
    tile_k = tile_k or formats.default_tile_k(K, group_size, bits)
    K_logical, K = K, formats._round_up(K, tile_k)
    planes = []
    for pb in PLANE_DECOMP[bits]:
        words = torch.randint(-(2**31), 2**31, (K // (32 // pb), N), generator=gen,
                              device=dev, dtype=torch.int64)
        planes.append(words.to(torch.int32))
    T = K // tile_k
    gt_pad = formats._round_up(max(1, tile_k // group_size), 8)
    maxq = (1 << bits) - 1
    scales = torch.empty((T, gt_pad, N), device=dev).uniform_(scale_lo, scale_hi, generator=gen)
    z = torch.empty((T, gt_pad, N), device=dev).uniform_(0.4 * maxq, 0.6 * maxq, generator=gen)
    return QTensor(
        planes=tuple(planes),
        scales=scales.half(),
        scale_zeros=(scales * z).half(),
        bits=bits, group_size=group_size, tile_k=tile_k, K=K, K_logical=K_logical,
    )


def random_llama_params(
    cfg: LlamaConfig,
    bits: int = 4,
    group_size: int = 128,
    *,
    device,
    seed: int = 0,
    fuse: bool = True,
) -> Llama:
    """A random packed Llama on ``device``: fused q|k|v and gate|up
    projections (``fuse``) or split ones, bf16 embedding, unit norms."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return _random_llama(gen, cfg, bits, group_size, fuse)


def _random_llama(gen: torch.Generator, cfg: LlamaConfig, bits: int, group_size: int,
                  fuse: bool = True) -> Llama:
    device = gen.device
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim

    def q(kdim, ndim):
        return random_qtensor(gen, kdim, ndim, bits, group_size)

    def ones():
        return torch.ones(h, dtype=torch.float32, device=device)

    blocks = []
    for _ in range(cfg.num_layers):
        if fuse:
            proj = dict(wqkv=q(h, qdim + 2 * kvdim), w_gateup=q(h, 2 * ffn))
        else:
            proj = dict(wq=q(h, qdim), wk=q(h, kvdim), wv=q(h, kvdim),
                        w_gate=q(h, ffn), w_up=q(h, ffn))
        proj.update(wo=q(qdim, h), w_down=q(ffn, h))
        blocks.append(LlamaBlock(cfg, proj, ones(), ones()))
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=device) * 0.02)
    return Llama(cfg, embed.to(torch.bfloat16), blocks, ones(), q(h, cfg.vocab_size))


def random_moe_params(
    cfg,
    bits: int = 4,
    group_size: int = 128,
    *,
    device,
    seed: int = 0,
    experts=None,
) -> Llama:
    """A random packed MoE model (a ``models.moe.MoeConfig``: Mixtral) on
    ``device``: ``moe.init_moe_params`` with every projection
    :func:`random_qtensor`, so no dense weight is drawn or quantized.
    ``experts``: keep only those experts (one rank's under expert
    parallelism; the same bits as a full build's)."""
    from xbitops_tpu_torch.models.moe import init_moe_params

    gen = torch.Generator(device=device).manual_seed(seed)
    return init_moe_params(gen, cfg, weight=lambda K, N, _: random_qtensor(gen, K, N, bits,
                                                                           group_size),
                           experts=experts)


def copy_llama_params(
    gen: torch.Generator,
    cfg: LlamaConfig,
    bits: int = 4,
    group_size: int = 128,
    period: int = 8,
) -> Llama:
    """A "copy-model" on ``gen``'s device (port of
    ``utils.synth.copy_llama_params``): greedy decode follows the cycle
    ``0, 1, .., period-1, 0, ..`` at the bytes of a real packed model.

    ``wo`` and ``w_down`` carry weights of scale ~1e-4, so the residual stream
    stays near the current token's embedding (scale 0.02), and lm_head column
    ``(v + 1) % period`` is embedding row ``v``: ``argmax(logits) = (token + 1)
    % period`` by a wide margin over the other random columns.  Speculative
    decoding's favourable case (the n-gram draft accepts nearly every token)
    at the full cost of every projection; random weights (acceptance ~0) are
    the other bracket."""
    if period > cfg.vocab_size:
        raise ValueError(f"period {period} > vocab_size {cfg.vocab_size}")
    return make_copy_model(_random_llama(gen, cfg, bits, group_size), gen, bits, group_size,
                           period)


def make_copy_model(model: Llama, gen: torch.Generator, bits: int = 4, group_size: int = 128,
                    period: int = 8, experts=None) -> Llama:
    """Turn a random packed model into a copy-model in place (see
    :func:`copy_llama_params`): ``wo`` and the FFN's output projection
    (``w_down``, or a MoE layer's stacked ``w_experts_down``) get weights of
    scale ~1e-4, and lm_head maps embedding row ``v`` to ``(v + 1) %
    period``.  The other weights keep their bytes.  ``experts``: the model
    holds only those experts of each layer (``random_moe_params(experts=)``)."""
    from xbitops_tpu_torch.models.moe import _stack_kept

    cfg = model.cfg
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim

    def small(kdim, ndim):
        return random_qtensor(gen, kdim, ndim, bits, group_size, scale_lo=1e-5, scale_hi=2e-5)

    for block in model.blocks:
        block.wo = QLinear(small(qdim, h))
        if hasattr(block, "moe"):
            block.moe.w_experts_down = QLinear(
                _stack_kept([small(ffn, h) for _ in range(cfg.n_experts)], experts))
        else:
            block.w_down = QLinear(small(ffn, h))
    W = torch.randn((h, cfg.vocab_size), generator=gen, device=gen.device) * 0.02
    succ = (torch.arange(period, device=gen.device) + 1) % period
    W[:, succ] = model.embed[:period].float().T
    model.lm_head = QLinear(quantize_array(W, bits, group_size))
    return model


def scatter_pages(linear, page_table, n_pages: int, scales: bool = False):
    """The inverse of ``kernels.kv_append.gather_pages``: a pool of
    ``n_pages`` pages that holds one layer's linear cache ``[B, Hkv, P * R, D]`` (``scales``:
    ``[B, 4, Hkv, P * R]``) where ``page_table`` [B, P] says; pages no entry
    names stay zero and rows behind a negative entry are dropped."""
    B, P = page_table.shape
    if scales:
        pages = linear.reshape(B, 4, linear.shape[2], P, -1).movedim(3, 1)
    else:
        pages = linear.reshape(B, linear.shape[1], P, -1, linear.shape[3]).movedim(2, 1)
    pool = linear.new_zeros((n_pages,) + tuple(pages.shape[2:]))
    ok = page_table >= 0
    pool[page_table[ok].long()] = pages[ok]
    return pool


def cut_pages(gen: torch.Generator, linear, P: int, slot_lens: torch.Tensor):
    """Cut stacked linear cache tensors (k, v[, ks, vs], each [L, B, ...]) into
    pools of ``B * P + 8`` pages (eight that no slot holds) behind a shuffled
    table [B, P]: a slot gets the pages that hold its first ``slot_lens[b]``
    positions and -1 after.
    Returns ``(table, pools)``; a kernel on the pools can then be held to the
    linear kernel on the cache they were cut from."""
    dev = gen.device
    B = linear[0].shape[1]
    n_pages = B * P + 8
    psz = linear[0].shape[3] * (4 if len(linear) == 4 else 1) // P
    order = torch.randperm(n_pages, generator=gen, device=dev)[: B * P].reshape(B, P)
    given = torch.arange(P, device=dev)[None] * psz < slot_lens[:, None]
    table = torch.where(given, order, -1).to(torch.int32)
    pools = [torch.stack([scatter_pages(layer, table, n_pages, scales=i >= 2) for layer in t])
             for i, t in enumerate(linear)]
    return table, pools
