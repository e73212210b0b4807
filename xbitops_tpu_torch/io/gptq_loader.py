"""AutoGPTQ checkpoints into the port (port of ``xbitops_tpu/io/gptq_loader.py``).

A HuggingFace-layout AutoGPTQ Llama or Mistral checkpoint (``*.safetensors``,
``config.json``, ``quantize_config.json``) is read with ``safetensors.numpy``
and converted straight into the packed layout (``formats.from_gptq``): act-order
rows (a non-trivial ``g_idx``) are sorted into contiguous groups, q|k|v and
gate|up fuse into one matmul each where their layouts allow, and a desc_act
``down_proj``'s row sort folds into gate/up's output columns, so the down
matmul gathers nothing.  The result is the port's :class:`Llama` on a device.

Zero points: AutoGPTQ's "gptq" format stores ``zero - 1`` in ``qzeros``
(``add_zero_bias=1``); "gptq_v2" stores true zeros.  ``add_zero_bias=None``
reads it from ``quantize_config.json``.

A Mixtral checkpoint (``model_type == "mixtral"``) gives a
:class:`~xbitops_tpu_torch.models.moe.MoeConfig` in no-drop mode
(``capacity_factor=None``) and blocks with a ``router`` and each expert's
w1 (gate) | w3 (up) fused, then stacked on a leading expert axis, w2 (down)
stacked likewise: quantized experts as stacked QTensors, dense ones (the
quantizer's input) as ``[E, K, N]`` tensors.

``tp > 1`` packs for tensor parallelism (``parallel.model_tp``; see
:func:`load_autogptq`); a Mixtral checkpoint shards over the expert axis, not
by rows, and raises for it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig, interleave_order

__all__ = ["load_autogptq", "llama_config_from_hf"]


def _load_safetensors_dir(path: Path) -> dict:
    from safetensors import numpy as st_np

    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    tensors = {}
    for f in files:
        tensors.update(st_np.load_file(str(f)))
    return tensors


def llama_config_from_hf(cfg: dict, max_seq_len: Optional[int] = None) -> LlamaConfig:
    """The :class:`LlamaConfig` of a HuggingFace ``config.json`` (as a dict),
    a :class:`~xbitops_tpu_torch.models.moe.MoeConfig` in no-drop mode for
    Mixtral.  ``max_seq_len`` defaults to ``max_position_embeddings``, at most
    4096."""
    heads = cfg["num_attention_heads"]
    # HF rope_scaling: {"type"|"rope_type": "linear"|"dynamic", "factor": f};
    # "dynamic" is NTK-aware scaling
    rs = cfg.get("rope_scaling") or {}
    rs_type = {"linear": "linear", "dynamic": "ntk", "ntk": "ntk"}.get(
        rs.get("type", rs.get("rope_type")))
    fields = dict(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // heads),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        max_seq_len=max_seq_len or min(cfg.get("max_position_embeddings", 2048), 4096),
        rope_scaling_type=rs_type,
        rope_scaling_factor=float(rs.get("factor", 1.0)),
        # Mistral-v0.1's sliding window (null or absent: full attention)
        sliding_window=cfg.get("sliding_window"),
    )
    if cfg.get("model_type") == "mixtral":
        from xbitops_tpu_torch.models.moe import MoeConfig

        # real Mixtral inference drops no route: checkpoint loads run the
        # exact no-drop dispatch (capacity = token count)
        return MoeConfig(**fields, n_experts=cfg.get("num_local_experts", 8),
                         experts_per_token=cfg.get("num_experts_per_tok", 2),
                         capacity_factor=None)
    return LlamaConfig(**fields)


def _detect_zero_bias(qcfg: dict) -> int:
    # AutoGPTQ "gptq" format stores zero - 1; "gptq_v2" stores true zeros
    return 0 if qcfg.get("checkpoint_format", "gptq") == "gptq_v2" else 1


def _nontrivial_gidx(tensors: dict, prefix: str, in_features: int, group_size: int, device):
    """The checkpoint's ``g_idx`` for ``prefix`` as int64 on ``device``, or None
    when absent or trivial (a monotone ``k // group_size`` map is not act-order)."""
    g_idx = tensors.get(f"{prefix}.g_idx")
    if g_idx is None:
        return None
    arr = np.asarray(g_idx, np.int64)
    if np.array_equal(arr, np.arange(in_features) // group_size):
        return None
    return torch.from_numpy(arr).to(device)


def _try_fuse(parts, sizes=None, tp: int = 1):
    """One QTensor for column-parallel parts ([q|k|v] or [gate|up]) of
    ``sizes`` columns, interleaved per shard for ``tp > 1``, or None where
    they cannot fuse (a dense part, act-order rows, other layouts)."""
    if not all(isinstance(p, formats.QTensor) for p in parts):
        return None
    if any(p.perm is not None for p in parts):
        return None
    if len({(p.bits, p.group_size, p.tile_k, p.K, p.K_logical) for p in parts}) != 1:
        return None
    order = interleave_order(sizes, tp) if tp > 1 else None
    return formats.concat_qtensors(parts, order=order)


def load_autogptq(
    path: str,
    tp: int = 1,
    max_seq_len: Optional[int] = None,
    add_zero_bias: Optional[int] = None,
    dtype=torch.bfloat16,
    scale_store_dtype=None,
    fuse: bool = True,
    storage_bits=None,
    device=None,
) -> Tuple[Llama, LlamaConfig]:
    """Load an AutoGPTQ Llama, Mistral or Mixtral checkpoint directory into
    ``(model, config)`` on ``device`` (default: the CUDA device), where the
    packing runs.

    ``fuse`` merges q|k|v and gate|up into single matmuls where they can
    fuse (per layer: not across act-order or dense projections).  A projection
    without ``qweight`` (often ``lm_head``) stays dense in ``dtype``.
    ``storage_bits``: see :func:`formats.resolve_storage_bits`.

    ``tp > 1`` packs for a ``tp``-way model axis (``parallel.model_tp``): the
    row-parallel o_proj and down_proj row-sharded
    (``formats.make_row_sharded_qtensor``; a desc_act down_proj with its sort
    folded into gate|up's columns, then sharded in sorted order), fused
    columns interleaved per shard.  A desc_act o_proj, whose order crosses
    the heads, keeps its whole tensor and runtime ``perm`` and runs gathered.
    Mixtral shards over the expert axis (``models.moe.shard_experts``), not
    this one: it raises for ``tp > 1``, as the JAX package does."""
    device = "cuda" if device is None else device
    p = Path(path)
    hf_cfg = json.loads((p / "config.json").read_text())
    if hf_cfg.get("model_type", "llama") not in ("llama", "mistral", "mixtral"):
        raise ValueError(f"unsupported model_type {hf_cfg.get('model_type')}")
    if hf_cfg.get("model_type") == "mixtral" and tp > 1:
        raise NotImplementedError("Mixtral checkpoints shard over the EXPERT axis "
                                  "(models.moe.shard_experts), not row-parallel TP; load with tp=1")
    qcfg_path = p / "quantize_config.json"
    qcfg = json.loads(qcfg_path.read_text()) if qcfg_path.exists() else {}
    bits = qcfg.get("bits", 4)
    group_size = qcfg.get("group_size", 128)
    if add_zero_bias is None:
        add_zero_bias = _detect_zero_bias(qcfg)
    cfg = llama_config_from_hf(hf_cfg, max_seq_len)
    tensors = _load_safetensors_dir(p)
    h = cfg.hidden_size

    def t(name: str) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tensors[name])).to(device)

    def q(prefix: str, k_dim: int, col_perm=None, fold: bool = False, row: bool = False,
          gathered_ok: bool = False):
        if f"{prefix}.qweight" in tensors:
            g_idx = _nontrivial_gidx(tensors, prefix, k_dim, group_size, device)
            if row and tp > 1 and (g_idx is None or fold):
                wq = formats.gptq_unpack_weight(t(f"{prefix}.qweight"), bits, k_dim)
                scales = t(f"{prefix}.scales")
                zeros = formats.gptq_unpack_zeros(t(f"{prefix}.qzeros"), bits, scales.shape[1])
                if g_idx is not None:  # rows sorted; the activations arrive sorted
                    wq = wq[torch.argsort(g_idx, stable=True)]
                return formats.make_row_sharded_qtensor(
                    wq, scales, zeros, bits, group_size, tp, add_zero_bias=add_zero_bias,
                    scale_store_dtype=scale_store_dtype, storage_bits=storage_bits)
            if row and tp > 1 and not gathered_ok:
                raise NotImplementedError(
                    "act-order (g_idx) on this row-parallel projection cannot fold into an "
                    "upstream layer; load with tp=1 or re-quantize without desc_act")
            # a desc_act o_proj under tp > 1 keeps its whole tensor and runs gathered
            return formats.from_gptq(
                t(f"{prefix}.qweight"), t(f"{prefix}.scales"), t(f"{prefix}.qzeros"), bits,
                group_size, k_dim, add_zero_bias=add_zero_bias, g_idx=g_idx,
                scale_store_dtype=scale_store_dtype, storage_bits=storage_bits,
                col_perm=col_perm, fold_perm=fold)
        # dense (lm_head is often kept fp16): HF stores [out, in]
        w = t(f"{prefix}.weight").T.to(dtype)
        return (w if col_perm is None else w[:, col_perm]).contiguous()

    def norm(name: str) -> torch.Tensor:
        return t(name).float()

    def moe_entries(pre: str) -> dict:
        """Mixtral's block_sparse_moe: the router, each expert's w1 (gate) |
        w3 (up) fused and w2 (down), stacked on a leading expert axis."""
        from xbitops_tpu_torch.models.moe import stack_experts

        gus, downs = [], []
        for e in range(cfg.n_experts):
            ep = f"{pre}.block_sparse_moe.experts.{e}"
            w1, w3 = q(f"{ep}.w1", h), q(f"{ep}.w3", h)
            if isinstance(w1, formats.QTensor):
                gu = _try_fuse([w1, w3])
                if gu is None:
                    raise NotImplementedError(
                        "Mixtral experts must be quantized and non-act-order "
                        "(the stacked expert matmul fuses w1|w3)")
            else:  # a dense checkpoint (the quantizer's input)
                gu = torch.cat([w1, w3], dim=1)
            gus.append(gu)
            downs.append(q(f"{ep}.w2", cfg.intermediate_size))
        return dict(router=t(f"{pre}.block_sparse_moe.gate.weight").T.float().contiguous(),
                    w_experts_gateup=stack_experts(gus), w_experts_down=stack_experts(downs))

    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    is_moe = hf_cfg.get("model_type") == "mixtral"
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        proj = {}
        qkv = [q(f"{pre}.self_attn.{n}_proj", h) for n in "qkv"]
        wqkv = _try_fuse(qkv, (qdim, kvdim, kvdim), tp) if fuse else None
        proj.update(dict(wqkv=wqkv) if wqkv is not None else dict(zip(("wq", "wk", "wv"), qkv)))
        # a desc_act o_proj keeps its runtime perm: its sort crosses the heads
        proj["wo"] = q(f"{pre}.self_attn.o_proj", qdim, row=True, gathered_ok=True)
        ln = (norm(f"{pre}.input_layernorm.weight"),
              norm(f"{pre}.post_attention_layernorm.weight"))
        if is_moe:
            blocks.append(LlamaBlock(cfg, dict(proj, **moe_entries(pre)), *ln))
            continue
        # desc_act down_proj: its row sort folds into gate/up's output columns
        # (a column permutation commutes with silu(g) * u), so down runs with
        # no gather of its activations
        down = f"{pre}.mlp.down_proj"
        down_gidx = _nontrivial_gidx(tensors, down, cfg.intermediate_size, group_size, device)
        col_perm = None
        if down_gidx is not None and f"{down}.qweight" in tensors:
            col_perm = torch.argsort(down_gidx, stable=True)
        gate = q(f"{pre}.mlp.gate_proj", h, col_perm=col_perm)
        up = q(f"{pre}.mlp.up_proj", h, col_perm=col_perm)
        gu = _try_fuse([gate, up], (cfg.intermediate_size,) * 2, tp) if fuse else None
        proj.update(dict(w_gateup=gu) if gu is not None else dict(w_gate=gate, w_up=up))
        proj["w_down"] = q(down, cfg.intermediate_size, fold=col_perm is not None, row=True)
        blocks.append(LlamaBlock(cfg, proj, *ln))
    embed = t("model.embed_tokens.weight").to(dtype)
    if "lm_head.weight" in tensors or "lm_head.qweight" in tensors:
        lm_head = q("lm_head", h)
    else:  # tied embeddings
        lm_head = embed.T.contiguous()
    return Llama(cfg, embed, blocks, norm("model.norm.weight"), lm_head), cfg
