"""The system under test, built through xbitops_tpu_torch's public API from
the benchmark's own tensors (``core/synth.py``)."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.core import synth


def model_config(cfg: Dict):
    """The port's config of a configuration file (``MoeConfig`` where it has
    experts, no-drop)."""
    from xbitops_tpu_torch.models.llama import LlamaConfig
    from xbitops_tpu_torch.models.moe import MoeConfig

    s = synth.Shape.of(cfg)
    kw = dict(vocab_size=s.vocab, hidden_size=s.hidden, intermediate_size=s.ffn,
              num_layers=s.layers, num_heads=s.heads, num_kv_heads=s.kv_heads,
              head_dim=s.head_dim, rope_theta=float(cfg["rope_theta"]),
              rms_eps=cfg["rms_norm_eps"], max_seq_len=cfg["max_position_embeddings"],
              sliding_window=cfg.get("sliding_window"))
    if s.experts:
        return MoeConfig(n_experts=s.experts, experts_per_token=cfg["num_experts_per_tok"],
                         capacity_factor=None, **kw)
    return LlamaConfig(**kw)


def qtensor(p: synth.Packed):
    from xbitops_tpu_torch.formats import QTensor

    return QTensor(planes=(p.words,), scales=p.scales, scale_zeros=p.scale_zeros,
                   bits=synth.BITS, group_size=p.group_size, tile_k=p.tile_k, K=p.K,
                   K_logical=p.K)


def build_model(cfg: Dict, seed: int, device):
    """The port's ``Llama`` holding the weights of ``seed``."""
    from xbitops_tpu_torch.models.llama import Llama, LlamaBlock

    mcfg = model_config(cfg)
    s = synth.Shape.of(cfg)
    blocks = []
    for li in range(s.layers):
        w = synth.layer(seed, s, li, device)
        ln_attn, ln_mlp = w.pop("ln_attn"), w.pop("ln_mlp")
        proj = {k: qtensor(v) if isinstance(v, synth.Packed) else v for k, v in w.items()}
        blocks.append(LlamaBlock(mcfg, proj, ln_attn, ln_mlp))
    ln_final, lm_head = synth.head(seed, s, device)
    embed = synth.embedding(seed, s, device)
    return Llama(mcfg, embed, blocks, ln_final, qtensor(lm_head)), mcfg


def build_engine(cfg: Dict, seed: int, device, options: Dict):
    """The model of ``seed`` under an ``Engine`` with the cell's ``options``;
    the engine's sampling generator is seeded from ``seed`` too."""
    from xbitops_tpu_torch.engine.engine import Engine

    model, mcfg = build_model(cfg, seed, device)
    return Engine(model, mcfg, seed=synth.tensor_seed(seed, "sampling"), **options)


def loop_stats(engine) -> Dict[str, float]:
    """The engine's loop statistics of its last ``generate`` call."""
    return {k: float(v) for k, v in engine.loop_stats.items()}


def release() -> None:
    """Give the device memory of the program's freed state back."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
