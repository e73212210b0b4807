"""Structured synthetic models: dense checkpoints with learnable sequence
structure (deterministic token-successor cycles) in place of random noise
(port of ``xbitops_tpu/utils/structured.py``).

A random-weight model has near-uniform logits: perplexity parity means
nothing and an n-gram draft never matches.  A successor-structured model
gives both teeth: the dense model predicts each token's successor with
near-certainty, so quantize -> generate has a real perplexity to keep, and
greedy continuations are periodic with period ``cycle``, so the engine's
prompt-lookup draft has real acceptance.

Token space is cut into blocks of ``cycle`` consecutive ids; the successor of
token t is the next id within its block (wrapping), so greedy generation
walks t's block forever: ``16 17 18 19 20 21 22 23 16 17 ...``.

Two ways to build one:

- ``device=None`` (default): numpy, from ``np.random.default_rng(seed)``, the
  JAX package's construction draw for draw.  The tree holds float32 arrays
  whose weights are already rounded to bfloat16 (as the JAX package's bf16
  arrays are), so a seed gives the same values, and the same checkpoint
  files, in both packages.  :func:`structured_llama` puts such a tree on a
  device as a :class:`~xbitops_tpu_torch.models.llama.Llama`.
- ``device="cuda"`` (or any device): the same construction drawn from a
  ``torch.Generator`` on that device, returned as a ``Llama`` there.  It is
  NOT bit-equal to the numpy path (other random streams); it exists because
  numpy draws at 7B widths take minutes.
"""

from __future__ import annotations

import json
from pathlib import Path
import numpy as np
import torch

from xbitops_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig

__all__ = ["successor", "successor_stream", "structured_dense_params",
           "structured_moe_params", "structured_llama", "write_hf_dense_checkpoint",
           "write_hf_mixtral_checkpoint", "structured_calib_tokens"]

# tree keys stored in bf16 (the rest, norms and the router, stay f32)
_F32_KEYS = ("ln_attn", "ln_mlp", "ln_final", "router")


def successor(tok, cycle: int):
    """Next token id in ``tok``'s cycle block (ints, numpy or torch)."""
    base = (tok // cycle) * cycle
    return base + (tok - base + 1) % cycle


def successor_stream(start: int, n: int, cycle: int) -> np.ndarray:
    """The n-token greedy continuation the structured model should emit."""
    out = np.empty(n, np.int64)
    t = start
    for i in range(n):
        t = int(successor(t, cycle))
        out[i] = t
    return out


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (nearest even), kept as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _predecessors(V: int, cycle: int) -> np.ndarray:
    v = np.arange(V)
    base = (v // cycle) * cycle
    return base + (v - base - 1) % cycle


class _Draw:
    """Normal draws in numpy (``default_rng``) or on a device (``torch.Generator``)."""

    def __init__(self, seed: int, device):
        self.device = device
        if device is None:
            self.rng = np.random.default_rng(seed)
        else:
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, scale=1.0):
        if self.device is None:
            return (self.rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.randn(shape, generator=self.gen, device=self.device) * scale


def _dense_tree(cfg: LlamaConfig, cycle: int, seed: int, logit_scale: float,
                layer_scale: float, device) -> dict:
    """The tree of :func:`structured_dense_params`, unrounded, numpy or torch f32."""
    V, h = cfg.vocab_size, cfg.hidden_size
    if V % cycle:
        raise ValueError("vocab_size must be a multiple of cycle")
    d = _Draw(seed, device)
    embed = d.normal((V, h))
    pred = _predecessors(V, cycle)
    if device is not None:
        pred = torch.from_numpy(pred).to(device)
    lm_head = (logit_scale * embed[pred]).T  # [h, V]
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    ffn = cfg.intermediate_size
    ones = (np.ones(h, np.float32) if device is None
            else torch.ones(h, dtype=torch.float32, device=device))
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(dict(
            wq=d.normal((h, qdim), layer_scale), wk=d.normal((h, kvdim), layer_scale),
            wv=d.normal((h, kvdim), layer_scale), wo=d.normal((qdim, h), layer_scale),
            w_gate=d.normal((h, ffn), layer_scale), w_up=d.normal((h, ffn), layer_scale),
            w_down=d.normal((ffn, h), layer_scale), ln_attn=ones, ln_mlp=ones,
        ))
    return dict(embed=embed, lm_head=lm_head, ln_final=ones, layers=layers)


def _round_tree(tree: dict) -> dict:
    """Weights rounded to bf16 (numpy: kept f32; torch: bf16 tensors)."""
    def rnd(k, a):
        if k in _F32_KEYS:
            return a
        return _bf16(a) if isinstance(a, np.ndarray) else a.to(torch.bfloat16)

    return dict(embed=rnd("embed", tree["embed"]), lm_head=rnd("lm_head", tree["lm_head"]),
                ln_final=tree["ln_final"],
                layers=[{k: rnd(k, a) for k, a in layer.items()} for layer in tree["layers"]])


def structured_llama(params: dict, cfg: LlamaConfig, device) -> Llama:
    """A numpy tree of this module on ``device`` as a dense :class:`Llama`
    (weights bf16, norms and router f32, projections unfused as the dense
    checkpoint loader gives them)."""
    def t(k, a):
        x = a.to(device) if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)).to(device)
        return (x.float() if k in _F32_KEYS else x.to(torch.bfloat16)).contiguous()

    blocks = []
    for layer in params["layers"]:
        proj = {k: t(k, a) for k, a in layer.items() if k not in ("ln_attn", "ln_mlp")}
        blocks.append(LlamaBlock(cfg, proj, t("ln_attn", layer["ln_attn"]),
                                 t("ln_mlp", layer["ln_mlp"])))
    return Llama(cfg, t("embed", params["embed"]), blocks, t("ln_final", params["ln_final"]),
                 t("lm_head", params["lm_head"]))


def structured_dense_params(
    cfg: LlamaConfig,
    cycle: int = 8,
    seed: int = 0,
    logit_scale: float = 0.1,
    layer_scale: float = 0.02,
    device=None,
):
    """Dense params whose greedy output is the successor walk.

    Embedding rows are random (quasi-orthogonal at hidden >= 128); lm_head
    column v is ``logit_scale * embed[predecessor(v)]``, so after the residual
    stream (small random layers riding on the embedding) the largest logit is
    the successor.  Layer weights are small but nonzero, so GPTQ has real
    weights to quantize and the structure survives 4-bit rounding.

    ``device=None``: a numpy tree (see the module docstring), equal to the
    JAX package's for the same seed; else a :class:`Llama` on ``device``,
    drawn there (not bit-equal to the numpy tree)."""
    tree = _round_tree(_dense_tree(cfg, cycle, seed, logit_scale, layer_scale, device))
    return tree if device is None else structured_llama(tree, cfg, device)


def structured_moe_params(
    cfg,
    cycle: int = 8,
    seed: int = 0,
    logit_scale: float = 0.1,
    layer_scale: float = 0.02,
    device=None,
):
    """Mixtral-shaped structured model: the dense successor model's attention,
    embedding and lm_head, each layer's MLP replaced by a router and stacked
    DENSE experts (``moe_ffn`` runs them through its dense branch), drawn
    after the dense model from ``seed + 1``.  ``device`` as in
    :func:`structured_dense_params`."""
    from xbitops_tpu_torch.models.moe import MoeConfig

    if not isinstance(cfg, MoeConfig):
        raise TypeError("structured_moe_params needs a MoeConfig")
    tree = _dense_tree(cfg, cycle, seed, logit_scale, layer_scale, device)
    d = _Draw(seed + 1, device)
    h, ffn, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    for layer in tree["layers"]:
        for k in ("w_gate", "w_up", "w_down"):
            del layer[k]
        layer["router"] = d.normal((h, E), h ** -0.5)
        layer["w_experts_gateup"] = d.normal((E, h, 2 * ffn), layer_scale)
        layer["w_experts_down"] = d.normal((E, ffn, h), layer_scale)
    tree = _round_tree(tree)
    return tree if device is None else structured_llama(tree, cfg, device)


def _numpy_tree(params) -> dict:
    """A numpy tree, or a dense :class:`Llama`'s weights as one (f32)."""
    if not isinstance(params, Llama):
        return params
    from xbitops_tpu_torch.io.checkpoint import _tree

    def f32(a):
        return a.detach().float().cpu().numpy()

    tree = _tree(params)
    return dict(embed=f32(tree["embed"]), lm_head=f32(tree["lm_head"]),
                ln_final=f32(tree["ln_final"]),
                layers=[{k: f32(a) for k, a in layer.items()} for layer in tree["layers"]])


def _hf_config(cfg: LlamaConfig, model_type: str, **extra) -> str:
    return json.dumps(dict(
        model_type=model_type, vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        max_position_embeddings=cfg.max_seq_len, **extra))


def _attn_and_norms(t: dict, pre: str, layer: dict) -> None:
    for name, key in (("q", "wq"), ("k", "wk"), ("v", "wv"), ("o", "wo")):
        t[f"{pre}.self_attn.{name}_proj.weight"] = np.ascontiguousarray(layer[key].T)
    t[f"{pre}.input_layernorm.weight"] = layer["ln_attn"]
    t[f"{pre}.post_attention_layernorm.weight"] = layer["ln_mlp"]


def _save(t: dict, params: dict, path: Path, config: str) -> None:
    from safetensors import numpy as st_np

    t["model.embed_tokens.weight"] = params["embed"]
    t["lm_head.weight"] = np.ascontiguousarray(params["lm_head"].T)
    t["model.norm.weight"] = params["ln_final"]
    st_np.save_file({k: np.asarray(v, np.float32) for k, v in t.items()},
                    str(path / "model.safetensors"))
    (path / "config.json").write_text(config)


def write_hf_dense_checkpoint(params, cfg: LlamaConfig, path: str) -> None:
    """Write a dense model (numpy tree, or a dense :class:`Llama` with
    unfused projections) as a HF-layout safetensors directory, f32, weights
    ``[out, in]`` as HF Linear stores them: the input of CLI ``quantize``."""
    params = _numpy_tree(params)
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    t = {}
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        _attn_and_norms(t, pre, layer)
        for name, key in (("gate", "w_gate"), ("up", "w_up"), ("down", "w_down")):
            t[f"{pre}.mlp.{name}_proj.weight"] = np.ascontiguousarray(layer[key].T)
    _save(t, params, p, _hf_config(cfg, "llama"))


def write_hf_mixtral_checkpoint(params, cfg, path: str) -> None:
    """Write a dense structured MoE model as a HF-layout Mixtral checkpoint
    (``block_sparse_moe.gate`` and ``experts.{e}.w1/w2/w3``, weights
    ``[out, in]``): the input of CLI ``quantize`` for MoE."""
    params = _numpy_tree(params)
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    ffn = cfg.intermediate_size
    t = {}
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        _attn_and_norms(t, pre, layer)
        t[f"{pre}.block_sparse_moe.gate.weight"] = np.ascontiguousarray(layer["router"].T)
        gu, down = layer["w_experts_gateup"], layer["w_experts_down"]
        for e in range(cfg.n_experts):
            ep = f"{pre}.block_sparse_moe.experts.{e}"
            t[f"{ep}.w1.weight"] = np.ascontiguousarray(gu[e, :, :ffn].T)
            t[f"{ep}.w3.weight"] = np.ascontiguousarray(gu[e, :, ffn:].T)
            t[f"{ep}.w2.weight"] = np.ascontiguousarray(down[e].T)
    _save(t, params, p, _hf_config(cfg, "mixtral", num_local_experts=cfg.n_experts,
                                   num_experts_per_tok=cfg.experts_per_token))


def structured_calib_tokens(
    cfg: LlamaConfig, cycle: int, n_rows: int, seq_len: int, seed: int = 1
) -> np.ndarray:
    """Calibration streams that follow the successor structure (random block
    starts, then the deterministic walk): the data distribution the model
    'was trained on'.  int64 ``[n_rows, seq_len]``, the JAX package's for the
    same seed."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n_rows, seq_len), np.int64)
    for r in range(n_rows):
        t = int(rng.integers(0, cfg.vocab_size))
        rows[r, 0] = t
        for i in range(1, seq_len):
            t = int(successor(t, cycle))
            rows[r, i] = t
    return rows
