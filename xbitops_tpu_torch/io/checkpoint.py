"""Save and load packed (quantized) models as a directory: one
``manifest.json`` with the tree's structure and each QTensor's static fields,
one ``.npy`` per array leaf (port of ``xbitops_tpu/io/checkpoint.py``, format
version 3, which both packages read and write).

bfloat16 leaves are stored as their bits in ``uint16`` with the true dtype in
the manifest; they come back as ``torch.bfloat16`` views, so loading needs no
bfloat16 support in numpy.  fp16 scales are stored as ``int16`` bit patterns,
as the JAX package keeps them.
"""

from __future__ import annotations

import json
import types
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.io.convert import _tensor, params_from_numpy, qtensor_from_numpy
from xbitops_tpu_torch.models.llama import Llama, LlamaConfig, linear_weight

__all__ = ["save_packed", "load_packed", "load_llama"]

_FORMAT_VERSION = 3
_QT_FIELDS = ("bits", "group_size", "tile_k", "K", "K_logical", "N_logical", "value_bits")


def _tree(model: Llama) -> dict:
    """The parameter tree of a model, in the JAX package's per-layer layout."""
    layers = [dict(block.weights(), ln_attn=block.ln_attn, ln_mlp=block.ln_mlp)
              for block in model.blocks]
    return {"embed": model.embed, "layers": layers, "ln_final": model.ln_final,
            "lm_head": linear_weight(model.lm_head)}


def _encode(node: Any, path: str, arrays: dict) -> dict:
    if isinstance(node, QTensor):
        for i, plane in enumerate(node.planes):
            arrays[f"{path}.plane{i}"] = plane
        arrays[f"{path}.scales"] = node.scales
        arrays[f"{path}.scale_zeros"] = node.scale_zeros
        if node.perm is not None:
            arrays[f"{path}.perm"] = node.perm.to(torch.int32)
        meta = {f: getattr(node, f) for f in _QT_FIELDS}
        return {"kind": "qtensor", "n_planes": len(node.planes),
                "has_perm": node.perm is not None, **meta}
    if isinstance(node, dict):
        return {"kind": "dict",
                "items": {k: _encode(v, f"{path}.{k}", arrays) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"kind": "list",
                "items": [_encode(v, f"{path}.{i}", arrays) for i, v in enumerate(node)]}
    arrays[path] = node
    return {"kind": "array"}


def save_packed(params: Any, path: str, tp: int = 1) -> None:
    """Write a :class:`Llama`, or a tree of dicts, lists, tensors and QTensors,
    to the directory ``path``.  ``tp`` records the tensor-parallel degree the
    tree was packed for (row-sharded leaves carry that many shards)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    arrays: dict = {}
    tree = _encode(_tree(params) if isinstance(params, Llama) else params, "p", arrays)
    dtypes = {}
    for name, t in arrays.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtypes[name] = "bfloat16"
            arr = t.view(torch.int16).numpy().view(np.uint16)
        elif t.dtype == torch.float16:  # stored as bit patterns
            arr = t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
        np.save(p / f"{name}.npy", arr, allow_pickle=False)
    (p / "manifest.json").write_text(
        json.dumps({"version": _FORMAT_VERSION, "tp": tp, "tree": tree, "dtypes": dtypes}))


def _decode(meta: dict, path: str, load_array, device) -> Any:
    kind = meta["kind"]
    if kind == "qtensor":
        fields = types.SimpleNamespace(
            planes=tuple(load_array(f"{path}.plane{i}") for i in range(meta["n_planes"])),
            scales=load_array(f"{path}.scales"),
            scale_zeros=load_array(f"{path}.scale_zeros"),
            perm=load_array(f"{path}.perm") if meta["has_perm"] else None,
            **{f: meta.get(f) for f in _QT_FIELDS},
        )
        return qtensor_from_numpy(fields, device)
    if kind == "dict":
        return {k: _decode(m, f"{path}.{k}", load_array, device)
                for k, m in meta["items"].items()}
    if kind == "list":
        return [_decode(m, f"{path}.{i}", load_array, device)
                for i, m in enumerate(meta["items"])]
    return _tensor(load_array(path), device)


def load_packed(path: str, device=None, tp: Optional[int] = None) -> Any:
    """Read a directory written by :func:`save_packed` (this package's or the
    JAX package's) into the same tree with ``torch.Tensor`` and
    :class:`QTensor` leaves on ``device`` (default: the CUDA device).

    ``tp`` (if given) must equal the degree recorded at pack time."""
    device = "cuda" if device is None else device
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    if manifest["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown packed-checkpoint version {manifest['version']}")
    packed_tp = manifest.get("tp", 1)
    if tp is not None and tp != packed_tp:
        raise ValueError(
            f"checkpoint at {path} was packed for tp={packed_tp}, requested tp={tp}")
    dtypes = manifest.get("dtypes", {})

    def load_array(name: str):
        arr = np.load(p / f"{name}.npy", allow_pickle=False)
        if name not in dtypes:
            return arr
        if dtypes[name] != "bfloat16" or arr.dtype != np.uint16:
            raise NotImplementedError(f"{name}: stored dtype {dtypes[name]} is not ported")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)

    return _decode(manifest["tree"], "p", load_array, device)


def load_llama(path: str, cfg: LlamaConfig, device=None, tp: int = 1) -> Llama:
    """A :class:`Llama` from a packed checkpoint directory, on ``device``
    (default: the CUDA device): what a server starts from.  The directory
    must be packed for ``tp`` ranks; a model of ``tp > 1`` (row-sharded wo and
    w_down, fused columns interleaved) is what ``parallel.model_tp.
    shard_params`` and ``Engine(mesh=)`` take."""
    device = "cuda" if device is None else device
    return params_from_numpy(load_packed(path, device, tp=tp), cfg, device)
