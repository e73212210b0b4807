"""Tensor-parallel quantized matmuls, one rank a process (port of
``xbitops_tpu/parallel/tp.py``).

Megatron's two layouts, so that a transformer block needs one collective a
pair of matmuls:

- **column parallel**: shard N.  Every packed array has N last, so rank ``r``
  holds columns ``[r N/n, (r+1) N/n)`` of the planes and scales, lane-aligned
  (``N % (n * 128) == 0``).  The output stays sharded, or is gathered.
- **row parallel**: shard K.  The QTensor is packed row-sharded
  (``formats.make_row_sharded_qtensor``: a leading shard axis, each shard a
  complete QTensor); rank ``r`` holds shard ``r``, multiplies its slice of the
  activations and the partial products are summed over the axis
  (``reduce="psum"``) or summed and sliced (``"reduce_scatter"``).

A rank holds its shard only (:func:`local_qtensor`), where the JAX package
places a global array on a mesh.  :class:`Role` is what a projection module
(``models.llama.QLinear``, ``DenseLinear``) does around its product on a rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from xbitops_tpu_torch.formats import QTensor, is_row_sharded
from xbitops_tpu_torch.ops.qmatmul import qmatmul
from xbitops_tpu_torch.parallel.mesh import Mesh, all_gather, psum, psum_scatter

__all__ = [
    "Role",
    "local_qtensor",
    "local_weight",
    "squeeze_row_shard",
    "column_parallel_qmatmul",
    "row_parallel_qmatmul",
]

_ROW_SHARDED = ("row-parallel requires a row-sharded QTensor "
                "(formats.make_row_sharded_qtensor / quantize_array(row_shards=...))")


def squeeze_row_shard(qt: QTensor) -> QTensor:
    """Drop the (length-1) leading shard axis of one rank's row shard: the
    stacked static fields already describe one shard."""
    if qt.planes[0].shape[0] != 1:
        raise ValueError(
            f"local row-shard axis is {qt.planes[0].shape[0]}, expected 1: the QTensor's shard "
            f"count does not match the mesh axis (was the checkpoint packed for another --tp?)")
    return dataclasses.replace(
        qt, planes=tuple(p[0] for p in qt.planes), scales=qt.scales[0],
        scale_zeros=qt.scale_zeros[0], perm=None if qt.perm is None else qt.perm[0])


def _check_shardable(qt: QTensor, mesh: Mesh, col_axis, row_axis) -> None:
    if col_axis is not None:
        n = mesh.shape[col_axis]
        if qt.N % (n * 128):
            raise ValueError(f"N={qt.N} must split into {n} lane-aligned shards")
    if row_axis is not None:
        n = mesh.shape[row_axis]
        if not is_row_sharded(qt):
            raise ValueError(_ROW_SHARDED)
        if qt.planes[0].shape[0] != n:
            raise ValueError(f"QTensor has {qt.planes[0].shape[0]} row shards, mesh axis has {n}")


def _columns(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    w = t.shape[-1] // n
    return t[..., r * w : (r + 1) * w].clone()


def local_qtensor(qt: QTensor, mesh: Mesh, col_axis: Optional[str] = None,
                  row_axis: Optional[str] = None) -> QTensor:
    """This rank's shard of ``qt`` (copied, so the full tensor can be freed):
    its columns (``col_axis``) or its row shard (``row_axis``).  An act-order
    row weight that is not row-sharded (a desc_act o_proj, whose order crosses
    the shards) is given by its columns: it runs gathered
    (:class:`Role` ``"row_gathered"``)."""
    if row_axis is not None and not is_row_sharded(qt) and qt.perm is not None:
        return local_qtensor(qt, mesh, col_axis=row_axis)
    _check_shardable(qt, mesh, col_axis, row_axis)
    if row_axis is not None:
        r = mesh.index(row_axis)
        return squeeze_row_shard(dataclasses.replace(
            qt, planes=tuple(p[r : r + 1].clone() for p in qt.planes),
            scales=qt.scales[r : r + 1].clone(), scale_zeros=qt.scale_zeros[r : r + 1].clone(),
            perm=None if qt.perm is None else qt.perm[r : r + 1].clone()))
    if col_axis is None:
        return qt
    r, n = mesh.index(col_axis), mesh.shape[col_axis]
    return dataclasses.replace(
        qt, planes=tuple(_columns(p, r, n) for p in qt.planes),
        scales=_columns(qt.scales, r, n), scale_zeros=_columns(qt.scale_zeros, r, n),
        N_logical=None)


def local_weight(w: Union[QTensor, torch.Tensor], mesh: Mesh, col_axis: Optional[str] = None,
                 row_axis: Optional[str] = None) -> Union[QTensor, torch.Tensor]:
    """:func:`local_qtensor`, or for a dense ``[K, N]`` weight its even slice
    of columns or rows."""
    if isinstance(w, QTensor):
        return local_qtensor(w, mesh, col_axis, row_axis)
    axis, dim = (col_axis, 1) if col_axis is not None else (row_axis, 0)
    if axis is None:
        return w
    n, r = mesh.shape[axis], mesh.index(axis)
    if w.shape[dim] % n:
        raise ValueError(f"dense weight {tuple(w.shape)} does not split over {n} ranks")
    s = w.shape[dim] // n
    return w.narrow(dim, r * s, s).clone()


@dataclasses.dataclass(frozen=True)
class Role:
    """What a rank's projection does around its product, on ``axis`` of
    ``mesh``:

    - ``"column"``: nothing (the output stays sharded);
    - ``"column_gather"``: gathers the output (lm_head), cut to ``n_logical``;
    - ``"row"``: sums the partial products, in their dtype (the JAX package
      psums the bf16 output of each row shard);
    - ``"row_gathered"``: an act-order row weight held by its columns: gathers
      the activations, then the output (two gathers for the one sum)."""

    mesh: Mesh
    axis: str
    kind: str
    n_logical: Optional[int] = None

    def __call__(self, product: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
        if self.kind == "row_gathered":
            x = all_gather(x, self.mesh, self.axis)
        y = product(x)
        if self.kind == "row":
            return psum(y, self.mesh, self.axis)
        if self.kind in ("column_gather", "row_gathered"):
            y = all_gather(y, self.mesh, self.axis)
            return y if self.n_logical is None else y[..., : self.n_logical]
        return y


def column_parallel_qmatmul(a: torch.Tensor, qt: QTensor, mesh: Mesh, axis: str = "model",
                            out_dtype=None, gather: bool = False, precise: bool = False,
                            n_logical: Optional[int] = None) -> torch.Tensor:
    """``a`` (replicated) ``@`` this rank's column shard ``qt``
    (:func:`local_qtensor`): the rank's columns of the output, or with
    ``gather`` all of them (cut to ``n_logical``).  Keeping the output sharded
    feeds a following row-parallel matmul with no collective."""
    out_dtype = out_dtype or a.dtype
    role = Role(mesh, axis, "column_gather" if gather else "column", n_logical)
    return role(lambda x: qmatmul(x, qt, out_dtype=out_dtype, precise=precise), a)


def row_parallel_qmatmul(a: torch.Tensor, qt: QTensor, mesh: Mesh, axis: str = "model",
                         out_dtype=None, reduce: str = "psum",
                         precise: bool = False) -> torch.Tensor:
    """This rank's K-slice of the activations ``a [..., K/n]`` ``@`` its row
    shard ``qt`` (:func:`local_qtensor`; its tile padding meets zeros): the
    partial products in f32, summed over ``axis`` (``"psum"``: the whole
    output on every rank) or summed and sliced (``"reduce_scatter"``: the
    rank's columns), then cast to ``out_dtype``."""
    if a.shape[-1] != qt.K_logical:
        raise ValueError(f"a K={a.shape[-1]} != the shard's K_logical = {qt.K_logical}")
    if reduce not in ("psum", "reduce_scatter"):
        raise ValueError(f"unknown reduce {reduce!r}")
    out_dtype = out_dtype or a.dtype
    o = qmatmul(a, qt, out_dtype=torch.float32, precise=precise)
    o = psum(o, mesh, axis) if reduce == "psum" else psum_scatter(o, mesh, axis)
    return o.to(out_dtype)
