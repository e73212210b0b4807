"""Process meshes and the collectives over their axes (port of
``xbitops_tpu/parallel/mesh.py``).

The JAX package runs one program over a device ``Mesh`` and lets XLA emit the
collectives.  Here each rank is a process (``parallel.multihost.initialize``)
and a :class:`Mesh` names the process group of each axis and the rank's
coordinate on it.  A sum is ``all_reduce``, a gather
``all_gather_into_tensor`` and a sum-and-slice ``reduce_scatter_tensor``, the
same calls on every backend: gloo on the CPU, gloo with ranks that share a
card (NCCL refuses two ranks on one card; gloo takes all three for CUDA
tensors, ``utils/collectives_probe.py``) and NCCL with a card a rank.  A ring
permute (``lax.ppermute``) is ``all_to_all_single`` with one nonzero split
each way (:func:`ppermute`).  An axis of size 1 makes no call.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "psum", "all_gather", "psum_scatter", "ppermute"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a world laid out on named axes, row-major: this rank's
    coordinate on each axis and the process group of the ranks that differ
    from it on that axis alone (None for an axis of size 1)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _at(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[self._at(axis)]

    def group(self, axis: str):
        return self.groups[self._at(axis)]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh over the ranks of the default process group (one process a
    rank).  The default shape puts every rank on the last (``model``) axis.
    Without an initialized process group the world is this process alone, and
    every axis has size 1.  Every rank must call this, in the same order as
    its other group constructions (``torch.distributed.new_group``)."""
    axis_names = tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(f"mesh shape {shape} needs {need} ranks, the world has {world}")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = []
    for a, size in enumerate(shape):
        mine = None
        if size > 1:
            # every rank builds every group of the axis, in one order
            others = [range(s) for i, s in enumerate(shape) if i != a]
            for rest in itertools.product(*others):
                ranks = []
                for c in range(size):
                    idx = list(rest)
                    idx.insert(a, c)
                    ranks.append(int(np.ravel_multi_index(idx, shape)))
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine = g
        groups.append(mine)
    return Mesh(axis_names, shape, coords, tuple(groups))


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, in ``x``'s dtype, on every
    one of them (``x`` itself is left as it is)."""
    if mesh.shape[axis] == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group(axis))
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the order of their
    coordinate on ``axis`` (``all_gather(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over ``axis``
    (``psum_scatter(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """The ring permute of ``lax.ppermute`` with pairs ``(i, (i + shift) % n)``:
    every rank of ``axis`` sends ``x`` to the rank at coordinate ``(c + shift)
    % n`` and returns what the rank at ``(c - shift) % n`` sent.  ``x`` has
    the same shape and dtype on every rank.

    One ``all_to_all_single`` whose input splits are 0 except at the
    destination and whose output splits are 0 except at the source.  Gloo
    takes it for CUDA tensors, while ``send`` / ``recv`` and
    ``batch_isend_irecv`` of a CUDA tensor hand gloo's TCP transport the
    device pointer and end the process ("Bad address";
    ``utils/collectives_probe.py``, torch 2.11 on an H100); NCCL and gloo on
    the CPU take it too, so one call serves every backend, as :func:`psum`
    does."""
    n = mesh.shape[axis]
    if shift % n == 0:
        return x
    c = mesh.index(axis)
    flat = x.reshape(-1).contiguous()
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(c + shift) % n] = recv[(c - shift) % n] = flat.numel()
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                           group=mesh.group(axis))
    return out.view(x.shape)
