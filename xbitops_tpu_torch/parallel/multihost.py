"""Starting the ranks of a world (port of ``xbitops_tpu/parallel/multihost.py``).

One process a rank.  Under ``torchrun`` every rank calls :func:`initialize`
with no argument (it reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and the ``MASTER_ADDR``/``MASTER_PORT`` rendezvous);
:func:`spawn` starts a world of local processes itself, with a file
rendezvous, as the tests, ``generate --tp`` and ``chip_smoke.py`` do.  The
backend is chosen once, here: NCCL when every rank of a host has a card of its
own, gloo otherwise (the CPU, or ranks that share a card, which NCCL refuses).
A rank runs on a card unless it is started with ``device="cpu"``: one that
finds no card raises, and does not go on on the CPU.
The JAX package's ``overlap_flags`` (XLA TPU flags) has no counterpart.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from xbitops_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize", "make_pod_mesh", "spawn"]


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = 600.0, device: str = "cuda") -> torch.device:
    """Join the default process group (once a process, before any mesh) and
    return this rank's device: with ``device="cuda"`` (the default)
    ``cuda:{LOCAL_RANK % device_count}``, set as the current device, and a
    ``RuntimeError`` where the CUDA runtime sees no card; with ``"cpu"`` the
    CPU.  Arguments not given come from torchrun's environment (``init_method``
    ``"env://"``).  ``backend=None``: NCCL when the ranks of this host
    (``LOCAL_WORLD_SIZE``, else the world) have a card each, else gloo."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    cards = 0
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not cards:
            raise RuntimeError(f"rank {rank}: the CUDA runtime sees no card (device='cpu' "
                               "runs the rank on the CPU)")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if backend is None:
        backend = "nccl" if cards and local_world <= cards else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_pod_mesh(tp: Optional[int] = None,
                  axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """The (data, model) mesh over every rank of the world: ``tp`` ranks on
    the model axis (default: the ranks of one host, ``LOCAL_WORLD_SIZE``),
    consecutive ranks, so that the per-token collectives stay inside a host,
    and the data axis over the rest."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = tp or _env_int("LOCAL_WORLD_SIZE", world)
    if world % tp:
        raise ValueError(f"tp={tp} must divide the world size {world}")
    return make_mesh((world // tp, tp), axis_names)


def _rank_main(rank: int, fn: Callable, world: int, init_method: str, backend: Optional[str],
               device: str, threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    initialize(backend, init_method, rank, world, device=device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
          device: str = "cuda") -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (start method
    "spawn"), each a rank of one world that :func:`initialize` has joined on
    ``device`` (file rendezvous in a temporary directory), and wait for all of
    them.  A rank that raises ends the others and the error is raised here.
    Each rank takes its share of this process's torch threads."""
    threads = max(1, torch.get_num_threads() // nprocs)
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(
            _rank_main,
            args=(fn, nprocs, f"file://{d}/rendezvous", backend, device, threads, args),
            nprocs=nprocs, join=True)
