"""Which collectives the gloo backend takes for CUDA tensors, and what an
``all_reduce`` costs, with two ranks sharing one card::

    python3 -m xbitops_tpu_torch.utils.collectives_probe

Two ranks on one GPU are a gloo world (NCCL refuses them), so this is what
the port's tensor-, expert-, pipeline- and sequence-parallel paths pay on one
card: every collective goes through the host.  Rank 0 prints one JSON object:
for each collective and dtype, "ok", "wrong" or the error it raised (a probe
of the backend; the port calls ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and, for ``parallel.mesh.ppermute``,
``all_to_all_single`` on every backend and chooses nothing by catching
errors), the mean ms of an ``all_reduce`` in bf16 and f32 at the shapes a 7B
decode step (8 slots), a verify step and a chunk forward sum, and the mean ms
of the ring permute at a PP decode microbatch's hidden state ([4, 1, 4096])
and an SP chunk's keys at 7B ([1, 1024, 32, 128]), bf16.  Then the
point-to-point calls a permute could have used instead, ``send`` / ``recv``
and ``batch_isend_irecv``, each in a world of its own (a backend that takes a
device pointer for a host one ends its process, which ends that world only):
one more JSON object, "ok", "wrong", the error, or how the world failed.
"""

from __future__ import annotations

import datetime
import json
import time

import torch
import torch.distributed as dist

from xbitops_tpu_torch.parallel import multihost
from xbitops_tpu_torch.parallel.mesh import make_mesh, ppermute

SHAPES = ((8, 4096), (8, 16000), (8, 32000), (40, 4096), (2560, 4096))
PERMUTE_SHAPES = ((4, 1, 4096), (1, 1024, 32, 128))


def _try(name: str, x: torch.Tensor, rank: int) -> str:
    dt, dev = x.dtype, x.device
    try:
        if name == "all_reduce":
            dist.all_reduce(x)
            ok = x[0, 0].item() == 3.0
        elif name == "broadcast":
            dist.broadcast(x, 0)
            ok = x[0, 0].item() == 1.0
        elif name == "all_gather_into_tensor":
            o = torch.empty((2 * x.shape[0], x.shape[1]), dtype=dt, device=dev)
            dist.all_gather_into_tensor(o, x)
            ok = o[x.shape[0], 0].item() == 2.0
        elif name == "reduce_scatter_tensor":
            o = torch.empty((x.shape[0] // 2, x.shape[1]), dtype=dt, device=dev)
            dist.reduce_scatter_tensor(o, x)
            ok = o[0, 0].item() == 3.0
        else:
            o = torch.empty_like(x)
            dist.all_to_all_single(o, x)
            ok = o[0, 0].item() == 1.0 and o[-1, 0].item() == 2.0
        return "ok" if ok else "wrong"
    except Exception as e:  # the probe's question: which calls the backend refuses
        return f"{type(e).__name__}: {str(e)[:100]}"


def _rank(rank: int) -> None:
    dev = torch.device("cuda", torch.cuda.current_device())
    taken = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for name in ("all_reduce", "broadcast", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "all_to_all_single"):
            x = torch.full((8, 4096), float(rank + 1), dtype=dt, device=dev)
            taken[f"{name} {str(dt).split('.')[-1]}"] = _try(name, x, rank)
    ms = {}
    for dt in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            x = torch.randn(shape, device=dev).to(dt)
            for _ in range(3):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(50):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            ms[f"{str(dt).split('.')[-1]} {shape[0]}x{shape[1]}"] = round(
                1e3 * (time.perf_counter() - t0) / 50, 4)
    mesh = make_mesh((2,), ("pipe",))
    x = torch.full((8, 4096), float(rank + 1), dtype=torch.bfloat16, device=dev)
    taken["ppermute (all_to_all_single) bfloat16"] = (
        "ok" if ppermute(x, mesh, "pipe")[0, 0].item() == 2.0 - rank else "wrong")
    permute_ms = {}
    for shape in PERMUTE_SHAPES:
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        for _ in range(3):
            ppermute(x, mesh, "pipe")
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(50):
            x = ppermute(x, mesh, "pipe")
        torch.cuda.synchronize()
        permute_ms["x".join(map(str, shape))] = round(1e3 * (time.perf_counter() - t0) / 50, 4)
    if rank == 0:
        print(json.dumps({"backend": dist.get_backend(), "torch": torch.__version__,
                          "gloo_cuda": taken, "all_reduce_ms": ms, "ppermute_ms": permute_ms}),
              flush=True)


def _p2p_rank(rank: int, name: str) -> None:
    """One point-to-point exchange of a CUDA tensor between the two ranks,
    in a group whose calls give up after 60 s."""
    dev = torch.device("cuda", torch.cuda.current_device())
    group = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=60))
    x = torch.full((8, 4096), float(rank + 1), dtype=torch.bfloat16, device=dev)
    o = torch.zeros_like(x)
    try:
        if name == "send / recv":
            req = dist.isend(x, 1 - rank, group=group)
            dist.recv(o, 1 - rank, group=group)
            req.wait()
        else:
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank, group),
                                               dist.P2POp(dist.irecv, o, 1 - rank, group)]):
                req.wait()
        torch.cuda.synchronize()
        out = "ok" if o[0, 0].item() == 2.0 - rank else "wrong"
    except Exception as e:  # the probe's question: which calls the backend refuses
        out = f"{type(e).__name__}: {str(e)[:100]}"
    if rank == 0:
        print(json.dumps({"gloo_cuda_p2p": {name: out}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("collectives_probe measures the card: it needs a CUDA device")
    multihost.spawn(_rank, 2, backend="gloo")
    for name in ("send / recv", "batch_isend_irecv"):
        try:
            multihost.spawn(_p2p_rank, 2, args=(name,), backend="gloo")
        except Exception as e:  # a rank's process that ended without a Python error
            print(json.dumps({"gloo_cuda_p2p": {name: f"world failed: {type(e).__name__}: "
                                                      f"{str(e)[:200]}"}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
