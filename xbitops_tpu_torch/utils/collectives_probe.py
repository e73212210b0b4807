"""Which collectives the gloo backend takes for CUDA tensors, and what an
``all_reduce`` costs, with two ranks sharing one card::

    python3 -m xbitops_tpu_torch.utils.collectives_probe

Two ranks on one GPU are a gloo world (NCCL refuses them), so this is what
the port's tensor- and expert-parallel paths pay on one card: every
collective goes through the host.  Rank 0 prints one JSON object: for each
collective and dtype, "ok", "wrong" or the error it raised (a probe of the
backend; the port calls ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` on every backend and chooses nothing by catching
errors), and the mean ms of an ``all_reduce`` in bf16 and f32 at the
shapes a 7B decode step (8 slots), a verify step and a chunk forward sum.
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from xbitops_tpu_torch.parallel import multihost

SHAPES = ((8, 4096), (8, 16000), (8, 32000), (40, 4096), (2560, 4096))


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
    if rank == 0:
        print(json.dumps({"backend": dist.get_backend(), "torch": torch.__version__,
                          "gloo_cuda": taken, "all_reduce_ms": ms}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("collectives_probe measures the card: it needs a CUDA device")
    multihost.spawn(_rank, 2, backend="gloo")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
