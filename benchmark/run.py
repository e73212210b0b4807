"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's model (weights drawn from the seed on the card), warms up,
measures for ``--seconds`` through the cell's driver, checks the served tokens
against the plain reference, and prints one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each number
compared, with its limit (also the last lines of standard error).

It exits 3 and prints no result without enough CUDA devices, and 4 where a
JAX module (``jax``, ``jaxlib``, ``flax``, ``xbitops_tpu``) is loaded.  Build
and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "xbitops_tpu"})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _caches(root: Path) -> None:
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """``device`` None takes the card and refuses to run without one; a test
    passes another device to drive the rest of a run."""
    args = parse(argv)
    _caches(root)
    from benchmark.core import cell as cells

    cell = cells.load(root, args.workload)
    import torch

    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"run.py: {args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    return measure(cell, args, torch.device(device))


def measure(cell, args, device) -> int:
    import torch

    from benchmark.core import judge, peaks, program
    from benchmark.core.records import Records
    from benchmark.core.trace import Tracer, breakdown
    from benchmark.core.cell import Context

    cuda = device.type == "cuda"
    tracer = Tracer(cuda) if args.trace else None
    ctx = Context(cell, args.seed, args.seconds, device, tracer, T_PROCESS)
    driver = importlib.import_module(f"benchmark.drivers.{cell.wl['driver']}")
    res = driver.run(ctx)  # the program's state is freed when it returns
    trace = tracer.read() if tracer is not None else None
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    reqs = res["requests"]
    chk = cell.wl["check"]
    picked = judge.sample(reqs, args.seed, chk["sample_tokens"])
    gaps = judge.served_gaps(cell.cfg, args.seed, device, picked)
    unanswered, short = judge.shortfalls(reqs)
    correct, check = judge.verdict(chk, gaps, unanswered, short)

    metrics = {}
    if args.trace:
        rec = Records(cell.cfg, cell.wl, res["window"], reqs, res["calls"], trace,
                      peaks.of(kind))
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(res["end_to_end"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    dev = dict(platform="gpu" if cuda else device.type, kind=kind, count=1,
               memory_peak_bytes=res["memory_peak_bytes"])
    line = dict(correct=bool(correct), attempted=len(reqs), failed=unanswered,
                metrics=metrics, device=dev)
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = breakdown(trace)
    line["check"] = check

    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    if gaps is not None and gaps.numel():
        print(f"widest logit gap {float(gaps.max())} over {gaps.numel()} served tokens "
              f"of {len(picked)} requests (not compared)", file=sys.stderr)
    for name, c in check.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
