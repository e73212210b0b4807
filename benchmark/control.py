"""The check's two readings for a cell, on the card: the program's gap and
the control's, over several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds <s>

For each seed it runs the cell as ``run.py`` does (its driver, at the cell's
own load for ``--seconds``), draws the same sample, and reads the reference
in float32 and twice in the program's place, one step below a precision the
configuration states: the control, every projection's input rounded to
float8 e4m3 (``reference.llama.fp8_rows``; the model computes in bf16), and
the second control, k and v rounded to int4 a row (``int4_rows``; the cache
is int8).  At each served position a control's reading is the float32
reference's best logit less its logit of the token the control puts first.
One JSON line a seed: for the program and each control the widest and the
mean gap, the share of positions where the picked token is the reference's
best, and ``correct`` as ``judge.verdict`` decides it with the cell's limit
(which both controls have to fail); the reference's logit spread.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def summary(g, verdict) -> dict:
    return dict(max=float(g.max()), mean=float(g.mean()), p99=float(g.quantile(0.99)),
                agree=float((g == 0).float().mean()), correct=verdict(g))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark import run
    from benchmark.core import cell as cells, judge
    from benchmark.core.cell import Context
    from benchmark.reference.llama import fp8_rows, int4_rows

    run._caches(ROOT)
    cell = cells.load(ROOT, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    driver = importlib.import_module(f"benchmark.drivers.{cell.wl['driver']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        res = driver.run(Context(cell, seed, args.seconds, device, None, t0))
        chk = cell.wl["check"]
        picked = judge.sample(res["requests"], seed, chk["sample_tokens"])
        shortfalls = judge.shortfalls(res["requests"])

        def verdict(g):
            return judge.verdict(chk, g, *shortfalls)[0]

        ref = judge.logits(cell.cfg, seed, device, picked)
        fp8 = judge.logits(cell.cfg, seed, device, picked, act=fp8_rows)
        kv4 = judge.logits(cell.cfg, seed, device, picked, kv=int4_rows)
        served = judge.gaps(ref, [torch.tensor(r.tokens) for r in picked]).cpu()
        control = judge.gaps(ref, [c.argmax(dim=-1) for c in fp8]).cpu()
        int4_kv = judge.gaps(ref, [c.argmax(dim=-1) for c in kv4]).cpu()
        top2 = torch.cat([lg.topk(2, dim=-1).values for lg in ref])
        print(json.dumps(dict(
            workload=args.workload, seed=seed, tokens=int(served.numel()),
            requests=len(picked), served=summary(served, verdict),
            control=summary(control, verdict), control_int4_kv=summary(int4_kv, verdict),
            logit_std=float(torch.cat(ref).std()),
            margin_median=float((top2[:, 0] - top2[:, 1]).median()),
            end_to_end=res["end_to_end"], seconds=time.monotonic() - t0,
            memory_peak_bytes=res["memory_peak_bytes"])), flush=True)
        del res, picked, ref, fp8, kv4
    return 0


if __name__ == "__main__":
    sys.exit(main())
