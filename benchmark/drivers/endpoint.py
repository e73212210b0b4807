"""A cell served through the HTTP endpoint (``engine/server.py``'s
``ServingEndpoint``), started in this process on port 0 over the cell's
engine.  A child process (``loadgen.py``) offers the open-loop load: each
request at its time from ``core/traffic.py`` (``traffic.arrival``).

The window runs from the first send to the last answer of the requests sent
in the first ``--seconds``.  ``latency_p95_ms`` is the 95th percentile over
all of them of the time from when each was due to its answer (a request never
answered counts at the close of the wait).  Below the endpoint's capacity the
served tokens a second are the offered rate, so the tail is the cell's
end-to-end number.  In a ``--trace 1`` run the engine's ``generate`` is
wrapped, so that the worker thread reports each token's read-back time and
profiles the first call that starts ``trace.after`` of the way into the
window, from its start (the wave's admission) to the first token read back
``trace.seconds`` later.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import Dict

from benchmark.core import program, traffic
from benchmark.core.records import Request
from benchmark.core.stats import percentile

LOADGEN = Path(__file__).resolve().parent / "loadgen.py"


def _post(url: str, r: traffic.Req) -> None:
    body = json.dumps(dict(prompt=r.prompt, max_tokens=r.max_tokens,
                           temperature=r.temperature)).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        resp.read()


def run(ctx) -> Dict:
    import torch
    from xbitops_tpu_torch.engine.server import ServingEndpoint

    wl, cfg = ctx.wl, ctx.cfg
    reqs = traffic.requests(wl["traffic"], ctx.seed, cfg["vocab_size"])
    engine = program.build_engine(cfg, ctx.seed, ctx.device, wl["engine"])
    endpoint = ServingEndpoint(engine, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{endpoint.start()}/v1/completions"
    for r in traffic.warmup(wl["traffic"], engine.buckets, engine.prefill_chunk,
                            cfg["vocab_size"]):
        _post(url, r)

    calls, token_times = [], {}
    start_at = time.monotonic() + 0.5
    tracer = ctx.tracer
    if tracer is not None:
        trace_from = start_at + wl["trace"]["after"] * ctx.seconds
        generate = engine.generate

        def traced_generate(requests, on_token=None):
            def stamp(rid, tok):
                t = time.monotonic()
                token_times.setdefault(rid, []).append(t)
                if tracer.running and t >= tracer.span_start + wl["trace"]["seconds"]:
                    tracer.stop()

            profile = not tracer.started and time.monotonic() >= trace_from
            if profile:
                tracer.start()
            out = generate(requests, on_token=stamp)
            if profile and tracer.running:
                tracer.stop()
            calls.append(program.loop_stats(engine))
            return out

        engine.generate = traced_generate

    job = dict(url=url, start_at=start_at, seconds=ctx.seconds, wait_s=wl["wait_s"],
               requests=[[r.prompt, r.max_tokens, r.temperature, r.at] for r in reqs])
    child = subprocess.Popen([sys.executable, str(LOADGEN)], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    try:
        out, _ = child.communicate(json.dumps(job), timeout=ctx.seconds + wl["wait_s"] + 60)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    records = json.loads(out)["records"]
    endpoint.shutdown()
    peak = torch.cuda.max_memory_allocated(ctx.device) if torch.cuda.is_available() else 0
    del endpoint, engine
    program.release()

    done = []
    for i, due, answered, status, tokens, cid in records:
        r = reqs[i]
        rid = int(cid.split("-")[1]) if cid else None
        done.append(Request(i, r.prompt, r.max_tokens, r.greedy, due,
                            answered if status == 200 else None, tokens,
                            token_times.get(rid)))
    t_end = max([r.answered for r in done if r.answered is not None] + [start_at])
    close = max(t_end, time.monotonic())
    lat = [(r.answered if r.answered is not None else close) - r.sent for r in done]
    if lat:
        first, second = lat[: len(lat) // 2] or lat, lat[len(lat) // 2:]
        print(f"endpoint: {len(done)} requests sent in the window, latency from due to answer "
              f"median {percentile(lat, 50):.3f} s (the first half sent "
              f"{percentile(first, 50):.3f}, the second {percentile(second, 50):.3f}), "
              f"max {max(lat):.3f} s", file=sys.stderr)
        # A wave's answers leave together: answer times more than 50 ms apart
        # start a new wave.  The tail rests on a few requests, so print them.
        ends = sorted(r.answered for r in done if r.answered is not None)
        waves = sum(1 for a, b in zip([None] + ends, ends) if a is None or b - a > 0.05)
        print(f"endpoint: {waves} waves answered; the 8 longest latencies (s): "
              + " ".join(f"{x:.3f}" for x in sorted(lat)[-8:]), file=sys.stderr)
    return dict(
        setup_s=start_at - ctx.t_process,
        window=(start_at, t_end),
        requests=done,
        calls=calls,
        memory_peak_bytes=int(peak),
        end_to_end=dict(latency_p95_ms=1e3 * percentile(lat, 95) if lat else None),
    )
