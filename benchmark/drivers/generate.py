"""A cell driven through ``Engine.generate`` with ``on_token``, as offline
batch generation calls it: the traffic's blocks, one call a block, back to
back; no call starts after ``--seconds``.

The window runs from the start of the first call to the end of the last;
``tokens_per_s`` is every served token over it, ``tpot_p95_ms`` the 95th
percentile over requests of (last token's time - first token's) / (tokens -
1), each token timed when it reaches the host.  In a ``--trace 1`` run the
profiler starts at the first token read back ``trace.after`` of the way into
the window and stops at the first one ``trace.seconds`` later, so the slice
holds whole bursts and admissions.
"""

from __future__ import annotations

import time
from typing import Dict

from benchmark.core import program, traffic
from benchmark.core.records import Request
from benchmark.core.stats import percentile


def run(ctx) -> Dict:
    import torch
    from xbitops_tpu_torch.engine.engine import Request as EngineRequest

    wl, cfg = ctx.wl, ctx.cfg
    reqs = traffic.requests(wl["traffic"], ctx.seed, cfg["vocab_size"])
    block = wl["traffic"]["block"]
    engine = program.build_engine(cfg, ctx.seed, ctx.device, wl["engine"])
    for r in traffic.warmup(wl["traffic"], engine.buckets, engine.prefill_chunk,
                            cfg["vocab_size"]):
        engine.generate([EngineRequest(r.prompt, r.max_tokens, r.temperature)])

    tracer = ctx.tracer
    times: Dict[int, list] = {}
    calls, sent, served = [], {}, {}
    t0 = time.monotonic()
    trace_from = t0 + wl["trace"]["after"] * ctx.seconds if tracer is not None else None

    def on_token(rid: int, tok: int) -> None:
        t = time.monotonic()
        times.setdefault(rid, []).append(t)
        if tracer is None:
            return
        if not tracer.started and t >= trace_from:
            tracer.start()
        elif tracer.running and t >= tracer.span_start + wl["trace"]["seconds"]:
            tracer.stop()

    t_end = t0
    for b0 in range(0, len(reqs), block):
        if time.monotonic() >= t0 + ctx.seconds:
            break
        batch = reqs[b0 : b0 + block]
        c0 = time.monotonic()
        for r in batch:
            sent[r.index] = c0
        outs = engine.generate([EngineRequest(r.prompt, r.max_tokens, r.temperature, id=r.index)
                                for r in batch], on_token=on_token)
        served.update((c.id, c.tokens) for c in outs)
        t_end = time.monotonic()
        calls.append(program.loop_stats(engine))
    if tracer is not None and tracer.running:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(ctx.device) if torch.cuda.is_available() else 0
    del engine
    program.release()

    done, tpot = [], []
    for r in reqs[: len(sent)]:
        ts = times.get(r.index, [])
        done.append(Request(r.index, r.prompt, r.max_tokens, r.greedy, sent[r.index],
                            ts[-1] if r.index in served else None, served.get(r.index, []), ts))
        if len(ts) >= 2:
            tpot.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return dict(
        setup_s=t0 - ctx.t_process,
        window=(t0, t_end),
        requests=done,
        calls=calls,
        memory_peak_bytes=int(peak),
        end_to_end=dict(tokens_per_s=sum(map(len, served.values())) / max(t_end - t0, 1e-9),
                        tpot_p95_ms=1e3 * percentile(tpot, 95) if tpot else None),
    )
