"""The program's spans (``xbitops_tpu_torch.utils.tracing``) that the
endpoint's metrics and ``decode_host_ms`` read.

A request's latency has three parts: its wait for a wave to take it up (the
``endpoint.request`` span's start to its ``engine.request`` span's start: the
endpoint's gathering and the waves before it), its own service (the
``engine.request`` span, admission forward to last token), and its hold (the
``engine.request`` span's end to the ``endpoint.request`` span's end: the
endpoint wakes a wave's waiters only when its longest request is done).

Only requests whose ``endpoint.request`` opened inside the window and was
answered before the traced slice opened are taken (about 40 at 15 s into a
chat run): the profiler's stop stalls the endpoint's worker for tens of
seconds, which would swamp every wait that follows it.  Below
``MIN_REQUESTS`` such requests, or without a traced slice, or where the
program records no spans, there is nothing to read.  The sample is the
window's first part, which waits less than its second (the window starts
with the endpoint idle), so both endpoint metrics read low against the
requests that set ``latency_p95_ms``.  ``dispatches`` cuts the decode bursts
at the same point, for ``slot_occupancy.chat``: the backlog that builds up
during the stall is served in fuller waves than the cell's own traffic.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

MIN_REQUESTS = 10


def _spans() -> Optional[list]:
    try:
        from xbitops_tpu_torch.utils import tracing
    except ImportError:  # a program without spans
        return None
    return tracing.spans()


def request_pairs(rec) -> Optional[List[Tuple[object, object]]]:
    """``(endpoint.request, engine.request)`` span pairs of the requests
    answered inside the window and before the slice, or None."""
    spans = _spans() if rec.trace is not None else None
    if spans is None:
        return None
    w0, w1 = (int(t * 1e9) for t in rec.window)
    cut = int(rec.trace.span[0] * 1e9)
    engine = {s.request: s for s in spans if s.name == "engine.request"}
    pairs = []
    for s in spans:
        if s.name == "endpoint.request" and w0 <= s.start_ns <= w1 and s.end_ns < cut:
            e = engine.get(s.request)
            if e is not None and s.start_ns <= e.start_ns:
                pairs.append((s, e))
    return pairs if len(pairs) >= MIN_REQUESTS else None


def dispatches(rec) -> Optional[list]:
    """The ``engine.dispatch`` and ``engine.spec`` spans (decode bursts and
    speculative steps) that started inside the window and before the traced
    slice, or None."""
    spans = _spans() if rec.trace is not None else None
    if spans is None:
        return None
    w0 = int(rec.window[0] * 1e9)
    cut = int(rec.trace.span[0] * 1e9)
    got = [s for s in spans if s.name in ("engine.dispatch", "engine.spec")
           and w0 <= s.start_ns < cut and "steps" in s.attrs]
    return got or None


def profiler_stalls_s(rec) -> float:
    """Seconds of the ``engine.accept`` spans inside which the traced slice
    opened or closed.  A ``generate`` cell starts and stops the profiler in
    ``on_token``, which the engine calls while it takes a burst's tokens in,
    and the profiler's start and stop stall the host for seconds: the
    harness's time, not the program's."""
    spans = _spans() if rec.trace is not None else None
    if spans is None:
        return 0.0
    ends = [int(t * 1e9) for t in rec.trace.span]
    return sum(s.seconds for s in spans if s.name == "engine.accept"
               and any(s.start_ns <= t <= s.end_ns for t in ends))
