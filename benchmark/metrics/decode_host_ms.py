"""decode_host_ms (engine, ms, moves tpot_p95_ms): the host time a decode
step costs the engine's loop outside its wait on the device, over the
window's ``generate`` calls: ``Engine.loop_stats`` ``decode`` (a burst's
dispatch, capture left out, plus its wait) less ``decode_wait`` (the
``engine.wait`` spans) plus ``decode_accept`` (the ``engine.accept`` spans:
taking the tokens in, ``on_token`` included), over ``decode_steps``.  With
bursts dispatched one at a time (``pipeline=0``) the device waits through
most of it.  The two ``engine.accept`` spans inside which the harness
started and stopped its profiler are left out (``_spans.profiler_stalls_s``:
seconds each, against ~0.1 ms a burst).  None where the program does not
time the wait."""

from benchmark.metrics import _spans

LAYER, UNIT, MOVES = "engine", "ms", "tpot_p95_ms"


def read(rec):
    calls = [c for c in rec.calls if "decode_wait" in c]
    steps = sum(c.get("decode_steps", 0.0) for c in calls)
    if not steps:
        return None
    host = sum(c["decode"] - c["decode_wait"] + c.get("decode_accept", 0.0) for c in calls)
    return 1e3 * (host - _spans.profiler_stalls_s(rec)) / steps
