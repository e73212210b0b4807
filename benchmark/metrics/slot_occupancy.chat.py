"""``slot_occupancy`` in the cells served below capacity, where it moves the
tail, ``latency_p95_ms``: the share of the engine's slots that held a
request in the decode bursts (and speculative steps) dispatched inside the
window and before the traced slice opened, from the program's
``engine.dispatch`` spans (their ``slots`` times their ``steps``, over the
steps times the cell's ``engine.slots``).  Not from ``Engine.loop_stats``
over the window's calls, as ``slot_occupancy.py`` reads: the profiler's stop
stalls the endpoint's worker, and the backlog that builds up meanwhile is
served in waves fuller than the cell's own traffic makes
(``_spans.dispatches``).  None without a trace, or where the program records
no such spans."""

from benchmark.metrics import _spans

LAYER, UNIT, MOVES = "engine", "%", "latency_p95_ms"


def read(rec):
    bursts = _spans.dispatches(rec)
    slots = rec.workload.get("engine", {}).get("slots")
    if bursts is None or not slots:
        return None
    steps = sum(s.attrs["steps"] for s in bursts)
    return 100.0 * sum(s.attrs["slots"] * s.attrs["steps"] for s in bursts) / (steps * slots)
