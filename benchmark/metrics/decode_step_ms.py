"""decode_step_ms (engine, ms, moves tpot_p95_ms): the engine's own host
time of its decode bursts over their steps (``Engine.loop_stats``:
``decode`` over ``decode_steps``, graph capture kept out), summed over the
window's ``generate`` calls.  The profiler starts and stops in ``on_token``,
outside the timed part of the loop; the kernels it traces run a little
slower inside the slice."""

LAYER, UNIT, MOVES = "engine", "ms", "tpot_p95_ms"


def read(rec):
    steps = sum(c.get("decode_steps", 0.0) for c in rec.calls)
    if not steps:
        return None
    return 1e3 * sum(c.get("decode", 0.0) for c in rec.calls) / steps
