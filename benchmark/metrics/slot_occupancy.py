"""slot_occupancy (engine, %, moves tokens_per_s): the share of the engine's
slots that held a request in its decode bursts, over the window's
``generate`` calls: ``Engine.loop_stats["decode_slot_steps"]`` (each
dispatched burst's active slots times its steps) over ``decode_steps`` times
the cell's ``engine.slots``.  None where the program does not count it."""

LAYER, UNIT, MOVES = "engine", "%", "tokens_per_s"


def read(rec):
    calls = [c for c in rec.calls if "decode_slot_steps" in c]
    steps = sum(c.get("decode_steps", 0.0) for c in calls)
    slots = rec.workload.get("engine", {}).get("slots")
    if not steps or not slots:
        return None
    return 100.0 * sum(c["decode_slot_steps"] for c in calls) / (steps * slots)
