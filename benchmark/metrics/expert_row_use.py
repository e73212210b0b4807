"""expert_row_use (experts, %, moves tokens_per_s): the share of the rows the
experts' products run in decode steps that are routed rows, over the window's
``generate`` calls: ``Engine.loop_stats["moe_routes"]`` (the routes of live
rows, counted on the device by ``models/moe.py``) over ``moe_expert_rows``
(``E x C`` a MoE layer forward).  No-drop decode runs every expert on every
slot's row, so it reads k x (live rows) / (E x slots); running each expert on
its routed rows only raises it.  None where the program does not count
routes."""

LAYER, UNIT, MOVES = "experts", "%", "tokens_per_s"


def read(rec):
    rows = sum(c.get("moe_expert_rows", 0.0) for c in rec.calls)
    if not rows:
        return None
    return 100.0 * sum(c.get("moe_routes", 0.0) for c in rec.calls) / rows
