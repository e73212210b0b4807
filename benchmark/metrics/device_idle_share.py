"""device_idle_share (device, %, moves tokens_per_s): the share of the traced
slice in which no kernel, copy or memset ran on the card (the union of the
device events' intervals, from the profiler's trace)."""

LAYER, UNIT, MOVES = "device", "%", "tokens_per_s"


def read(rec):
    tr = rec.trace
    if tr is None or not tr.n_device_events or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
