"""``device_idle_share`` in the cells served below capacity, where it moves the tail,
``latency_p95_ms``: the same reading as ``device_idle_share.py``."""

from benchmark.metrics.device_idle_share import LAYER, UNIT, read  # noqa: F401

MOVES = "latency_p95_ms"
