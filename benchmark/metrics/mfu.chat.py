"""``mfu`` in the cells served below capacity, where it moves the tail,
``latency_p95_ms``: the same reading as ``mfu.py``."""

from benchmark.metrics.mfu import LAYER, UNIT, read  # noqa: F401

MOVES = "latency_p95_ms"
