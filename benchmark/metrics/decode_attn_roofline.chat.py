"""``decode_attn_roofline`` in the cells served below capacity, where it moves the tail,
``latency_p95_ms``: the same reading as ``decode_attn_roofline.py``."""

from benchmark.metrics.decode_attn_roofline import LAYER, UNIT, read  # noqa: F401

MOVES = "latency_p95_ms"
