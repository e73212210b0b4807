"""Per-layer metrics: one module a metric, named as in BENCHMARK.json, whose
``read(records)`` gives its value or None where it finds nothing to read."""
