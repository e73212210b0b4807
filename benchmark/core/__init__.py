"""The benchmark's own code: cells, traffic, weights, traces and the check."""
