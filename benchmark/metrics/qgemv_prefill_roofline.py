"""qgemv_prefill_roofline (fused matmul, tensor-core tile, %, moves
latency_p95_ms): the least time of the prompts admitted in the traced slice
over the tile's device time there (``qgemv_mma_kernel`` and its split-K sums,
``add_splits_kernel``).

Least time: 2 K N of each projection on the true prompt rows (no bucket or
chunk padding; for a MoE layer the top-k experts of a row only, where the
engine's no-drop admission runs every expert on every row), over the card's
dense bf16 rate.  A prompt is in the slice when its first token, which its
admission reads back, is."""

from benchmark.metrics import _counts

LAYER, UNIT, MOVES = "fused matmul", "%", "latency_p95_ms"


def read(rec):
    tr = rec.trace
    if tr is None or rec.peaks is None:
        return None
    seconds = tr.seconds("qgemv_mma_kernel") + tr.seconds("add_splits_kernel")
    rows = sum(len(r.prompt) for r, i in rec.traced_tokens() if i == 0)
    if seconds <= 0 or not rows:
        return None
    flops = rows * _counts.tile_flops(rec.shape)
    return 100.0 * flops / rec.peaks["bf16_flops_per_s"] / seconds
