"""expert_decode_roofline (fused matmul, few-rows form, %, moves
tokens_per_s): the least time for the bytes the slice's decode steps need,
over the few-rows form's device time in the slice.

A step needs the packed weight, scales and zeros (``_counts.packed_bytes``)
of every layer's dense projections (q|k|v, wo), of each expert that a live
route reached, and of the lm_head, over the card's memory rate.  The share of
experts reached is the window's calls' ``moe_experts_hit`` over
``moe_layer_forwards`` x E (``Engine.loop_stats``, counted on the device by
``models/moe.py``).  Steps, and the admissions' lm_head launches beyond
them, are counted as ``qgemv_decode_roofline`` counts them.  A launch over
an expert that no route reached adds time and no bytes; skipping it raises
this share.  None without the route counters, the trace or the card's peaks,
and for a dense model."""

from benchmark.metrics import _counts
from benchmark.metrics.qgemv_decode_roofline import FORMS

LAYER, UNIT, MOVES = "fused matmul", "%", "tokens_per_s"


def read(rec):
    tr, s = rec.trace, rec.shape
    forwards = sum(c.get("moe_layer_forwards", 0.0) for c in rec.calls)
    if tr is None or rec.peaks is None or not s.experts or not forwards:
        return None
    seconds = sum(tr.seconds(f) for f in FORMS)
    launches = sum(tr.count(f) for f in FORMS)
    steps = tr.count("decode_attention_kernel") // s.layers
    if seconds <= 0 or not steps:
        return None
    reached = sum(c.get("moe_experts_hit", 0.0) for c in rec.calls) / (forwards * s.experts)
    proj = _counts.projections(s)
    dense = sum(_counts.packed_bytes(s, K, N) for K, N, c in proj if c == 1)
    expert = sum(_counts.packed_bytes(s, K, N) for K, N, c in proj if c > 1)
    head = _counts.packed_bytes(s, s.hidden, s.vocab)
    step = s.layers * (dense + reached * s.experts * expert) + head
    extra = max(0, launches - steps * _counts.step_launches(s))
    return 100.0 * (steps * step + extra * head) / rec.peaks["hbm_bytes_per_s"] / seconds
