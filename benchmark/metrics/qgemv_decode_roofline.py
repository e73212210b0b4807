"""qgemv_decode_roofline (fused matmul, few-rows form, %, moves
tokens_per_s): the least time of the slice's few-rows launches over their
device time (``qgemv_word_kernel``, ``qgemv_planes_kernel``).

Least time: each launch reads its packed weight, scales and zeros once, over
the card's memory rate.  A decode step launches the form once a projection
(every expert: at 16 rows a MoE layer's top-2 routes reach nearly all of
them), so the slice's steps, counted by the decode-attention launches (one a
layer a step), stream ``_counts.step_weight_bytes`` each; launches beyond
the steps' are admissions' lm_head products (at most 16 logits rows), which
read the lm_head."""

from benchmark.metrics import _counts

LAYER, UNIT, MOVES = "fused matmul", "%", "tokens_per_s"
FORMS = ("qgemv_word_kernel", "qgemv_planes_kernel")


def read(rec):
    tr = rec.trace
    if tr is None or rec.peaks is None:
        return None
    s = rec.shape
    seconds = sum(tr.seconds(f) for f in FORMS)
    launches = sum(tr.count(f) for f in FORMS)
    steps = tr.count("decode_attention_kernel") // s.layers
    if seconds <= 0 or not steps:
        return None
    extra = max(0, launches - steps * _counts.step_launches(s))
    bytes_ = (steps * _counts.step_weight_bytes(s)
              + extra * _counts.packed_bytes(s, s.hidden, s.vocab))
    return 100.0 * bytes_ / rec.peaks["hbm_bytes_per_s"] / seconds
