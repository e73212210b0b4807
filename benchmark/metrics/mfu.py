"""mfu (model step, %, moves tokens_per_s): the model operations of the work
in the traced slice over the slice's length times the card's dense bf16 peak.

The work is each admission whose first token the slice reads back and each
decode step that serves a token in it (``_counts.admission_flops``,
``decode_flops``: 2 K N of each projection a token goes through, top-k
experts only, 4 H D a row attended, the lm_head where logits are taken),
counted from the benchmark's own request records.  Slots without a request
compute too and count nothing.  The slice, and not the whole window, since
starting and stopping the profiler stalls the host for seconds."""

from benchmark.metrics import _counts

LAYER, UNIT, MOVES = "model step", "%", "tokens_per_s"


def read(rec):
    tr = rec.trace
    if tr is None or rec.peaks is None or tr.window_s <= 0:
        return None
    s = rec.shape
    flops = sum(_counts.admission_flops(s, len(r.prompt)) if i == 0
                else _counts.decode_flops(s, len(r.prompt), i) for r, i in rec.traced_tokens())
    if not flops:
        return None
    return 100.0 * flops / (tr.window_s * rec.peaks["bf16_flops_per_s"])
