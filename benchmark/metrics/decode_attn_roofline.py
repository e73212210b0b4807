"""decode_attn_roofline (decode attention, %, moves tokens_per_s): the bytes
the slice's decode steps need over the card's memory rate, divided by the
``decode_attention_kernel`` device time.

Bytes: for each token a decode step served in the slice, the int8 rows and
scales of its context (capped at the sliding window) and the new row it
writes, over the layers (``_counts.decode_attn_bytes``).  Slots without a
request compute too and need nothing."""

from benchmark.metrics import _counts

LAYER, UNIT, MOVES = "decode attention", "%", "tokens_per_s"


def read(rec):
    tr = rec.trace
    if tr is None or rec.peaks is None:
        return None
    seconds = tr.seconds("decode_attention_kernel")
    s = rec.shape
    need = sum(_counts.decode_attn_bytes(s, len(r.prompt), i)
               for r, i in rec.traced_tokens() if i >= 1)
    if seconds <= 0 or not need:
        return None
    return 100.0 * need / rec.peaks["hbm_bytes_per_s"] / seconds
