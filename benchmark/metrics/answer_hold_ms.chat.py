"""answer_hold_ms.chat (endpoint, ms, moves latency_p95_ms): the median over
requests of the hold from a request's last token in the engine to its
waiter's wake-up in the endpoint, which answers a wave's requests only when
its longest one is done (the program's ``engine.request`` and
``endpoint.request`` spans).

It samples only the requests sent inside the window and answered before the
traced slice opened (about 40 at 15 s), since the profiler's stop stalls the
endpoint's worker; None below 10 such requests or without a trace
(``_spans.py``).  That sample is the window's first part, which starts with
the endpoint idle and waits less than the second: the reading is low against
the requests that set the tail."""

from benchmark.core.stats import percentile
from benchmark.metrics import _spans

LAYER, UNIT, MOVES = "endpoint", "ms", "latency_p95_ms"


def read(rec):
    pairs = _spans.request_pairs(rec)
    if pairs is None:
        return None
    return 1e-6 * percentile([s.end_ns - e.end_ns for s, e in pairs], 50)
