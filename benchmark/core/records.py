"""What a run hands its per-layer metrics: its requests, the engine's
statistics of each call in the window, the traced slice, the configuration
and the card's peaks.  Times are ``time.monotonic`` seconds."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.core import synth
from benchmark.core.trace import Trace

# Tokens read back closer together than this belong to one unit of device
# work: one decode burst, or one admission.
CHAIN_GAP_S = 2e-3


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_tokens: int
    greedy: bool
    sent: float
    answered: Optional[float]  # None: never answered
    tokens: List[int]
    token_times: Optional[List[float]] = None  # host time each token reached the host


@dataclass
class Records:
    cfg: Dict
    workload: Dict
    window: Tuple[float, float]
    requests: List[Request]
    calls: List[Dict[str, float]] = field(default_factory=list)  # loop_stats a call
    trace: Optional[Trace] = None
    peaks: Optional[Dict[str, float]] = None

    @property
    def shape(self) -> synth.Shape:
        return synth.Shape.of(self.cfg)

    def traced_tokens(self) -> List[Tuple[Request, int]]:
        """(request, token index) of every token whose device work lies in
        the traced slice: the tokens of each chain (one burst's or one
        admission's read-back) that begins inside the slice."""
        if self.trace is None:
            return []
        t0, t1 = self.trace.span
        stamped = sorted((t, id(r), i, r) for r in self.requests if r.token_times
                         for i, t in enumerate(r.token_times))
        out, chain_in, last = [], False, None
        for t, _, i, r in stamped:
            if last is None or t - last > CHAIN_GAP_S:
                chain_in = t0 < t <= t1
            last = t
            if chain_in:
                out.append((r, i))
        return out
