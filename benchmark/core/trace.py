"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over the CPU
and the device, started and stopped by the driver, read once the window has
closed.

Times are ``time.monotonic`` seconds, as the drivers' own records: the
profiler stamps events in wall-clock nanoseconds, and the offset between the
two clocks is read when the profiler starts.  Device events are kernels,
copies and memsets, graph replays included (CUPTI sees each launch of a
replayed graph).  Nothing is written to disk.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Idle gaps shorter than this are launch gaps and go under one label.
SHORT_GAP_S = 50e-6


@dataclass
class Trace:
    """What the slice holds: ``span`` (start, end), every device event's
    name, count and seconds, the device's busy seconds (union of the events'
    intervals within the span) and its idle seconds by what the host did."""

    span: Tuple[float, float]
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # name -> [count, seconds]
    busy_s: float = 0.0
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    n_device_events: int = 0

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def seconds(self, part: str) -> float:
        """Device seconds of the events whose name holds ``part``."""
        return sum(sec for name, (_, sec) in self.kernels.items() if part in name)

    def count(self, part: str) -> int:
        return int(sum(n for name, (n, _) in self.kernels.items() if part in name))


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`; :meth:`read` gives the
    :class:`Trace` (once, after the window)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.span: Optional[Tuple[float, float]] = None
        self.offset = 0.0
        self._t0 = None

    @property
    def started(self) -> bool:
        return self.prof is not None

    @property
    def span_start(self) -> float:
        return self._t0

    @property
    def running(self) -> bool:
        return self.prof is not None and self.span is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.offset = time.time() - time.monotonic()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.span = (self._t0, time.monotonic())
        self.prof.stop()

    def read(self) -> Optional[Trace]:
        if self.span is None:
            return None
        import torch

        cuda_type = torch.autograd.DeviceType.CUDA
        t0, t1 = self.span
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        starts, ends, host = [], [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9 - self.offset
            d = ev.duration_ns() * 1e-9
            if ev.device_type() == cuda_type:
                k = kernels[ev.name()]
                k[0] += 1
                k[1] += d
                starts.append(s)
                ends.append(s + d)
            elif d > 0:
                host.append((s, s + d, ev.name()))
        tr = Trace(span=(t0, t1), kernels=dict(kernels), n_device_events=len(starts))
        if not starts:
            return tr
        st, en = np.asarray(starts), np.asarray(ends)
        order = np.argsort(st)
        st, en = np.clip(st[order], t0, t1), np.clip(en[order], t0, t1)
        reach = np.maximum.accumulate(en)
        gap_lo = np.concatenate(([t0], reach))
        gap_hi = np.concatenate((st, [t1]))
        gaps = np.maximum(gap_hi - gap_lo, 0.0)
        tr.busy_s = float(t1 - t0 - gaps.sum())
        tr.idle_by_host = _label_gaps(gap_lo, gap_hi, gaps, host)
        return tr


def _label_gaps(lo, hi, gaps, host) -> Dict[str, float]:
    """Idle seconds by the host event that covers each gap's middle and began
    last (the innermost of nested ones; "no host op" where none does); gaps
    under ``SHORT_GAP_S`` together."""
    out: Dict[str, float] = defaultdict(float)
    short = gaps < SHORT_GAP_S
    out[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] = float(gaps[short].sum())
    host.sort()
    live: list = []  # heap of (-start, end, name): the latest start on top
    j = 0
    for i in sorted(np.nonzero(~short)[0], key=lambda i: lo[i] + hi[i]):
        mid = 0.5 * (lo[i] + hi[i])
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(live, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while live and live[0][1] < mid:  # ended before this middle: before every later one
            heapq.heappop(live)
        out[live[0][2] if live else "no host op"] += float(gaps[i])
    return dict(out)


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The ``breakdown`` of a result line: the device operations that took
    most time and the idle time by what the host did, ``[[name, s], ...]``."""
    ops = sorted(tr.kernels.items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[name[:120], s] for name, (_, s) in ops],
                idle_gaps=[[name[:120], s] for name, s in gaps if s > 0])
