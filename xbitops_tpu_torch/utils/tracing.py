"""Spans of the serving path's boundaries: requests, waves, admissions and
decode bursts, stamped on the host's monotonic clock.

    from xbitops_tpu_torch.utils import tracing

    with tracing.span("engine.wait") as s:
        ...                      # s.seconds once the block has left
    tracing.record("endpoint.request", start_ns, end_ns, request=7)
    tracing.spans()              # a snapshot, oldest first

Every span holds its name, its start and end (``time.monotonic_ns``), its
own id, its parent's id (the innermost span open on the same thread when it
opened, kept on a per-thread stack), the request it serves where it serves
one, the thread it ran on and a few attributes.  Spans go into one bounded
ring of the process (``MAXLEN``): the oldest drop out first.

Spans mark the engine's and the endpoint's phases only, about ten a decode
burst, never code that a CUDA graph captures (a span there would record once
at capture and never at a replay).  Off the profiler a span costs two clock
reads, a stack push and pop and a ring append.  While ``torch.profiler``
records on the span's thread, a span opened with ``mirror=True`` also opens
``torch.profiler.record_function`` of its name, so that the profiler's
timeline names that stretch of host time.  Only spans that enqueue no device
work are mirrored: with CUDA activity on, the profiler may report a range
around kernel launches as a device event of its own.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional

import torch

__all__ = ["MAXLEN", "Span", "record", "span", "spans"]

MAXLEN = 65536  # tens of minutes of serving at tens of spans a second

_ring: deque = deque(maxlen=MAXLEN)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiling() -> bool:
    """Whether ``torch.profiler`` records on this thread (the global flag is
    a Python attribute, read first since it is nearly always False)."""
    return (torch.autograd.profiler._is_profiler_enabled
            and torch._C._autograd._profiler_enabled())


class Span:
    """One span; a context manager that stamps its ends (:func:`span`)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request", "thread", "attrs",
                 "_mirror")

    def __init__(self, name: str, request: Optional[int], attrs: dict, mirror: bool = False):
        self.name = name
        self.request = request
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self._mirror = mirror

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if self._mirror and _profiling():
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        else:
            self._mirror = None
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.monotonic_ns()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
            self._mirror = None
        _stack().pop()
        _ring.append(self)


def span(name: str, request: Optional[int] = None, mirror: bool = False, **attrs) -> Span:
    """A span to open with ``with``; ``mirror=True`` for host-only work
    (module docstring)."""
    return Span(name, request, attrs, mirror)


def record(name: str, start_ns: int, end_ns: int, request: Optional[int] = None,
           parent: Optional[int] = None, **attrs) -> Span:
    """Record a span whose ends were stamped apart (on other threads, or
    across phases).  Its parent is ``parent``, else the innermost span open
    on this thread."""
    s = Span(name, request, attrs)
    if parent is None:
        stack = _stack()
        parent = stack[-1].id if stack else None
    s.parent, s.start_ns, s.end_ns = parent, start_ns, end_ns
    _ring.append(s)
    return s


def spans() -> List[Span]:
    """The spans in the ring, oldest first (a copy: recording goes on)."""
    return list(_ring)
