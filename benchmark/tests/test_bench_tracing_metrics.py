"""The readers of the program's spans and counters (``queue_wait_ms.chat``,
``answer_hold_ms.chat``, ``slot_occupancy``, ``slot_occupancy.chat``,
``decode_host_ms``) on hand-made records, with spans put in through the
program's ``tracing.record``, against values worked out by hand."""

from __future__ import annotations

import pytest

from benchmark.core.cell import reader
from benchmark.core.records import Records
from benchmark.core.trace import Trace
from conftest import REPO
from xbitops_tpu_torch.utils import tracing

# far past any monotonic time of a real run: no other span of this process
# falls in these windows
T0 = 1e9
MS = 1_000_000


def metric(name):
    return reader(REPO, name).read


def put(rid, sent_s, wait_ms, service_ms, hold_ms):
    """A request's two spans: enqueued at ``sent_s``, admitted ``wait_ms``
    later, served for ``service_ms``, answered ``hold_ms`` after its last token."""
    s = int(sent_s * 1e9)
    e0 = s + wait_ms * MS
    e1 = e0 + service_ms * MS
    tracing.record("engine.request", e0, e1, request=rid)
    tracing.record("endpoint.request", s, e1 + hold_ms * MS, request=rid)


def records(t0, trace_at=20.0, calls=(), workload=None):
    return Records({}, workload or {}, (t0, t0 + 60.0), [], list(calls),
                   Trace(span=(t0 + trace_at, t0 + trace_at + 3.0)))


def test_endpoint_parts_take_the_requests_answered_before_the_slice():
    t0, rid = T0, 10**9
    for i in range(12):  # answered before the slice opens at 20 s
        put(rid + i, t0 + 0.5 * i, wait_ms=100 + 10 * i, service_ms=2000, hold_ms=300 + i)
    put(rid + 20, t0 + 15.0, wait_ms=30_000, service_ms=1000, hold_ms=9_000)  # after the slice
    put(rid + 21, t0 - 5.0, wait_ms=30_000, service_ms=1000, hold_ms=9_000)  # before the window
    rec = records(t0)
    # medians of 12: the mean of the 6th and 7th
    assert metric("queue_wait_ms.chat")(rec) == pytest.approx(155.0)
    assert metric("answer_hold_ms.chat")(rec) == pytest.approx(305.5)


def test_endpoint_parts_need_ten_requests_and_a_trace():
    t0, rid = T0 + 1000.0, 2 * 10**9
    for i in range(9):
        put(rid + i, t0 + i, wait_ms=100, service_ms=500, hold_ms=200)
    put(rid + 9, t0 + 9, wait_ms=100, service_ms=500, hold_ms=200)
    put(rid + 10, t0 + 19.5, wait_ms=100, service_ms=500, hold_ms=200)  # answered in the slice
    rec = records(t0)
    for name in ("queue_wait_ms.chat", "answer_hold_ms.chat"):
        assert metric(name)(records(t0, trace_at=9.5)) is None  # 9 answered before the slice
        assert metric(name)(rec) == pytest.approx(100.0 if "queue" in name else 200.0)
        rec_untraced = records(t0)
        rec_untraced.trace = None
        assert metric(name)(rec_untraced) is None


def test_occupancy_and_host_time_by_hand():
    calls = [dict(decode=1.0, decode_wait=0.6, decode_accept=0.1, decode_steps=100.0,
                  decode_slot_steps=800.0),
             dict(decode=2.0, decode_wait=1.5, decode_accept=0.2, decode_steps=200.0,
                  decode_slot_steps=1000.0)]
    rec = records(T0, calls=calls, workload={"engine": {"slots": 16}})
    assert metric("slot_occupancy")(rec) == pytest.approx(100.0 * 1800 / (300 * 16))
    assert metric("decode_host_ms")(rec) == pytest.approx(1e3 * (0.5 + 0.7) / 300)


def test_chat_occupancy_takes_the_bursts_dispatched_before_the_slice():
    t0 = T0 + 3000.0
    # the loop statistics of the window's calls hold the stalled backlog's full
    # waves too: the chat reader takes the spans before the slice instead
    calls = [dict(decode_steps=100.0, decode_slot_steps=1600.0)]
    rec = records(t0, calls=calls, workload={"engine": {"slots": 16}})
    for at, name, slots, steps in ((1.0, "engine.dispatch", 4, 8), (5.0, "engine.dispatch", 6, 8),
                                   (9.0, "engine.spec", 12, 1),
                                   (-1.0, "engine.dispatch", 16, 8),  # before the window
                                   (20.0, "engine.dispatch", 16, 8),  # as the slice opens
                                   (30.0, "engine.dispatch", 16, 8)):  # in the backlog
        s = int((t0 + at) * 1e9)
        tracing.record(name, s, s + 1000, slots=slots, steps=steps)
    assert metric("slot_occupancy.chat")(rec) == pytest.approx(
        100.0 * (4 * 8 + 6 * 8 + 12) / (17 * 16))
    untraced = records(t0, calls=calls, workload={"engine": {"slots": 16}})
    untraced.trace = None
    assert metric("slot_occupancy.chat")(untraced) is None
    assert metric("slot_occupancy.chat")(records(t0 + 500.0, calls=calls,
                                                 workload={"engine": {"slots": 16}})) is None


def test_host_time_leaves_out_the_profilers_start_and_stop():
    t0 = T0 + 2000.0
    calls = [dict(decode=1.0, decode_wait=0.6, decode_accept=5.2, decode_steps=100.0)]
    rec = records(t0, calls=calls)  # the slice opens at 20 s and closes at 23 s
    for at, seconds in ((19.0, 2.0), (22.5, 3.0), (10.0, 0.1)):  # the last holds neither
        s = int((t0 + at) * 1e9)
        tracing.record("engine.accept", s, s + int(seconds * 1e9))
    assert metric("decode_host_ms")(rec) == pytest.approx(1e3 * (0.4 + 5.2 - 5.0) / 100)


def test_counters_a_program_lacks_read_nothing():
    # a program without the counters: the loop statistics it had before them
    calls = [dict(decode=1.0, decode_steps=100.0)]
    rec = records(T0, calls=calls, workload={"engine": {"slots": 16}})
    for name in ("slot_occupancy", "slot_occupancy.chat", "decode_host_ms"):
        assert metric(name)(rec) is None
        assert metric(name)(records(T0, workload={"engine": {"slots": 16}})) is None
