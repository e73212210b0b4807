"""The span recorder (``utils/tracing.py``) and the spans of the port's engine
and endpoint, on the tiny port model (no JAX reference): parents on each
thread's own stack, the ring's bound, ``loop_stats`` summed from the spans,
the request ids that tie an endpoint request to its engine request, and the
mirrored spans on the profiler's clock."""

import json
import threading
import time
import urllib.request

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.engine.server import ServingEndpoint
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils import tracing

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CFG = llama.LlamaConfig.tiny()
KW = dict(slots=2, decode_burst=2, prefill_buckets=[8])


@pytest.fixture(scope="module")
def model():
    return llama.init_params(torch.Generator().manual_seed(0), CFG, bits=4, group_size=32)


def mark() -> int:
    """An id below every span made after this call (ids only grow)."""
    return tracing.span("mark").id


def since(m: int):
    return [s for s in tracing.spans() if s.id > m]


def total(spans, name: str) -> float:
    return sum(s.seconds for s in spans if s.name == name)


def test_spans_nest_on_each_threads_own_stack():
    m = mark()
    both = threading.Barrier(2)

    def work(tag):
        with tracing.span("outer", tag=tag):
            both.wait(timeout=10)  # both threads hold a span open at once
            with tracing.span("inner", request=7, tag=tag):
                both.wait(timeout=10)
            tracing.record("recorded", 1, 2, tag=tag)

    threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by = {(s.name, s.attrs["tag"]): s for s in since(m)}
    for tag in "ab":
        outer, inner, rec = by["outer", tag], by["inner", tag], by["recorded", tag]
        assert outer.parent is None and inner.parent == rec.parent == outer.id
        assert outer.thread == inner.thread == rec.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
        assert inner.request == 7 and (rec.start_ns, rec.end_ns) == (1, 2)
    assert by["outer", "a"].thread != by["outer", "b"].thread
    with tracing.span("outer") as outer:
        assert tracing.record("given", 0, 1, parent=5).parent == 5
    assert since(outer.id)[0].parent == 5 and outer.parent is None


def test_ring_drops_the_oldest_spans():
    first = tracing.record("first", 0, 1)
    for _ in range(tracing.MAXLEN - 1):
        tracing.record("fill", 0, 1)
    got = tracing.spans()
    assert len(got) == tracing.MAXLEN and got[0] is first
    tracing.record("fill", 0, 1)
    got = tracing.spans()
    assert len(got) == tracing.MAXLEN and got[0] is not first and got[0].name == "fill"


def test_engine_spans_and_the_loop_stats_they_sum(model):
    eng = Engine(model, CFG, **KW)
    m = mark()
    done = eng.generate([Request(prompt=[5, 9, 2], max_new_tokens=3),
                         Request(prompt=[3, 1], max_new_tokens=5),
                         Request(prompt=[7, 7, 1], max_new_tokens=4)])
    got = since(m)
    (gen,) = [s for s in got if s.name == "engine.generate"]
    reqs = {s.request: s for s in got if s.name == "engine.request"}
    assert len(reqs) == 3 and sorted(reqs) == [c.id for c in done]
    assert all(s.parent == gen.id for s in reqs.values())
    first, second, third = (reqs[c.id] for c in done)
    # two slots: the third request is admitted once one of the first two ends
    assert third.start_ns >= min(first.end_ns, second.end_ns)
    assert first.start_ns == second.start_ns < third.start_ns

    lt = eng.loop_stats
    dispatch, wait = total(got, "engine.dispatch"), total(got, "engine.wait")
    assert lt["decode"] == pytest.approx(dispatch - total(got, "engine.capture") + wait, rel=1e-9)
    assert lt["decode_wait"] == pytest.approx(wait, rel=1e-9)
    assert lt["decode_accept"] == pytest.approx(total(got, "engine.accept"), rel=1e-9)
    assert lt["admit_prefill"] == pytest.approx(total(got, "engine.admit"), rel=1e-9)
    assert lt["decode_tokens"] <= lt["decode_slot_steps"] <= lt["decode_steps"] * eng.slots
    bursts = [s for s in got if s.name == "engine.dispatch"]
    assert len(bursts) * KW["decode_burst"] == lt["decode_steps"]
    assert all(s.attrs["steps"] == KW["decode_burst"] for s in bursts)
    assert lt["decode_slot_steps"] == sum(s.attrs["slots"] * s.attrs["steps"] for s in bursts)
    assert all(s.parent == gen.id for s in got if s.name in ("engine.dispatch", "engine.wait",
                                                              "engine.accept", "engine.admit"))


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_endpoint_spans_carry_the_engines_request_ids(model):
    ep = ServingEndpoint(Engine(model, CFG, **KW), port=0, batch_window_s=0.05)
    ep.start()
    m = mark()
    answers = []
    try:
        clients = [threading.Thread(target=lambda p=p: answers.append(
            _post(ep.port, {"prompt": p, "max_tokens": 3}))) for p in ([5, 9], [3, 1, 4], [2])]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients) and len(answers) == 3
    finally:
        ep.shutdown()  # joins the worker: every wave's span is in the ring
    got = since(m)
    outer = {s.request: s for s in got if s.name == "endpoint.request"}
    inner = {s.request: s for s in got if s.name == "engine.request"}
    assert sorted(outer) == sorted(inner) == sorted(int(a["id"].split("-")[1]) for a in answers)
    for rid, s in outer.items():
        # queue wait, service and hold: each part of the latency is >= 0
        assert s.start_ns <= inner[rid].start_ns <= inner[rid].end_ns <= s.end_ns
    waves = {s.id: s for s in got if s.name == "endpoint.wave"}
    gens = [s for s in got if s.name == "engine.generate"]
    assert sorted(g.parent for g in gens) == sorted(waves)
    assert sum(w.attrs["requests"] for w in waves.values()) == 3
    assert sorted(s.parent for s in got if s.name == "endpoint.gather") == sorted(waves)


def test_mirrored_spans_on_the_profilers_clock():
    x = torch.ones(64, 64)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    offset = time.time() - time.monotonic()  # benchmark/core/trace.py's conversion
    with tracing.span("test.mirrored", mirror=True) as mirrored:
        torch.mm(x, x)
    with tracing.span("test.plain") as plain:
        torch.mm(x, x)
    # the profiler records on the thread that started it only
    other = threading.Thread(target=lambda: tracing.span("test.other", mirror=True).__enter__())
    other.start()
    other.join(timeout=10)
    with tracing.span("test.stopped_inside", mirror=True):
        prof.stop()  # a mirrored span may outlive the profiler
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "test.mirrored" in names
    assert not {"test.plain", "test.other"} & set(names)
    mm = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"),
                key=lambda e: e.start_ns())
    assert len(mm) == 2
    for ev, s in zip(mm, (mirrored, plain)):
        t = ev.start_ns() * 1e-9 - offset
        assert s.start_ns * 1e-9 - 2e-3 <= t <= s.end_ns * 1e-9 + 2e-3
    with tracing.span("test.off", mirror=True) as off:
        pass
    assert off._mirror is None  # no profiler: nothing mirrored
