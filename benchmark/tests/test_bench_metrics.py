"""The per-layer metrics and the statistics on hand-made records, against
counts worked out by hand."""

from __future__ import annotations

import importlib
import json
import numpy as np
import pytest

from benchmark.core import synth
from benchmark.core.records import Records, Request
from benchmark.core.stats import percentile
from benchmark.core.trace import Trace, _label_gaps, breakdown
from benchmark.metrics import _counts
from conftest import DATA

PEAKS = dict(bf16_flops_per_s=1e12, hbm_bytes_per_s=1e9)


def cfg(name="tiny-llama"):
    return json.loads((DATA / f"{name}.json").read_text())


def metric(name):
    return importlib.import_module(f"benchmark.metrics.{name}").read


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys(q):
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3]
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_counts_by_hand():
    s = synth.Shape.of(cfg())  # h 256, ffn 512, 2 layers, 4 / 2 heads of 128, vocab 512
    assert _counts.packed_bytes(s, 256, 1024) == 256 * 1024 // 2 + 4 * 2 * 1024
    per_layer = (_counts.packed_bytes(s, 256, 1024) + _counts.packed_bytes(s, 512, 256)
                 + _counts.packed_bytes(s, 256, 1024) + _counts.packed_bytes(s, 512, 256))
    assert _counts.step_weight_bytes(s) == 2 * per_layer + _counts.packed_bytes(s, 256, 512)
    assert _counts.step_launches(s) == 2 * 4 + 1
    proj = 2 * (2 * 256 * 1024 + 2 * 512 * 256 + 2 * 256 * 1024 + 2 * 512 * 256)
    assert _counts.token_proj_flops(s) == proj
    assert _counts.tile_flops(s) == proj
    # window 48: a query at position 99 attends 48 rows
    assert _counts.attn_flops(s, 100) == 2 * 4 * 4 * 128 * 48
    assert _counts.attn_flops(s, 10) == 2 * 4 * 4 * 128 * 10
    lm = 2 * 256 * 512
    want = (3 * proj + sum(2 * 4 * 4 * 128 * (p + 1) for p in range(3))
            + 2 * lm + proj + 2 * 4 * 4 * 128 * 4)
    assert _counts.request_flops(s, 3, 2) == want
    assert _counts.kv_row_bytes(s) == 2 * 2 * (128 + 2)
    assert _counts.decode_attn_bytes(s, 60, 5) == 2 * 48 * 2 * 2 * 130


def test_moe_counts_take_top_k_and_the_router():
    s = synth.Shape.of(cfg("tiny-moe"))  # 4 experts, top-2
    expert = 2 * 256 * 1024 + 2 * 512 * 256
    attn = 2 * 256 * 1024 + 2 * 512 * 256
    assert _counts.token_proj_flops(s) == 2 * (attn + 2 * expert + 2 * 256 * 4)
    assert _counts.tile_flops(s) == 2 * (attn + 2 * expert)
    assert _counts.step_launches(s) == 2 * (2 + 4 + 4) + 1


def records(trace=None, calls=(), window=(0.0, 10.0), reqs=None):
    reqs = reqs or [Request(0, [1] * 3, 2, True, 0.0, 5.0, [7, 8], [1.0, 1.0005]),
                    Request(1, [1] * 5, 3, True, 0.0, 6.0, [7, 8, 9], [1.0002, 2.0, 3.0])]
    return Records(cfg(), {}, window, reqs, list(calls), trace, PEAKS)


def test_mfu_over_the_traced_slice():
    s = synth.Shape.of(cfg())
    tr = Trace(span=(0.9, 2.5))  # request 0: tokens 0, 1; request 1: tokens 0, 1
    flops = (_counts.admission_flops(s, 3) + _counts.decode_flops(s, 3, 1)
             + _counts.admission_flops(s, 5) + _counts.decode_flops(s, 5, 1))
    assert metric("mfu")(records(tr)) == pytest.approx(100 * flops / (1.6 * 1e12))
    assert _counts.request_flops(s, 5, 3) == (_counts.admission_flops(s, 5)
                                              + _counts.decode_flops(s, 5, 1)
                                              + _counts.decode_flops(s, 5, 2))


def test_traced_tokens_take_whole_chains():
    # chain (1.0, 1.0002, 1.0005) begins inside (0.9, 2.5]; 2.0 inside; 3.0 after
    tr = Trace(span=(0.9, 2.5))
    got = sorted((r.index, i) for r, i in records(tr).traced_tokens())
    assert got == [(0, 0), (0, 1), (1, 0), (1, 1)]
    tr = Trace(span=(1.0001, 2.5))  # the chain began before the slice: left out
    assert sorted((r.index, i) for r, i in records(tr).traced_tokens()) == [(1, 1)]


def test_rooflines_by_hand():
    s = synth.Shape.of(cfg())
    steps, extra = 3, 2
    launches = steps * _counts.step_launches(s) + extra
    tr = Trace(span=(0.9, 2.5), kernels={
        "void (anonymous namespace)::qgemv_word_kernel<4, 2, false>(Args)": [launches, 0.004],
        "void (anonymous namespace)::decode_attention_kernel<128, 2, 3, false>(Args)":
            [steps * s.layers, 0.002],
        "void (anonymous namespace)::qgemv_mma_kernel<2, true>(Args)": [10, 0.003],
        "add_splits_kernel(float const*, int)": [2, 0.001],
    })
    rec = records(tr)
    want = (steps * _counts.step_weight_bytes(s) + extra * _counts.packed_bytes(s, 256, 512))
    assert metric("qgemv_decode_roofline")(rec) == pytest.approx(100 * want / 1e9 / 0.004)
    # prompts in the slice: both requests' first tokens (3 + 5 rows)
    assert metric("qgemv_prefill_roofline")(rec) == pytest.approx(
        100 * 8 * _counts.tile_flops(s) / 1e12 / 0.004)
    # decode tokens in the slice: request 0 token 1 (ctx 3 + 1), request 1 token 1 (5 + 1)
    need = _counts.decode_attn_bytes(s, 3, 1) + _counts.decode_attn_bytes(s, 5, 1)
    assert metric("decode_attn_roofline")(rec) == pytest.approx(100 * need / 1e9 / 0.002)


def test_idle_share_and_step_time():
    tr = Trace(span=(0.0, 2.0), busy_s=1.5, n_device_events=4)
    assert metric("device_idle_share")(records(tr)) == pytest.approx(25.0)
    calls = [dict(decode=1.0, decode_steps=100.0), dict(decode=3.0, decode_steps=200.0)]
    assert metric("decode_step_ms")(records(calls=calls)) == pytest.approx(1e3 * 4.0 / 300)


def test_metrics_find_nothing_without_a_trace_or_peaks():
    rec = records()
    for name in ("device_idle_share", "qgemv_decode_roofline", "qgemv_prefill_roofline",
                 "decode_attn_roofline", "decode_step_ms"):
        assert metric(name)(rec) is None
    rec.peaks = None
    assert metric("mfu")(rec) is None


def test_idle_gaps_labelled_by_the_innermost_host_event():
    lo = np.array([0.0, 1.0, 2.0, 3.0])
    hi = np.array([0.00001, 1.5, 2.5, 3.2])
    host = [(0.9, 3.0, "outer"), (1.1, 1.4, "inner"), (2.6, 3.3, "late")]
    got = _label_gaps(lo, hi, hi - lo, host)
    assert got["inner"] == pytest.approx(0.5)
    assert got["outer"] == pytest.approx(0.5)
    assert got["late"] == pytest.approx(0.2)
    assert got["gaps under 50 us"] == pytest.approx(0.00001)
    tr = Trace(span=(0, 1), kernels={"a": [1, 0.2], "b": [2, 0.5]}, idle_by_host=got)
    b = breakdown(tr)
    assert [n for n, _ in b["device_ops"]] == ["b", "a"]
    assert b["idle_gaps"][0][1] == pytest.approx(0.5)
