"""Mixtral-8x7B's configuration and the readers of the MoE layer's route
counters (``expert_row_use``, ``expert_decode_roofline``), on hand-made
records against counts worked out by hand."""

from __future__ import annotations

import importlib
import json

import pytest

from benchmark.core import synth
from benchmark.core.records import Records
from benchmark.core.trace import Trace
from benchmark.metrics import _counts
from conftest import DATA, REPO

PEAKS = dict(bf16_flops_per_s=1e12, hbm_bytes_per_s=1e9)


def cfg(name="tiny-llama"):
    return json.loads((DATA / f"{name}.json").read_text())


def metric(name):
    return importlib.import_module(f"benchmark.metrics.{name}").read


def test_mixtral_configuration_is_the_published_one():
    """Mixtral-8x7B-v0.1's published widths, cut only in its positions; a
    decode step streams ~24.7 GB of packed weight, nearly all of it experts."""
    from benchmark.core import program

    body = json.loads((REPO / "benchmark" / "configs" / "mixtral-8x7b.json").read_text())
    s = synth.Shape.of(body)
    assert (s.hidden, s.ffn, s.layers, s.heads, s.kv_heads, s.head_dim, s.vocab) == (
        4096, 14336, 32, 32, 8, 128, 32000)
    assert (s.experts, s.top_k, s.window) == (8, 2, None)
    assert (s.embed_scale, s.out_scale, s.expert_out_scale) == (1.0, 1 / 32, 1 / 128)
    assert body["rope_theta"] == 1e6 and body["rms_norm_eps"] == 1e-5
    assert body["reduced"] == {"max_position_embeddings": [32768, 8192]}
    assert body["max_position_embeddings"] == 8192 and not body["tie_word_embeddings"]
    assert _counts.step_weight_bytes(s) == pytest.approx(24.7e9, rel=0.005)
    experts = s.layers * sum(c * _counts.packed_bytes(s, K, N)
                             for K, N, c in _counts.projections(s) if c > 1)
    assert 0.96 < experts / _counts.step_weight_bytes(s) < 0.98
    mcfg = program.model_config(body)
    assert (mcfg.n_experts, mcfg.experts_per_token, mcfg.capacity_factor) == (8, 2, None)
    assert (mcfg.max_seq_len, mcfg.sliding_window, mcfg.rope_theta) == (8192, None, 1e6)


def moe_records(calls, trace=None, peaks=PEAKS):
    return Records(cfg("tiny-moe"), {}, (0.0, 10.0), [], list(calls), trace, peaks)


# two calls' route counters: 32 routes on 96 expert rows, 14 experts reached
# over 6 MoE layer forwards of 4 experts
MOE_CALLS = [dict(moe_routes=24.0, moe_expert_rows=64.0, moe_experts_hit=12.0,
                  moe_layer_forwards=4.0),
             dict(moe_routes=8.0, moe_expert_rows=32.0, moe_experts_hit=2.0,
                  moe_layer_forwards=2.0)]


def test_expert_metrics_by_hand():
    s = synth.Shape.of(cfg("tiny-moe"))  # h 256, ffn 512, 2 layers, 4 / 2 heads of 128, 4 experts
    assert metric("expert_row_use")(moe_records(MOE_CALLS)) == pytest.approx(100 * 32 / 96)
    steps, extra = 3, 2
    tr = Trace(span=(0.9, 2.5), kernels={
        "void (anonymous namespace)::qgemv_word_kernel<4, 2, false>(Args)":
            [steps * _counts.step_launches(s) + extra, 0.004],
        "void (anonymous namespace)::decode_attention_kernel<128, 2, 3, false>(Args)":
            [steps * s.layers, 0.002],
    })
    dense = _counts.packed_bytes(s, 256, 1024) + _counts.packed_bytes(s, 512, 256)
    expert = _counts.packed_bytes(s, 256, 1024) + _counts.packed_bytes(s, 512, 256)
    head = _counts.packed_bytes(s, 256, 512)
    step = 2 * (dense + 14 / 24 * 4 * expert) + head
    assert metric("expert_decode_roofline")(moe_records(MOE_CALLS, tr)) == pytest.approx(
        100 * (steps * step + extra * head) / 1e9 / 0.004)
    # every expert reached: the few-rows form's whole roofline
    every = [dict(c, moe_experts_hit=4 * c["moe_layer_forwards"]) for c in MOE_CALLS]
    assert metric("expert_decode_roofline")(moe_records(every, tr)) == pytest.approx(
        metric("qgemv_decode_roofline")(moe_records(every, tr)))


def test_expert_metrics_find_nothing_without_counters_or_a_trace():
    tr = Trace(span=(0.9, 2.5), kernels={"qgemv_word_kernel": [20, 0.004],
                                         "decode_attention_kernel": [4, 0.002]})
    # a program without route counters: its calls hold no moe_* keys
    bare = [dict(decode=1.0, decode_steps=100.0), dict(decode=2.0, decode_steps=150.0)]
    for name in ("expert_row_use", "expert_decode_roofline"):
        assert metric(name)(moe_records(bare, tr)) is None
        assert metric(name)(moe_records([], tr)) is None
    assert metric("expert_decode_roofline")(moe_records(MOE_CALLS)) is None
    assert metric("expert_decode_roofline")(moe_records(MOE_CALLS, tr, peaks=None)) is None
    dense = Records(cfg(), {}, (0.0, 10.0), [], MOE_CALLS, tr, PEAKS)
    assert metric("expert_decode_roofline")(dense) is None
