"""The traffic generator: every seed offers the same work in the same order
and at the same times, and draws only the token ids; the warm-up takes each
admission bucket the traffic reaches."""

from __future__ import annotations

import json
from collections import Counter

import pytest

from benchmark.core import traffic
from conftest import REPO


def params(cell):
    return json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json").read_text())["traffic"]


def test_blocks_hold_the_same_sizes_for_every_seed():
    p = params("mistral-7b.chat")
    n = p["block"]
    runs = [traffic.requests(p, seed, 32000) for seed in (1, 2, 3000000123)]
    for b in range(p["blocks"]):
        shapes = [Counter((len(r.prompt), r.max_tokens > 0) for r in reqs[b * n:(b + 1) * n])
                  for reqs in runs]
        outs = [sorted(r.max_tokens for r in reqs[b * n:(b + 1) * n]) for reqs in runs]
        temps = [sorted(r.temperature for r in reqs[b * n:(b + 1) * n]) for reqs in runs]
        assert shapes[0] == shapes[1] == shapes[2]
        assert outs[0] == outs[1] == outs[2] and temps[0] == temps[1] == temps[2]
    assert [r.at for r in runs[0]] == [r.at for r in runs[1]] == [r.at for r in runs[2]]
    assert [r.prompt for r in runs[0]] != [r.prompt for r in runs[1]]
    assert traffic.requests(p, 2, 32000)[5].prompt == runs[1][5].prompt  # the seed decides


def test_lengths_are_quantiles_within_limits():
    p = params("mistral-7b.chat")
    lens = traffic.quantiles(p["prompt"], 32)
    assert lens == sorted(lens) and min(lens) >= 32 and max(lens) == 1024
    assert 240 <= lens[16] <= 270  # the median, 256
    dec = traffic.quantiles(params("mistral-7b.decode")["output"], 32)
    assert 256 <= min(dec) and max(dec) <= 1024


def test_warmup_covers_the_buckets_reached():
    buckets = [16, 32, 64, 128, 256, 512]
    chat = traffic.warmup(params("mistral-7b.chat"), buckets, 512, 32000)
    assert [len(r.prompt) for r in chat] == [32, 64, 128, 256, 512, 1024]
    assert sum(r.temperature > 0 for r in chat) == 1
    dec = traffic.warmup(params("mistral-7b.decode"), buckets, 512, 32000)
    assert [len(r.prompt) for r in dec] == [32, 64, 128, 256] and all(r.greedy for r in dec)


@pytest.mark.parametrize("cell", ["mistral-7b.chat", "mistral-7b.decode"])
def test_fixed_order_keeps_sizes_in_place_and_draws_the_ids(cell):
    p = params(cell)
    a, b = traffic.requests(p, 1, 32000), traffic.requests(p, 3000000123, 32000)
    sizes = [(len(r.prompt), r.max_tokens, r.temperature, r.at) for r in a]
    assert sizes == [(len(r.prompt), r.max_tokens, r.temperature, r.at) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert len(set(sizes[: p["block"]])) > p["block"] // 2  # not one size repeated


def test_arrivals_are_a_poisson_process_at_the_rate():
    p = params("mistral-7b.chat")
    rate, n = p["arrival"]["rate_per_s"], p["block"]
    at = [r.at for r in traffic.requests(p, 7, 32000)]
    gaps = [b - a for a, b in zip(at, at[1:])]
    assert at[0] == 0 and all(g > 0 for g in gaps)
    assert sorted(gaps[: n - 1] + [at[n] - at[n - 1]]) == pytest.approx(
        traffic.gaps(p["arrival"], n))
    assert at[n] == pytest.approx(sum(traffic.gaps(p["arrival"], n)))
    # the exponential's quantiles: mean 1 / rate, as many gaps under the mean as a
    # Poisson process has (1 - 1/e of them)
    assert sum(gaps[:n]) / n == pytest.approx(1 / rate, rel=0.01)
    assert sum(g < 1 / rate for g in gaps[:n]) == pytest.approx(n * (1 - 1 / 2.718281828), abs=1)
    assert traffic.requests(params("mistral-7b.decode"), 7, 32000)[-1].at == 0
