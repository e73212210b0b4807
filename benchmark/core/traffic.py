"""The one traffic generator: a cell's ``traffic`` parameters and a seed give
the requests, in the order they are sent, and when.

Requests come in blocks of ``block`` requests.  Every block holds the same
multiset of prompt lengths and of output lengths, the distributions' quantiles
at ``(i + 0.5) / block``, and the same number of sampled requests.  Their
order is drawn once, from a constant, since it changes the work (the order of
a batch's long requests sets when the batch ends): every seed sends the same
sizes in the same order at the same times, and draws only the prompts' token
ids.

Parameters (JSON): ``block``, ``blocks``; ``prompt`` and ``output``, each
``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}`` or
``{"dist": "loguniform", "min": a, "max": b}``; ``sampled_share`` and
``temperature`` (sampled requests; the rest are greedy); ``arrival``
(open-loop cells): ``{"rate_per_s": r}``, a Poisson process: the gaps between
sends are the quantiles of the exponential of mean ``1 / r``, in an order
drawn with the sizes.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

from benchmark.core import synth


@dataclass
class Req:
    index: int
    prompt: List[int]
    max_tokens: int
    temperature: float
    at: float = 0.0  # seconds after the window opens that it is sent

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0


def quantiles(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``spec``, clipped
    to ``[min, max]``."""
    lo, hi = spec["min"], spec["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(u))
        elif spec["dist"] == "loguniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(int(min(hi, max(lo, round(x)))))
    return out


def gaps(arrival: Dict, n: int) -> List[float]:
    """``n`` gaps between sends at the quantiles ``(i + 0.5) / n`` of the
    exponential of mean ``1 / rate_per_s``."""
    return [-math.log(1.0 - (i + 0.5) / n) / arrival["rate_per_s"] for i in range(n)]


def requests(params: Dict, seed: int, vocab: int) -> List[Req]:
    """All ``blocks * block`` requests of ``params`` for ``seed``."""
    rng = random.Random(synth.tensor_seed(seed, "traffic"))
    order = random.Random(0)
    n = params["block"]
    prompts = quantiles(params["prompt"], n)
    outputs = quantiles(params["output"], n)
    n_sampled = round(n * params.get("sampled_share", 0.0))
    temps = [params.get("temperature", 0.0)] * n_sampled + [0.0] * (n - n_sampled)
    arrival = params.get("arrival")
    out: List[Req] = []
    at = 0.0
    for _ in range(params["blocks"]):
        p, o, t = prompts[:], outputs[:], temps[:]
        order.shuffle(p)
        order.shuffle(o)
        order.shuffle(t)
        g = [0.0] * n
        if arrival:
            g = gaps(arrival, n)
            order.shuffle(g)
        for plen, olen, temp, gap in zip(p, o, t, g):
            ids = [rng.randrange(vocab) for _ in range(plen)]
            out.append(Req(len(out), ids, olen, temp, at))
            at += gap
    return out


def warmup(params: Dict, buckets: List[int], chunk: int, vocab: int) -> List[Req]:
    """Requests that take each admission bucket the traffic's prompts reach
    once, and one prompt past the chunk length where the traffic has such
    prompts: one burst's tokens each; the second sampled where the traffic
    samples."""
    lo, hi = params["prompt"]["min"], params["prompt"]["max"]
    first = next(b for b in buckets if b >= lo)
    lens = [min(b, hi) for b in buckets if first <= b <= chunk and (b == first or b // 2 < hi)]
    if hi > chunk:
        lens.append(hi)
    out = []
    for i, n in enumerate(lens):
        temp = params.get("temperature", 0.0) if params.get("sampled_share") and i == 1 else 0.0
        out.append(Req(-1 - i, [(7 * j + i) % vocab for j in range(n)], 8, temp))
    return out
