"""The check that decides ``correct``: served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample drawn
from the seed of the greedy requests that were answered, the longest among
them, goes through the reference (``reference/<name>.py``, float32) as one
sequence each: the prompt and the served tokens.  At each served token the
gap is the reference's best logit there less the reference's logit of the
served token; the run's reading is the mean gap (the widest swings with one
near-tie and is printed, not compared).  A program that serves the
reference's greedy tokens reads 0, up to near-ties that its own rounding
settles the other way.  :func:`verdict` decides ``correct``, for the program
and, in ``control.py``, for the controls in its place.
"""

from __future__ import annotations

import importlib
import random
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.core import synth
from benchmark.core.records import Request


MIN_REQUESTS = 3


def sample(done: List[Request], seed: int, tokens: int) -> List[Request]:
    """The longest answered greedy request and others drawn from the seed,
    until the sample holds ``tokens`` served tokens and ``MIN_REQUESTS``
    requests, or every such request."""
    pool = [r for r in done if r.greedy and r.answered is not None and r.tokens]
    if not pool:
        return []
    pool.sort(key=lambda r: r.index)
    longest = max(pool, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in pool if r is not longest]
    random.Random(synth.tensor_seed(seed, "sample")).shuffle(rest)
    out, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= tokens and len(out) >= MIN_REQUESTS:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def reference(cfg: Dict, seed: int, device, **rounding):
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return mod.Reference(cfg, seed, device, **rounding)


def logits(cfg: Dict, seed: int, device, reqs: List[Request],
           **rounding) -> List[torch.Tensor]:
    """The reference's logits at each served token of each request."""
    seqs = [list(r.prompt) + list(r.tokens[:-1]) for r in reqs]
    wanted = [range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.tokens)) for r in reqs]
    return reference(cfg, seed, device, **rounding).logits(seqs, wanted)


def gaps(ref: List[torch.Tensor], picked: List[torch.Tensor]) -> torch.Tensor:
    """Each position's gap: the reference's best logit less its logit of the
    token picked there."""
    out = [lg.max(dim=-1).values - lg.gather(1, p[:, None].to(lg.device))[:, 0]
           for lg, p in zip(ref, picked)]
    return torch.cat(out) if out else torch.zeros(0)


def served_gaps(cfg: Dict, seed: int, device, reqs: List[Request]) -> Optional[torch.Tensor]:
    if not reqs:
        return None
    ref = logits(cfg, seed, device, reqs)
    return gaps(ref, [torch.tensor(r.tokens) for r in reqs]).cpu()


def verdict(check: Dict, gaps: Optional[torch.Tensor], unanswered: int,
            short: int) -> Tuple[bool, Dict]:
    """``correct`` and each number compared with its limit: the mean gap
    against the cell's ``check.mean_logit_gap``, requests never answered and
    greedy answers short of their length against 0."""
    gap = float(gaps.mean()) if gaps is not None and gaps.numel() else None
    numbers = {
        "mean_logit_gap": dict(value=gap, limit=check["mean_logit_gap"]),
        "unanswered": dict(value=unanswered, limit=0),
        "short_answers": dict(value=short, limit=0),
    }
    return all(n["value"] is not None and n["value"] <= n["limit"]
               for n in numbers.values()), numbers


def shortfalls(done: List[Request]) -> Tuple[int, int]:
    """Requests never answered, and greedy answers short of their length."""
    unanswered = sum(r.answered is None for r in done)
    short = sum(r.answered is not None and r.greedy and len(r.tokens) != r.max_tokens
                for r in done)
    return unanswered, short
