"""The port's pipelined bursts (``Engine(pipeline=N)``) against its synchronous
engine and the JAX package's, on the tiny config, as ``tests/test_engine.py``
holds the JAX engine's: depths 1, 2 and 4 with bursts of 1, 2 and 3 steps, an
eos in the middle of a burst and refills while bursts are in flight give the
synchronous stream and finish reasons, on the linear cache and on a paged
pool (pages reserved for the bursts in flight; with a pool so small that a
slot sits bursts out, the engine first takes in the bursts in flight).  A
device error between pipelined bursts is recovered with the fault-free
tokens."""

import jax
import numpy as np
import pytest
import torch

from xbitops_tpu.engine import Engine as JEngine
from xbitops_tpu.engine import Request as JRequest
from xbitops_tpu.models import llama as jllama
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
# prompts whose greedy paths have no near-tie of two tokens between the
# frameworks (``tests/test_torch_engine.py``)
_rng = np.random.default_rng(1)
PROMPTS = [_rng.integers(0, CFG.vocab_size, n).tolist() for n in (3, 6, 1, 4, 5)]
KW = dict(slots=2, prefill_buckets=[4, 8])


@pytest.fixture(scope="module")
def jparams():
    # the JAX engine tests' model (8-bit, groups of 32), jitted: one compile
    return jax.jit(jllama.init_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 8, 32)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.fixture(scope="module")
def reqs(model):
    """Four requests on two slots: the first stops at an eos that its second
    token is, in the middle of any burst longer than one step."""
    eos = Engine(model, CFG, slots=1).generate([Request(prompt=PROMPTS[0], max_new_tokens=3)])
    return [Request(prompt=PROMPTS[0], max_new_tokens=8, eos_id=eos[0].tokens[1]),
            Request(prompt=PROMPTS[1], max_new_tokens=5),
            Request(prompt=PROMPTS[2], max_new_tokens=7),
            Request(prompt=PROMPTS[3], max_new_tokens=4)]


@pytest.fixture(scope="module")
def sync(jparams, model, reqs):
    """The synchronous streams of the port and of the JAX engine, equal."""
    got = Engine(model, CFG, **KW).generate(reqs)
    want = JEngine(jparams, JCFG, **KW).generate(
        [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens, eos_id=r.eos_id)
         for r in reqs])
    _same(got, want)
    assert got[0].finish_reason == "eos"
    return got


def _same(got, want):
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [(c.id, c.prompt_len, c.finish_reason) for c in got] == [
        (c.id, c.prompt_len, c.finish_reason) for c in want]


@pytest.mark.parametrize("depth,burst", [(1, 1), (1, 3), (2, 2), (4, 2), (2, 3), (4, 1)])
def test_pipelined_matches_sync(model, reqs, sync, depth, burst):
    eng = Engine(model, CFG, pipeline=depth, decode_burst=burst, **KW)
    _same(eng.generate(reqs), sync)
    st = eng.loop_stats
    # bursts went out while older ones were in flight: more steps than tokens need
    assert st["decode_steps"] >= st["decode_tokens"] / KW["slots"]


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_paged_matches_sync(model, sync, depth):
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS[1:]]
    want = Engine(model, CFG, **KW).generate(reqs)
    eng = Engine(model, CFG, pipeline=depth, paged=True, page_size=16, pool_pages=6, **KW)
    _same(eng.generate(reqs), want)
    assert sorted(eng._free_pages) == list(range(6)) and not any(eng._slot_pages)


@pytest.mark.parametrize("depth", [2, 4])
def test_pipelined_paged_pool_pressure(model, depth):
    """A pool of 5 pages of 16 for 2 slots of 64 (``test_torch_paged.py``'s
    pressure case), bursts of 2: the long request sits bursts out until the
    other has finished.  Pages are reserved for the bursts in flight, and a
    slot that sits out resumes after the engine has taken them all in.  (The
    JAX engine reserves pages for ``pipeline`` bursts whether they are in
    flight or not, and at depth 2 finds every slot blocked on this pool.)"""
    reqs = [Request(prompt=list(range(2, 42)), max_new_tokens=12),
            Request(prompt=list(range(50, 60)), max_new_tokens=20),
            Request(prompt=[7, 7], max_new_tokens=8)]
    kw = dict(slots=2, prefill_buckets=[4, 8, 48], prefill_chunk=48, decode_burst=2)
    want = Engine(model, CFG, **kw).generate(reqs)
    eng = Engine(model, CFG, pipeline=depth, paged=True, page_size=16, pool_pages=5, **kw)
    _same(eng.generate(reqs), want)
    assert eng.loop_stats["deferred_slot_steps"] > 0
    assert sorted(eng._free_pages) == list(range(5))


def test_restart_between_pipelined_bursts(model, reqs, sync):
    """A device error before the fourth burst, with two in flight: they are
    dropped, the requests resume from the tokens the host accepted."""
    eng = Engine(model, CFG, pipeline=2, decode_burst=2, max_restarts=1, **KW)
    seen = []

    def hook():
        seen.append(1)
        if len(seen) == 4:
            raise torch.AcceleratorError("injected device error")

    eng._fault_hook = hook
    _same(eng.generate(reqs), sync)
    assert eng.restarts == 1 and eng.loop_stats["restarts"] == 1
