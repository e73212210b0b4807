"""The port's speculative engine against the JAX package's, on the tiny
config (the model's part, the unaligned write and ``spec_verify_step``, is
``tests/test_torch_spec.py``).

``Engine(spec_tokens=)``, the cases of ``tests/test_engine.py``: the n-gram
draft, the draft model on a non-periodic walk and with a chunked prompt and a
refill, the copy-model (``utils/synth.copy_llama_params``), the int8 cache, a
paged pool that makes a slot wait, the refusal of sampling.  Each emits the
port's plain greedy stream and the JAX engine's, with its ``spec_stats``.  A
device error in a speculative step is recovered with the fault-free tokens,
the draft cache rebuilt."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from xbitops_tpu.engine import Engine as JEngine
from xbitops_tpu.engine import Request as JRequest
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import structured
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils import synth

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def jparams():
    # the JAX engine tests' model (8-bit, groups of 32), jitted: one compile
    return jax.jit(jllama.init_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 8, 32)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _tokens(completions):
    return [c.tokens for c in completions]


# --- the engine ---

# prompts whose greedy paths have no near-tie of two tokens between the
# frameworks (``tests/test_torch_engine.py``)
_rng = np.random.default_rng(1)
PROMPTS = [_rng.integers(0, CFG.vocab_size, n).tolist() for n in (3, 6, 1)]


def _same(got, want):
    assert _tokens(got) == _tokens(want)
    assert [(c.id, c.prompt_len, c.finish_reason) for c in got] == [
        (c.id, c.prompt_len, c.finish_reason) for c in want]


def _jax_spec(params, cfg, reqs, **kw):
    eng = JEngine(params, cfg, **kw)
    return eng.generate([JRequest(**dataclasses.asdict(r)) for r in reqs]), eng.spec_stats


def test_ngram_spec_matches_greedy_and_jax(jparams, model):
    reqs = [Request(prompt=p, max_new_tokens=12) for p in PROMPTS]
    kw = dict(slots=2, prefill_buckets=[4, 8])
    plain = Engine(model, CFG, **kw).generate(reqs)
    eng = Engine(model, CFG, spec_tokens=3, **kw)
    spec = eng.generate(reqs)
    want, stats = _jax_spec(jparams, JCFG, reqs, spec_tokens=3, **kw)
    _same(spec, plain)
    _same(spec, want)
    assert eng.spec_stats == stats and stats["drafted"] > 0
    assert eng.loop_stats["decode_steps"] > 0 and eng.loop_stats["graph_replays"] == 0


def _walk_models(cycle):
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, seq=64), num_layers=2)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    target = structured.structured_dense_params(cfg, cycle=cycle, seed=0)
    draft = structured.structured_dense_params(dcfg, cycle=cycle, seed=3)
    port = lambda p, c: params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, p), llama.LlamaConfig(**dataclasses.asdict(c)), "cpu")
    return (cfg, target, dcfg, draft), (port(target, cfg), port(draft, dcfg))


def test_draft_model_on_a_nonperiodic_walk():
    """The successor walk t -> t+1 mod V repeats no bigram: the n-gram draft
    accepts next to nothing, the draft model (one layer of the same walk)
    nearly everything; all three streams are the walk."""
    cycle = 256
    (jcfg, jtarget, jdcfg, jdraft), (target, draft) = _walk_models(cycle)
    cfg = target.cfg
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=12, id=0),
            Request(prompt=[100, 101], max_new_tokens=10, id=1)]
    plain = Engine(target, cfg, slots=2, prefill_buckets=[8]).generate(reqs)
    assert plain[0].tokens == list(structured.successor_stream(7, 12, cycle))
    ngram_eng = Engine(target, cfg, slots=2, prefill_buckets=[8], spec_tokens=4)
    ngram = ngram_eng.generate(reqs)
    model_eng = Engine(target, cfg, slots=2, prefill_buckets=[8], spec_tokens=4,
                       draft_params=draft, draft_cfg=draft.cfg)
    spec = model_eng.generate(reqs)
    want, stats = _jax_spec(jtarget, jcfg, reqs, slots=2, prefill_buckets=[8], spec_tokens=4,
                            draft_params=jdraft, draft_cfg=jdcfg)
    for got in (ngram, spec, want):
        _same(got, plain)
    assert model_eng.spec_stats == stats and stats["draft_source"] == "model"
    assert ngram_eng.spec_stats["draft_source"] == "ngram"
    rate = lambda st: st["accepted"] / st["drafted"]  # noqa: E731
    assert rate(model_eng.spec_stats) >= 0.8 and rate(ngram_eng.spec_stats) <= 0.2


def test_draft_model_with_a_chunked_prompt_and_a_refill():
    cycle = 256
    (jcfg, jtarget, jdcfg, jdraft), (target, draft) = _walk_models(cycle)
    cfg = target.cfg
    reqs = [Request(prompt=[int(t) for t in structured.successor_stream(40, 20, cycle)],
                    max_new_tokens=8, id=0),  # chunked
            Request(prompt=[9, 10], max_new_tokens=8, id=1),
            Request(prompt=[200, 201], max_new_tokens=8, id=2)]  # a refill
    kw = dict(slots=2, prefill_buckets=[8], prefill_chunk=16)
    plain = Engine(target, cfg, **kw).generate(reqs)
    eng = Engine(target, cfg, spec_tokens=3, draft_params=draft, **kw)
    spec = eng.generate(reqs)
    want, stats = _jax_spec(jtarget, jcfg, reqs, spec_tokens=3, draft_params=jdraft,
                            draft_cfg=jdcfg, **kw)
    _same(spec, plain)
    _same(spec, want)
    assert eng.spec_stats == stats and stats["accepted"] / stats["drafted"] >= 0.8
    assert eng.loop_stats["chunks"] == 2


def test_copy_model_accepts_nearly_every_draft():
    """``copy_llama_params`` of the port (its own random bits): greedy is the
    cycle 0..3, the n-gram draft accepts >= 90%, with the JAX copy-model's
    stream and ``spec_stats``."""
    cycle = [0, 1, 2, 3]
    reqs = [Request(prompt=cycle * 2, max_new_tokens=16),
            Request(prompt=(cycle * 3)[2:], max_new_tokens=12)]
    cp = synth.copy_llama_params(torch.Generator().manual_seed(0), CFG, bits=4, group_size=32,
                                 period=4)
    kw = dict(slots=2, prefill_buckets=[8, 16])
    plain = Engine(cp, CFG, **kw).generate(reqs)
    eng = Engine(cp, CFG, spec_tokens=4, **kw)
    spec = eng.generate(reqs)
    jcp = jax.jit(jsynth.copy_llama_params, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(0), JCFG, 4, 32, 4)
    want, stats = _jax_spec(jcp, JCFG, reqs, spec_tokens=4, **kw)
    assert plain[0].tokens == (cycle * 4)[:16]
    _same(spec, plain)
    _same(spec, want)
    assert eng.spec_stats == stats and stats["accepted"] / stats["drafted"] >= 0.9


def test_spec_on_the_int8_cache(jparams, model):
    reqs = [Request(prompt=[3, 1, 4, 1, 5], max_new_tokens=10)]
    kw = dict(slots=2, prefill_buckets=[8], kv_quant=True)
    plain = Engine(model, CFG, **kw).generate(reqs)
    eng = Engine(model, CFG, spec_tokens=4, **kw)
    spec = eng.generate(reqs)
    want, stats = _jax_spec(jparams, JCFG, reqs, spec_tokens=4, **kw)
    assert eng.cache.quantized
    _same(spec, plain)
    _same(spec, want)
    assert eng.spec_stats == stats


def test_spec_on_a_small_paged_pool(jparams, model):
    """A pool of 5 pages of 16 for 2 slots of 64 (``test_torch_paged.py``'s
    pressure case): each verify reserves γ + 1 positions a slot, and the long
    request sits steps out until the other has finished."""
    reqs = [Request(prompt=list(range(2, 42)), max_new_tokens=12),
            Request(prompt=list(range(50, 60)), max_new_tokens=20),
            Request(prompt=[7, 7], max_new_tokens=8)]
    kw = dict(slots=2, prefill_buckets=[4, 8, 48], prefill_chunk=48)
    plain = Engine(model, CFG, **kw).generate(reqs)
    pkw = dict(paged=True, page_size=16, pool_pages=5, spec_tokens=3, **kw)
    eng = Engine(model, CFG, **pkw)
    spec = eng.generate(reqs)
    want, stats = _jax_spec(jparams, JCFG, reqs, **pkw)
    _same(spec, plain)
    _same(spec, want)
    assert eng.spec_stats == stats and eng.loop_stats["deferred_slot_steps"] > 0
    assert sorted(eng._free_pages) == list(range(5)) and not any(eng._slot_pages)


def test_spec_rejects_sampling(model):
    eng = Engine(model, CFG, slots=2, prefill_buckets=[8], spec_tokens=2)
    with pytest.raises(ValueError):
        eng.generate([Request(prompt=[1, 2], temperature=0.7)])


def test_restart_in_a_spec_step_rebuilds_the_draft_cache():
    """A device error before the third speculative step: one restart, a new
    draft cache, the fault-free tokens."""
    (_, _, _, _), (target, draft) = _walk_models(256)
    cfg = target.cfg
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=12), Request(prompt=[100, 101],
                                                                   max_new_tokens=10)]
    kw = dict(slots=2, prefill_buckets=[8], spec_tokens=3, draft_params=draft)
    clean = Engine(target, cfg, **kw).generate(reqs)
    eng = Engine(target, cfg, max_restarts=1, **kw)
    old = eng._draft_cache
    seen = []

    def hook():
        seen.append(1)
        if len(seen) == 3:
            raise torch.AcceleratorError("injected device error")

    eng._fault_hook = hook
    got = eng.generate(reqs)
    assert eng.restarts == 1 and eng._draft_cache is not old
    _same(got, clean)
