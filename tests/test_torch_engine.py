"""The port's continuous-batching engine against the JAX package's on the tiny
config: greedy tokens are identical, request by request, with slot recycling
(3 requests on 2 slots) and bursts of 1 and 4 steps.  Also: seeded sampling
is reproducible, top_k=1 sampling equals greedy, finish reasons, and the
option pairs the JAX engine refuses raise ``ValueError``, ``mesh=`` with a
draft model among them (the mesh engine is in ``tests/test_torch_engine_tp.py``,
speculative decoding and pipelined bursts in ``tests/test_torch_spec.py`` and
``tests/test_torch_pipeline.py``).  Long prompts (130-250 tokens at S=256, admitted
in chunks of 128, which takes JAX through its flash-prefill kernel) and the
packed int8 cache give identical greedy tokens too, alone and together; so does
W4A8 admission (``prefill_a8``: prompts of 33-50 tokens, bucket 64).  Restarts
(``max_restarts``): a device error injected before a decode dispatch or in an
admission forward is recovered with the fault-free tokens (the port's and the
JAX engine's), on the linear and the paged cache (every page given back); a
Python error or a fault past ``max_restarts`` propagates."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from xbitops_tpu.engine import Engine as JEngine
from xbitops_tpu.engine import Request as JRequest
from xbitops_tpu.engine.sampling import sample_tokens as jsample
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.engine.sampling import sample_tokens
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
rng = np.random.default_rng(0)
PROMPTS = [rng.integers(0, CFG.vocab_size, n).tolist() for n in (3, 9, 20)]


@pytest.fixture(scope="module")
def jparams():
    # random packed 4-bit weights, jitted: one compile instead of one per op
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.fixture(scope="module")
def jax_greedy(jparams):
    """The JAX Engine's greedy completions, once per module: its tokens do not
    depend on the burst length, so every burst case of the port is held to
    the same run."""
    return JEngine(jparams, JCFG, slots=2, decode_burst=4, kv_quant=False).generate(
        [JRequest(prompt=p, max_new_tokens=6) for p in PROMPTS])


@pytest.mark.parametrize("burst", [1, 4])
def test_greedy_tokens_match_jax_engine(jax_greedy, model, burst):
    got = Engine(model, CFG, slots=2, decode_burst=burst, kv_quant=False).generate(
        [Request(prompt=p, max_new_tokens=6) for p in PROMPTS])
    assert [c.tokens for c in got] == [c.tokens for c in jax_greedy]
    assert [(c.id, c.prompt_len, c.finish_reason) for c in got] == [
        (c.id, c.prompt_len, c.finish_reason) for c in jax_greedy]


def _sampled(model, seed, top_k=0, temperature=0.8):
    eng = Engine(model, CFG, slots=2, decode_burst=2, top_k=top_k, seed=seed)
    reqs = [Request(prompt=p, max_new_tokens=5, temperature=temperature) for p in PROMPTS]
    return [c.tokens for c in eng.generate(reqs)]


def test_sampling_seeded_and_top_k_1_is_greedy(model):
    assert _sampled(model, seed=3) == _sampled(model, seed=3)
    assert _sampled(model, seed=3, top_k=1) == _sampled(model, seed=0, temperature=0.0)


def test_sample_tokens_matches_jax_on_deterministic_rows():
    """Greedy rows are exact argmax; top_k=1 and top_p=0 rows keep only the
    argmax, like the JAX sampler."""
    logits = np.random.default_rng(4).standard_normal((4, 50), dtype=np.float32)
    temps = np.asarray([0.0, 0.7, 1.0, -1.0], np.float32)
    want = np.argmax(logits, axis=-1)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(top_k=1), dict(top_p=0.0)):
        got = sample_tokens(torch.from_numpy(logits), gen, torch.from_numpy(temps), **kw)
        jgot = jsample(jax.numpy.asarray(logits), jax.random.PRNGKey(0),
                       jax.numpy.asarray(temps), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jgot), want)


def test_finish_reasons(model):
    first = Engine(model, CFG, slots=1).generate([Request(PROMPTS[0], max_new_tokens=3)])[0]
    eos = first.tokens[1]
    eng = Engine(model, CFG, slots=2, decode_burst=4)
    out = eng.generate([
        Request(PROMPTS[0], max_new_tokens=10, eos_id=eos),
        Request(list(range(60)), max_new_tokens=10),  # S = 64: capacity after 4
    ])
    # generation stops at the first eos, which it keeps
    assert out[0].finish_reason == "eos"
    assert out[0].tokens == first.tokens[: first.tokens.index(eos) + 1]
    assert out[1].finish_reason == "capacity" and len(out[1].tokens) == 4


@pytest.mark.parametrize("kw", [
    dict(spec_tokens=2, decode_burst=2), dict(spec_tokens=2, pipeline=1),
    dict(draft_params="model"), dict(draft_params="model", spec_tokens=2, paged=True),
    dict(mesh="mesh", draft_params="model", spec_tokens=2),
    dict(draft_params="model_s128", spec_tokens=2),
])
def test_unported_options_raise(model, kw):
    """The option pairs the JAX engine refuses with ``ValueError`` the port
    refuses so too: speculative decoding with bursts or a pipeline, a draft
    model without speculative decoding, over a paged cache, under a mesh
    (here the one-process mesh), or of another ``max_seq_len``."""
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    if "draft_params" in kw:
        draft = model if kw["draft_params"] == "model" else model.with_config(
            dataclasses.replace(CFG, max_seq_len=128))
        kw = dict(kw, draft_params=draft)
    if "mesh" in kw:
        kw = dict(kw, mesh=make_mesh((1, 1)))
    with pytest.raises(ValueError):
        Engine(model, CFG, **kw)


JCFG256 = jllama.LlamaConfig.tiny(seq=256)
CFG256 = llama.LlamaConfig.tiny(seq=256)
# This random model's logits are nearly flat, so a few prompts in ten put two
# tokens within one bf16 step of each other and the frameworks' different
# rounding picks either: seed 1 is one whose greedy path has no such tie.
_long_rng = np.random.default_rng(1)
LONG_PROMPTS = [_long_rng.integers(0, CFG.vocab_size, n).tolist()
                for n in (130, 250, 9, 200, 20)]


@pytest.fixture(scope="module")
def model256(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG256, "cpu")


def _same_completions(got, want):
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [(c.id, c.prompt_len, c.finish_reason) for c in got] == [
        (c.id, c.prompt_len, c.finish_reason) for c in want]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16cache", "int8cache"])
def test_chunked_admission_matches_jax_engine(jparams, model256, kv_quant):
    """Long prompts in chunks of 128 mixed with short ones in one generate, 5
    requests on 3 slots: both kinds are admitted in one wave and a recycled
    slot takes a long prompt."""
    kw = dict(slots=3, decode_burst=4, prefill_chunk=128, kv_quant=kv_quant)
    want = JEngine(jparams, JCFG256, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=5) for p in LONG_PROMPTS])
    eng = Engine(model256, CFG256, **kw)
    got = eng.generate([Request(prompt=p, max_new_tokens=5) for p in LONG_PROMPTS])
    _same_completions(got, want)
    assert eng.cache.quantized == kv_quant
    # waves: (130, 250 chunked; 9), then 200 chunked, then 20: 2 + 2 chunk forwards
    assert eng.loop_stats["chunks"] == 4 and eng.loop_stats["admit_prefill_chunks"] > 0


def test_kv_quant_short_prompts_match_jax_engine(jparams, model):
    kw = dict(slots=2, decode_burst=4, kv_quant=True)
    want = JEngine(jparams, JCFG, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=6) for p in PROMPTS])
    got = Engine(model, CFG, **kw).generate(
        [Request(prompt=p, max_new_tokens=6) for p in PROMPTS])
    _same_completions(got, want)


@pytest.mark.parametrize("seq", [64, 1024])
def test_kv_quant_auto_resolves_like_jax(jparams, seq):
    jcfg, cfg = jllama.LlamaConfig.tiny(seq=seq), llama.LlamaConfig.tiny(seq=seq)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    want = JEngine(jparams, jcfg, slots=1).kv_quant
    eng = Engine(model, cfg, slots=1)
    assert eng.kv_quant == want == (seq >= 1024)
    assert eng.cache.quantized == want
    assert not Engine(model, cfg, slots=1, prefill_chunk=30).kv_quant  # chunk % 4 != 0


def test_kv_quant_rounds_buckets_and_checks_the_chunk(model):
    eng = Engine(model, CFG, slots=1, kv_quant=True, prefill_buckets=[6, 16, 30])
    assert eng.buckets == [8, 16, 32]
    with pytest.raises(ValueError):
        Engine(model, CFG, slots=1, kv_quant=True, prefill_chunk=30)


# prompts past 32 tokens, so that admission (one bucket of 64 rows) clears the
# int8-activation threshold; a seed whose greedy path has no near-tie
_a8_rng = np.random.default_rng(2)
A8_PROMPTS = [_a8_rng.integers(0, CFG.vocab_size, n).tolist() for n in (33, 50, 40)]


def test_prefill_a8_engine_matches_jax_engine(jparams, model):
    """3 requests on 2 slots with W4A8 admission: greedy tokens equal to the
    JAX Engine's; an admission's logits are not those of the bf16-activation
    model (the int8 path ran)."""
    jcfg8 = dataclasses.replace(JCFG, prefill_a8=True)
    cfg8 = dataclasses.replace(CFG, prefill_a8=True)
    kw = dict(slots=2, decode_burst=4, kv_quant=False)
    want = JEngine(jparams, jcfg8, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=6) for p in A8_PROMPTS])
    model8 = model.with_config(cfg8)
    eng = Engine(model8, cfg8, **kw)
    assert eng.buckets[-1] == 64
    got = eng.generate([Request(prompt=p, max_new_tokens=6) for p in A8_PROMPTS])
    _same_completions(got, want)
    # the admission logits differ from the bf16-activation model's
    tokens = torch.zeros(64, dtype=torch.long)
    tokens[:50] = torch.tensor(A8_PROMPTS[1])
    l8, _ = llama.prefill_slot(model8, tokens, 50, 0, llama.KVCache.init(cfg8, 1, "cpu"))
    l16, _ = llama.prefill_slot(model, tokens, 50, 0, llama.KVCache.init(CFG, 1, "cpu"))
    assert not torch.equal(l8, l16)


# A 3-bit model (planes of 2 and 1 bits, packed storage): JAX's init_params
# quantizes random weights and io/convert carries them across.  Prompt seed 0
# gives a greedy path with no near-tie between two tokens (see above); the two
# prompts share a bucket, so the JAX engine compiles one admission.
_three_rng = np.random.default_rng(0)
THREE_BIT_PROMPTS = [_three_rng.integers(0, CFG.vocab_size, n).tolist() for n in (5, 12)]


def test_three_bit_model_matches_jax_engine():
    jp = jllama.init_params(jax.random.PRNGKey(3), JCFG, bits=3, group_size=128)
    port = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    qt = port.blocks[0].wo.qtensor
    assert qt.bits == 3 and len(qt.planes) == 2
    want = JEngine(jp, JCFG, slots=2, decode_burst=4, kv_quant=False).generate(
        [JRequest(prompt=p, max_new_tokens=5) for p in THREE_BIT_PROMPTS])
    got = Engine(port, CFG, slots=2, decode_burst=4, kv_quant=False).generate(
        [Request(prompt=p, max_new_tokens=5) for p in THREE_BIT_PROMPTS])
    _same_completions(got, want)


# Restarts (``max_restarts``), as ``tests/test_engine.py`` injects them: a
# device error raised by ``_fault_hook`` before a decode dispatch, here
# ``torch.AcceleratorError``.  The engine rebuilds the cache and requeues each
# request as prompt + tokens emitted so far; greedy tokens equal a fault-free
# run of the port and the JAX engine's.

def _fault_at(*calls, exc=torch.AcceleratorError):
    seen = []

    def hook():
        seen.append(1)
        if len(seen) in calls:
            raise exc("injected device error")
    return hook


@pytest.mark.parametrize("burst", [1, 4])
def test_restart_recovers_the_clean_tokens(jax_greedy, model, burst):
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    clean = Engine(model, CFG, slots=2, decode_burst=burst, kv_quant=False).generate(reqs)
    eng = Engine(model, CFG, slots=2, decode_burst=burst, kv_quant=False, max_restarts=2)
    eng._fault_hook = _fault_at(3)
    got = eng.generate(reqs)
    assert eng.restarts == 1 and eng.loop_stats["restarts"] == 1
    _same_completions(got, clean)
    _same_completions(got, jax_greedy)


def test_restart_propagates_without_max_restarts(model):
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    eng = Engine(model, CFG, slots=2, kv_quant=False)
    eng._fault_hook = _fault_at(2)
    with pytest.raises(torch.AcceleratorError):
        eng.generate(reqs)
    # a Python error is not a device error: it is not retried
    eng = Engine(model, CFG, slots=2, kv_quant=False, max_restarts=3)
    eng._fault_hook = _fault_at(2, exc=KeyError)
    with pytest.raises(KeyError):
        eng.generate(reqs)
    assert eng.restarts == 0


def test_restarts_run_out(jax_greedy, model):
    """Two faults: one restart recovers the first, the second raises; with two
    restarts both recover (out of memory counts as a device error too)."""
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    eng = Engine(model, CFG, slots=2, kv_quant=False, max_restarts=1)
    eng._fault_hook = _fault_at(2, 4)
    with pytest.raises(torch.AcceleratorError):
        eng.generate(reqs)
    assert eng.restarts == 1
    eng = Engine(model, CFG, slots=2, kv_quant=False, max_restarts=2)
    eng._fault_hook = _fault_at(2, 4, exc=torch.OutOfMemoryError)
    _same_completions(eng.generate(reqs), jax_greedy)
    assert eng.restarts == 2


def test_restart_during_admission_requeues_the_admitted(jax_greedy, model, monkeypatch):
    """A device error in an admission forward: the requests being admitted go
    back to the queue (none is lost or served twice)."""
    calls = []
    real = llama.prefill_slots

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise torch.AcceleratorError("injected device error")
        return real(*args, **kw)

    monkeypatch.setattr(llama, "prefill_slots", failing)
    eng = Engine(model, CFG, slots=2, decode_burst=4, kv_quant=False, max_restarts=1)
    got = eng.generate([Request(prompt=p, max_new_tokens=6) for p in PROMPTS])
    assert eng.restarts == 1 and len(calls) > 2
    _same_completions(got, jax_greedy)


def test_paged_restart_gives_every_page_back(jax_greedy, model):
    """A paged engine's restart: a new pool with every page free, the table
    reset on the host and the card; tokens equal the fault-free run's."""
    reqs = [Request(prompt=p, max_new_tokens=6) for p in PROMPTS]
    kw = dict(slots=2, decode_burst=2, paged=True, page_size=16, kv_quant=False)
    clean = Engine(model, CFG, **kw).generate(reqs)
    eng = Engine(model, CFG, max_restarts=1, **kw)
    old = eng.cache
    eng._fault_hook = _fault_at(3)
    got = eng.generate(reqs)
    assert eng.restarts == 1 and eng.cache is not old
    _same_completions(got, clean)
    _same_completions(got, jax_greedy)
    n_pages = eng.cache.k.shape[1]
    assert sorted(eng._free_pages) == list(range(n_pages)) and not any(eng._slot_pages)
    assert (eng._table == -1).all() and bool((eng.cache.page_table == -1).all())


def test_restart_does_not_serve_a_finished_request_twice(model256, monkeypatch):
    """A long prompt that finishes at its chunked admission (one new token),
    then a device error in the bucketed admission of the same loop: the
    finished request keeps its one completion (the JAX engine would requeue
    it and merge its tokens twice: ROADMAP.md, queue 3), the other resumes."""
    reqs = [Request(prompt=LONG_PROMPTS[0], max_new_tokens=1),
            Request(prompt=PROMPTS[0], max_new_tokens=4)]
    kw = dict(slots=2, decode_burst=2, kv_quant=False, prefill_chunk=128)
    clean = Engine(model256, CFG256, **kw).generate(reqs)
    calls = []
    real = llama.prefill_slots

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise torch.AcceleratorError("injected device error")
        return real(*args, **kwargs)

    monkeypatch.setattr(llama, "prefill_slots", failing)
    eng = Engine(model256, CFG256, max_restarts=1, **kw)
    got = eng.generate(reqs)
    assert eng.restarts == 1 and len(got) == 2
    _same_completions(got, clean)
    assert len(got[0].tokens) == 1
