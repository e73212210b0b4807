"""The port's continuous-batching engine against the JAX package's on the tiny
config: greedy tokens are identical, request by request, with slot recycling
(3 requests on 2 slots) and bursts of 1 and 4 steps.  Also: seeded sampling
is reproducible, top_k=1 sampling equals greedy, finish reasons, and the
options not ported yet raise."""

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
    dict(kv_quant=True), dict(spec_tokens=2), dict(paged=True), dict(pipeline=1),
    dict(mesh=object()), dict(draft_params={}), dict(max_restarts=1),
])
def test_unported_options_raise(model, kw):
    with pytest.raises(NotImplementedError):
        Engine(model, CFG, **kw)


def test_long_prompt_names_prefill_attention(model):
    eng = Engine(model, CFG, slots=1, prefill_chunk=16)
    with pytest.raises(NotImplementedError, match="prefill_attention"):
        eng.generate([Request(list(range(20)), max_new_tokens=1)])
