"""The port's Llama against the JAX package's on the tiny config (2 layers,
hidden 256, head_dim 128, S=64, so JAX takes its flash-decode path): the same
packed weights (converted through ``io.convert``) and the same tokens give
logits within rel 2e-2 of the largest logit, for per-layer and stacked
parameters.  The two frameworks round bf16 at different places, so tokens are
compared only in the engine test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
# the JAX reference, jitted with the config static (one compile per function)
jprefill_slots = jax.jit(jllama.prefill_slots, static_argnums=1)
jprefill = jax.jit(jllama.prefill, static_argnums=1)
jdecode_step = jax.jit(jllama.decode_step, static_argnums=1)


@pytest.fixture(scope="module")
def jparams():
    # random packed 4-bit weights, jitted: one compile instead of one per op
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


PREFILL_TOKENS = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
PREFILL_LENS = np.asarray([9, 16], np.int32)
PREFILL_SLOTS = np.asarray([1, 0], np.int32)
ACTIVE = ([True, True], [False, True], [True, True])


@pytest.fixture(scope="module")
def jax_slots_run(jparams):
    """The JAX model's prefill_slots and three decode steps (per-layer params),
    once per module: [(logits, lengths, tokens fed)] per call.  The stacked
    layout computes the same function, so both layouts are held to it."""
    jcache = jllama.KVCache.init(JCFG, 2)
    jl, jcache = jprefill_slots(jparams, JCFG, jnp.asarray(PREFILL_TOKENS),
                               jnp.asarray(PREFILL_LENS), jnp.asarray(PREFILL_SLOTS), jcache)
    run = [(np.asarray(jl), np.asarray(jcache.lengths), None)]
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[::-1].copy()  # slot order
    for active in ACTIVE:
        jl, jcache = jdecode_step(jparams, JCFG, jnp.asarray(tok), jcache,
                                  active=jnp.asarray(active))
        run.append((np.asarray(jl), np.asarray(jcache.lengths), tok))
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    return run


def _close(got: torch.Tensor, want):
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_configs_agree():
    for name in ("llama2_7b", "llama2_13b", "llama3_8b", "mistral_7b", "tiny"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(llama.LlamaConfig, name)()
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == t.__dict__, name


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_prefill_slots_and_decode_match_jax(jparams, model, jax_slots_run, layout):
    if layout == "stacked":
        model = params_from_numpy(
            jax.tree.map(np.asarray, jllama.stack_layers(jparams)), CFG, "cpu")
    cache = llama.KVCache.init(CFG, 2, "cpu")
    tl, cache2 = llama.prefill_slots(
        model, torch.from_numpy(PREFILL_TOKENS), torch.from_numpy(PREFILL_LENS),
        torch.from_numpy(PREFILL_SLOTS), cache)
    assert cache2 is cache
    jl, jlens, _ = jax_slots_run[0]
    _close(tl, jl)
    np.testing.assert_array_equal(cache.lengths.numpy(), jlens)
    for active, (jl, jlens, tok) in zip(ACTIVE, jax_slots_run[1:]):
        act = np.asarray(active)
        tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache,
                                  active=torch.from_numpy(act))
        _close(tl[act], jl[act])
        np.testing.assert_array_equal(cache.lengths.numpy(), jlens)


def test_prefill_through_cache_matches_jax(jparams, model):
    """``prefill`` (all rows from position 0, attending the cache) and one
    decode step that appends through the kernel path."""
    tokens = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    jl, jcache = jprefill(jparams, JCFG, jnp.asarray(tokens), jllama.KVCache.init(JCFG, 2))
    cache = llama.KVCache.init(CFG, 2, "cpu")
    tl, _ = llama.prefill(model, torch.from_numpy(tokens), cache)
    _close(tl, jl)
    tok, active = np.asarray([3, 200], np.int32), np.asarray([True, True])
    jl, _ = jdecode_step(jparams, JCFG, jnp.asarray(tok), jcache, active=jnp.asarray(active))
    tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache, active=torch.from_numpy(active))
    _close(tl, jl)


def test_prefill_slot_is_one_row_of_prefill_slots(model):
    tokens = torch.tensor([[4, 8, 15, 16, 23, 42, 0, 0]])
    a, b = llama.KVCache.init(CFG, 3, "cpu"), llama.KVCache.init(CFG, 3, "cpu")
    la, _ = llama.prefill_slot(model, tokens[0], 6, 2, a)
    lb, _ = llama.prefill_slots(model, tokens, torch.tensor([6]), torch.tensor([2]), b)
    assert torch.equal(la, lb[0]) and torch.equal(a.k, b.k)
    assert a.lengths.tolist() == [0, 0, 6]


def test_use_kernel_false_matches_default(model):
    """On the CPU both switches run plain versions; they agree closely."""
    tokens = torch.tensor([[5, 9, 2, 7]])
    a, b = llama.KVCache.init(CFG, 1, "cpu"), llama.KVCache.init(CFG, 1, "cpu")
    la, _ = llama.prefill(model, tokens, a)
    lb, _ = llama.prefill(model, tokens, b, use_kernel=False)
    _close(la, lb.float().numpy())
    la, _ = llama.decode_step(model, torch.tensor([4]), a)
    lb, _ = llama.decode_step(model, torch.tensor([4]), b, use_kernel=False)
    _close(la, lb.float().numpy())
    _close(a.k, b.k.float().numpy())


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        llama.KVCache.init(CFG, 1, "cpu", quantized=True)
    with pytest.raises(NotImplementedError):
        llama.KVCache.init_paged(CFG, 1, 4)
