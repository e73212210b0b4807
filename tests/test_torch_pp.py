"""The port's pipeline parallelism (``parallel/pp.py``) against the JAX
package's (``tests/test_pp.py``'s cases) on the tiny config, and the
``multihost`` rule that a rank finds its card or raises.

The JAX package builds its stacked trees (``init_params(tp=1|2)`` from key 0,
``stack_layers``), prefills the caches that ``test_pp.py`` starts from
(jitted single-chip ``prefill_slots``) and runs its ``pp_decode_step``,
``pp_decode_burst`` and ``pp_prefill_slots`` (jitted) on a mesh of as many
virtual devices; the port's ranks read the same trees as packed directories
(``load_llama``), take their stage (``stage_model``, ``stage_cache``) and run
the same cases in a 2-rank (pipe) and a 4-rank ((pipe, model) = 2 x 2) gloo
world (``tests/torch_parallel_ranks.py``: each rank a process that imports no
JAX, one torch thread).  Held: logits within rel 2e-2 of JAX's and the same
greedy tokens; lengths equal; cache rows within ``test_pp.py``'s tolerance of
JAX's, and equal, bit for bit, to the port's one-rank ``decode_step`` /
``prefill_slots`` on the same cache; a burst's tokens and cache bit-equal to
n of the port's ``pp_decode_step``; the raises."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from xbitops_tpu.io.checkpoint import save_packed as jsave_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.parallel import mesh as jmeshlib
from xbitops_tpu.parallel import pp as jpp
from xbitops_tpu_torch.parallel import multihost

torch.set_num_threads(1)

CFG = jllama.LlamaConfig.tiny(seq=64)  # 2 layers -> 2 stages of 1
B = 4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _params(tp=1):
    return jllama.stack_layers(
        jllama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32, tp=tp))


def _prefilled(params, T=6, quantized=False):
    """``test_pp.py``'s prefilled batch: greedy next tokens and the cache."""
    tokens = jax.random.randint(jax.random.PRNGKey(5), (B, T), 0, CFG.vocab_size)
    lens = jnp.full((B,), T, jnp.int32)
    logits, cache = jax.jit(lambda p, t, c: jllama.prefill_slots(
        p, CFG, t, lens, jnp.arange(B), c))(params, tokens,
                                            jllama.KVCache.init(CFG, B, quantized=quantized))
    return jnp.argmax(logits, -1).astype(jnp.int32), cache


def _np(t):
    return np.asarray(t, np.float32 if t.dtype == jnp.bfloat16 else t.dtype)


def _cache_arrays(cache, prefix=""):
    out = {prefix + "lengths": np.asarray(cache.lengths)}
    for f in ("k", "v", "k_scale", "v_scale"):
        if getattr(cache, f) is not None:
            out[prefix + f] = _np(getattr(cache, f))
    return out


@functools.lru_cache(maxsize=None)
def _jitted_step(mesh, tp_axis):
    return jax.jit(lambda p, t, c, a: jpp.pp_decode_step(p, CFG, mesh, t, c, tp_axis=tp_axis,
                                                         active=a))


def _jax_step(params, mesh, toks, cache, active=None, tp_axis=None):
    return _jitted_step(mesh, tp_axis)(
        params, toks, cache, jnp.ones((B,), bool) if active is None else jnp.asarray(active))


def _jax_burst(params, mesh, toks, cache, n, active=None):
    return jax.jit(lambda p, t, c, a: jpp.pp_decode_burst(p, CFG, mesh, t, c, n, active=a))(
        params, toks, cache, jnp.ones((B,), bool) if active is None else jnp.asarray(active))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """JAX's cases on a 2-device pipe mesh, then the 2-rank world's."""
    d = tmp_path_factory.mktemp("pp2")
    mesh = jmeshlib.make_mesh((2,), ("pipe",))
    params = _params()
    jsave_packed(params, str(d / "p1"))
    toks, cache = _prefilled(params)
    q_toks, q_cache = _prefilled(params, T=4, quantized=True)
    inputs = dict(toks=np.asarray(toks), q_toks=np.asarray(q_toks), **_cache_arrays(cache),
                  **_cache_arrays(q_cache, "q_"))
    want = {}
    for name, c, t, active in (("dec", cache, toks, None),
                               ("mask", cache, toks, [True, False, True, False]),
                               ("int8", q_cache, q_toks, None)):
        logits, got = _jax_step(params, mesh, t, c, active)
        want[f"{name}_logits"] = np.asarray(logits, np.float32)
        want[f"{name}_lengths"] = np.asarray(got.lengths)
        want[f"{name}_k"] = _np(got.k)
    S = CFG.max_seq_len
    near_full = dataclasses.replace(cache, lengths=cache.lengths.at[3].set(S - 1))
    for name, c, n, active in (("burst", cache, 5, None),
                               ("burst_mask", near_full, 4, [True, True, False, True])):
        tokens, got = _jax_burst(params, mesh, toks, c, n, active)
        want[f"{name}_tokens"] = np.asarray(tokens)
        want[f"{name}_lengths"] = np.asarray(got.lengths)
        want[f"{name}_k"] = _np(got.k)
    T = 8
    tokens = jax.random.randint(jax.random.PRNGKey(9), (B, T), 0, CFG.vocab_size)
    lens = jnp.asarray([3, 8, 5, 1], jnp.int32)
    tokens = jnp.where(jnp.arange(T)[None] < lens[:, None], tokens, 0)
    logits, got = jax.jit(lambda p, t, c: jpp.pp_prefill_slots(p, CFG, mesh, t, lens, c))(
        params, tokens, jllama.KVCache.init(CFG, B))
    want.update(pre_logits=np.asarray(logits, np.float32), pre_lengths=np.asarray(got.lengths),
                pre_k=np.asarray(got.k, np.float32))
    inputs.update(pre_tokens=np.asarray(tokens), pre_lens=np.asarray(lens))
    np.savez(d / "inputs.npz", **inputs)
    ranks.run("pp2", 2, d)
    got = [dict(np.load(d / f"pp2_rank{r}.npz")) for r in range(2)]
    return want, got, [json.loads((d / f"raises_rank{r}.json").read_text()) for r in range(2)]


def _same_on_ranks(got, key):
    assert np.array_equal(got[0][key], got[1][key]), key
    return got[0][key]


@pytest.mark.parametrize("name", ["dec", "int8"])
def test_pp_decode_matches_single_chip(world2, name):
    """``test_pp.py::test_pp_decode_matches_single_chip`` and
    ``::test_pp_decode_int8_cache``: logits within rel 2e-2 of JAX's
    ``pp_decode_step`` and its greedy tokens, on every rank; the lengths; the
    cache (bf16 rows, or int8 words and scales) bit-equal to the port's
    one-rank ``decode_step`` from the same cache, and the rows within
    ``test_pp.py``'s tolerance of JAX's."""
    want, got, _ = world2
    assert int(got[0]["stage_layers"]) == 1
    logits = _same_on_ranks(got, f"{name}_logits")
    assert logits.shape == (B, CFG.vocab_size)
    assert _rel(logits, want[f"{name}_logits"]) < 2e-2
    assert (logits.argmax(-1) == want[f"{name}_logits"].argmax(-1)).all()
    assert _rel(logits, got[0][f"{name}_one"]) == 0.0
    assert np.array_equal(got[0][f"{name}_lengths"], want[f"{name}_lengths"])
    assert bool(got[0][f"{name}_same_as_one"]) and bool(got[1][f"{name}_same_as_one"])
    if name == "dec":
        np.testing.assert_allclose(got[0]["dec_k"], want["dec_k"], rtol=2e-2, atol=2e-2)
    else:  # int8 words: the bytes of JAX's within one step of the quantizer's rounding
        w, g = want["int8_k"].astype(np.int64), got[0]["int8_k"].astype(np.int64)
        bytes_ = lambda x: np.stack([(x >> (8 * j)) & 255 for j in range(4)])
        assert np.abs(bytes_(w) - bytes_(g)).max() <= 1


def test_pp_decode_active_mask_and_capacity(world2):
    """``test_pp.py::test_pp_decode_active_mask_and_capacity``: inactive
    slots write nothing and keep their lengths; the active slots' greedy
    tokens equal JAX's."""
    want, got, _ = world2
    active = np.asarray([True, False, True, False])
    logits = _same_on_ranks(got, "mask_logits")
    assert np.array_equal(got[0]["mask_lengths"], want["mask_lengths"])
    assert bool(got[0]["mask_same_as_one"])
    np.testing.assert_allclose(got[0]["mask_k"], want["mask_k"], rtol=2e-2, atol=2e-2)
    assert (logits[active].argmax(-1) == want["mask_logits"][active].argmax(-1)).all()
    assert _rel(logits[active], want["mask_logits"][active]) < 2e-2


@pytest.mark.parametrize("name", ["burst", "burst_mask"])
def test_pp_decode_burst_matches_sequential(world2, name):
    """``test_pp.py::test_pp_decode_burst_matches_sequential`` and
    ``::test_pp_decode_burst_inactive_and_capacity``: the software-pipelined
    burst's tokens and cache bit-equal to n of the port's ``pp_decode_step``,
    its tokens equal to JAX's ``pp_decode_burst``'s (active slots), the
    lengths equal (an inactive slot stays, a slot a position from the
    capacity advances once), the rows within ``test_pp.py``'s tolerance."""
    want, got, _ = world2
    tokens = _same_on_ranks(got, f"{name}_tokens")
    for r in range(2):
        assert np.array_equal(got[r][f"{name}_tokens"], got[r][f"{name}_seq"])
        assert bool(got[r][f"{name}_cache_same"])
    active = np.asarray([True, True, False, True] if name == "burst_mask" else [True] * B)
    assert np.array_equal(tokens[:, active], want[f"{name}_tokens"][:, active])
    assert (tokens[:, ~active] == 0).all()
    assert np.array_equal(got[0][f"{name}_lengths"], want[f"{name}_lengths"])
    if name == "burst_mask":
        assert got[0][f"{name}_lengths"].tolist() == [10, 10, 6, CFG.max_seq_len]
    np.testing.assert_allclose(got[0][f"{name}_k"], want[f"{name}_k"], rtol=2e-2, atol=2e-2)


def test_pp_prefill_matches_single_chip(world2):
    """``test_pp.py::test_pp_prefill_matches_single_chip``: ragged prompts
    into their own slots; last-token logits within rel 2e-2 of JAX's
    ``pp_prefill_slots`` with its greedy tokens; lengths; the cache bit-equal
    to the port's one-rank ``prefill_slots``, the rows within each length
    within rtol 5e-2 / atol 3e-2 of JAX's (``test_pp.py`` holds JAX's PP to
    its own one chip bit for bit; across the frameworks layer 2's rows part
    by bf16 roundings of its input, as ``test_pp_with_tp``'s do);
    the gathered stage caches feed an ordinary ``decode_step`` to the one-rank
    cache's greedy tokens."""
    want, got, _ = world2
    logits = _same_on_ranks(got, "pre_logits")
    assert _rel(logits, want["pre_logits"]) < 2e-2
    assert (logits.argmax(-1) == want["pre_logits"].argmax(-1)).all()
    assert np.array_equal(logits, got[0]["pre_one"])
    assert np.array_equal(got[0]["pre_lengths"], want["pre_lengths"])
    assert bool(got[0]["pre_same_as_one"])
    for b, n in enumerate(want["pre_lengths"]):  # JAX writes the padding rows past a length too
        np.testing.assert_allclose(got[0]["pre_k"][:, b, :, :n], want["pre_k"][:, b, :, :n],
                                   rtol=5e-2, atol=3e-2)
    assert (got[0]["pre_decode"].argmax(-1) == got[0]["pre_decode_one"].argmax(-1)).all()


def test_pp_rejects_bad_inputs(world2):
    """``test_pp.py::test_pp_rejects_bad_inputs``: a batch that does not
    split over the stages, a paged cache, a model that is not the rank's
    stage, layers that do not split over the stages.  (The JAX package's
    "needs stacked layers" is a rule of its layout: the port slices its block
    list.)"""
    _, _, msgs = world2
    for m in msgs:
        assert "divide the pipe" in m[0]
        assert "paged" in m[1]
        assert "stage_model" in m[2]
        assert "do not split" in m[3]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """``test_pp.py::test_pp_with_tp``'s case on a (pipe, model) = 2 x 2
    mesh: JAX's tp=2 tree from the tp=1 oracle's prefilled cache."""
    d = tmp_path_factory.mktemp("pp4")
    params = _params(tp=2)
    jsave_packed(params, str(d / "p2"), tp=2)
    toks, cache = _prefilled(_params(tp=1))
    np.savez(d / "inputs.npz", toks=np.asarray(toks), **_cache_arrays(cache))
    mesh = jmeshlib.make_mesh((2, 2), ("pipe", "model"))
    logits, got = _jax_step(params, mesh, toks, cache, tp_axis="model")
    want = dict(logits=np.asarray(logits, np.float32), k=np.asarray(got.k, np.float32),
                lengths=np.asarray(got.lengths))
    ranks.run("pp4", 4, d)
    return want, [dict(np.load(d / f"pp4_rank{r}.npz")) for r in range(4)]


def test_pp_with_tp(world4):
    """A stage of one layer a rank, each holding half its heads: logits
    within rel 2e-2 of JAX's and its greedy tokens on every rank; the cache
    (the ranks' layers and heads put together) within ``test_pp.py``'s
    tolerance of JAX's; a burst of 3 bit-equal to 3 steps."""
    want, got = world4
    H, Hkv = CFG.num_heads // 2, CFG.num_kv_heads // 2
    for g in got:
        assert int(g["heads"]) == H
        assert _rel(g["logits"], want["logits"]) < 2e-2
        assert (g["logits"].argmax(-1) == want["logits"].argmax(-1)).all()
        assert np.array_equal(g["lengths"], want["lengths"])
        assert np.array_equal(g["burst_tokens"], g["burst_seq"]) and bool(g["burst_cache_same"])
    # rank = pipe * 2 + model: layer `pipe`, kv heads [model Hkv, (model + 1) Hkv)
    k = np.concatenate([np.concatenate([got[2 * p + m]["k"] for m in range(2)], axis=2)
                        for p in range(2)], axis=0)
    np.testing.assert_allclose(k, want["k"], rtol=5e-2, atol=3e-2)


def test_initialize_without_a_card_raises(monkeypatch):
    """A rank started for the card (the default) on a machine whose CUDA
    runtime sees none raises before it joins a group, where it used to go on
    on the CPU; ``device="cpu"`` is what the CPU tests pass."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        multihost.initialize(init_method="file:///nonexistent/rendezvous", rank=0, world_size=1)
    with pytest.raises(ValueError, match="device"):
        multihost.initialize(rank=0, world_size=1, device="tpu")
    assert not torch.distributed.is_initialized()
