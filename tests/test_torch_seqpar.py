"""The port's sequence parallelism (``parallel/seqpar.py``) against the JAX
package's (``tests/test_seqpar.py``'s cases) on the tiny config.

The JAX package draws the inputs and trees (``test_seqpar.py``'s keys) and
runs its ``ring_attention`` and ``sp_prefill`` (jitted) on a mesh of as many
virtual devices as the port has ranks: ``seq`` = 4, and (seq, model) = 2 x 2
where ``test_seqpar.py`` runs (4, 2).  The port runs the same cases in one
4-rank gloo world (``tests/torch_parallel_ranks.py``: each rank a process that
imports no JAX, one torch thread), each rank on its chunk of the sequence.
Held: ring attention within rtol / atol 1e-5 of JAX's and of a dense f32
oracle, on f32 inputs; ``sp_prefill``'s last-token logits within rel 2e-2 of
JAX's ``sp_prefill`` and of the port's one-rank ``prefill``, the same greedy
tokens; the cache rows within ``test_seqpar.py``'s rtol 5e-2 / atol 3e-2 of
JAX's; one ordinary greedy decode step from the cache equal to one from the
one-rank prefill's; the raises."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from xbitops_tpu.io.checkpoint import save_packed as jsave_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.parallel import mesh as jmeshlib
from xbitops_tpu.parallel import seqpar as jseqpar

torch.set_num_threads(1)

CFG = jllama.LlamaConfig.tiny(seq=64)
SP = 4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _oracle(q, k, v, q_pos, kv_pos, window=None):
    """Dense attention over global positions in f64 (numpy)."""
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2).astype(np.float64), np.repeat(v, rep, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bqhk", q.astype(np.float64), k) * q.shape[-1] ** -0.5
    vis = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        vis &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    s = np.where(vis[:, :, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bqhk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


# name -> (B, T, H, Hkv, D, reversed kv positions, window): test_seqpar.py's shapes
RINGS = {"rep1": (2, 64, 2, 2, 64, False, 0), "rep2": (2, 64, 4, 2, 64, False, 0),
         "reversed": (1, 16, 2, 2, 32, True, 0), "window": (2, 64, 4, 2, 64, False, 20)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's results, then the 4-rank world's."""
    d = tmp_path_factory.mktemp("seq4")
    seq = jmeshlib.make_mesh((SP,), ("seq",))
    sp_tp = jmeshlib.make_mesh((2, 2), ("seq", "model"))
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    for name, (B, T, H, Hkv, D, rev, window) in RINGS.items():
        q = rng.standard_normal((B, T, H, D), np.float32)
        k, v = (rng.standard_normal((B, T, Hkv, D), np.float32) * 0.3 for _ in range(2))
        q_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
        kv_pos = q_pos[:, ::-1].copy() if rev else q_pos
        got = jax.jit(lambda *a: jseqpar.ring_attention(*a, seq, axis="seq",
                                                        window=window or None))(
            q, k, v, q_pos, kv_pos)
        want[f"ring_{name}"] = np.asarray(got)
        want[f"oracle_{name}"] = _oracle(q, k, v, q_pos, kv_pos, window or None)
        inputs.update({f"{name}_q": q, f"{name}_k": k, f"{name}_v": v, f"{name}_q_pos": q_pos,
                       f"{name}_kv_pos": kv_pos, f"{name}_window": np.asarray(window)})

    plain = jllama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    wcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), sliding_window=8)
    trees = {  # name -> (params, cfg, mesh, tp axis, tokens key)
        "plain": (plain, CFG, seq, None, 7),
        "stacked": (jllama.stack_layers(plain), CFG, seq, None, 7),
        "window": (jllama.init_params(jax.random.PRNGKey(4), wcfg, bits=8, group_size=32), wcfg,
                   seq, None, 5),
        "tp": (jllama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32, tp=2), CFG,
               sp_tp, "model", 7),
    }
    for name, (params, cfg, mesh, tp_axis, key) in trees.items():
        path, _, tp = ranks.SP_TREES[name]
        jsave_packed(params, str(d / path), tp=tp)
        tokens = jax.random.randint(jax.random.PRNGKey(key), (2, 32), 0, cfg.vocab_size)
        logits, cache = jax.jit(lambda p, t, c: jseqpar.sp_prefill(
            p, cfg, mesh, t, c, seq_axis="seq", tp_axis=tp_axis))(
            params, tokens, jllama.KVCache.init(cfg, 2))
        want[f"{name}_logits"] = np.asarray(logits, np.float32)
        want[f"{name}_k"] = np.asarray(cache.k, np.float32)
        want[f"{name}_v"] = np.asarray(cache.v, np.float32)
        inputs[f"{name}_tokens"] = np.asarray(tokens)
    np.savez(d / "inputs.npz", **inputs)
    ranks.run("seq4", SP, d)
    got = [dict(np.load(d / f"seq4_rank{r}.npz")) for r in range(SP)]
    return want, got, [json.loads((d / f"raises_rank{r}.json").read_text()) for r in range(SP)]


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_attention_matches_dense(world, name):
    """``test_seqpar.py::test_ring_attention_matches_dense`` (rep 1 and 2),
    ``::test_ring_attention_respects_positions`` (kv positions reversed: the
    early queries' keys sit on the last rank) and
    ``::test_ring_attention_sliding_window``: the ranks' chunks put together
    within rtol / atol 1e-5 of JAX's ring attention and of the dense oracle,
    in f32."""
    want, got, _ = world
    out = np.concatenate([g[f"ring_{name}"] for g in got], axis=1)
    np.testing.assert_allclose(out, want[f"ring_{name}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, want[f"oracle_{name}"], rtol=1e-5, atol=1e-5)


def _heads(got, key, tp):
    """A cache field of every rank: whole, or at tp=2 (rank = seq * 2 +
    model) the two model ranks' kv heads put together."""
    if tp == 1:
        for g in got[1:]:
            assert np.array_equal(g[key], got[0][key]), key
        return got[0][key]
    for r in range(2, len(got)):
        assert np.array_equal(got[r][key], got[r % 2][key]), key
    return np.concatenate([got[0][key], got[1][key]], axis=2)


@pytest.mark.parametrize("name", list(ranks.SP_TREES))
def test_sp_prefill_matches_dense(world, name):
    """``test_seqpar.py::test_sp_prefill_matches_dense``, ``::_stacked_layers``
    (JAX's stacked tree, which the loader unstacks), ``::_with_tp`` ((seq,
    model) = 2 x 2) and ``::test_sp_prefill_sliding_window`` (window 8, 8-bit):
    the last-token logits on every rank within rel 2e-2 of JAX's
    ``sp_prefill`` and of the port's one-rank ``prefill`` with their greedy
    tokens; lengths T; the cache rows within rtol 5e-2 / atol 3e-2 of JAX's;
    the next greedy decode step from the cache equal to the one from the
    one-rank prefill's cache (at tp=2: ``tp_decode_step``, equal to the tp=1
    model's from its own ``sp_prefill``)."""
    want, got, _ = world
    tp = ranks.SP_TREES[name][2]
    T = 32
    for g in got:
        logits = g[f"{name}_logits"]
        assert logits.shape == (2, CFG.vocab_size)
        assert _rel(logits, want[f"{name}_logits"]) < 2e-2
        assert (logits.argmax(-1) == want[f"{name}_logits"].argmax(-1)).all()
        assert g[f"{name}_lengths"].tolist() == [T, T]
        if tp == 1:
            assert _rel(logits, g[f"{name}_one"]) < 2e-2
            assert (logits.argmax(-1) == g[f"{name}_one"].argmax(-1)).all()
            assert (g[f"{name}_decode"].argmax(-1) == g[f"{name}_one_decode"].argmax(-1)).all()
        else:  # the same logical model as "plain", one rank's heads each
            assert (g["tp_decode"].argmax(-1) == g["plain_decode"].argmax(-1)).all()
            assert _rel(g["tp_decode"], g["plain_decode"]) < 2e-2
    for f in ("k", "v"):
        np.testing.assert_allclose(_heads(got, f"{name}_{f}", tp)[:, :, :, :T],
                                   want[f"{name}_{f}"][:, :, :, :T], rtol=5e-2, atol=3e-2)


def test_sp_prefill_rejects_bad_shapes(world):
    """``test_seqpar.py::test_sp_prefill_rejects_bad_shapes``: T that does not
    split over the seq axis, a quantized cache; and a paged cache, T past the
    cache's capacity."""
    _, _, msgs = world
    for m in msgs:
        assert "divide the seq axis" in m[0]
        assert "dense caches" in m[1] and "dense caches" in m[2]
        assert "exceeds cache capacity" in m[3]
