"""The port's tensor-parallel model and cache, and its expert parallelism,
against the JAX package on the tiny configs (``tests/test_llama.py``,
``tests/test_multihost.py``, ``tests/test_moe.py``; the engine is in
``tests/test_torch_engine_tp.py``).

The JAX package writes its own tp=2 trees (``init_params(tp=2)``: row-sharded
wo and w_down, fused columns interleaved; stacked and act-order ones too) as
packed directories; the port's ranks read them (``load_llama(tp=2)``, which
goes through ``params_from_numpy``) in one 2-rank and one 4-rank gloo world
(``tests/torch_parallel_ranks.py``: each rank a process that imports no JAX,
one torch thread).  Held: the sharded prefill logits within rel 2e-2 of
JAX's ``tp_prefill`` on the same trees, on every rank, and the next decode
step's within rel 2e-2 of JAX's ``tp_decode_step`` (finite on the others, as
JAX's own tests hold them); the one-slot admissions ``tp_prefill_slot`` and
``tp_prefill_slot_chunk`` within rel 2e-2 of JAX's; ``pack_for_tp`` of the port's own tp=1 models
(split, fused, fused act-order) within rel 2e-2 of those models; a dp x tp =
2 x 2 mesh's logits within rel 2e-2 of
JAX's; expert parallelism over 4 ranks against one rank (prefill logits rtol
5e-2, decode argmax equal, as ``test_moe.py``) and within rel 2e-2 of JAX's
``ep_prefill_slots``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from xbitops_tpu.io.checkpoint import save_packed as jsave_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.models import moe as jmoe
from xbitops_tpu.parallel import mesh as jmeshlib
from xbitops_tpu.parallel import model_tp as jmodel_tp

torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
POD = jllama.LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                         num_layers=1, num_heads=4, num_kv_heads=4, head_dim=128, max_seq_len=16)

# name -> (init key, tokens key, T, init_params options, stacked)
TREES = {
    "q8": (0, 4, 5, {}, False),
    "fused": (9, 10, 4, {}, False),
    "stacked": (12, 13, 4, {}, True),
    "act": (11, 12, 4, dict(act_order=True), False),
}

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())

def _jax_tp(params, cfg, mesh, tokens, data_axis=None, decode=True):
    """JAX's sharded prefill, its greedy next tokens and the decode step's
    logits (each jitted: one compile, where the eager shard_map interprets
    every Pallas call)."""
    cache = jllama.KVCache.init(cfg, tokens.shape[0])
    if data_axis is None:
        cache = jmodel_tp.shard_cache(cache, mesh)
    else:
        cache = jax.tree.map(
            lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)), cache,
            jmodel_tp.cache_pspecs("model", data_axis))
    ps = jmodel_tp.shard_params(params, mesh)
    logits, cache = jax.jit(lambda p, t, c: jmodel_tp.tp_prefill(
        p, cfg, mesh, t, c, data_axis=data_axis))(ps, tokens, cache)
    nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    if not decode:
        return np.asarray(logits, np.float32), np.asarray(nxt), None
    step, _ = jax.jit(lambda p, t, c: jmodel_tp.tp_decode_step(
        p, cfg, mesh, t, c, data_axis=data_axis))(ps, nxt, cache)
    return np.asarray(logits, np.float32), np.asarray(nxt), np.asarray(step, np.float32)

def _jax_slot(params, mesh, inputs):
    """JAX's one-slot forms, jitted: a prompt of 6 (padded to 8) into slot 1
    by ``tp_prefill_slot``; one of 12 into slot 0 in chunks of 8 by
    ``tp_prefill_slot_chunk``.  Their last-token logits."""
    ps = jmodel_tp.shard_params(params, mesh)
    toks = jax.random.randint(jax.random.PRNGKey(21), (20,), 0, JCFG.vocab_size)
    inputs["slot_tokens"] = np.asarray(jnp.where(jnp.arange(8) < 6, toks[:8], 0))
    inputs["chunk_tokens"] = np.asarray(jnp.where(jnp.arange(16) < 12, toks[4:], 0))
    cache = jmodel_tp.shard_cache(jllama.KVCache.init(JCFG, 2), mesh)
    slot, _ = jax.jit(lambda p, t, c: jmodel_tp.tp_prefill_slot(p, JCFG, mesh, t, 6, 1, c))(
        ps, jnp.asarray(inputs["slot_tokens"]), cache)
    chunk = jax.jit(lambda p, t, s, r, c: jmodel_tp.tp_prefill_slot_chunk(
        p, JCFG, mesh, t, s, 12, 0, c, reset=r))
    for start in (0, 8):
        logits, cache = chunk(ps, jnp.asarray(inputs["chunk_tokens"][start:start + 8]), start,
                              start == 0, cache)
    return {"slot": np.asarray(slot, np.float32), "slot_chunk": np.asarray(logits, np.float32)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """JAX's results, then the 2-rank world's."""
    d = tmp_path_factory.mktemp("model_tp2")
    mesh = jmeshlib.make_mesh((1, 2), ("data", "model"))
    inputs, want = {}, {}
    for name, (key, tkey, T, kw, stacked) in TREES.items():
        params = jllama.init_params(jax.random.PRNGKey(key), JCFG, bits=8, group_size=32, tp=2,
                                    **kw)
        if stacked:
            params = jllama.stack_layers(params)
        tokens = jax.random.randint(jax.random.PRNGKey(tkey), (2, T), 0, JCFG.vocab_size)
        jsave_packed(params, str(d / name), tp=2)
        # JAX's decode step on the first tree only, as tests/test_llama.py
        want[f"{name}_prefill"], inputs[f"{name}_next"], want[f"{name}_decode"] = _jax_tp(
            params, JCFG, mesh, tokens, decode=name == "q8")
        inputs[f"{name}_tokens"] = np.asarray(tokens)
        if name == "q8":
            want.update(_jax_slot(params, mesh, inputs))
    np.savez(d / "inputs.npz", **inputs)
    ranks.run("model_tp2", 2, d)
    return want, [dict(np.load(d / f"model_rank{r}.npz")) for r in range(2)]

@pytest.mark.parametrize("name", list(TREES))
def test_tp_logits_match_jax(world2, name):
    """``test_llama.py``'s TP cases (:72 plain, :124 fused, :165 stacked, :265
    act-order): the port's sharded prefill and next decode step on JAX's tp=2
    tree, every rank, against JAX's sharded forward on the same tree."""
    want, got = world2
    for r in range(2):
        for step in ("prefill", "decode"):
            g = got[r][f"{name}_{step}"]
            assert np.isfinite(g).all() and g.shape[0] == 2 and g.shape[-1] == JCFG.vocab_size
            if want[f"{name}_{step}"] is not None:
                assert g.shape == want[f"{name}_{step}"].shape
                assert _rel(g, want[f"{name}_{step}"]) < 2e-2, (name, step, r)
        T = want[f"{name}_prefill"].shape[1]
        assert got[r][f"{name}_lengths"].tolist() == [T + 1, T + 1]  # the decode step wrote
    assert np.array_equal(got[0][f"{name}_prefill"], got[1][f"{name}_prefill"])

@pytest.mark.parametrize("name", ["slot", "slot_chunk"])
def test_tp_prefill_slot_matches_jax(world2, name):
    """``model_tp.tp_prefill_slot`` and ``tp_prefill_slot_chunk`` (the
    one-slot forms of the batched admissions) on JAX's tp=2 q8 tree: the
    last-token logits [V] on every rank within rel 2e-2 of JAX's functions'."""
    want, got = world2
    for r in range(2):
        assert got[r][name].shape == (JCFG.vocab_size,)
        assert _rel(got[r][name], want[name]) < 2e-2, (name, r)


@pytest.mark.parametrize("name", list(ranks.PACKED))
def test_pack_for_tp_matches_tp1(world2, name):
    """``pack_for_tp`` of a port tp=1 model (split; fused; fused act-order,
    whose fused columns keep their row order), then ``shard_params`` at tp=2:
    the sharded prefill logits within rel 2e-2 of the tp=1 model's, on every
    rank."""
    _, got = world2
    assert bool(got[0][f"pack_{name}_perm"]) == (name == "act")
    for r in range(2):
        one, tp = got[r][f"pack_{name}_one"], got[r][f"pack_{name}_tp"]
        assert np.isfinite(tp).all() and tp.shape == one.shape
        assert _rel(tp, one) < 2e-2, (name, r, _rel(tp, one))

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_tp4")
    inputs, want = {}, {}
    pod = jllama.init_params(jax.random.PRNGKey(0), POD, bits=8, group_size=32, tp=2)
    jsave_packed(pod, str(d / "pod"), tp=2)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 3), 0, POD.vocab_size)
    want["pod_prefill"], inputs["pod_next"], want["pod_decode"] = _jax_tp(
        pod, POD, jmeshlib.make_mesh((2, 2), ("data", "model")), tokens, data_axis="data")
    inputs["pod_tokens"] = np.asarray(tokens)

    mcfg = jmoe.MoeConfig.tiny_moe()
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), mcfg, bits=4, group_size=32)
    jsave_packed(params, str(d / "moe"))
    B, T = 2, 5
    tokens = jax.random.randint(jax.random.PRNGKey(7), (B, T), 0, mcfg.vocab_size)
    lens = jnp.full((B,), T, jnp.int32)
    emesh = jmeshlib.make_mesh((4,), ("expert",))
    one, _ = jax.jit(lambda p, t, c: jllama.prefill_slots(p, mcfg, t, lens, jnp.arange(B), c))(
        params, tokens, jllama.KVCache.init(mcfg, B))
    ep, _ = jax.jit(lambda p, t, c: jmoe.ep_prefill_slots(p, mcfg, emesh, t, lens, jnp.arange(B),
                                                          c))(
        params, tokens, jllama.KVCache.init(mcfg, B))
    want["moe_one"], want["moe_ep"] = np.asarray(one, np.float32), np.asarray(ep, np.float32)
    inputs["moe_tokens"] = np.asarray(tokens)
    inputs["moe_next"] = np.asarray(jnp.argmax(one, -1), np.int32)
    np.savez(d / "inputs.npz", **inputs)
    ranks.run("model_tp4", 4, d)
    return want, [dict(np.load(d / f"model4_rank{r}.npz")) for r in range(4)]

def test_pod_mesh_dp_tp_matches_jax(world4):
    """``test_multihost.py:20`` at dp x tp = 2 x 2: each data replica holds
    its 2 slots and its kv heads; the gathered logits of the prefill and of
    the next decode step match JAX's on every rank."""
    want, got = world4
    for r in range(4):
        assert got[r]["pod_shape"].tolist() == [2, 2]
        assert got[r]["pod_cache_shape"].tolist() == [1, 2, 2, POD.max_seq_len, 128]
        for step in ("prefill", "decode"):
            assert _rel(got[r][f"pod_{step}"], want[f"pod_{step}"]) < 2e-2, (step, r)

def test_expert_parallel_matches_one_rank(world4):
    """``test_moe.py:178``: 4 experts over 4 ranks, one a rank."""
    want, got = world4
    for r in range(4):
        g = got[r]
        assert int(g["ep_experts"]) == 1
        np.testing.assert_allclose(g["ep_prefill"], g["one_prefill"], rtol=5e-2, atol=5e-2)
        assert (g["ep_decode"].argmax(-1) == g["one_decode"].argmax(-1)).all()
        np.testing.assert_allclose(g["ep_k"], g["one_k"], rtol=5e-2, atol=3e-2)
        assert _rel(g["ep_prefill"], want["moe_ep"]) < 2e-2
        assert _rel(g["one_prefill"], want["moe_one"]) < 2e-2
