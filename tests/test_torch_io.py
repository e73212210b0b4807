"""The port's packed-checkpoint loader and cache conversion against the JAX
package: a tiny model saved by the JAX ``save_packed`` loads through the port's
``load_packed`` to the same tensors as ``params_from_numpy`` gives, the port's
own ``save_packed`` round-trips (and the JAX loader reads it), a wrong version
or tensor-parallel degree raises, and a cache prefilled by the JAX model
continues in the port (logits within rel 2e-2)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xbitops_tpu.io import checkpoint as jcheckpoint
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.formats import QTensor
from xbitops_tpu_torch.io import checkpoint
from xbitops_tpu_torch.io.convert import kvcache_from_numpy, params_from_numpy
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 128)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.fixture(scope="module")
def jax_dir(jparams, tmp_path_factory):
    path = tmp_path_factory.mktemp("packed_by_jax")
    jcheckpoint.save_packed(jparams, str(path))
    return path


def _same_state(a: llama.Llama, b: llama.Llama) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and len(sa) > 20
    for name in sa:
        assert sa[name].dtype == sb[name].dtype, name
        assert torch.equal(sa[name], sb[name]), name
    for x, y in zip(a.blocks, b.blocks):
        assert x.wqkv.meta == y.wqkv.meta
    assert a.lm_head.meta == b.lm_head.meta


def test_load_packed_reads_a_jax_checkpoint(jax_dir, model):
    tree = checkpoint.load_packed(str(jax_dir), device="cpu")
    assert isinstance(tree["lm_head"], QTensor) and len(tree["layers"]) == CFG.num_layers
    assert tree["embed"].dtype == torch.bfloat16  # from its uint16 bits
    _same_state(params_from_numpy(tree, CFG, "cpu"), model)
    _same_state(checkpoint.load_llama(str(jax_dir), CFG, device="cpu"), model)


def test_save_packed_round_trip_and_jax_reads_it(model, jparams, tmp_path):
    checkpoint.save_packed(model, str(tmp_path))
    _same_state(checkpoint.load_llama(str(tmp_path), CFG, device="cpu"), model)
    back = jcheckpoint.load_packed(str(tmp_path), to_device=False)
    want = jax.tree.map(np.asarray, jparams)
    leaves, treedef = jax.tree.flatten(back)
    want_leaves, want_def = jax.tree.flatten(want)
    assert treedef == want_def
    for got, ref in zip(leaves, want_leaves):
        assert got.dtype == ref.dtype and np.array_equal(
            got.view(np.uint8), ref.view(np.uint8))


def test_load_packed_checks_version_and_tp(jax_dir, tmp_path):
    with pytest.raises(ValueError, match="tp=1"):
        checkpoint.load_packed(str(jax_dir), device="cpu", tp=2)
    checkpoint.load_packed(str(jax_dir), device="cpu", tp=1)
    manifest = json.loads((jax_dir / "manifest.json").read_text())
    manifest["version"] = 2
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="version 2"):
        checkpoint.load_packed(str(tmp_path), device="cpu")


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16cache", "int8cache"])
def test_kvcache_from_numpy_continues_a_jax_prefill(jparams, model, quantized):
    """Prefill in the JAX package, one decode step in the port."""
    tokens = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    lens, slots = np.asarray([12, 16], np.int32), np.asarray([1, 0], np.int32)
    jcache = jllama.KVCache.init(JCFG, 2, quantized=quantized)
    jl, jcache = jax.jit(jllama.prefill_slots, static_argnums=1)(
        jparams, JCFG, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(slots), jcache)
    cache = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache.quantized == quantized and cache.S == CFG.max_seq_len
    assert cache.lengths.tolist() == [16, 12] and cache.lengths.dtype == torch.int32
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(cache, name), getattr(jcache, name)
        if want is None:
            assert got is None
        else:
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want).astype(np.float32))
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[::-1].copy()  # slot order
    jl2, _ = jax.jit(jllama.decode_step, static_argnums=1)(
        jparams, JCFG, jnp.asarray(tok), jcache)
    tl, _ = llama.decode_step(model, torch.from_numpy(tok), cache)
    want = np.asarray(jl2).astype(np.float32)
    assert np.abs(tl.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    assert cache.lengths.tolist() == [17, 13]


def test_kvcache_from_numpy_refuses_a_paged_cache():
    """A paged cache whose table does not fit it is refused; a sound one
    converts with its pools and its table."""
    jcache = jllama.KVCache.init_paged(JCFG, 1, 2, page_size=32)
    cache = kvcache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache.paged and cache.page_size == 32 and cache.S == CFG.max_seq_len
    assert cache.k.shape == tuple(jcache.k.shape) and cache.page_table.dtype == torch.int32
    assert cache.page_table.tolist() == [[-1, -1]]
    for table in (np.zeros((2, 2), np.int32), np.zeros(2, np.int32), np.full((1, 2), 2, np.int32)):
        bad = jax.tree.map(np.asarray, jcache.__class__(
            jcache.k, jcache.v, jcache.lengths, page_table=jnp.asarray(table)))
        with pytest.raises(ValueError):
            kvcache_from_numpy(bad, "cpu")


def test_dense_and_per_channel_leaves_convert_and_round_trip(tmp_path):
    """A JAX tree with dense bf16 leaves and 8-bit per-channel QTensors
    (``requantize_a8``: one scale row repeated in every K-tile) converts, and
    the port's checkpoint of it reads back to the same tensors."""
    from xbitops_tpu.ops.quantize import quantize_array as jquantize, requantize_a8 as jrequant

    jdense = jllama.init_params(jax.random.PRNGKey(1), JCFG, bits=None)
    layers = []
    for layer in jdense["layers"]:
        rq = {k: jrequant(jquantize(jnp.asarray(layer[k], jnp.float32), 4, 128))
              for k in ("wqkv", "w_down")}
        layers.append(dict(layer, **rq))  # wo and w_gateup stay dense
    jp = dict(jdense, layers=layers)
    m = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    assert isinstance(m.lm_head, llama.DenseLinear) and m.lm_head.weight.dtype == torch.bfloat16
    assert isinstance(m.blocks[0].wo, llama.DenseLinear)
    qt = m.blocks[1].w_down.qtensor
    assert qt.bits == 8 and qt.group_size == qt.K_logical == 512 and qt.groups_per_tile == 1
    assert qt.scales.shape[0] == qt.K // qt.tile_k and torch.equal(qt.scales[0], qt.scales[-1])
    checkpoint.save_packed(m, str(tmp_path))
    back = checkpoint.load_llama(str(tmp_path), CFG, device="cpu")
    sa, sb = m.state_dict(), back.state_dict()
    assert sa.keys() == sb.keys()
    assert all(sa[n].dtype == sb[n].dtype and torch.equal(sa[n], sb[n]) for n in sa)
    assert back.blocks[1].w_down.meta == m.blocks[1].w_down.meta
    tokens = torch.tensor([[5, 9, 2, 7]])
    la, _ = llama.prefill(m, tokens, llama.KVCache.init(CFG, 1, "cpu"))
    lb, _ = llama.prefill(back, tokens, llama.KVCache.init(CFG, 1, "cpu"))
    assert torch.equal(la, lb)
