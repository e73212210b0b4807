"""The port's loaders at ``tp=2`` against the JAX package's
(``tests/test_io.py:148, 251, 338``), on the JAX tests' own AutoGPTQ
checkpoints.

Held here, in one process: ``load_autogptq(tp=2)`` equal, tensor by tensor and
bit for bit, to the JAX loader's tree carried across by ``params_from_numpy``
(row-sharded o_proj and down_proj, fused columns interleaved, the desc_act
checkpoint's folded down_proj and gathered o_proj), each row shard dequantized
equal to the unsharded rows; a Mixtral checkpoint at ``tp=2`` raises as JAX's
loader does; a tp=2 packed directory written by either package read by the
other (equal trees), and a wrong ``tp`` refused.  In a 2-rank gloo world
(``tests/torch_parallel_ranks.py``: each rank a process that imports no JAX):
the desc_act checkpoint's sharded prefill within rel 2e-2 of JAX's sharded
prefill and of the port's one-rank logits, the gathered path taken by o_proj
only, and the two packed directories' sharded prefills equal."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_io import DVOCAB, ckpt_dir, desc_ckpt_dir, mixtral_ckpt_dir  # noqa: F401
from xbitops_tpu.io import gptq_loader as jloader
from xbitops_tpu.io.checkpoint import load_packed as jload_packed
from xbitops_tpu.io.checkpoint import save_packed as jsave_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu.parallel import mesh as jmeshlib
from xbitops_tpu.parallel import model_tp as jmodel_tp
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io import load_autogptq, save_packed
from xbitops_tpu_torch.io.checkpoint import load_llama
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama

torch.set_num_threads(1)


def _same_model(a: llama.Llama, b: llama.Llama) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        if sa[name] is None or sb[name] is None:
            assert sa[name] is None and sb[name] is None, name
            continue
        assert sa[name].dtype == sb[name].dtype and torch.equal(sa[name], sb[name]), name
    ma, mb = dict(a.named_modules()), dict(b.named_modules())
    for name in ma:
        assert getattr(ma[name], "meta", None) == getattr(mb[name], "meta", None), name


def _from_jax(path, **kw):
    """JAX's tp=2 tree and config, and the tree carried into the port."""
    params, jcfg = jloader.load_autogptq(str(path), tp=2, **kw)
    cfg = llama.LlamaConfig(**dataclasses.asdict(jcfg))
    return params, jcfg, params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu"), cfg


def _shard(qt: formats.QTensor, s: int) -> formats.QTensor:
    return dataclasses.replace(qt, planes=tuple(p[s] for p in qt.planes), scales=qt.scales[s],
                               scale_zeros=qt.scale_zeros[s],
                               perm=None if qt.perm is None else qt.perm[s])


def test_load_autogptq_tp_equals_jax(ckpt_dir):  # noqa: F811
    d, _ = ckpt_dir
    _, _, want, cfg = _from_jax(d)
    got, gcfg = load_autogptq(str(d), tp=2, device="cpu")
    assert gcfg == cfg
    _same_model(got, want)
    b0 = got.blocks[0]
    assert formats.is_row_sharded(b0.wo.qtensor) and formats.is_row_sharded(b0.w_down.qtensor)
    assert not formats.is_row_sharded(b0.wqkv.qtensor)
    whole = formats.dequant_qtensor_reference(
        load_autogptq(str(d), device="cpu")[0].blocks[0].wo.qtensor, torch.float32)
    qt = b0.wo.qtensor
    Ks = qt.K_logical
    for s in range(2):
        shard = formats.dequant_qtensor_reference(_shard(qt, s), torch.float32)
        torch.testing.assert_close(shard, whole[s * Ks: (s + 1) * Ks], rtol=0, atol=1e-6)


def test_mixtral_tp2_raises_as_jax(mixtral_ckpt_dir):  # noqa: F811
    with pytest.raises(NotImplementedError, match="EXPERT"):
        jloader.load_autogptq(str(mixtral_ckpt_dir), tp=2)
    with pytest.raises(NotImplementedError, match="EXPERT"):
        load_autogptq(str(mixtral_ckpt_dir), tp=2, device="cpu")


def test_packed_tp2_round_trip_both_ways(ckpt_dir, tmp_path):  # noqa: F811
    """JAX's tp=2 directory read by the port, the port's read by JAX."""
    d, _ = ckpt_dir
    jparams, _, want, cfg = _from_jax(d)
    jsave_packed(jparams, str(tmp_path / "jax"), tp=2)
    _same_model(load_llama(str(tmp_path / "jax"), cfg, "cpu", tp=2), want)
    with pytest.raises(ValueError, match="tp=2"):
        load_llama(str(tmp_path / "jax"), cfg, "cpu")
    save_packed(want, str(tmp_path / "port"), tp=2)
    back = jload_packed(str(tmp_path / "port"), tp=2)
    la, ta = jax.tree_util.tree_flatten(jparams)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError):
        jload_packed(str(tmp_path / "port"), tp=1)


@pytest.fixture(scope="module")
def world2(desc_ckpt_dir, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("tp_io")
    (d / "desc_ckpt").symlink_to(desc_ckpt_dir)
    jparams, jcfg, model, cfg = _from_jax(desc_ckpt_dir, max_seq_len=32)
    jsave_packed(jparams, str(d / "jax_tp2"), tp=2)
    save_packed(model, str(d / "port_tp2"), tp=2)
    B, T = 2, 5
    tokens = jax.random.randint(jax.random.PRNGKey(4), (B, T), 0, DVOCAB)
    mesh = jmeshlib.make_mesh((1, 2), ("data", "model"))
    logits, _ = jax.jit(lambda p, t, c: jmodel_tp.tp_prefill(p, jcfg, mesh, t, c))(
        jmodel_tp.shard_params(jparams, mesh), tokens,
        jmodel_tp.shard_cache(jllama.KVCache.init(jcfg, B), mesh))
    one, _ = load_autogptq(str(desc_ckpt_dir), max_seq_len=32, device="cpu")
    ref, _ = llama.prefill(one, torch.from_numpy(np.array(tokens)).long(),
                           llama.KVCache.init(cfg, B, "cpu"))
    np.savez(d / "inputs.npz", desc_tokens=np.asarray(tokens))
    ranks.run("io_tp2", 2, d)
    got = [dict(np.load(d / f"io_rank{r}.npz")) for r in range(2)]
    return (np.asarray(logits, np.float32), ref.float().numpy(), got,
            json.loads((d / "roles.json").read_text()))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_load_autogptq_desc_act_tp(desc_ckpt_dir, world2):  # noqa: F811
    """desc_act on every linear at tp=2: the down_proj fold (row-sharded, no
    perm) and the gathered o_proj (whole, runtime perm, column-sharded on a
    rank) through the sharded forward."""
    *_, model, _ = _from_jax(desc_ckpt_dir, max_seq_len=32)
    l0 = model.blocks[0]
    assert formats.is_row_sharded(l0.w_down.qtensor) and l0.w_down.qtensor.perm is None
    assert not formats.is_row_sharded(l0.wo.qtensor) and l0.wo.qtensor.perm is not None
    got_model, _ = load_autogptq(str(desc_ckpt_dir), tp=2, max_seq_len=32, device="cpu")
    _same_model(got_model, model)
    want, one, got, roles = world2
    assert roles == {"wo": "row_gathered", "w_down": "row"}
    for r in range(2):
        assert _rel(got[r]["desc"], want) < 2e-2, r
        assert _rel(got[r]["desc"], one) < 2e-2, r


def test_packed_tp2_directories_serve_alike(world2):
    """The JAX-written and the port-written tp=2 directories give the ranks
    the same weights: equal sharded prefills, equal to the loader's."""
    *_, got, _ = world2
    for r in range(2):
        np.testing.assert_array_equal(got[r]["jax_dir"], got[r]["port_dir"])
        np.testing.assert_array_equal(got[r]["jax_dir"], got[r]["desc"])
