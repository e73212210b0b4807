"""The port's tensor-parallel matmuls (``parallel/tp.py``) and row-sharded
packing against the JAX package (``tests/test_tp.py``'s cases, at 2 and 4
ranks where JAX runs them on 8 virtual devices).

The packing runs here, in one process: ``make_row_sharded_qtensor`` and
``quantize_array(row_shards=)`` (act-order included) give leaves bit-equal to
JAX's, ``formats.row_shard_qtensor`` repacks a packed tensor into the same
leaves, and ``concat_qtensors(order=)`` interleaves as JAX's does.  The matmuls
run in a 2-rank and a 4-rank gloo world (``tests/torch_parallel_ranks.py``:
each rank a process that imports no JAX, one torch thread), on weights each
rank quantizes from the same numpy arrays, and are held to the dequantized
oracle at ``test_tp.py``'s tolerances and to JAX's sharded matmuls on the same
inputs (jitted, on a mesh of as many virtual devices)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from tests import torch_parallel_ranks as ranks
from xbitops_tpu import formats as jformats
from xbitops_tpu.models.llama import interleave_order as jinterleave
from xbitops_tpu.parallel import mesh as jmeshlib
from xbitops_tpu.parallel import tp as jtp
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io.convert import qtensor_from_numpy
from xbitops_tpu_torch.models.llama import interleave_order
from xbitops_tpu_torch.ops.quantize import quantize_array

torch.set_num_threads(1)

NS = (2, 4)


def _np(qt):
    return qtensor_from_numpy(jax.tree.map(np.asarray, qt), "cpu")


def _same(a: formats.QTensor, b: formats.QTensor) -> None:
    assert len(a.planes) == len(b.planes)
    for x, y in zip(a.planes, b.planes):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in ("scales", "scale_zeros"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("bits", "group_size", "tile_k", "K", "K_logical", "N_logical", "value_bits"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.perm is None) == (b.perm is None)
    if a.perm is not None:
        assert torch.equal(a.perm, b.perm)


def _inputs():
    """test_tp.py's draws, case by case (numpy, float32)."""
    out = {}
    rng = np.random.default_rng(0)
    out["col_w"] = rng.standard_normal((512, 2048), dtype=np.float32) * 0.1
    out["col_a"] = rng.standard_normal((2, 512), dtype=np.float32) * 0.3
    rng = np.random.default_rng(0)
    out["row_w"] = rng.standard_normal((4096, 1024), dtype=np.float32) * 0.1
    out["row_a"] = rng.standard_normal((2, 4096), dtype=np.float32) * 0.3
    rng = np.random.default_rng(7)
    out["mis_w"] = rng.standard_normal((11008, 512), dtype=np.float32) * 0.05
    out["mis_a"] = rng.standard_normal((1, 11008), dtype=np.float32) * 0.3
    rng = np.random.default_rng(1)
    out["meg_w1"] = rng.standard_normal((512, 4096), dtype=np.float32) * 0.1
    out["meg_w2"] = rng.standard_normal((4096, 512), dtype=np.float32) * 0.1
    out["meg_a"] = rng.standard_normal((2, 512), dtype=np.float32) * 0.3
    rng = np.random.default_rng(3)
    out["act_w"] = rng.standard_normal((2048, 512), dtype=np.float32) * 0.1
    out["act_a"] = rng.standard_normal((2, 2048), dtype=np.float32) * 0.3
    rng = np.random.default_rng(2)
    out["val_w"] = rng.standard_normal((512, 1024), dtype=np.float32)
    return out


def _jax(inp, n):
    """JAX's sharded matmuls on a (1, n) mesh of virtual devices."""
    mesh = jmeshlib.make_mesh((1, n), ("data", "model"))
    J = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}

    def col(a, qt, gather):
        return jax.jit(lambda a, q: jtp.column_parallel_qmatmul(
            a, q, mesh, out_dtype=jnp.float32, gather=gather, precise=True))(a, qt)

    def row(a, qt, reduce="psum"):
        return jax.jit(lambda a, q: jtp.row_parallel_qmatmul(
            a, q, mesh, out_dtype=jnp.float32, reduce=reduce, precise=True))(a, qt)

    qt = jtp.shard_qtensor(xb.quantize_array(J["col_w"], 4, 128), mesh, col_axis="model")
    out["col"] = col(J["col_a"], qt, True)
    out["col_sharded"] = col(J["col_a"][:1], qt, False)
    qt = jtp.shard_qtensor(xb.quantize_array(J["row_w"], 4, 128, row_shards=n), mesh,
                           row_axis="model")
    for red in ("psum", "reduce_scatter"):
        out[f"row_{red}"] = row(J["row_a"], qt, red)
    qt = jtp.shard_qtensor(xb.quantize_array(J["mis_w"], 4, 128, row_shards=n), mesh,
                           row_axis="model")
    out["mis"] = row(J["mis_a"], qt)
    q1 = jtp.shard_qtensor(xb.quantize_array(J["meg_w1"], 4, 128), mesh, col_axis="model")
    q2 = jtp.shard_qtensor(xb.quantize_array(J["meg_w2"], 4, 128, row_shards=n), mesh,
                           row_axis="model")
    out["meg"] = row(col(J["meg_a"], q1, False), q2)
    qt = jtp.shard_qtensor(xb.quantize_array(J["act_w"], 4, 64, row_shards=n, act_order=True),
                           mesh, row_axis="model")
    out["act"] = row(J["act_a"], qt)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per rank count: the inputs, JAX's results, and each rank's."""
    inp = _inputs()
    res = {}
    for n in NS:
        d = tmp_path_factory.mktemp(f"tp{n}")
        cases = dict(inp, val_narrow=inp["val_w"][:, : 64 * n],
                     val_over=np.random.default_rng(5).standard_normal(
                         (128 * 2 * n, 256), dtype=np.float32))
        np.savez(d / "inputs.npz", **cases)
        ranks.run("tp_ops", n, d)
        got = [dict(np.load(d / f"tp_rank{r}.npz")) for r in range(n)]
        val = [json.loads((d / f"val_rank{r}.json").read_text()) for r in range(n)]
        res[n] = (inp, _jax(inp, n), got, val)
    return res


def _dense(w, bits, g, **kw):
    qt = quantize_array(torch.from_numpy(w), bits, g, **kw)
    return formats.dequant_qtensor_reference(qt, torch.float32).numpy()


def _shard_dense(qt):
    """Each row shard of a row-sharded QTensor dequantized, stacked on K."""
    return np.concatenate([formats.dequant_qtensor_reference(dataclasses.replace(
        qt, planes=tuple(p[i] for p in qt.planes), scales=qt.scales[i],
        scale_zeros=qt.scale_zeros[i], perm=None if qt.perm is None else qt.perm[i]),
        torch.float32).numpy() for i in range(qt.planes[0].shape[0])])


@pytest.mark.parametrize("n", NS)
def test_column_parallel(worlds, n):
    inp, want, got, _ = worlds[n]
    expect = inp["col_a"] @ _dense(inp["col_w"], 4, 128)
    for r in range(n):
        np.testing.assert_allclose(got[r]["col"], expect, rtol=1e-5, atol=3e-4)
        np.testing.assert_allclose(got[r]["col"], want["col"], rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("n", NS)
def test_column_parallel_sharded_out(worlds, n):
    """Each rank holds its columns; together they are JAX's N-sharded output."""
    inp, want, got, _ = worlds[n]
    assert all(got[r]["col_sharded"].shape == (1, 2048 // n) for r in range(n))
    out = np.concatenate([got[r]["col_sharded"] for r in range(n)], axis=1)
    expect = inp["col_a"][:1] @ _dense(inp["col_w"], 4, 128)
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=3e-4)
    np.testing.assert_allclose(out, want["col_sharded"], rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("reduce", ["psum", "reduce_scatter"])
def test_row_parallel(worlds, n, reduce):
    inp, want, got, _ = worlds[n]
    qt = quantize_array(torch.from_numpy(inp["row_w"]), 4, 128, row_shards=n)
    expect = inp["row_a"] @ _shard_dense(qt)
    if reduce == "psum":
        outs = [got[r]["row_psum"] for r in range(n)]
    else:  # each rank its columns of the sum
        outs = [np.concatenate([got[r]["row_reduce_scatter"] for r in range(n)], axis=1)]
    for out in outs:
        assert out.shape == (2, 1024)
        np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(out, want[f"row_{reduce}"], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", NS)
def test_row_parallel_misaligned_groups(worlds, n):
    """Llama-7B's down-proj K=11008, g=128: 5504 rows a shard (g'=128) at n=2,
    2752 (g'=64) at n=4; the copied scales make the sharded matmul equal the
    unsharded weight's."""
    inp, want, got, _ = worlds[n]
    assert int(got[0]["mis_group"]) == {2: 128, 4: 64}[n]
    expect = inp["mis_a"] @ _dense(inp["mis_w"], 4, 128)
    for r in range(n):
        np.testing.assert_allclose(got[r]["mis"], expect, rtol=1e-4, atol=5e-3)
        np.testing.assert_allclose(got[r]["mis"], want["mis"], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", NS)
def test_megatron_pair(worlds, n):
    """Column (sharded out) into row (sharded in): no collective between."""
    inp, want, got, _ = worlds[n]
    expect = (inp["meg_a"] @ _dense(inp["meg_w1"], 4, 128)) @ _dense(inp["meg_w2"], 4, 128)
    for r in range(n):
        np.testing.assert_allclose(got[r]["meg"], expect, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(got[r]["meg"], want["meg"], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", NS)
def test_shard_validation(worlds, n):
    """A weight not packed row-sharded, columns of fewer than 128 lanes a
    rank, and a row-sharded weight of another shard count are refused."""
    *_, val = worlds[n]
    for msgs in val:
        assert "row-sharded" in msgs[0]
        assert "lane-aligned" in msgs[1]
        assert f"{2 * n} row shards, mesh axis has {n}" in msgs[2]


@pytest.mark.parametrize("n", NS)
def test_row_parallel_act_order(worlds, n):
    """Per-shard act-order: each K-shard sorts its own rows and gathers its
    activations through its own perm, inside the rank."""
    inp, want, got, _ = worlds[n]
    qt = quantize_array(torch.from_numpy(inp["act_w"]), 4, 64, row_shards=n, act_order=True)
    expect = inp["act_a"] @ _shard_dense(qt)
    for r in range(n):
        assert got[r]["act_perm_shape"].tolist() == [n, 2048 // n]
        np.testing.assert_allclose(got[r]["act"], expect, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got[r]["act"], want["act"], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("K,N,g,n,bits,kw", [
    (512, 256, 32, 2, 4, {}),
    (2752, 384, 128, 2, 4, dict(add_zero_bias=1)),
    (11008, 256, 128, 4, 4, {}),
    (768, 200, 128, 2, 3, dict(storage_bits="auto")),
    (1024, 256, 64, 4, 8, dict(tile_k=256)),
], ids=["tiny", "odd-shard-bias", "7b-down-tp4", "3bit-auto-padN", "8bit-tile"])
def test_make_row_sharded_qtensor_bit_equal_to_jax(K, N, g, n, bits, kw):
    """Every leaf and field equal to JAX's; ``row_shard_qtensor`` of the
    unsharded packing gives the same leaves (padding rows aside where the
    zero bias fills them)."""
    rng = np.random.default_rng(K + N)
    wq = rng.integers(0, 1 << bits, (K, N)).astype(np.int32)
    G = -(-K // g)
    scales = (rng.uniform(0.002, 0.01, (G, N))).astype(np.float16)
    zeros = rng.integers(0, 1 << bits, (G, N)).astype(np.int32)
    want = _np(jformats.make_row_sharded_qtensor(
        jnp.asarray(wq), jnp.asarray(scales), jnp.asarray(zeros), bits, g, n, **kw))
    t = dict(wq=torch.from_numpy(wq), scales=torch.from_numpy(scales),
             zeros=torch.from_numpy(zeros))
    got = formats.make_row_sharded_qtensor(t["wq"], t["scales"], t["zeros"], bits, g, n, **kw)
    _same(got, want)
    assert formats.is_row_sharded(got) and got.planes[0].shape[0] == n
    if "add_zero_bias" not in kw and "tile_k" not in kw:
        plain = formats.make_qtensor(t["wq"], t["scales"], t["zeros"], bits, g,
                                     storage_bits=kw.get("storage_bits"))
        _same(formats.row_shard_qtensor(plain, n), got)


@pytest.mark.parametrize("act_order", [False, True], ids=["plain", "act_order"])
def test_quantize_array_row_shards_bit_equal_to_jax(act_order):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((1024, 256), dtype=np.float32) * 0.1
    w *= rng.uniform(0.5, 2.0, (1024, 1)).astype(np.float32)  # row saliences far apart
    want = _np(xb.quantize_array(jnp.asarray(w), 4, 128, row_shards=2, act_order=act_order))
    got = quantize_array(torch.from_numpy(w), 4, 128, row_shards=2, act_order=act_order)
    _same(got, want)
    if act_order:
        assert tuple(got.perm.shape) == (2, 512)
        assert all(sorted(p.tolist()) == list(range(512)) for p in got.perm)


@pytest.mark.parametrize("tp", [2, 4])
def test_concat_qtensors_order_equals_jax(tp):
    """q|k|v fused with the per-shard interleave: bit-equal to JAX's, and rank
    ``r``'s columns are its own q, k and v heads."""
    rng = np.random.default_rng(tp)
    sizes = (512, 256, 256)
    ws = [rng.standard_normal((256, s), dtype=np.float32) * 0.1 for s in sizes]
    jparts = [xb.quantize_array(jnp.asarray(w), 4, 64) for w in ws]
    order = interleave_order(sizes, tp)
    assert order.tolist() == np.asarray(jinterleave(sizes, tp)).tolist()
    got = formats.concat_qtensors([_np(p) for p in jparts], order=order)
    _same(got, _np(jformats.concat_qtensors(jparts, order=jinterleave(sizes, tp))))
    dense = formats.dequant_qtensor_reference(got, torch.float32).numpy()
    full = np.concatenate([formats.dequant_qtensor_reference(_np(p), torch.float32).numpy()
                           for p in jparts], axis=1)
    w = sum(sizes) // tp
    for r in range(tp):
        own = np.concatenate([full[:, off + r * s // tp: off + (r + 1) * s // tp]
                              for off, s in zip(np.cumsum((0,) + sizes[:-1]), sizes)], axis=1)
        np.testing.assert_array_equal(dense[:, r * w: (r + 1) * w], own)
    with pytest.raises(ValueError, match="permutation"):
        formats.concat_qtensors([_np(p) for p in jparts], order=order[:-1])


def test_concat_qtensors_keeps_a_shared_row_order():
    """An act-order tensor's columns reordered (``pack_for_tp`` of a fused
    act-order q|k|v) keep its row permutation: the dequantized weight is the
    original's columns in ``order``.  Parts with other row orders are
    refused."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((256, 512), dtype=np.float32) * 0.1)
    qt = quantize_array(w, 4, 32, act_order=True)
    order = interleave_order((256, 128, 128), 2)
    got = formats.concat_qtensors([qt], order=order)
    assert got.perm is not None and torch.equal(got.perm, qt.perm)
    np.testing.assert_array_equal(
        formats.dequant_qtensor_reference(got, torch.float32).numpy(),
        formats.dequant_qtensor_reference(qt, torch.float32).numpy()[:, order])
    other = quantize_array(torch.flip(w, (0,)), 4, 32, act_order=True)
    assert not torch.equal(other.perm, qt.perm)
    with pytest.raises(ValueError, match="row orders"):
        formats.concat_qtensors([qt, other])
