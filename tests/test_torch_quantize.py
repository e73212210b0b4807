"""The port's quantizer and packers against the JAX package's, on the same
numpy inputs: ``quantize_array``, ``make_qtensor``, ``from_gptq`` and
``requantize_a8`` give planes, scales, scale-zeros, ``perm`` and metadata EQUAL
to the JAX ones after ``io.convert.qtensor_from_numpy`` (both compute the
scales, zeros and q in f32 with the same operations, round scales through fp16
first, and sort act-order rows with a stable sort).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from xbitops_tpu import formats as jformats
import xbitops_tpu_torch as xt
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io.convert import qtensor_from_numpy
from xbitops_tpu_torch.kernels.qgemv_kernel import a8_per_channel

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

META = ("bits", "group_size", "tile_k", "K", "K_logical", "N_logical", "value_bits")


def assert_same_qtensor(qt, jqt):
    want = qtensor_from_numpy(jax.tree.map(np.asarray, jqt), "cpu")
    for f in META:
        assert getattr(qt, f) == getattr(want, f), f
    assert len(qt.planes) == len(want.planes)
    for got, exp in zip(qt.planes, want.planes):
        assert got.dtype == torch.int32 and torch.equal(got, exp)
    for got, exp in ((qt.scales, want.scales), (qt.scale_zeros, want.scale_zeros)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
    assert (qt.perm is None) == (want.perm is None)
    if qt.perm is not None:
        assert qt.perm.dtype == torch.int64 and torch.equal(qt.perm, want.perm)


def _w(K, N, seed, scale=0.1):
    """Rows of distinct magnitudes: the saliences (f32 row sums of |w|, which
    the two frameworks add in different orders) then differ by far more than
    a sum's rounding, so act-order sorts the rows alike in both."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(np.linspace(0.5, 1.5, K, dtype=np.float32))
    return rng.standard_normal((K, N), dtype=np.float32) * scale * rows[:, None]


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("kw", [dict(), dict(sym=True), dict(act_order=True),
                                dict(storage_bits="auto")], ids=lambda d: "-".join(d) or "asym")
def test_quantize_array_matches_jax(bits, kw):
    w = _w(256, 256, bits)
    jqt = xb.quantize_array(jnp.asarray(w), bits, 64, **kw)
    assert_same_qtensor(xt.quantize_array(torch.from_numpy(w), bits, 64, **kw), jqt)


@pytest.mark.parametrize("K,N,g,kw", [
    (200, 200, 128, dict(act_order=True)),  # K pads to the tile, N to 128 lanes
    (200, 128, 50, dict()),  # an odd group: lcm tile, slot layout
    (512, 128, 256, dict(tile_k=64)),  # a group longer than the tile
    (256, 128, 64, dict(scale_store_dtype="f32")),
    (256, 128, 64, dict(scale_round_dtype="bf16", scale_store_dtype="f32")),
    (256, 128, 64, dict(storage_bits=8)),
], ids=["pad-K-N-act-order", "odd-group", "group-gt-tile", "f32-store", "bf16-round", "store-8"])
def test_quantize_array_shapes_and_options_match_jax(K, N, g, kw):
    w = _w(K, N, K + g)
    names = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    jkw = {k: names[v][0] if v in names else v for k, v in kw.items()}
    tkw = {k: names[v][1] if v in names else v for k, v in kw.items()}
    jqt = xb.quantize_array(jnp.asarray(w), 4, g, **jkw)
    assert_same_qtensor(xt.quantize_array(torch.from_numpy(w), 4, g, **tkw), jqt)


def test_quantize_array_row_shards_wait_for_parallel():
    """Row-sharded packing is ported (``parallel/``): leaves equal to JAX's,
    a leading shard axis; a K that does not split raises as JAX's does."""
    w = _w(256, 128, 7)
    jqt = xb.quantize_array(jnp.asarray(w), 4, 64, row_shards=2)
    got = xt.quantize_array(torch.from_numpy(w), 4, 64, row_shards=2)
    assert got.planes[0].shape[0] == 2
    assert_same_qtensor(got, jqt)
    with pytest.raises(ValueError):
        xt.quantize_array(torch.zeros(258, 128), 4, 64, row_shards=4)


@pytest.mark.parametrize("bits", [3, 4, 8])
@pytest.mark.parametrize("sym", [False, True])
def test_numpy_quantize_and_gptq_pack_match_jax(bits, sym):
    w = _w(192, 96, bits)  # 192 * 3 bits: values straddle words
    got, want = formats.quantize(w, bits, 64, sym=sym), jformats.quantize(w, bits, 64, sym=sym)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(formats.gptq_pack(*got, bits), jformats.gptq_pack(*want, bits)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits,kw", [
    (4, dict()), (3, dict()), (7, dict(storage_bits="auto")), (4, dict(add_zero_bias=1)),
    (4, dict(g_idx=True)), (4, dict(g_idx=True, fold_perm=True)), (5, dict(col_perm=True)),
    (8, dict(scales="bf16")), (2, dict(tile_k=128)),
], ids=["4", "3", "7-auto", "zero-bias", "g_idx", "fold-perm", "col-perm", "bf16-scales", "tile"])
def test_from_gptq_matches_jax(bits, kw):
    K, N, g = 256, 160, 64
    rng = np.random.default_rng(bits)
    kw = dict(kw)
    wq, scales, zeros = formats.quantize(_w(K, N, bits), bits, g)
    qweight, s16, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    js, ts = jnp.asarray(s16), torch.from_numpy(s16)
    if kw.pop("scales", None) == "bf16":  # a bf16 checkpoint: scales store as f32
        js, ts = js.astype(jnp.bfloat16), ts.to(torch.bfloat16)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("g_idx"):
        g_idx = rng.permutation(np.arange(K) // g).astype(np.int32)
        jkw["g_idx"], tkw["g_idx"] = jnp.asarray(g_idx), torch.from_numpy(g_idx)
    if kw.get("col_perm"):
        cp = rng.permutation(N).astype(np.int32)
        jkw["col_perm"], tkw["col_perm"] = jnp.asarray(cp), torch.from_numpy(cp)
    jqt = jformats.from_gptq(jnp.asarray(qweight), js, jnp.asarray(qzeros), bits, g, K, **jkw)
    qt = formats.from_gptq(torch.from_numpy(qweight), ts, torch.from_numpy(qzeros), bits, g, K,
                           **tkw)
    assert_same_qtensor(qt, jqt)


def test_make_qtensor_f32_source_and_errors():
    K, N, g = 128, 128, 32
    rng = np.random.default_rng(2)
    wq = rng.integers(0, 16, (K, N)).astype(np.int32)
    scales = rng.random((K // g, N), dtype=np.float32) + 0.5
    zeros = rng.integers(0, 16, (K // g, N)).astype(np.int32)
    jqt = jformats.make_qtensor(jnp.asarray(wq), jnp.asarray(scales), jnp.asarray(zeros), 4, g)
    qt = formats.make_qtensor(torch.from_numpy(wq), torch.from_numpy(scales),
                              torch.from_numpy(zeros), 4, g)
    assert qt.scales.dtype == torch.float32  # an f32 source stays f32 (exact)
    assert_same_qtensor(qt, jqt)
    args = (torch.from_numpy(wq), torch.from_numpy(scales), torch.from_numpy(zeros), 4, g)
    with pytest.raises(ValueError, match="divide one another"):
        formats.make_qtensor(*args, tile_k=80)
    with pytest.raises(ValueError, match="multiple of"):
        formats.make_qtensor(*args, tile_k=32)
    with pytest.raises(ValueError, match="storage_bits"):
        formats.make_qtensor(*args, storage_bits=2)


@pytest.mark.parametrize("bits,storage,want", [(3, "auto", 4), (7, "auto", 8), (5, "auto", 5),
                                               (6, None, 6), (3, "packed", 3), (3, 8, 8)])
def test_resolve_storage_bits_matches_jax(bits, storage, want):
    assert formats.resolve_storage_bits(bits, storage) == want
    assert jformats.resolve_storage_bits(bits, storage) == want
    assert formats.POW2_STORAGE == jformats.POW2_STORAGE
    assert formats.AUTO_PAD_WIDTHS == jformats.AUTO_PAD_WIDTHS


@pytest.mark.parametrize("K,per_channel", [(1024, True), (512, True), (200, False)])
def test_requantize_a8_matches_jax(K, per_channel):
    """8-bit, one group over K_logical, planes and scales equal to JAX's.  K
    off the tile pads, group_size < K, and the grouped kernel takes it."""
    w = _w(K, 256, K)
    jqt = xb.quantize_array(jnp.asarray(w), 4, 128 if K % 128 == 0 else 40, act_order=True)
    qt = xt.quantize_array(torch.from_numpy(w), 4, jqt.group_size, act_order=True)
    jrq, rq = xb.requantize_a8(jqt), xt.requantize_a8(qt)
    assert rq.bits == 8 and rq.group_size >= rq.K_logical and rq.perm is None
    assert_same_qtensor(rq, jrq)
    assert a8_per_channel(rq) == per_channel == (jrq.group_size >= jrq.K)
    # requant rounding: half a grid step, plus the clip shortfall of an
    # fp16-rounded scale that lands just under range/maxq
    step = rq.scales.float().max()
    wd4 = xt.dequant_qtensor(qt, torch.float32)
    wd8 = xt.dequant_qtensor(rq, torch.float32)
    assert (wd8 - wd4).abs().max() <= (0.5 + 255 * 2.0 ** -12) * step
