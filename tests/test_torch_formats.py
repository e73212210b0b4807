"""The port's packed layout against the JAX package: plane unpacking and the
dequant reference agree EXACTLY for every width 1-8, in the paired and slot
layouts, after conversion through ``xbitops_tpu_torch.io.convert``.  Also: the
port imports neither JAX nor the JAX package."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xbitops_tpu as xb
from xbitops_tpu import formats as jformats
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io.convert import qtensor_from_numpy

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "xbitops_tpu_torch"


def _np_tree(qt):
    return jax.tree.map(np.asarray, qt)


# (bits, group_size, K): group 128 pairs the 4-bit plane of 4/5/6/7 bits; group
# 40 (chunks not a multiple of 16 rows) keeps it in the slot layout.
CASES = [(b, 128, 512) for b in range(1, 9)] + [(4, 40, 640), (5, 40, 1280)]


@pytest.mark.parametrize("bits,g,K", CASES)
def test_unpack_and_dequant_match_jax_exactly(bits, g, K):
    rng = np.random.default_rng(bits * 7 + g)
    w = rng.standard_normal((K, 256), dtype=np.float32) * 0.1
    jqt = xb.quantize_array(jnp.asarray(w), bits, g)
    qt = qtensor_from_numpy(_np_tree(jqt), "cpu")
    assert qt.paired == jqt.paired
    assert qt.scales.dtype == torch.float16  # fp16 bits arrive as float16
    want = np.asarray(jformats.unpack_planes_reference(
        jqt.planes, jqt.bits, jqt.tile_k, jqt.K, paired=jqt.paired))
    got = formats.unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jformats.dequant_qtensor_reference(jqt, out_dtype=jnp.float32))
    got = formats.dequant_qtensor_reference(qt, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_layouts_cover_paired_and_slot():
    assert formats.paired_ok(4, 1024, 128) and formats.paired_ok(7, 1024, 128)
    assert not formats.paired_ok(4, 320, 40) and not formats.paired_ok(8, 256, 128)


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_planes_matches_jax(bits):
    rng = np.random.default_rng(bits)
    tile_k = 256
    wq = rng.integers(0, 1 << bits, (512, 128), dtype=np.int32)
    for paired in ((False, True) if bits in (4, 5, 6, 7) else (False,)):
        want = jformats.pack_planes(jnp.asarray(wq), bits, tile_k, paired=paired)
        got = formats.pack_planes(torch.from_numpy(wq), bits, tile_k, paired=paired)
        for w, gp in zip(want, got):
            np.testing.assert_array_equal(gp.numpy(), np.asarray(w))
        back = formats.unpack_planes_reference(got, bits, tile_k, 512, paired=paired)
        np.testing.assert_array_equal(back.numpy(), wq)


def test_f32_scales_padding_and_act_order_match_jax():
    """f32 scale storage, K and N padding, and an act-order permutation."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((200, 200), dtype=np.float32)
    jqt = xb.quantize_array(jnp.asarray(w), 4, 128, scale_store_dtype=jnp.float32,
                            act_order=True)
    assert jqt.K != jqt.K_logical and jqt.N_logical == 200 and jqt.perm is not None
    qt = qtensor_from_numpy(_np_tree(jqt), "cpu")
    assert qt.scales.dtype == torch.float32 and qt.shape == (200, 200)
    want = np.asarray(jformats.dequant_qtensor_reference(jqt, out_dtype=jnp.float32))
    got = formats.dequant_qtensor_reference(qt, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile_k,g", [(1024, 128), (128, 512)])
def test_tile_scales_matches_jax(tile_k, g):
    K = 2048
    s = np.random.default_rng(1).random((K // g, 256)).astype(np.float32)
    want = np.asarray(jformats.tile_scales(jnp.asarray(s), tile_k, g, K))
    got = formats.tile_scales(torch.from_numpy(s), tile_k, g, K)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,g", [(4, 128), (3, 128), (1, 64), (4, 40)])
def test_default_tile_k_matches_jax(bits, g):
    for K in (256, 4096, 11008, 384):
        assert formats.default_tile_k(K, g, bits) == jformats.default_tile_k(K, g, bits)


def test_port_imports_no_jax():
    """No module of the port imports jax or the JAX package."""
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "xbitops_tpu"):
                    bad.append(f"{path.relative_to(PORT)}: {n}")
    assert list(PORT.rglob("*.py")), "port package not found"
    assert not bad, bad
