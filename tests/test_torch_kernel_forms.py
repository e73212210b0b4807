"""The routing of the fused dequant-matmul's three kernel forms, their
split-K arithmetic, the split plan of the fused decode-attention kernel, and
numpy models of the order in which the whole-word
kernels walk K (``csrc/qgemv_mma.cu``, ``csrc/qgemv_word.cu``): which K rows
a word of each plane yields, which rows a sub-chunk or a slab covers, and the
fold ``acc += s_g * dot_g - sz_g * asum_g`` over those pieces, against
``unpack_planes_reference`` and the dense dequantized product.  The kernels
themselves run only on the card (``tests/test_torch_kernels_gpu.py``); what
surrounds them is held here.
"""

import itertools

import numpy as np
import pytest
import torch

from xbitops_tpu_torch import formats
from xbitops_tpu_torch.formats import PLANE_DECOMP, dequant_qtensor_reference
from xbitops_tpu_torch.kernels import decode_attention as da
from xbitops_tpu_torch.kernels import qgemv_kernel as qk
from xbitops_tpu_torch.utils import synth

torch.set_num_threads(1)


def _qt(bits, g, K, N=128, tile_k=None, seed=0):
    return synth.random_qtensor(torch.Generator().manual_seed(seed), K, N, bits, g, tile_k=tile_k)


# paired 4-bit (the main path), 8-bit, a slot-layout 4-bit plane (groups of
# 40), and widths of two and three planes
LAYOUTS = {
    "paired": dict(bits=4, g=128, K=2048),
    "eight": dict(bits=8, g=128, K=1024),
    "slot": dict(bits=4, g=40, K=640),
    "two_planes": dict(bits=3, g=128, K=1024),
    "three_planes": dict(bits=7, g=128, K=1024),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("M", [1, 8, 9, 32, 2560])
def test_qgemv_form(layout, precise, M):
    qt = _qt(**LAYOUTS[layout])
    form = qk.qgemv_form(M, precise, qt)
    assert qt.paired == (layout in ("paired", "three_planes"))  # width 7 pairs its 4-bit plane
    if precise:
        want = "cuda_core"  # bf16 products cannot hold rel 1e-5
    elif layout in ("paired", "eight") and M <= qk.GEMV_MAX_M:
        want = "gemv"  # the layouts whose words the few-rows form reads whole
    elif M >= qk.MMA_MIN_M:
        want = "mma"
    else:
        want = "cuda_core"
    assert form == want
    assert qk.word_layout(qt) == (layout in ("paired", "eight"))
    assert qk.mma_whole_words(qt) == (layout == "paired")


def test_qgemv_form_odd_groups_stay_on_the_cuda_cores():
    """A scale group that is not a multiple of 8 rows breaks the tile's
    16-byte activation copies."""
    qt = _qt(4, 20, 640, tile_k=160)
    assert (qt.tile_k // qt.groups_per_tile) % 8
    assert qk.qgemv_form(300, False, qt) == "cuda_core"
    assert not qk.word_layout(_qt(4, 16, 512, tile_k=64))  # a K-tile of half a slab


SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000), (640, 160)]


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("M", [1, 8, 16, 32, 64, 256, 2560])
@pytest.mark.parametrize("bits,g", [(4, 128), (8, 128), (4, 40), (3, 128)])
def test_k_splits_cover_k(K, N, M, bits, g):
    """For every form that takes the input: ``splits * per`` covers the
    form's units of K, ``per`` is a multiple of the unit's alignment (four
    sub-chunks to a whole-word chunk), no split is empty, and the grid reaches
    the target of blocks per SM unless K runs out first."""
    qt = _qt(bits, g, K, N=8)
    forms = {"cuda_core", qk.qgemv_form(M, False, qt)}
    if (qt.tile_k // qt.groups_per_tile) % 8 == 0:
        forms.add("mma")
    for form in forms:
        units, align = qk._units(form, qt)
        splits, per = qk._k_splits(form, M, N, units, 132, align)
        assert per % align == 0 and units % align == 0
        assert splits * per >= units > (splits - 1) * per
        blocks = qk._blocks(form, M, N)
        target = qk.BLOCKS_PER_SM[form] * 132
        if form == "gemv":  # at most one wave of resident blocks, unless one split is over it
            assert splits == 1 or blocks * splits <= target
        else:
            assert splits == 1 or blocks * (splits - 1) < target + blocks
        if form == "cuda_core":
            assert units * qk.CHUNK >= qt.K > (units - 1) * qk.CHUNK
        elif form == "gemv":
            assert units * 16 * (32 // qt.bits) == qt.K  # slabs of 16 word rows
        elif qk.mma_whole_words(qt):
            assert units * qk.SUB == qt.K


def _word_fields(pb, paired, tile_k, r):
    """(K row, bit shift) of every field of word row ``r`` of a plane: the
    inverse of ``plane_slot`` in ``csrc/planes.cuh``."""
    if paired:
        wt = tile_k // 8
        t, rl = divmod(r, wt)
        return [(t * tile_k + j * (tile_k // 4) + 2 * rl + h, 4 * j + 16 * h)
                for j in range(4) for h in range(2)]
    wt = tile_k * pb // 32
    t, rl = divmod(r, wt)
    return [(t * tile_k + j * wt + rl, pb * j) for j in range(32 // pb)]


@pytest.mark.parametrize("bits,layout", [(b, "slot") for b in range(1, 9)]
                         + [(b, "paired") for b in range(1, 9) if formats.paired_plane_layout(b)])
def test_whole_word_decode_order_equals_unpack(bits, layout):
    """Decoding every word of every plane whole, field by field, gives each K
    row exactly once and the values of ``unpack_planes_reference``."""
    paired = layout == "paired"
    g = 128 if paired else 40  # groups of 40 rows keep the slot layout
    K, N = (1024, 8) if paired else (640, 8)
    qt = _qt(bits, g, K, N=N, seed=bits)
    assert qt.paired == paired
    wq = np.zeros((qt.K, N), np.int64)
    off = 0
    for pi, (plane, pb) in enumerate(zip(qt.planes, PLANE_DECOMP[bits])):
        words = plane.numpy().astype(np.int64) & 0xFFFFFFFF
        seen = np.zeros(qt.K, np.int64)
        for r in range(words.shape[0]):
            for k, shift in _word_fields(pb, paired and pi == 0, qt.tile_k, r):
                wq[k] |= ((words[r] >> shift) & ((1 << pb) - 1)) << off
                seen[k] += 1
        assert (seen == 1).all()
        off += pb
    want = formats.unpack_planes_reference(qt.planes, bits, qt.tile_k, qt.K, paired=qt.paired)
    np.testing.assert_array_equal(wq, want.numpy())


def _pieces_mma(qt):
    """The tile's walk: (first K row, rows, [(word row, shift)] per K row or
    None) for every sub-chunk, in order (csrc/qgemv_mma.cu first_row)."""
    g_tile = qt.tile_k // qt.groups_per_tile
    if qk.mma_whole_words(qt):
        cpt = qt.tile_k // 256
        for i in range(qt.K // qk.SUB):
            c, j = divmod(i, 4)
            t, rb = divmod(c, cpt)
            k0 = t * qt.tile_k + j * (qt.tile_k // 4) + rb * 64
            first_word = t * (qt.tile_k // 8) + rb * 32
            # K rows 2r and 2r + 1 of the sub-chunk: the halves of word row r, nibble j
            src = [(first_word + r // 2, 4 * j + 16 * (r % 2)) for r in range(64)]
            yield k0, 64, src
    else:
        cpg = -(-g_tile // qk.SUB)
        for i in range((qt.K // g_tile) * cpg):
            u, part = divmod(i, cpg)
            yield u * g_tile + part * qk.SUB, min(qk.SUB, g_tile - part * qk.SUB), None


def _pieces_gemv(qt):
    """The few-rows form's walk: for every slab of 16 word rows and nibble or
    byte j, a run of consecutive K rows (csrc/qgemv_word.cu first_row)."""
    rj = 32 if qt.bits == 4 else 16
    spt = qt.tile_k // (128 if qt.bits == 4 else 64)
    for sl in range(qt.K // (4 * rj)):
        t, sr = divmod(sl, spt)
        for j in range(4):
            k0 = t * qt.tile_k + j * (qt.tile_k // 4) + rj * sr
            if qt.bits == 4:
                src = [(sl * 16 + i // 2, 4 * j + 16 * (i % 2)) for i in range(rj)]
            else:
                src = [(sl * 16 + i, 8 * j) for i in range(rj)]
            yield k0, rj, src


@pytest.mark.parametrize("case,form", [
    (c, "mma") for c in ("paired", "paired_tile256", "eight", "eight_g16", "slot", "two_planes",
                         "long_groups")
] + [(c, "gemv") for c in ("paired", "paired_tile256", "eight", "eight_g16")])
def test_kernel_walk_covers_k_inside_groups_and_folds_to_the_product(case, form):
    """Each piece of a form's walk is a run of consecutive K rows inside one
    scale group, the pieces cover K once, a whole-word piece's rows are where
    the kernel reads them, and folding the pieces with the TPU kernel's
    algebra gives the dense product."""
    kw = {"paired": dict(bits=4, g=128, K=2048), "paired_tile256": dict(bits=4, g=64, K=1024, tile_k=256),
          "eight": dict(bits=8, g=128, K=1024), "eight_g16": dict(bits=8, g=16, K=256, tile_k=64),
          "slot": dict(bits=4, g=40, K=640), "two_planes": dict(bits=6, g=128, K=1024),
          "long_groups": dict(bits=3, g=512, K=1024, tile_k=256)}[case]
    qt = _qt(N=16, seed=3, **kw)
    assert form == "mma" or qk.word_layout(qt)
    g_tile = qt.tile_k // qt.groups_per_tile
    wq = formats.unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    wq = wq.numpy().astype(np.float64)
    words = qt.planes[0].numpy().astype(np.int64) & 0xFFFFFFFF
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, qt.K))
    s, sz = qt.scales.double().numpy(), qt.scale_zeros.double().numpy()
    acc = np.zeros((5, qt.N))
    seen = np.zeros(qt.K, np.int64)
    for k0, rows, src in (_pieces_mma(qt) if form == "mma" else _pieces_gemv(qt)):
        assert k0 // g_tile == (k0 + rows - 1) // g_tile  # one scale row
        seen[k0:k0 + rows] += 1
        vals = wq[k0:k0 + rows]
        if src is not None:  # the whole-word read gives the same values
            mask = (1 << qt.bits) - 1
            got = np.stack([(words[r] >> sh) & mask for r, sh in src])
            np.testing.assert_array_equal(got, vals)
        t, gi = divmod(k0 // g_tile, qt.groups_per_tile)
        dot, asum = a[:, k0:k0 + rows] @ vals, a[:, k0:k0 + rows].sum(1, keepdims=True)
        acc += s[t, gi] * dot - sz[t, gi] * asum
    assert (seen == 1).all()
    want = a @ dequant_qtensor_reference(qt, torch.float64).numpy()
    np.testing.assert_allclose(acc, want, rtol=1e-9, atol=1e-9)


def test_forced_form_is_checked_before_any_launch():
    """``form=`` is for timing one kernel against another on the card; a CPU
    tensor takes the plain version whatever it says."""
    qt = _qt(4, 128, 512)
    a = torch.ones(2, 512, dtype=torch.bfloat16)
    out = qk.qmatmul_kernel(a, qt, form="mma")
    assert out.shape == (2, 128) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, qk.qmatmul_kernel_reference(a, qt))


# A Python model of the kernel's split plan (``csrc/decode_attention.cu``:
# ``first``, ``n_live``, ``s0``/``s1``, ``t_begin`` and the writer test), over
# the wrapper's ``n_splits`` / ``SPLIT_LEN`` / ``TILE``.
def _live_splits(length, S, window=None):
    """The splits that hold positions ``[max(0, len - window), len)`` of a slot
    (``len`` clamped into ``[0, S]``), in the order the last block combines them."""
    length = min(max(length, 0), S)
    lo = max(0, length - window) if window else 0
    if length <= lo:
        return range(0)
    return range(lo // da.SPLIT_LEN, (length - 1) // da.SPLIT_LEN + 1)


def _writer_split(position, S):
    """The split whose block writes a new row at ``position``; None outside ``[0, S)``."""
    return position // da.SPLIT_LEN if 0 <= position < S else None


def _split_tiles(split, length, S, window=None):
    """First positions of the tiles a split's block streams: from its first
    attended position rounded down to a tile, to its last."""
    length = min(max(length, 0), S)
    lo = max(0, length - window) if window else 0
    s0, s1 = max(split * da.SPLIT_LEN, lo), min((split + 1) * da.SPLIT_LEN, length)
    if s0 >= s1:
        return range(0)
    return range(s0 - s0 % da.TILE, s1, da.TILE)


@pytest.mark.parametrize("S", [4, 64, 252, 256, 260, 2048])
@pytest.mark.parametrize("window", [None, 1, 100, 300])
def test_decode_split_plan(S, window):
    """The split plan of the fused decode-attention kernel
    (``csrc/decode_attention.cu``), as modelled above: exactly one
    split writes each position of ``[0, S)`` and none writes outside it; an
    int8 word (positions 4w..4w+3) never straddles two splits; the live
    splits of a slot are contiguous, in increasing order, and their tiles,
    which start on a multiple of 64, cover ``[lo, len)`` once; the new row is
    in exactly one tile of its writer when it is attended."""
    n, L = da.n_splits(S), da.SPLIT_LEN
    assert n * L >= S > (n - 1) * L and L % da.TILE == 0 and L % 4 == 0
    for p in range(-3, S + 3):
        w = _writer_split(p, S)
        assert (w is None) == (not 0 <= p < S)
        assert w is None or (0 <= w < n and w * L <= p < (w + 1) * L)
    for word in range(S // 4):
        assert len({_writer_split(4 * word + j, S) for j in range(4)}) == 1
    for length in sorted({-3, 0, 1, 2, S // 2, S - 1, S, S + 5}):
        ln = min(max(length, 0), S)
        lo = max(0, ln - window) if window else 0
        live = list(_live_splits(length, S, window))
        assert live == list(range(live[0], live[-1] + 1)) if live else ln == 0
        covered = []
        for sp in range(n):
            tiles = list(_split_tiles(sp, length, S, window))
            assert bool(tiles) == (sp in live)
            assert all(t % da.TILE == 0 for t in tiles)
            covered += [p for t in tiles for p in range(t, t + da.TILE)
                        if lo <= p < ln and sp * L <= p < (sp + 1) * L]
            pos = ln - 1  # the decode contract: the new row is the last attended one
            if ln > 0 and _writer_split(pos, S) == sp:
                assert sum(t <= pos < t + da.TILE for t in tiles) == 1
        assert covered == list(range(lo, ln))


def test_decode_split_combine_order_is_fixed():
    """A numpy model of the kernel's combine: each live split leaves (max,
    sum, unnormalised output); the block that takes the last ticket adds them
    in split order, so every order of finishing gives the same bits, and the
    result is the softmax over the live positions."""
    rng = np.random.default_rng(0)
    S, D, length, window = 2048, 16, 1500, 900
    scores = rng.standard_normal(S).astype(np.float32) * 3
    v = rng.standard_normal((S, D)).astype(np.float32)
    live = list(_live_splits(length, S, window))
    lo = length - window
    parts = {}
    for sp in live:
        rows = np.arange(max(sp * da.SPLIT_LEN, lo), min((sp + 1) * da.SPLIT_LEN, length))
        m = scores[rows].max()
        p = np.exp(scores[rows] - m)
        parts[sp] = (m, p.sum(dtype=np.float32), (p[:, None] * v[rows]).sum(0, dtype=np.float32))

    def combine(finished):
        assert sorted(finished) == live  # the ticket of finished[-1] is the last one
        mx = np.float32(max(parts[sp][0] for sp in live))
        l, o = np.float32(0), np.zeros(D, np.float32)
        for sp in live:  # split order, whichever block took the last ticket
            c = np.exp(parts[sp][0] - mx, dtype=np.float32)
            l, o = l + parts[sp][1] * c, o + parts[sp][2] * c
        return o / l

    got = [combine(list(order)) for order in itertools.permutations(live)]  # finishing orders
    assert all(np.array_equal(g, got[0]) for g in got)
    w = np.exp(scores[lo:length] - scores[lo:length].max())
    np.testing.assert_allclose(got[0], (w[:, None] * v[lo:length]).sum(0) / w.sum(), rtol=1e-5,
                               atol=1e-6)
