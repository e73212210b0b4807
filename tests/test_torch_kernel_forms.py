"""The routing of the fused dequant-matmul's three kernel forms and of the
int8-activation kernel's three routes, their split-K arithmetic, the split
plan of the fused decode-attention kernel, and numpy models of the order in
which the whole-word kernels walk K (``csrc/qgemv_mma.cu``,
``csrc/qgemv_word.cu``, ``csrc/qgemv_a8.cu``): which K rows a word of each
plane yields, which rows a sub-chunk, a slab or a step covers, which K rows
each B register carries after the kernel's byte permutes, and the fold
``acc += s_g * dot_g - sz_g * asum_g`` over those pieces, against
``unpack_planes_reference``, the dense dequantized product and the a8
kernels' plain version.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``); what surrounds them is held here.
"""

import dataclasses
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
@pytest.mark.parametrize("M", [1, 8, 9, 13, 16, 32, 2560])
def test_qgemv_form(layout, precise, M):
    qt = _qt(**LAYOUTS[layout])
    form = qk.qgemv_form(M, precise, qt)
    # the few-rows form's 9-16-row instance: the paired plane at groups of 128
    # and K-tiles of 1024 (its windows of four slabs lie in one group)
    assert qk.word16(M, qt) == (layout == "paired" and 9 <= M <= 16)
    assert qk.plan_form(form, M, qt) == ("gemv16" if form == "gemv" and qk.word16(M, qt)
                                         else form)
    assert qt.paired == (layout in ("paired", "three_planes"))  # width 7 pairs its 4-bit plane
    whole = ("paired", "eight", "two_planes", "three_planes")
    if precise:
        want = "cuda_core"  # bf16 products cannot hold rel 1e-5
    elif layout in whole and M <= qk.GEMV_MAX_M:
        want = "gemv"  # the layouts whose words the few-rows form reads whole
    elif M >= qk.MMA_MIN_M:
        want = "mma"
    else:
        want = "cuda_core"
    assert form == want
    assert qk.word_layout(qt) == (layout in whole)
    assert qk.word_planes(qt) == (layout in ("two_planes", "three_planes"))
    assert qk.mma_whole_words(qt) == (layout == "paired")
    # the int8-activation kernel: the paired plane in whole words; 8-bit with
    # groups shorter than its K-tile, slot planes and several planes by rows
    assert qk.a8_whole_words(qt) == (layout == "paired")


# (bits, group, K, tile_k or None, route, C): the 7B layout (w_down's K pads
# 11008 -> 11264, which the kernel reads whole like any other K), the paired
# plane's edges, per channel (group = K), the 8-bit plane, and the layouts
# that decode row by row: slot planes, 3-bit (two planes), 7-bit (three),
# groups of 64 on the paired plane (a nibble's run would span two groups),
# K-tiles of 256 (not whole 512-row word blocks) and a K-tile of 64 rows
A8_ROUTES = {
    "7b_wqkv": (4, 128, 4096, None, "paired", 1),
    "7b_w_down_padded_k": (4, 128, 11008, None, "paired", 1),
    "paired_tile512": (4, 128, 1024, 512, "paired", 1),
    "paired_g256_tile1024": (4, 256, 2048, 1024, "paired", 2),
    "paired_g256_tile2048": (4, 256, 4096, None, "paired", 2),
    "paired_g256_tile512": (4, 256, 1024, 512, "paired", 1),
    "paired_per_channel": (4, 4096, 4096, None, "paired", 1),
    "bytes_per_channel": (8, 4096, 4096, None, "bytes", 1),
    "bytes_per_channel_tile256": (8, 11008, 11008, None, "bytes", 1),
    "bytes_one_group_a_tile": (8, 1024, 2048, 1024, "bytes", 1),
    "eight_g128": (8, 128, 1024, None, "rows", 1),
    "slot_g40": (4, 40, 640, None, "rows", 1),
    "three_bit": (3, 128, 1024, None, "rows", 1),
    "seven_bit": (7, 128, 1024, None, "rows", 1),
    "paired_g64": (4, 64, 1024, 512, "rows", 1),
    "paired_tile256": (4, 128, 1024, 256, "rows", 1),
    "eight_tile64": (8, 16, 256, 64, "rows", 1),
}


@pytest.mark.parametrize("case", A8_ROUTES)
def test_a8_route(case):
    bits, g, K, tile_k, route, c = A8_ROUTES[case]
    qt = _qt(bits, g, K, tile_k=tile_k)
    assert qk.a8_route(qt) == route and qk._a8_c(qt) == c
    assert qk.a8_whole_words(qt) == (route != "rows")
    assert qk.A8_ROUTES.index(route) == {"paired": 0, "bytes": 1, "rows": 2}[route]
    units, align = qk._units("a8", qt)
    if route != "rows":  # steps of 128 K rows; a split holds whole word blocks
        assert units * qk.A8_STEP == qt.K
        assert align == (4 * c if route == "paired" else
                         1 if qk.a8_per_channel(qt) else qt.tile_k // 128)


def test_qgemv_form_odd_groups_stay_on_the_cuda_cores():
    """A scale group that is not a multiple of 8 rows breaks the tile's
    16-byte activation copies."""
    qt = _qt(4, 20, 640, tile_k=160)
    assert (qt.tile_k // qt.groups_per_tile) % 8
    assert qk.qgemv_form(300, False, qt) == "cuda_core"
    assert not qk.word_layout(_qt(4, 16, 512, tile_k=64))  # a K-tile of half a slab


def _meta(bits, g, K, N, storage_bits=None):
    """A QTensor that holds a layout and no data (empty planes and scales):
    what the routing reads, at any shape, without packing a weight."""
    sb = formats.resolve_storage_bits(bits, storage_bits)
    tile_k = formats.default_tile_k(K, g, sb)
    empty = torch.empty((0, N), dtype=torch.int32)
    scales = torch.empty(0, dtype=torch.float16)
    return formats.QTensor(planes=(empty,) * len(PLANE_DECOMP[sb]), scales=scales,
                           scale_zeros=scales, bits=sb, group_size=g, tile_k=tile_k,
                           K=-(-K // tile_k) * tile_k, K_logical=K, value_bits=bits)


SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000), (640, 160)]
SHAPES_7B = SHAPES[:5]
# Mistral-7B's and Mixtral-8x7B's (its experts'): q|k|v, wo, gate|up, down, lm_head
SERVED_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)]


@pytest.mark.parametrize("K,N", SERVED_SHAPES)
def test_served_shapes_take_the_16_row_instance(K, N):
    """Every decode step of 16 slots, a γ=1 verify on 8 and an admission's
    lm_head on 9-16 logits rows run the few-rows form's 9-16-row instance on
    the served layout (4-bit, g=128, K-tiles of 1024); 8 rows and fewer keep
    the first instance, 17 take the tile."""
    qt = _meta(4, 128, K, N)
    assert qt.tile_k == 1024 and qt.paired and qk.word_layout(qt) and not qk.word_planes(qt)
    for M in range(1, 18):
        form = qk.qgemv_form(M, False, qt)
        assert form == ("gemv" if M <= 16 else "mma")
        assert qk.word16(M, qt) == (9 <= M <= 16) and qk.counter(form, qt) != "qgemv_planes"
    for other in (_meta(8, 128, K, N), _meta(4, 64, K, N), _meta(4, 128, K, N, "auto"),
                  _meta(3, 128, K, N, "auto")):  # the 8-bit plane, groups of 64, width 3 on 4
        assert not qk.word16(16, other) or (other.bits, other.group_size) == (4, 128)


@pytest.mark.parametrize("bits", [1, 2, 3, 5, 6, 7])
@pytest.mark.parametrize("g", [128, 32])
def test_every_width_takes_the_few_rows_form(bits, g):
    """At default (packed) storage, widths 1, 2, 3, 5, 6 and 7 take the few-rows
    form's planes kernel at M <= 16 on the five 7B projection shapes (and on
    groups of 32), the tile from M = 17, the CUDA cores with ``precise``.
    Groups that cut a run of 16 K rows (40), f32 scales, N not a multiple of
    8 (the kernel stages scales in 16-byte copies), and ``"auto"`` storage, which
    pads 3 and 7 bits to the 4- and 8-bit planes of the other kernel, route
    elsewhere."""
    for K, N in SHAPES_7B:
        qt = _meta(bits, g, K, N)
        assert qt.bits == bits and qt.paired == (bits > 4)
        assert qk.word_planes(qt) and qk.word_layout(qt)
        for M in (1, 8, 16):
            assert qk.qgemv_form(M, False, qt) == "gemv"
            assert qk.counter("gemv", qt) == "qgemv_planes"
            assert qk.qgemv_form(M, True, qt) == "cuda_core"
        assert qk.qgemv_form(17, False, qt) == "mma"
        units, align = qk._units("gemv", qt)
        assert units * qk.RUN * qk.planes_runs(qt) == qt.K and align == 1
        assert qk.planes_runs(qt) == 32 // min(PLANE_DECOMP[bits])
        odd = _meta(bits, 40, K, N)
        assert not qk.word_layout(odd) and qk.qgemv_form(8, False, odd) == "cuda_core"
        f32 = dataclasses.replace(qt, scales=qt.scales.float(), scale_zeros=qt.scales.float())
        for other in (f32, _meta(bits, g, K, N - 4)):  # f32 scales; N not a multiple of 8
            assert not qk.word_layout(other) and qk.qgemv_form(8, False, other) == "cuda_core"
        auto = _meta(bits, g, K, N, storage_bits="auto")
        assert qk.word_layout(auto) and qk.word_planes(auto) == (bits not in (3, 7))
        assert qk.counter("gemv", auto) == ("qgemv" if bits in (3, 7) else "qgemv_planes")


def test_planes_kernel_group_rules():
    """The planes kernel's scale groups: whole runs of 16 rows (each run's
    fold reads its group's row, whatever the runs' stride ``tile_k / F``);
    K-tiles of whole units."""
    ok = [_qt(3, 32, 4096, N=8, tile_k=4096),  # stride 128, groups of 32
          _qt(3, 128, 1024, N=8),  # tile 1024, stride 32: a group spans four runs
          _qt(3, 32, 1536, N=8, tile_k=1536),  # stride 48, groups of 32
          _qt(1, 1024, 1024, N=8),  # one group a K-tile
          _qt(6, 64, 2048, N=8)]  # F = 16 at width 6
    for qt in ok:
        assert qk.word_planes(qt), (qt.bits, qt.group_size, qt.tile_k)
    bad = [_qt(3, 512, 1024, N=8, tile_k=256),  # a K-tile of half a unit
           _qt(2, 40, 640, N=8),  # groups of 40 cut a run
           _qt(1, 24, 1536, N=8, tile_k=1536)]  # groups of 24 cut a run
    for qt in bad:
        assert not qk.word_planes(qt), (qt.bits, qt.group_size, qt.tile_k)
        assert qk.qgemv_form(8, False, qt) == "cuda_core"
    paired4 = _qt(4, 128, 1024, N=8)
    assert not qk.word_planes(paired4) and qk.word_layout(paired4)


@pytest.mark.parametrize("K,N", SHAPES + SERVED_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 9, 13, 16, 32, 64, 256, 2560])
@pytest.mark.parametrize("bits,g", [(4, 128), (8, 128), (4, 40), (3, 128), (8, None), (1, 128),
                                    (2, 128), (5, 128), (6, 128), (7, 128), (3, 32)])
def test_k_splits_cover_k(K, N, M, bits, g):
    """For every form that takes the input: ``splits * per`` covers the
    form's units of K, ``per`` is a multiple of the unit's alignment (four
    sub-chunks to a whole-word chunk; a8: whole word blocks and, grouped,
    whole groups), no split is empty, and the grid reaches the target of
    blocks per SM unless K runs out first.  The a8 split-K workspace holds
    f32 partial outputs grouped and int32 partial sums (and row sums) per
    channel (g None: one group over K).  The few-rows form plans by
    :func:`plan_form`: at 9-16 rows on the paired plane (``gemv16``) splits
    of whole slabs that may cut a window (the kernel folds at a split's end
    too), at most one resident block an SM; otherwise, where the lazy fold
    runs, splits that start on a window of four slabs.  Its column tiles fit
    the split-K tickets."""
    qt = _qt(bits, g or K, K, N=8)
    forms = {"cuda_core", "a8", qk.plan_form(qk.qgemv_form(M, False, qt), M, qt)}
    if (qt.tile_k // qt.groups_per_tile) % 8 == 0:
        forms.add("mma")
    for form in forms:
        units, align = qk._units(form, qt)
        splits, per = qk._k_splits(form, M, N, units, 132, align)
        assert per % align == 0 and units % align == 0
        assert splits * per >= units > (splits - 1) * per
        blocks = qk._blocks(form, M, N)
        target = qk.BLOCKS_PER_SM[form] * 132
        if form in ("gemv", "gemv16"):  # at most one wave of resident blocks, unless one split
            assert splits == 1 or blocks * splits <= target  # is over it
            assert blocks == -(-N // 256) <= qk.SPLIT_COUNTERS
            rows = 128 if qt.bits == 4 else 64  # K rows a slab
            lazy = not qk.word_planes(qt) and qt.tile_k % (4 * rows) == 0 and (
                (qt.tile_k // qt.groups_per_tile) % rows == 0)  # a window: one group a nibble
            assert align == (4 if form == "gemv" and lazy else 1)
            assert (form == "gemv16") == (qt.bits == 4 and lazy and 9 <= M <= 16)
        else:
            assert splits == 1 or blocks * (splits - 1) < target + blocks
        if form == "cuda_core":
            assert units * qk.CHUNK >= qt.K > (units - 1) * qk.CHUNK
        elif form == "gemv" and qk.word_planes(qt):
            # units of 16 word rows of the narrowest plane
            assert units * 16 * qk.planes_runs(qt) == qt.K and align == 1
        elif form in ("gemv", "gemv16"):
            assert units * 16 * (32 // qt.bits) == qt.K  # slabs of 16 word rows
        elif form == "a8":
            g_tile = qt.tile_k // qt.groups_per_tile
            steps = (qt.K // qk.A8_STEP if qk.a8_whole_words(qt)
                     else qt.K // g_tile * -(-g_tile // qk.A8_STEP))
            assert units == steps
            plan = qk.a8_plan(qt, M, 132)  # at the weight's own N
            assert plan.splits * plan.per >= units and plan.per % align == 0
            if plan.splits == 1:
                assert plan.part_dtype is None and plan.part_numel == 0
            elif qk.a8_per_channel(qt):
                assert plan.part_dtype == torch.int32
                assert plan.part_numel == plan.splits * (M * qt.N + M)
            else:
                assert plan.part_dtype == torch.float32
                assert plan.part_numel == plan.splits * M * qt.N
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


def _folds_gemv16(qt, per):
    """The few-rows form's 9-16-row walk (csrc/qgemv_word.cu
    ``qgemv_word_kernel16``): splits of ``per`` slabs in split order, each a
    list of folds; a fold is a window of four slabs (cut at the split's ends)
    and a nibble j, and holds that window's pieces of :func:`_pieces_gemv`
    for j, in slab order: one sum and one asum, folded once."""
    pieces = list(_pieces_gemv(qt))  # slab-major, then j
    n = qt.K // 128
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        yield [[pieces[4 * sl + j] for sl in range(4 * w, 4 * w + 4) if lo <= sl < hi]
               for w in range(lo // 4, (hi - 1) // 4 + 1) for j in range(4)]


def _prmt(x, y, sel):
    """``__byte_perm(x, y, sel)`` on arrays of 32-bit words (held in int64)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _pieces_a8(qt):
    """The int8-activation kernel's walk (csrc/qgemv_a8.cu ``step_k0``,
    ``load``, ``compute``), a step at a time, in order: ``rows [4, 32]``, the
    K row of each byte of a k-step's A registers (natural order from the
    staged tile; -1 past a short ROWS step, where the tile holds zeros);
    ``b [4, 32, N]``, the value each byte of the B registers carries, made
    from the raw words by the kernel's own register expressions (PAIRED: one
    byte permute of words r and r + 1, a shift for odd nibbles, a mask;
    BYTES: the 4 x 4 byte transpose of four word rows, as u8 per channel and
    minus 128 grouped) or, on ROWS, as the block decodes them (width 8 minus
    128); ``fold``: the step ends its scale group, whose int32 sums then fold
    once; ``unsigned``: B enters the product as u8."""
    route, c = qk.a8_route(qt), qk._a8_c(qt)
    per_ch = qk.a8_per_channel(qt)
    tile_k, P, K = qt.tile_k, qt.tile_k // 4, qt.K
    g_tile = tile_k // qt.groups_per_tile
    words = qt.planes[0].numpy().astype(np.int64) & 0xFFFFFFFF
    wq = formats.unpack_planes_reference(qt.planes, qt.bits, tile_k, K, paired=qt.paired).numpy()
    kap = np.arange(32)
    for i in range(qk._units("a8", qt)[0]):
        b = np.zeros((4, 32, qt.N), np.int64)
        if route == "paired":
            t, x = divmod(i, tile_k // 128)
            blk, r = divmod(x, 4 * c)
            j, part = divmod(r, c)
            kl = j * P + blk * 128 * c + part * 128
            rows = np.stack([t * tile_k + kl + 32 * ks + kap for ks in range(4)])
            base = t * (tile_k // 8) + blk * 64 * c + part * 64
            sel, sh = 0x6420 + (j >> 1) * 0x1111, 4 * (j & 1)
            for ks, h, t4 in itertools.product(range(4), range(2), range(4)):
                r0 = base + 16 * ks + 8 * h + 2 * t4
                reg = (_prmt(words[r0], words[r0 + 1], sel) >> sh) & 0x0F0F0F0F
                for k in range(4):
                    b[ks, 16 * h + 4 * t4 + k] = (reg >> (8 * k)) & 0xFF
            yield dict(rows=rows, b=b, fold=(kl + 128) % g_tile == 0, unsigned=False)
        elif route == "bytes":
            t, x = divmod(i, P // 32)
            rows = np.stack([t * tile_k + j * P + 32 * x + kap for j in range(4)])
            base = t * P + 32 * x
            for h, t4 in itertools.product(range(2), range(4)):
                x0, x1, x2, x3 = (words[base + 16 * h + 4 * t4 + q] for q in range(4))
                lo01, lo23 = _prmt(x0, x1, 0x5140), _prmt(x2, x3, 0x5140)
                hi01, hi23 = _prmt(x0, x1, 0x7362), _prmt(x2, x3, 0x7362)
                regs = [_prmt(lo01, lo23, 0x5410), _prmt(lo01, lo23, 0x7632),
                        _prmt(hi01, hi23, 0x5410), _prmt(hi01, hi23, 0x7632)]
                for j, reg in enumerate(regs):
                    for k in range(4):
                        v = (reg >> (8 * k)) & 0xFF
                        if not per_ch:  # the byte XOR 0x80, read as s8
                            v = (v ^ 0x80) - 256 * ((v ^ 0x80) >= 128)
                        b[j, 16 * h + 4 * t4 + k] = v
            yield dict(rows=rows, b=b, fold=x == P // 32 - 1, unsigned=per_ch)
        else:
            cpg = -(-g_tile // 128)
            u, part = divmod(i, cpg)
            k0, kc = u * g_tile + 128 * part, min(128, g_tile - 128 * part)
            off = np.stack([32 * ks + kap for ks in range(4)])
            rows = np.where(off < kc, k0 + off, -1)
            b[rows >= 0] = wq[rows[rows >= 0]] - (128 if qt.bits == 8 else 0)
            yield dict(rows=rows, b=b, fold=part == cpg - 1, unsigned=False)


@pytest.mark.parametrize("case,form", [
    (c, "mma") for c in ("paired", "paired_tile256", "eight", "eight_g16", "slot", "two_planes",
                         "long_groups")
] + [(c, "gemv") for c in ("paired", "paired_tile256", "eight", "eight_g16")] + [
    (c, "gemv16") for c in ("paired", "paired_tile512_g256")] + [
    (c, "gemv") for c in ("one_bit", "two_bit", "three_bit", "five_bit", "six_bit", "seven_bit",
                          "three_bit_tile1024", "three_bit_g32", "three_bit_g32_tile1536",
                          "seven_bit_one_group")
] + [
    (c, "a8") for c in ("paired", "paired_tile512_g256", "paired_g256", "paired_per_channel",
                        "eight", "eight_per_channel", "eight_one_group_a_tile", "slot",
                        "two_planes", "eight_short_tile_per_channel")
])
def test_kernel_walk_covers_k_inside_groups_and_folds_to_the_product(case, form):
    """Each piece of a form's walk is a run of consecutive K rows inside one
    scale group, the pieces cover K once, a whole-word piece's rows are where
    the kernel reads them, and folding the pieces with the TPU kernel's
    algebra gives the dense product.  a8: every K row once, a grouped step
    inside one group and each group folded once, each B register byte the
    value of the K row its A byte holds; per channel the int32 sums and the
    output equal the plain version bit for bit, grouped the folds hold it to
    rel 1e-5 / abs 3e-4."""
    kw = {"paired": dict(bits=4, g=128, K=2048), "paired_tile256": dict(bits=4, g=64, K=1024, tile_k=256),
          "eight": dict(bits=8, g=128, K=1024), "eight_g16": dict(bits=8, g=16, K=256, tile_k=64),
          "slot": dict(bits=4, g=40, K=640), "two_planes": dict(bits=6, g=128, K=1024),
          "long_groups": dict(bits=3, g=512, K=1024, tile_k=256),
          "paired_tile512_g256": dict(bits=4, g=256, K=1024, tile_k=512),
          "paired_g256": dict(bits=4, g=256, K=2048, tile_k=1024),
          "paired_per_channel": dict(bits=4, g=2048, K=2048),
          "eight_per_channel": dict(bits=8, g=1024, K=1024),
          "eight_one_group_a_tile": dict(bits=8, g=512, K=1024, tile_k=512),
          "eight_short_tile_per_channel": dict(bits=8, g=96, K=96),
          # the planes kernel: each width at its 7B K-tile (4096; 2048 at widths 2 and
          # 6), a group spanning four runs, four groups a run's stride, one group
          # a K-tile
          "one_bit": dict(bits=1, g=128, K=4096), "two_bit": dict(bits=2, g=128, K=4096),
          "three_bit": dict(bits=3, g=128, K=4096), "five_bit": dict(bits=5, g=128, K=4096),
          "six_bit": dict(bits=6, g=128, K=4096), "seven_bit": dict(bits=7, g=128, K=4096),
          "three_bit_tile1024": dict(bits=3, g=128, K=1024),
          "three_bit_g32": dict(bits=3, g=32, K=4096, tile_k=4096),
          "three_bit_g32_tile1536": dict(bits=3, g=32, K=3072, tile_k=1536),
          "seven_bit_one_group": dict(bits=7, g=1024, K=2048)}[case]
    qt = _qt(N=16, seed=3, **kw)
    if form == "a8":
        _a8_walk_folds_to_the_plain_version(qt)
        return
    if qk.word_planes(qt):
        _planes_walk_folds_to_the_product(qt)
        return
    if form == "gemv16":
        _gemv16_walk_folds_to_the_product(qt)
        return
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


def _gemv16_walk_folds_to_the_product(qt):
    """The 9-16-row walk at splits that cut windows (3 and 5 slabs), that
    keep them (4) and one split: each fold's rows are consecutive, in one
    scale group and read whole where the kernel reads them; every K row
    once a split plan; the folds, summed in split order, give the product."""
    assert qk.word16(16, qt)
    g_tile = qt.tile_k // qt.groups_per_tile
    wq = formats.unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    wq = wq.numpy().astype(np.float64)
    words = qt.planes[0].numpy().astype(np.int64) & 0xFFFFFFFF
    a = np.random.default_rng(0).standard_normal((16, qt.K))
    s, sz = qt.scales.double().numpy(), qt.scale_zeros.double().numpy()
    want = a @ dequant_qtensor_reference(qt, torch.float64).numpy()
    n = qt.K // 128
    for per in (3, 4, 5, n):
        out = np.zeros((16, qt.N))
        seen = np.zeros(qt.K, np.int64)
        for folds in _folds_gemv16(qt, per):
            acc = np.zeros_like(out)
            for fold in folds:
                rows = np.concatenate([np.arange(k0, k0 + r) for k0, r, _ in fold])
                assert (np.diff(rows) == 1).all() and len(rows) <= 128
                assert rows[0] // g_tile == rows[-1] // g_tile  # one scale row
                got = np.stack([(words[r] >> sh) & 15 for _, _, src in fold for r, sh in src])
                np.testing.assert_array_equal(got, wq[rows])
                seen[rows] += 1
                t, gi = divmod(rows[0] // g_tile, qt.groups_per_tile)
                acc += s[t, gi] * (a[:, rows] @ wq[rows]) - sz[t, gi] * a[:, rows].sum(1)[:, None]
            out += acc
        assert (seen == 1).all()
        np.testing.assert_allclose(out, want, rtol=1e-9, atol=1e-9)


def _walk_planes(qt):
    """The planes kernel's walk (csrc/qgemv_word_planes.cu), a run at a time
    in its order: unit, plane 0's piece, field j, run of the piece.  Planes 1
    and 2 of the unit are held as byte-permuted pairs (word rows 2e and
    2e + 1 side by side); for each run every plane's field is moved to its
    bit offset and joined into the weight's value, with the kernel's own
    register expressions.  ``vals``: the 16 K rows x N values the run's A
    registers carry; ``row``: the scale row its fold reads (tile, group), as
    the kernel stages it (``(i * wt + r0) / g``)."""
    pbs, F, tile_k = qt.plane_bits, qk.planes_runs(qt), qt.tile_k
    wt, g = tile_k // F, qk._g_tile(qt)
    words = [p.numpy().astype(np.int64) & 0xFFFFFFFF for p in qt.planes]
    offs = np.cumsum((0,) + pbs[:-1])

    def pairs(p, base):  # 16 word rows of a slot plane -> [lo/hi][8 pairs][N]
        rows = words[p][base:base + 16]
        return [[_prmt(rows[2 * e], rows[2 * e + 1], sel) for e in range(8)]
                for sel in (0x5410, 0x7632)]

    def halves(regs, mask):  # each register's two halves: K rows 2e and 2e + 1 -> [8, 2, N]
        return np.stack([np.stack([r & mask, (r >> 16) & mask]) for r in regs])

    for u in range(qt.K // (qk.RUN * F)):
        t, r0 = divmod(u, wt // qk.RUN)
        r0 *= qk.RUN
        res = {p: [pairs(p, t * (tile_k * pb // 32) + q * wt + r0) for q in range(F * pb // 32)]
               for p, pb in enumerate(pbs) if p > 0}
        paired = qt.paired
        fields0, c0 = (4, F // 4) if paired else (32 // pbs[0], F * pbs[0] // 32)
        sr = 2 if paired else 1
        mask0 = 0xF if paired else (1 << pbs[0]) - 1
        for sq in range(c0 // sr):
            pr0 = None if paired else pairs(0, t * (tile_k * pbs[0] // 32) + sq * wt + r0)
            for j, s in itertools.product(range(fields0), range(sr)):
                i = j * c0 + sr * sq + s
                if paired:  # word row e holds K rows 2e (low half) and 2e + 1
                    base = t * (tile_k // 8) + ((sr * sq + s) * wt + r0) // 2
                    v = halves(list(words[0][base:base + 8] >> (4 * j)), mask0)
                else:
                    sh = pbs[0] * j
                    v = halves([r >> (sh & 15) for r in pr0[sh >> 4]], mask0)
                for p in res:  # plane p's field of run i, moved to bit off_p
                    cp = F * pbs[p] // 32
                    sh = pbs[p] * (i // cp)
                    d = (sh & 15) - offs[p]
                    moved = [((r >> d) if d >= 0 else (r << -d)) & 0xFFFFFFFF
                             for r in res[p][i % cp][sh >> 4]]
                    v = v | halves(moved, ((1 << pbs[p]) - 1) << offs[p])
                yield dict(k0=t * tile_k + i * wt + r0, vals=v.reshape(16, -1),
                           row=(t, (i * wt + r0) // g))


def _planes_walk_folds_to_the_product(qt):
    """Every K row once, each run's values those of ``unpack_planes_reference``,
    each run inside the scale group whose row its fold reads, and the folds,
    one a run (``s * dot - sz * asum``), give the dense product."""
    g_tile = qk._g_tile(qt)
    wq = formats.unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    wq = wq.numpy().astype(np.int64)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, qt.K))
    s, sz = qt.scales.double().numpy(), qt.scale_zeros.double().numpy()
    acc = np.zeros((5, qt.N))
    seen = np.zeros(qt.K, np.int64)
    for run in _walk_planes(qt):
        k0 = run["k0"]
        seen[k0:k0 + 16] += 1
        np.testing.assert_array_equal(run["vals"], wq[k0:k0 + 16])
        t, gi = run["row"]
        assert t == k0 // qt.tile_k and gi == (k0 % qt.tile_k) // g_tile  # the run's own group
        assert (k0 + 15) // g_tile == k0 // g_tile
        a_run = a[:, k0:k0 + 16]
        acc += s[t, gi] * (a_run @ run["vals"]) - sz[t, gi] * a_run.sum(1, keepdims=True)
    assert (seen == 1).all()
    want = a @ dequant_qtensor_reference(qt, torch.float64).numpy()
    np.testing.assert_allclose(acc, want, rtol=1e-9, atol=1e-9)


def _a8_walk_folds_to_the_plain_version(qt):
    route, per_ch = qk.a8_route(qt), qk.a8_per_channel(qt)
    g_tile = qt.tile_k // qt.groups_per_tile
    wq = formats.unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    wq = wq.numpy().astype(np.int64)
    rng = np.random.default_rng(0)
    aq_np = rng.integers(-127, 128, (5, qt.K)).astype(np.int8)
    aq = torch.from_numpy(aq_np)
    a = aq_np.astype(np.int64)
    s, sz = qt.scales.float().numpy(), qt.scale_zeros.float().numpy()
    seen, folds = np.zeros(qt.K, np.int64), {}
    d = np.zeros((5, qt.N), np.int64)
    asum = np.zeros((5, 1), np.int64)
    acc = np.zeros((5, qt.N), np.float64)
    group = None
    for st in _pieces_a8(qt):
        rows, valid = st["rows"], st["rows"] >= 0
        seen[rows[valid]] += 1
        want = np.where(valid[..., None], wq[np.where(valid, rows, 0)], 0)
        off = 128 if qt.bits == 8 and not st["unsigned"] else 0
        np.testing.assert_array_equal(st["b"], np.where(valid[..., None], want - off, 0))
        if not per_ch:  # a grouped step lies inside one group, a group's steps in a row
            gs = set((rows[valid] // g_tile).tolist())
            assert len(gs) == 1
            assert group in (None, *gs) or folds.get(group) == 1
            group = gs.pop()
        for ks in range(4):
            a_ks = np.where(valid[ks], a[:, np.where(valid[ks], rows[ks], 0)], 0)
            d += a_ks @ st["b"][ks]
            asum += a_ks.sum(1, keepdims=True)
        if st["fold"] and not per_ch:
            folds[group] = folds.get(group, 0) + 1
            t, gi = divmod(group, qt.groups_per_tile)
            sv, zv = s[t, gi].astype(np.float64), sz[t, gi].astype(np.float64)
            acc += d * sv - asum * (zv - (128 * sv if qt.bits == 8 else 0))
            d[:], asum[:] = 0, 0
    assert (seen == 1).all()
    ref = qk.qmatmul_kernel_a8_reference(aq, qt)
    if per_ch:
        if qt.bits == 8 and route == "rows":  # minus 128 in the dot, 128 * asum back
            d = d + 128 * asum
        d_ref = (aq.double() @ torch.from_numpy(wq).double()).to(torch.int64)
        assert torch.equal(torch.from_numpy(d), d_ref)
        s0, z0 = qt.scales[0, 0].float(), qt.scale_zeros[0, 0].float()
        out = torch.from_numpy(d).float() * s0 - torch.from_numpy(asum).float() * z0
        assert torch.equal(out, ref)
    else:
        assert sorted(folds) == list(range(qt.K // g_tile)) and set(folds.values()) == {1}
        np.testing.assert_allclose(acc, ref.double().numpy(), rtol=1e-5, atol=3e-4)


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
