"""Fused dequantize + matmul ``a[M, K] @ dequant(qt)[K, N]``: the CUDA kernels
and their plain PyTorch versions.

Four sources replace the Pallas kernel
``xbitops_tpu/kernels/qgemv_kernel.py:_kernel``: ``csrc/qgemv_word.cu`` and
``csrc/qgemv_word_planes.cu`` (a few rows, every packed word read once: the
paired 4-bit and the 8-bit plane, and widths 1, 2, 3, 5, 6 and 7),
``csrc/qgemv_mma.cu`` (the tensor-core tile for larger M) and ``csrc/qgemv.cu``
(f32 multiply-adds: ``precise`` and what the others do not take);
:func:`qgemv_form` chooses.
``csrc/qgemv_a8.cu`` replaces ``_kernel_a8`` and ``_kernel_a8_perchannel``
(int8 activations, integer products; :func:`a8_route` says how it walks K).
The note at the top of each source says what bounds it on the card and how the
design answers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from xbitops_tpu_torch.formats import (
    QTensor,
    dequant_qtensor_reference,
    unpack_planes_reference,
)
from xbitops_tpu_torch.kernels import common


def qmatmul_kernel_reference(
    a: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16, precise: bool = False
) -> torch.Tensor:
    """Plain version of :func:`qmatmul_kernel`: the kernel's arithmetic
    (activations rounded to bf16 unless ``precise``, f32 sums) over the
    dense dequantized weight."""
    common.count_plain("qgemv", a)
    a = a.to(torch.float32 if precise else torch.bfloat16).float()
    w = dequant_qtensor_reference(_padded_view(qt), out_dtype=torch.float32)
    return (a @ w).to(out_dtype)


def _pad_k(a: torch.Tensor, K: int) -> torch.Tensor:
    """``a`` with zero columns up to ``K``."""
    return a if a.shape[1] == K else torch.nn.functional.pad(a, (0, K - a.shape[1]))


def _padded_view(qt: QTensor) -> QTensor:
    """The same weight seen with all ``K`` packed rows and ``N`` columns
    (no logical slicing, no permutation): the kernel's own view."""
    return dataclasses.replace(qt, K_logical=qt.K, N_logical=None, perm=None)


CHUNK = 256  # K rows the CUDA-core form stages at a time (csrc/qgemv.cu kChunk)
SUB = 64  # K rows a sub-chunk of the tensor-core tile (csrc/qgemv_mma.cu KS)
# Split-K target in blocks per SM, per form (H100 80GB HBM3, 700 W; PERF.md
# has the tables).  cuda_core: sweep of 1/2/4/8 at the five 7B shapes, M=8: 4
# and 8 tie and beat 2 by ~11% summed over a decode step's matmuls; 4 makes
# fewer partial sums.  gemv, the same sweep (`utils/qgemv_sweep.py --splits`):
# 2, the blocks an SM holds, wins on every shape (30.2 / 19.8 / 42.8 / 33.1 /
# 51.6 us against 36.7 / 19.9 / 60.7 / 33.8 / 64.6 at 1 and 34.3 / 19.8 / 48.2
# / 40.6 / 54.2 at 4); its planes kernel at widths 1-7 on the five shapes
# (`--widths --splits`): 2 sums to 1.448 ms against 1.498 / 1.460 / 1.482 at
# 1 / 4 / 8.  mma at M=32 and 256: 1, 2, 4 and 8 read within 10% of each
# other; 2 is the blocks an SM holds.  gemv16, the few-rows form's 9-16-row
# instance (:func:`word16`): 1, the block an SM holds (152 KB of shared
# memory), splits at any slab; at 2 and 3 (waves of blocks) the served shapes
# at M=16 read 21-39% and 33-75% slower.
BLOCKS_PER_SM = {"cuda_core": 4, "gemv": 2, "gemv16": 1, "mma": 2, "a8": 2}
# The largest M the few-rows form takes (its tile holds 16 activation rows),
# and the smallest the tensor-core tile takes on layouts the few-rows form
# does not decode.  `utils/qgemv_sweep.py`, same card: at M=16 the few-rows
# form takes 0.049 / 0.030 / 0.066 / 0.055 / 0.081 ms at the five 7B shapes
# and the tile 0.086 / 0.033 / 0.154 / 0.090 / 0.189; a 3-bit 4096x4096 weight
# (`chip_smoke.py`) takes 0.0198 ms at M=8 and 0.0246 at M=16 on the few-rows
# form's planes kernel, 0.0515 and 0.1601 on the CUDA cores; the tile took
# 0.112 ms at M=8 and at M=32.
GEMV_MAX_M = 16
MMA_MIN_M = 9
# The launch counter of each form (`common.launches`); the few-rows form
# counts its planes kernel apart (`counter`).
COUNTER = {"gemv": "qgemv", "mma": "qgemv_mma", "cuda_core": "qgemv_cuda_core"}
RUN = 16  # K rows a run of the planes kernel's walk (csrc/qgemv_word_planes.cu kRun)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


SPLIT_COUNTERS = 8192  # column tiles of 256 the few-rows form's split-K tickets cover


@functools.lru_cache(maxsize=None)
def _stream_counters(device: torch.device, stream: int) -> torch.Tensor:
    return torch.zeros(SPLIT_COUNTERS, dtype=torch.int32, device=device)


def _split_counters(a: torch.Tensor, tiles: int) -> torch.Tensor:
    """One zeroed int per column tile for the few-rows form's split-K tickets.
    The kernel sets back what it counted, so the calls of one stream, which
    the stream orders, share a buffer; calls on different streams may be in
    flight together and each stream has its own.  A call that a CUDA graph
    captures may be replayed on any stream, so it zeroes a buffer of its own
    inside the graph."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(tiles, dtype=torch.int32, device=a.device)
    counters = _stream_counters(a.device, common.stream_ptr(a))
    common.require(tiles <= counters.numel(), f"{tiles} column tiles need more counters")
    return counters


def _g_tile(qt: QTensor) -> int:
    """K rows that share a scale row."""
    return qt.tile_k // qt.groups_per_tile


def _word_bytes(qt: QTensor) -> bool:
    """Whether ``csrc/qgemv_word.cu`` decodes ``qt``: one plane, paired 4-bit
    or 8-bit, K-tiles of whole slabs (16 word rows) and scale groups that do
    not cut a slab's run of 32 (8-bit: 16) consecutive K rows."""
    if len(qt.planes) != 1:
        return False
    if qt.bits == 4 and qt.paired:
        return qt.tile_k % 128 == 0 and _g_tile(qt) % 32 == 0
    return qt.bits == 8 and qt.tile_k % 64 == 0 and _g_tile(qt) % 16 == 0


def word16(M: int, qt: QTensor) -> bool:
    """Whether the few-rows form runs ``csrc/qgemv_word.cu``'s 9-16-row
    instance (``qgemv_word_kernel16``, counter ``qgemv_word16`` beside
    ``qgemv``): 9 <= M <= 16 on the paired 4-bit plane where each nibble's
    run of four slabs lies in one scale group (groups of a multiple of 128
    rows, K-tiles of a multiple of 512: the served layouts).  The 8-bit plane
    and the other layouts keep the first instance."""
    return (MMA_MIN_M <= M <= GEMV_MAX_M and qt.bits == 4 and _word_bytes(qt)
            and _g_tile(qt) % 128 == 0 and qt.tile_k % 512 == 0)


def plan_form(form: str, M: int, qt: QTensor) -> str:
    """The key of ``form``'s split plan (:func:`_units`, :func:`_blocks`,
    :func:`_k_splits`): ``"gemv16"`` where the few-rows form runs its
    9-16-row instance, else the form."""
    return "gemv16" if form == "gemv" and word16(M, qt) else form


def planes_runs(qt: QTensor) -> int:
    """F, the runs of a unit of the planes kernel: the fields of a word of
    the narrowest plane (32 at widths 1, 3, 5 and 7; 16 at 2 and 6)."""
    return 32 // min(qt.plane_bits)


def word_planes(qt: QTensor) -> bool:
    """Whether ``csrc/qgemv_word_planes.cu`` decodes ``qt``: widths 1, 2, 3,
    5, 6 and 7 (slot planes of 1 and 2 bits, and a 4-bit plane only paired);
    fp16 scales (the default store) and N a multiple of 8, which it stages
    in 16-byte copies; K-tiles of whole units (16 word rows of the narrowest
    plane, runs of 16 K rows ``tile_k / F`` apart) and scale groups of whole
    runs.  Default packed storage at any group that is a multiple of 16
    meets this."""
    pbs = qt.plane_bits
    if max(pbs) > 4 or (4 in pbs and not qt.paired) or (len(pbs) == 1 and qt.paired):
        return False
    if qt.scales.dtype != torch.float16 or qt.N % 8:
        return False
    g = _g_tile(qt)
    return qt.tile_k % (RUN * planes_runs(qt)) == 0 and qt.tile_k % g == 0 and g % RUN == 0


def word_layout(qt: QTensor) -> bool:
    """Whether the few-rows form decodes ``qt``: one of its two kernels,
    ``csrc/qgemv_word.cu`` (:func:`_word_bytes`) or the planes kernel
    (:func:`word_planes`), which take disjoint layouts, reads every word
    whole."""
    return _word_bytes(qt) or word_planes(qt)


def counter(form: str, qt: QTensor) -> str:
    """The launch counter of ``form`` on ``qt``: the few-rows form's planes
    kernel counts as ``qgemv_planes``."""
    return "qgemv_planes" if form == "gemv" and word_planes(qt) else COUNTER[form]


def mma_whole_words(qt: QTensor) -> bool:
    """Whether the tensor-core tile walks ``qt`` by word rows (the paired
    4-bit plane with K-tiles of whole 32-word-row chunks and scale groups of
    whole 64-row sub-chunks); otherwise it decodes contiguous K rows."""
    return (len(qt.planes) == 1 and qt.bits == 4 and qt.paired and qt.tile_k % 256 == 0
            and _g_tile(qt) % SUB == 0)


def qgemv_form(M: int, precise: bool, qt: QTensor) -> str:
    """Which kernel multiplies ``a[M, K]`` with ``qt``:

    - ``"gemv"``: a few rows (``M <= GEMV_MAX_M``) on a layout whose words it
      reads whole (:func:`word_layout`: every width at default packed storage,
      fp16 scales and groups of a multiple of 16 rows), bf16 activations,
      tensor cores;
    - ``"mma"``: the tensor-core tile, bf16 activations, any width;
    - ``"cuda_core"``: f32 multiply-adds: ``precise`` (bf16 products cannot
      hold rel 1e-5), and at ``M < MMA_MIN_M`` the layouts the few-rows form
      turns away: scale groups that cut a run of 16 K rows (not a multiple of
      16; 4-bit alone then keeps the slot layout), K-tiles that are not whole
      units, f32 scales or N not a multiple of 8 at widths 1-3 and 5-7; and
      scale groups that are not a multiple of 8 rows (the tile's 16-byte
      copies) at any M."""
    if precise:
        return "cuda_core"
    if M <= GEMV_MAX_M and word_layout(qt):
        return "gemv"
    if M >= MMA_MIN_M and _g_tile(qt) % 8 == 0:
        return "mma"
    return "cuda_core"


A8_STEP = 128  # K rows a step of the int8-activation kernel (csrc/qgemv_a8.cu KA)
A8_ROUTES = ("paired", "bytes", "rows")  # csrc/qgemv_a8.cu Route, in its order


def a8_route(qt: QTensor) -> str:
    """How the int8-activation kernel walks K on ``qt``:

    - ``"paired"``: the paired 4-bit plane in whole-word order.  A block of
      word rows stays in shared memory for the four nibbles j, each a run of
      consecutive K rows ``tile_k / 4`` apart.  Takes K-tiles of whole 512
      rows and, grouped, runs that keep a group's rows together: scale groups
      of 128 rows, or of 256 where a run is 256 rows (C = 2), or a run of 128
      rows inside longer groups (``tile_k = 512``);
    - ``"bytes"``: the 8-bit plane in whole-word order (byte j of a word is
      K row r + j * tile_k / 4): K-tiles of whole 128 rows, per channel or one
      scale row a K-tile (all four bytes of a word in one group);
    - ``"rows"``: every other layout, contiguous K rows decoded row by row.

    K padding does not enter: the kernel reads all ``qt.K`` packed rows (the
    op pads the activations with zeros)."""
    if len(qt.planes) != 1:
        return "rows"
    g, P, pb = _g_tile(qt), qt.tile_k // 4, qt.plane_bits[0]
    per_ch = a8_per_channel(qt)
    if pb == 4 and qt.paired and qt.tile_k % 512 == 0:
        m = min(g, P)
        if per_ch or (m in (128, 256) and (P % g == 0 if g <= P else g % P == 0)):
            return "paired"
    if pb == 8 and qt.tile_k % A8_STEP == 0 and (per_ch or g == qt.tile_k):
        return "bytes"
    return "rows"


def a8_whole_words(qt: QTensor) -> bool:
    """Whether the int8-activation kernel reads ``qt``'s words whole (every
    field of a word loaded is used): :func:`a8_route` is not ``"rows"``."""
    return a8_route(qt) != "rows"


def _a8_c(qt: QTensor) -> int:
    """Steps of 128 K rows a nibble j of a PAIRED word block (1 or 2)."""
    if a8_route(qt) != "paired" or a8_per_channel(qt):
        return 1
    return min(_g_tile(qt), qt.tile_k // 4) // A8_STEP


def _units(form: str, qt: QTensor):
    """(units of K the form splits by, their alignment): chunks of 256 rows,
    sub-chunks of up to 64 rows inside a scale group (whole-word chunks are
    four of them), slabs of 16 word rows, or (a8) steps of up to 128 K rows,
    a split holding whole word blocks and, grouped, whole groups."""
    if form == "a8":
        route, g, P = a8_route(qt), _g_tile(qt), qt.tile_k // 4
        one = a8_per_channel(qt)
        if route == "paired":
            return qt.K // A8_STEP, 4 * _a8_c(qt)
        if route == "bytes":
            return qt.K // A8_STEP, (1 if one else P // 32)
        cpg = -(-g // A8_STEP)
        return (qt.K // g) * cpg, (1 if one else cpg)
    if form == "cuda_core":
        return -(-qt.K // CHUNK), 1
    if form == "gemv" and word_planes(qt):
        return qt.K // (RUN * planes_runs(qt)), 1
    if form == "gemv16":  # slabs; a split may cut a window, where it folds too
        return qt.K // 128, 1
    if form == "gemv":
        # four slabs fold together where a scale group holds their rows: the
        # splits then start on a stage (csrc/qgemv_word.cu LAZY)
        rows = 128 if qt.bits == 4 else 64
        lazy = _g_tile(qt) % rows == 0 and qt.tile_k % (4 * rows) == 0
        return qt.K // rows, (4 if lazy else 1)
    if mma_whole_words(qt):
        return qt.K // SUB, 4
    g = _g_tile(qt)
    return (qt.K // g) * -(-g // SUB), 1


def _blocks(form: str, M: int, N: int) -> int:
    """Blocks of the form's grid before K is split."""
    if form == "cuda_core":
        tm, cols = (8, 128 if N % 4 == 0 else 32) if M <= 8 else (32, 32)
    elif form in ("gemv", "gemv16"):
        tm, cols = 16, 256
    elif form == "a8":
        tm, cols = 128, 128
    else:
        tm, cols = (64 if M <= 64 else 128), 64
    return -(-N // cols) * -(-M // tm)


def _k_splits(form: str, M: int, N: int, units: int, sms: int, align: int = 1):
    """(splits, units per split): split K until the grid has about
    ``BLOCKS_PER_SM[form]`` blocks per SM; shapes with few rows have too few
    otherwise.  ``per`` is a multiple of ``align`` and ``splits * per``
    covers ``units``.  The few-rows form stays at or under that number (one
    wave of resident blocks: a second wave of its short-lived blocks cost
    more than it filled); the other two go just over it."""
    target, blocks = BLOCKS_PER_SM[form] * sms, _blocks(form, M, N)
    want = target // blocks if form in ("gemv", "gemv16") else -(-target // blocks)
    want = min(units, max(1, want))
    per = -(-(-(-units // want)) // align) * align
    return -(-units // per), per


def qmatmul_kernel(
    a: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16, precise: bool = False,
    a8: bool = False, form: Optional[str] = None,
) -> torch.Tensor:
    """``a (M, K) @ dequant(qt) (K, N) -> (M, N)`` without materialising the weight.

    ``a`` must already be permuted (the public op ``ops.qmatmul`` does it) and
    hold ``qt.K_logical`` to ``qt.K`` columns: the packed rows past its last
    column are K padding and meet zeros, inside the kernel where the form
    allows it (no padded copy of the activations is made).  Activations enter
    in bf16, or in f32 when ``precise``; sums are f32.  With ``a8`` they are
    int8 ``[M, qt.K]`` (quantized per row by the op, which applies their scale
    to this f32 output) and the products are integer: see
    :func:`qmatmul_kernel_a8`.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.  ``form`` overrides
    :func:`qgemv_form` (to time one form against another); a form that does
    not take the input raises."""
    if a8:
        common.require(not precise, "a8 is integer-exact; `precise` does not apply")
        common.require(out_dtype == torch.float32, "the a8 kernels write f32")
        return qmatmul_kernel_a8(a, qt)
    req = common.require
    M, Ka = a.shape
    K = qt.K
    req(qt.K_logical <= Ka <= K, f"activation K={Ka} outside [{qt.K_logical}, {K}]")
    if not a.is_cuda:
        return qmatmul_kernel_reference(_pad_k(a, K), qt, out_dtype, precise)
    req(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype {out_dtype}")
    qargs = common.qtensor_args(qt, a.device)
    N = qt.N
    a = a.to(torch.float32 if precise else torch.bfloat16).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0:
        return out
    form = form or qgemv_form(M, precise, qt)
    req(form in COUNTER, f"form {form!r}")
    if form == "cuda_core" or Ka % 8:  # the form, or its 16-byte copies, need whole rows
        a, Ka = _pad_k(a, K), K
    if a.data_ptr() % 16:  # a view that starts inside an allocation
        a = a.clone()
    req(form == "cuda_core" or not precise, "`precise` runs on the CUDA-core form only")
    req(form != "gemv" or (M <= GEMV_MAX_M and word_layout(qt)),
        f"the few-rows form does not take M={M}, bits={qt.bits}, tile_k={qt.tile_k}")
    key = plan_form(form, M, qt)
    units, align = _units(key, qt)
    splits, per = _k_splits(key, M, N, units, _sm_count(a.device.index), align)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    tail = (None if part is None else part.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), common.stream_ptr(a))
    if form == "cuda_core":
        err = common.lib().xb_qgemv(
            a.data_ptr(), int(precise), M, K, N, *qargs, splits, per * CHUNK, *tail)
    elif form == "mma":
        err = common.lib().xb_qgemv_mma(a.data_ptr(), M, K, Ka, N, *qargs, splits, per, *tail)
    else:
        counters = _split_counters(a, -(-N // 256)) if splits > 1 else None
        cptr = None if counters is None else counters.data_ptr()
        if word_planes(qt):
            err = common.lib().xb_qgemv_word_planes(
                a.data_ptr(), M, K, Ka, N, *qargs, splits, per, tail[0], cptr, *tail[1:])
        else:
            err = common.lib().xb_qgemv_word(
                a.data_ptr(), M, K, Ka, N, qargs[0], qt.bits, *qargs[7:], splits, per, tail[0],
                cptr, *tail[1:])
    name = counter(form, qt)
    common.check(err, name)
    common.launches[name] += 1
    if key == "gemv16":
        common.launches["qgemv_word16"] += 1
    return out


def a8_per_channel(qt: QTensor) -> bool:
    """Whether the a8 matmul of ``qt`` takes the per-channel kernel: one scale
    group spans all packed rows (the JAX package's rule).  A per-channel
    weight whose K had to pad to a tile multiple has ``group_size < K`` and
    takes the grouped kernel."""
    return qt.group_size >= qt.K


def _a8_name(qt: QTensor) -> str:
    return "qgemv_a8_perchannel" if a8_per_channel(qt) else "qgemv_a8"


def qmatmul_kernel_a8_reference(aq: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version of :func:`qmatmul_kernel_a8`, with the kernels' algebra.

    The integer dots run in float64, which holds them exactly (a per-channel
    sum reaches 127 * 255 * K, past float32's 2**24).  Per channel, the
    rescale repeats the kernel's f32 operations one for one; grouped, the
    groups fold in f32 in K order (the kernel may fuse each multiply-add)."""
    common.count_plain(_a8_name(qt), aq)
    wq = unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    M, N = aq.shape[0], qt.N
    if a8_per_channel(qt):
        d = (aq.double() @ wq.double()).to(torch.int64)
        asum = aq.sum(dim=1, keepdim=True, dtype=torch.int64)
        s, sz = qt.scales[0, 0].float(), qt.scale_zeros[0, 0].float()
        return d.float() * s - asum.float() * sz
    g_tile = qt.tile_k // qt.groups_per_tile  # K rows per scale row
    off = 128 if qt.bits == 8 else 0  # width 8 enters the dot minus 128
    acc = torch.zeros((M, N), dtype=torch.float32, device=aq.device)
    for u in range(qt.K // g_tile):
        t, gi = divmod(u, qt.groups_per_tile)
        rows = slice(u * g_tile, (u + 1) * g_tile)
        a_g = aq[:, rows]
        d = a_g.double() @ (wq[rows] - off).double()
        asum = a_g.sum(dim=1, keepdim=True, dtype=torch.int64).float()
        s, sz = qt.scales[t, gi].float(), qt.scale_zeros[t, gi].float()
        acc = acc + d.float() * s - asum * (sz - off * s)
    return acc


@dataclasses.dataclass(frozen=True)
class A8Plan:
    """What one int8-activation call launches: the route, its C (PAIRED
    steps a nibble and word block), the K splits and steps a split, and the
    split-K workspace (None without a split): f32 ``[splits, M, N]`` partial
    outputs grouped, added in split order; per channel int32 partial sums
    ``[splits, M, N]`` then ``[splits, M]`` of asum, added exactly before the
    one rescale."""

    route: str
    c: int
    splits: int
    per: int
    part_dtype: Optional[torch.dtype]
    part_numel: int


def a8_plan(qt: QTensor, M: int, sms: int) -> A8Plan:
    units, align = _units("a8", qt)
    splits, per = _k_splits("a8", M, qt.N, units, sms, align)
    numel, dtype = 0, None
    if splits > 1:
        per_ch = a8_per_channel(qt)
        dtype = torch.int32 if per_ch else torch.float32
        numel = splits * (M * qt.N + (M if per_ch else 0))
    return A8Plan(a8_route(qt), _a8_c(qt), splits, per, dtype, numel)


def qmatmul_kernel_a8(aq: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``aq int8 (M, K)`` times the integer weight values of ``qt`` with the
    scales applied to the integer dots, f32 ``(M, N)``:
    ``sum_g s_g * (aq_g . wq_g) - (sum aq_g) * sz_g``.  One scale group over
    all of K (:func:`a8_per_channel`) takes the per-channel kernel, which
    keeps one integer sum over K and rescales once."""
    req = common.require
    req(aq.dtype == torch.int8 and aq.dim() == 2, "a8 activations must be int8 [M, K]")
    if not aq.is_cuda:
        return qmatmul_kernel_a8_reference(aq, qt)
    M, K = aq.shape
    req(K == qt.K, f"activation K={K} != packed K={qt.K}")
    req(K < 66000, "int32 sums over K need K < 66000")
    qargs = common.qtensor_args(qt, aq.device)
    aq = aq.contiguous()
    if aq.data_ptr() % 16:  # a view that starts inside an allocation
        aq = aq.clone()
    out = torch.empty((M, qt.N), dtype=torch.float32, device=aq.device)
    if M == 0:
        return out
    plan = a8_plan(qt, M, _sm_count(aq.device.index))
    part = None
    if plan.splits > 1:
        part = torch.empty(plan.part_numel, dtype=plan.part_dtype, device=aq.device)
    err = common.lib().xb_qgemv_a8(
        aq.data_ptr(), M, K, qt.N, *qargs, int(a8_per_channel(qt)), A8_ROUTES.index(plan.route),
        plan.c, plan.splits, plan.per, None if part is None else part.data_ptr(), out.data_ptr(),
        common.stream_ptr(aq))
    name = _a8_name(qt)
    common.check(err, name)
    common.launches[name] += 1
    return out
