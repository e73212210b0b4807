"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (nvcc builds the kernels at first use) and skip
without one.  They import neither JAX nor the JAX package, so they run where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: fused matmul rel 1e-5 / abs 3e-4 with f32 activations and rel 2e-2
(of the output's largest value) with bf16 ones; appended cache rows, words
and scales exact; attention outputs abs 2e-2 in bf16, padding queries of the
prefill attention exactly 0; the dequant kernel equal to its plain version bit
for bit; the int8-activation matmul equal per channel (its only f32 operations
repeat the plain version's) and rel 1e-5 / abs 3e-4 grouped (the groups' f32
folds may fuse their multiply-adds).  The paged forms of the two attention
kernels and the two appends are held to their plain versions at the same
tolerances, and to the linear kernels on the cache the pool was cut from.
The fp16 and f32 caches' forms of the two attention kernels and of the append
(linear and paged) are held to the same plain versions on the same cache:
appends bit for bit, fp16 attention abs 2e-2, f32 attention abs 1e-4 beyond
the rounding of its bf16 output (``_beyond_rounding``: both outputs are bf16,
and a flip of their last bit is 7.8e-3 at |out| >= 1, whatever the
arithmetic), and the graph and speculative engines serve on such caches.
The engine's decode bursts, captured as CUDA graphs and replayed, give the
eager bursts' greedy tokens exactly (bf16, int8, paged and eager-attention
caches, a slot deferred), count an eager burst's launches a replay, and are
captured again after a restart; sampled graphs are seeded and stay in top_k.
A speculative engine replays each verify step (a draft model's chain inside
it) as one graph with the eager steps' tokens and ``spec_stats``; pipelined
bursts give the synchronous engine's tokens; the unaligned write (T append
launches a layer) leaves each cache form as its plain version does.  A tiny
MoE model's graph-replayed bursts (bf16 and int8 cache) and γ=2 verify steps
give the eager engine's tokens; GPTQ with an identity Hessian equals
round-to-nearest bit for bit on the card, and its Hessian is a true-f32 sum.
One rank's shards of Llama-2-7B under tensor parallelism (tp=2, and w_down at
tp=4) take the few-rows form at M=8 and agree with its plain version.
"""

import dataclasses

import pytest
import torch

from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.kernels.dequant_kernel import dequant_kernel, dequant_kernel_reference
from xbitops_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from xbitops_tpu_torch.kernels.kv_append import (
    gather_pages,
    kv_append_dense,
    kv_append_dense_reference,
    kv_append_packed,
    kv_append_packed_reference,
)
from xbitops_tpu_torch.kernels.prefill_attention import (
    prefill_attention,
    prefill_attention_reference,
)
from xbitops_tpu_torch.kernels.qgemv_kernel import (
    COUNTER,
    GEMV_MAX_M,
    _stream_counters,
    a8_per_channel,
    a8_plan,
    counter,
    mma_whole_words,
    qgemv_form,
    qmatmul_kernel,
    qmatmul_kernel_a8,
    qmatmul_kernel_a8_reference,
    word_layout,
    word_planes,
)
from xbitops_tpu_torch.ops.dequant import dequant_qtensor
from xbitops_tpu_torch.ops.qmatmul import qmatmul, quantize_activations
from xbitops_tpu_torch.ops.quantize import quantize_array, requantize_a8
from xbitops_tpu_torch.utils import synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# (bits, group_size, K, tile_k): paired and slot layouts, one or several groups
# per tile, groups longer than a tile, K padded to the tile.
QCASES = [(b, 128, 512, None) for b in range(1, 9)] + [
    (4, 40, 640, None), (5, 40, 1280, None), (4, 64, 200, None),
    (3, 512, 1024, 256), (8, 32, 96, 32),
]


@pytest.mark.parametrize("bits,g,K,tile_k", QCASES)
@pytest.mark.parametrize("M", [1, 8, 9, 40])
def test_qmatmul_kernel_matches_plain(dev, bits, g, K, tile_k, M):
    gen = _gen(dev, bits * 100 + M)
    qt = synth.random_qtensor(gen, K, 160, bits, g, tile_k=tile_k)
    a = torch.randn(M, K, device=dev, generator=gen)
    ref = qmatmul(a, qt, use_kernel=False)
    got = qmatmul(a, qt, precise=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)
    a16 = a.to(torch.bfloat16)
    ref = qmatmul(a16, qt, out_dtype=torch.float32, use_kernel=False)
    got = qmatmul(a16, qt)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


# the same shapes, and the two shapes the whole-word forms were written for:
# K-tiles of 1024 rows (paired 4-bit) and of 512 (8-bit), several tiles
FORM_CASES = QCASES + [(4, 128, 2048, None), (8, 128, 1024, None), (4, 64, 1024, 256),
                       (8, 16, 256, 64)]


@pytest.mark.parametrize("bits,g,K,tile_k", FORM_CASES)
@pytest.mark.parametrize("M", [1, 8, 9, 40, 300])
@pytest.mark.parametrize("N", [160, 100, 99])
def test_qmatmul_forms_match_plain(dev, bits, g, K, tile_k, M, N):
    """The few-rows form and the tensor-core tile, each forced wherever it
    takes the input, against the plain version (rel 2e-2 of the largest
    output, bf16 out) and against the CUDA-core form in f32 (the same algebra
    on exact products: only the order of the f32 sums differs, rel 1e-4).
    N = 160 is no multiple of either tile, 100 takes the 16-byte loads
    without the 8-column stores, 99 the single-word loads."""
    gen = _gen(dev, bits * 1000 + M + N)
    qt = synth.random_qtensor(gen, K, N, bits, g, tile_k=tile_k)
    a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
    a_pad = torch.nn.functional.pad(a, (0, qt.K - K))
    core = qmatmul_kernel(a_pad, qt, out_dtype=torch.float32, form="cuda_core")
    top = ref.abs().max()
    forms = ["mma"] if (qt.tile_k // qt.groups_per_tile) % 8 == 0 else []
    if M <= GEMV_MAX_M and word_layout(qt):
        forms.append("gemv")
    assert qgemv_form(M, False, qt) in forms + ["cuda_core"]
    for form in forms:
        common.reset_counts()
        got = qmatmul_kernel(a_pad, qt, out_dtype=torch.float32, form=form)
        assert common.launches[counter(form, qt)] == 1
        assert sum(common.launches.values()) == 1 and not any(common.plain_on_cuda.values())
        assert (got - core).abs().max() <= 1e-4 * top, form
        got16 = qmatmul_kernel(a_pad, qt, form=form)
        assert got16.dtype == torch.bfloat16
        assert (got16.float() - ref).abs().max() <= 2e-2 * top, form
    if (bits, g, K) == (4, 128, 2048):
        assert mma_whole_words(qt) and word_layout(qt)
    if "gemv" not in forms:
        with pytest.raises(ValueError):
            qmatmul_kernel(a_pad, qt, form="gemv")


# the planes kernel of the few-rows form, every width at default storage:
# (bits, group, K, N, tile_k): the 7B K-tiles (K split across blocks), a small
# tile with groups over four runs (no split), K padded to its tile (4000 ->
# 4096), groups of 32 at tiles of 4096 and 1536 (runs 128 and 48 rows
# apart), one group a K-tile, and N that ends inside a block's 256 columns
# (296, 264, 160)
PLANES_CASES = [(b, 128, 4096, 512, None) for b in (1, 2, 3, 5, 6, 7)] + [
    (b, 128, 512, 296, None) for b in (1, 2, 3, 5, 6, 7)] + [
    (5, 128, 4000, 256, None), (3, 32, 4096, 264, 4096), (3, 32, 3072, 256, 1536),
    (6, 64, 2048, 160, None), (7, 1024, 2048, 296, None)]


@pytest.mark.parametrize("bits,g,K,N,tile_k", PLANES_CASES)
@pytest.mark.parametrize("M", [1, 8, 13, 16])
def test_few_rows_planes_kernel_matches_plain(dev, bits, g, K, N, tile_k, M):
    """The few-rows form's planes kernel (widths 1, 2, 3, 5, 6, 7), routed by
    ``qgemv_form``: one launch of ``qgemv_planes`` a call, against the plain
    version (rel 2e-2 of the largest output, bf16 out) and against the
    CUDA-core form in f32 (exact products, f32 sums in another order: rel
    1e-4); the same bits from a second call and from a CUDA graph replay
    (which zeroes split-K tickets of its own)."""
    gen = _gen(dev, bits * 7 + K + N + M)
    qt = synth.random_qtensor(gen, K, N, bits, g, tile_k=tile_k)
    assert word_planes(qt) and qgemv_form(M, False, qt) == "gemv"
    a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
    top = ref.abs().max()
    a_pad = torch.nn.functional.pad(a, (0, qt.K - K))
    core = qmatmul_kernel(a_pad, qt, out_dtype=torch.float32, form="cuda_core")
    common.reset_counts()
    got = qmatmul_kernel(a, qt, out_dtype=torch.float32)
    assert common.launches == {**dict.fromkeys(common.launches, 0), "qgemv_planes": 1}
    assert not any(common.plain_on_cuda.values())
    assert (got - core).abs().max() <= 1e-4 * top
    got16 = qmatmul(a, qt)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max() <= 2e-2 * top
    assert torch.equal(qmatmul_kernel(a, qt, out_dtype=torch.float32), got)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmatmul_kernel(a, qt, out_dtype=torch.float32)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("M", [(3, 5), (3, 50)], ids=["M15", "M150"])
def test_qmatmul_forms_f32_scales_perm_n_logical_layer(dev, M):
    """The routed bf16 forms through the op: a stacked QTensor's layer view,
    f32 scales, the act-order gather, K padding and the N_logical cut."""
    gen = _gen(dev, 8)
    qts = [synth.random_qtensor(gen, 300, 256, 4, 128) for _ in range(2)]
    st = dataclasses.replace(
        qts[0],
        planes=tuple(torch.stack(p) for p in zip(*(q.planes for q in qts))),
        scales=torch.stack([q.scales.float() for q in qts]),
        scale_zeros=torch.stack([q.scale_zeros.float() for q in qts]),
        perm=torch.stack([torch.randperm(300, device=dev, generator=gen) for _ in qts]),
        N_logical=250,
    )
    a = torch.randn(*M, 300, device=dev, generator=gen).to(torch.bfloat16)
    for li in (0, 1):
        ref = qmatmul(a, st, layer=li, out_dtype=torch.float32, use_kernel=False)
        common.reset_counts()
        got = qmatmul(a, st, layer=li)
        name = COUNTER[qgemv_form(M[0] * M[1], False, st.layer(li))]
        assert common.launches[name] == 1 and not any(common.plain_on_cuda.values())
        assert got.shape == (*M, 250) and got.dtype == torch.bfloat16
        assert (got.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_qmatmul_few_rows_on_two_streams(dev):
    """Few-rows calls with split K in flight on two streams: each stream has
    its own split-K tickets, so both give what one stream gives, and the
    tickets are back at zero afterwards."""
    gen = _gen(dev, 9)
    qts = [synth.random_qtensor(gen, 4096, 512, 4, 128) for _ in range(2)]
    acts = [torch.randn(8, 4096, device=dev, generator=gen).to(torch.bfloat16) for _ in qts]
    want = [qmatmul_kernel(a, qt, form="gemv") for a, qt in zip(acts, qts)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in qts]
    for _ in range(50):
        got = []
        for s, a, qt in zip(streams, acts, qts):
            with torch.cuda.stream(s):
                got.append(qmatmul_kernel(a, qt, form="gemv"))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for s in streams:
        assert _stream_counters(dev, s.cuda_stream).abs().max() == 0


def test_cuda_core_form_has_its_own_counter(dev):
    """`precise`, and a few rows on a layout the few-rows form does not read
    (groups of 40), count as the CUDA-core form and as nothing else."""
    gen = _gen(dev, 10)
    a = torch.randn(8, 640, device=dev, generator=gen)
    for precise, qt in ((True, synth.random_qtensor(gen, 512, 160, 4, 128)),
                        (False, synth.random_qtensor(gen, 640, 160, 4, 40))):
        assert qgemv_form(8, precise, qt) == "cuda_core"
        common.reset_counts()
        qmatmul(a[:, :qt.K_logical], qt, precise=precise)
        assert common.launches["qgemv_cuda_core"] == 1 and sum(common.launches.values()) == 1


def test_qmatmul_kernel_f32_scales_perm_n_logical_layer(dev):
    gen = _gen(dev, 7)
    qts = [synth.random_qtensor(gen, 300, 256, 4, 128) for _ in range(2)]
    st = dataclasses.replace(
        qts[0],
        planes=tuple(torch.stack(p) for p in zip(*(q.planes for q in qts))),
        scales=torch.stack([q.scales.float() for q in qts]),
        scale_zeros=torch.stack([q.scale_zeros.float() for q in qts]),
        perm=torch.stack([torch.randperm(300, device=dev, generator=gen) for _ in qts]),
        N_logical=250,
    )
    a = torch.randn(3, 5, 300, device=dev, generator=gen)
    for li in (0, 1):
        ref = qmatmul(a, st, layer=li, use_kernel=False)
        got = qmatmul(a, st, layer=li, precise=True)
        assert got.shape == (3, 5, 250)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("D,H,Hkv,S", [(128, 8, 8, 600), (128, 32, 4, 257), (64, 8, 1, 255),
                                       (256, 4, 2, 1000)])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_kernel_matches_plain(dev, D, H, Hkv, S, window):
    gen = _gen(dev, D + S)
    B, L = 5, 2
    k = torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    kn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    vn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    pos = torch.tensor([0, S - 1, S, 255 % S, S // 2], device=dev)  # S: inactive
    lens = torch.clamp(pos + 1, max=S)
    k2, v2 = k.clone(), v.clone()
    out, rk, rv = decode_attention(q, k, v, lens, layer_idx=1, kv_new=(kn, vn, pos),
                                   window=window)
    assert rk is k and rv is v
    kv_append_dense_reference(k2, v2, kn, vn, pos, 1)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    ref = decode_attention_reference(q, k2[1], v2[1], lens, window)
    assert (out.float() - ref.float()).abs().max() <= 2e-2
    zero = decode_attention(q, k[0], v[0], torch.zeros(B, dtype=torch.int32, device=dev))
    assert zero.abs().max() == 0  # a slot with no live rows attends nothing


def test_kv_append_kernel_guards(dev):
    k = torch.zeros(2, 4, 2, 16, 128, dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    new = torch.randn(4, 2, 128, device=dev).to(torch.bfloat16)
    pos = torch.tensor([3, -1, 16, 40], device=dev)  # rows 1-3 out of [0, S)
    k2, v2 = k.clone(), v.clone()
    kv_append_dense(k, v, new, new, pos, 1)
    kv_append_dense_reference(k2, v2, new, new, pos, 1)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    assert torch.equal(k[1, 0, :, 3], new[0])  # the only row in bounds
    k[1, 0, :, 3] = 0
    assert k.abs().max() == 0


def test_wrappers_count_and_reject(dev):
    common.reset_counts()
    q = torch.zeros(1, 4, 96, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 1, 4, 8, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # head_dim 96 is not built
        decode_attention(q, k, k, torch.ones(1, device=dev), layer_idx=0)
    with pytest.raises(ValueError):  # the dense cache is bf16, fp16 or f32
        kv_append_dense(k.double(), k.double(), k[0, 0, :, 0].double()[None],
                        k[0, 0, :, 0].double()[None], torch.zeros(1, device=dev), 0)
    qt = synth.random_qtensor(_gen(dev, 0), 256, 128, 4, 128)
    name = COUNTER[qgemv_form(2, False, qt)]
    qmatmul(torch.ones(2, 256, device=dev), qt)
    assert common.launches[name] == 1 and common.plain_on_cuda["qgemv"] == 0
    qmatmul(torch.ones(2, 256, device=dev), qt, use_kernel=False)
    assert common.launches[name] == 1 and common.plain_on_cuda["qgemv"] == 1


def _packed_cache(gen, L, B, Hkv, S, D):
    """A random packed int8 cache on gen's device: words, words, scales, scales."""
    dev = gen.device
    words = [torch.randint(-(2**31), 2**31, (L, B, Hkv, S // 4, D), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.int32) for _ in range(2)]
    scales = [torch.empty((L, B, 4, Hkv, S // 4), device=dev).uniform_(lo, hi, generator=gen)
              .to(torch.bfloat16) for lo, hi in ((0.002, 0.01), (0.005, 0.02))]
    return (*words, *scales)


def _new_packed_rows(gen, B, Hkv, D):
    dev = gen.device
    kq, vq = (torch.randint(1, 256, (B, Hkv, D), generator=gen, device=dev, dtype=torch.int32)
              for _ in range(2))
    ks, vs = (torch.empty((B, Hkv), device=dev).uniform_(0.002, 0.02, generator=gen)
              for _ in range(2))
    return kq, vq, ks, vs


@pytest.mark.parametrize("L,B,Hkv,S,D", [(2, 8, 32, 2048, 128), (1, 5, 3, 20, 64),
                                         (2, 6, 1, 8, 256)])
def test_kv_append_packed_kernel_matches_plain(dev, L, B, Hkv, S, D):
    gen = _gen(dev, S + B)
    cache = _packed_cache(gen, L, B, Hkv, S, D)
    ref = [t.clone() for t in cache]
    new = _new_packed_rows(gen, B, Hkv, D)
    pos = torch.tensor([0, 1, 2, S - 1, S, -1, 7, 5][:B], device=dev)  # S, -1: no-op
    out = kv_append_packed(*cache, *new, pos, L - 1)
    kv_append_packed_reference(*ref, *new, pos, L - 1)
    for got, o, want in zip(cache, out, ref):
        assert o is got and torch.equal(got, want)
    untouched = _packed_cache(_gen(dev, S + B), L, B, Hkv, S, D)
    assert not torch.equal(cache[0], untouched[0]) and not torch.equal(cache[3], untouched[3])
    if L > 1:
        assert torch.equal(cache[0][0], untouched[0][0])  # the other layer


@pytest.mark.parametrize("D,H,Hkv,S", [(128, 8, 8, 600), (128, 32, 4, 260), (64, 8, 1, 252),
                                       (256, 4, 2, 1000), (128, 32, 32, 2048)])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_int8_kernel_matches_plain(dev, D, H, Hkv, S, window):
    gen = _gen(dev, D + S)
    B, L = 5, 2
    k, v, ks, vs = _packed_cache(gen, L, B, Hkv, S, D)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    new = _new_packed_rows(gen, B, Hkv, D)
    pos = torch.tensor([0, S - 1, S, 255 % S, S // 2 + 1], device=dev)  # S: inactive
    lens = torch.clamp(pos + 1, max=S)
    ref = [t.clone() for t in (k, v, ks, vs)]
    out, *rest = decode_attention(q, k, v, lens, layer_idx=1, k_scale=ks, v_scale=vs,
                                  kv_new=(*new, pos), window=window)
    assert all(r is t for r, t in zip(rest, (k, v, ks, vs)))
    kv_append_packed_reference(*ref, *new, pos, 1)
    for got, want in zip((k, v, ks, vs), ref):
        assert torch.equal(got, want)
    want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, window, ref[2][1], ref[3][1])
    assert (out.float() - want.float()).abs().max() <= 2e-2
    assert want.float().abs().max() > 0.05
    zero = decode_attention(q, k[0], v[0], torch.zeros(B, dtype=torch.int32, device=dev),
                            k_scale=ks[0], v_scale=vs[0])
    assert zero.abs().max() == 0  # a slot with no live rows attends nothing


def _chunk_positions(dev, starts, lens, T, S):
    pos = torch.tensor(starts, device=dev)[:, None] + torch.arange(T, device=dev)[None]
    return torch.where(pos < torch.tensor(lens, device=dev)[:, None], pos, S)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16cache", "int8cache"])
@pytest.mark.parametrize("D,H,Hkv,S,T,window", [
    (128, 32, 32, 2048, 512, None), (128, 32, 8, 2048, 512, 512), (128, 8, 2, 300, 70, None),
    (64, 4, 4, 128, 64, 20), (256, 4, 1, 200, 96, None), (128, 4, 4, 64, 4, None),
    (64, 8, 2, 512, 100, None), (64, 4, 1, 300, 200, 64), (128, 8, 8, 1024, 333, None),
])
def test_prefill_attention_kernel_matches_plain(dev, int8, D, H, Hkv, S, T, window):
    gen = _gen(dev, D + S + T)
    B, L = 5, 2
    S = S - S % 4
    if int8:
        k, v, ks, vs = _packed_cache(gen, L, B, Hkv, S, D)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        scales = {}
    q = torch.randn(4, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    # a chunk from 0 that ends mid-chunk, the cache's last chunk, one in the
    # middle, and an inert row (slot out of range, nothing but padding)
    starts = [0, S - T, (S - T) // 2 // 4 * 4, 0]
    lens = [max(T - 5, 1), S, S, 0]
    pos = _chunk_positions(dev, starts, lens, T, S)
    slots = torch.tensor([3, 0, 4, B], device=dev)
    got = prefill_attention(q, k, v, pos, slots, layer_idx=1, window=window, **scales)
    one = {name: t[1] for name, t in scales.items()}
    want = prefill_attention_reference(q, k[1], v[1], pos, slots, window=window, **one)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2e-2
    assert want.float().abs().max() > 0.05
    assert (got[pos >= S] == 0).all() and (pos >= S).any()
    # a flat cache, and padding in the middle of a row
    pos2 = pos.clone()
    pos2[1, T // 2] = S
    flat = {name: t[0] for name, t in scales.items()}
    got = prefill_attention(q, k[0], v[0], pos2, slots, window=window, **flat)
    want = prefill_attention_reference(q, k[0], v[0], pos2, slots, window=window, **flat)
    assert (got.float() - want.float()).abs().max() <= 2e-2
    assert (got[1, T // 2] == 0).all()


def test_new_wrappers_count_and_reject(dev):
    common.reset_counts()
    gen = _gen(dev, 1)
    k, v, ks, vs = _packed_cache(gen, 1, 2, 2, 16, 128)
    q = torch.zeros(2, 4, 128, dtype=torch.bfloat16, device=dev)
    lens = torch.ones(2, device=dev)
    decode_attention(q, k, v, lens, layer_idx=0, k_scale=ks, v_scale=vs)
    assert common.launches["decode_attention_int8"] == 1
    assert common.launches["decode_attention"] == 0
    with pytest.raises(ValueError):  # scales must be bf16
        decode_attention(q, k, v, lens, layer_idx=0, k_scale=ks.float(), v_scale=vs.float())
    with pytest.raises(ValueError):  # words must be int32
        kv_append_packed(k.long(), v.long(), ks, vs, *_new_packed_rows(gen, 2, 2, 128), lens, 0)
    table = torch.tensor([[1], [0]], dtype=torch.int32, device=dev)  # k/v as 2 pages of 16
    decode_attention(q, k, v, lens, layer_idx=0, k_scale=ks, v_scale=vs, page_table=table)
    assert common.launches["decode_attention_int8_paged"] == 1
    assert common.launches["decode_attention_int8"] == 1
    with pytest.raises(ValueError):  # the table must be int32
        decode_attention(q, k, v, lens, layer_idx=0, k_scale=ks, v_scale=vs,
                         page_table=table.long())
    qc = torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16, device=dev)
    pos = torch.arange(8, device=dev)[None].expand(2, 8)
    prefill_attention(qc, k, v, pos, torch.arange(2, device=dev), layer_idx=0,
                      k_scale=ks, v_scale=vs)
    assert common.launches["prefill_attention"] == 1
    with pytest.raises(ValueError):  # q must be bf16 on the card
        prefill_attention(qc.float(), k, v, pos, torch.arange(2, device=dev), layer_idx=0,
                          k_scale=ks, v_scale=vs)
    assert common.launches["prefill_attention"] == 1
    assert not any(common.plain_on_cuda.values())


@pytest.mark.parametrize("bits,g,K,tile_k", QCASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dequant_kernel_equals_plain(dev, bits, g, K, tile_k, out_dtype):
    gen = _gen(dev, bits)
    for N in (160, 130):  # 16-byte and single-word column paths
        qt = synth.random_qtensor(gen, K, N, bits, g, tile_k=tile_k)
        common.reset_counts()
        got = dequant_kernel(qt, out_dtype)
        assert common.launches["dequant"] == 1 and common.plain_on_cuda["dequant"] == 0
        ref = dequant_kernel_reference(qt, out_dtype)
        assert got.shape == (qt.K, N) and got.dtype == out_dtype
        assert torch.equal(got, ref)


def test_dequant_qtensor_f32_scales_act_order_padding(dev):
    w = torch.randn(200, 200, device=dev, generator=_gen(dev, 1))
    qt = quantize_array(w, 4, 64, act_order=True, scale_store_dtype=torch.float32)
    assert qt.perm is not None and qt.K != 200 and qt.N_logical == 200
    got = dequant_qtensor(qt, torch.float32)
    assert torch.equal(got, dequant_qtensor(qt, torch.float32, use_kernel=False))
    assert (got - w).abs().max() <= 0.51 * qt.scales.max()


# grouped: (bits, group_size, K, tile_k) with groups of one chunk, several
# chunks, less than a chunk, not a multiple of 32 rows, and a padded K; then
# the whole-word layouts at their edges (kernels/qgemv_kernel.a8_route): the
# paired plane with K-tiles of 1024 and 512 and groups of 128 and 256 (C = 2
# where a run of a nibble is 256 rows; at tile 512 a group spans two nibbles),
# and the 8-bit plane with one scale row a K-tile
A8_GROUPED = [(2, 128, 512, None), (4, 128, 1024, None), (8, 128, 512, None),
              (3, 128, 512, None), (7, 64, 512, None), (4, 32, 256, None),
              (4, 40, 640, None), (4, 512, 1024, 256), (8, 256, 1000, None),
              (5, 128, 200, None), (4, 128, 1024, 512), (4, 256, 2048, 1024),
              (4, 256, 1024, 512), (4, 128, 2048, 1024), (8, 1024, 2048, 1024)]


@pytest.mark.parametrize("bits,g,K,tile_k", A8_GROUPED)
@pytest.mark.parametrize("M,N", [(1, 160), (40, 130), (300, 384)])
def test_a8_grouped_kernel_matches_plain(dev, bits, g, K, tile_k, M, N):
    gen = _gen(dev, bits * 1000 + M)
    qt = synth.random_qtensor(gen, K, N, bits, g, tile_k=tile_k)
    assert not a8_per_channel(qt)
    a = torch.nn.functional.pad(torch.randn(M, K, device=dev, generator=gen), (0, qt.K - K))
    aq, a_scale = quantize_activations(a)
    common.reset_counts()
    got = qmatmul_kernel_a8(aq, qt) * a_scale
    assert common.launches["qgemv_a8"] == 1 and common.launches["qgemv_a8_perchannel"] == 0
    ref = qmatmul_kernel_a8_reference(aq, qt) * a_scale
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("bits,K", [(8, 512), (8, 1024), (4, 512), (3, 1024), (8, 4096),
                                    (4, 4096), (8, 11008), (8, 96)])
@pytest.mark.parametrize("M,N", [(1, 160), (40, 130), (300, 384)])
def test_a8_per_channel_kernel_equals_plain(dev, bits, K, M, N):
    gen = _gen(dev, bits * 1000 + M)
    qt = synth.random_qtensor(gen, K, N, bits, K)
    assert a8_per_channel(qt)
    aq, _ = quantize_activations(torch.randn(M, K, device=dev, generator=gen))
    common.reset_counts()
    got = qmatmul_kernel_a8(aq, qt)
    assert common.launches["qgemv_a8_perchannel"] == 1 and common.launches["qgemv_a8"] == 0
    assert torch.equal(got, qmatmul_kernel_a8_reference(aq, qt))


# (per channel, bits, group, K, N, M, split): split K where the grid is
# short (w_down's shape at M=256, grouped and per channel), a grid that needs
# no split, ragged M and N (N = 4098: single-word loads and scale loads
# without 16-byte copies; 4100: fp16 scale rows not on 16 bytes)
A8_SPLITS = [(False, 4, 128, 11008, 4096, 256, True), (True, 8, 11008, 11008, 4096, 256, True),
             (False, 4, 128, 4096, 4096, 2560, False), (False, 4, 128, 4096, 4098, 300, None),
             (True, 8, 4096, 4096, 4100, 300, None), (True, 4, 4096, 4096, 4096, 256, True)]


@pytest.mark.parametrize("per_channel,bits,g,K,N,M,split", A8_SPLITS)
def test_a8_split_k_repeat_and_graph(dev, per_channel, bits, g, K, N, M, split):
    """Split K and no split against the plain version (per channel equal,
    grouped rel 1e-5 / abs 3e-4), one launch a call, and the same bits from a
    second call on the stream and from a CUDA graph replay (the split-K
    workspace is made anew each call, inside the graph when captured)."""
    gen = _gen(dev, K + N + M)
    qt = synth.random_qtensor(gen, K, N, bits, g)
    assert a8_per_channel(qt) == per_channel
    plan = a8_plan(qt, M, torch.cuda.get_device_properties(dev).multi_processor_count)
    if split is not None:
        assert (plan.splits > 1) == split
    a = torch.nn.functional.pad(torch.randn(M, K, device=dev, generator=gen), (0, qt.K - K))
    aq, _ = quantize_activations(a)
    name = "qgemv_a8_perchannel" if per_channel else "qgemv_a8"
    common.reset_counts()
    got = qmatmul_kernel_a8(aq, qt)
    assert common.launches[name] == 1 and sum(common.launches.values()) == 1
    ref = qmatmul_kernel_a8_reference(aq, qt)
    if per_channel:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)
    assert torch.equal(qmatmul_kernel_a8(aq, qt), got)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        qmatmul_kernel_a8(aq, qt)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmatmul_kernel_a8(aq, qt)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_requantize_a8_and_qmatmul_a8_on_the_card(dev):
    """quantize -> requantize (the dequant kernel) -> a8 matmul, against the
    plain path; act-order gather, K padding and the N_logical cut included."""
    gen = _gen(dev, 3)
    w = torch.randn(1024, 200, device=dev, generator=gen) * 0.1
    a = torch.randn(2, 33, 1024, device=dev, generator=gen)
    qt = quantize_array(w, 4, 128, act_order=True)
    common.reset_counts()
    rq = requantize_a8(qt)
    assert common.launches["dequant"] == 1 and rq.bits == 8 and a8_per_channel(rq)
    for q, name in ((qt, "qgemv_a8"), (rq, "qgemv_a8_perchannel")):
        common.reset_counts()
        got = qmatmul(a, q, out_dtype=torch.float32, a8=True)
        assert common.launches[name] == 1 and not any(common.plain_on_cuda.values())
        ref = qmatmul(a, q, out_dtype=torch.float32, a8=True, use_kernel=False)
        assert got.shape == (2, 33, 200)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=3e-4)
        full = qmatmul(a, q, out_dtype=torch.float32, use_kernel=False)
        assert (got - full).abs().max() < 0.03 * full.abs().max()


PAGED_DECODE = [(128, 8, 8, 8, 256), (128, 32, 4, 40, 16), (64, 8, 1, 9, 28), (256, 4, 2, 5, 64),
                (128, 32, 32, 128, 16)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("D,H,Hkv,P,psz", PAGED_DECODE)
@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_paged_kernel_matches_plain(dev, int8, D, H, Hkv, P, psz, window):
    gen = _gen(dev, D + P * psz)
    B, L, S = 5, 2, P * psz
    if int8:
        linear = list(_packed_cache(gen, L, B, Hkv, S, D))
        new = _new_packed_rows(gen, B, Hkv, D)
    else:
        linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
        new = tuple(torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                    for _ in range(2))
    scales = lambda t: dict(k_scale=t[2], v_scale=t[3]) if int8 else {}
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    # slot 2 is inactive: position S, length S, and not one page
    pos = torch.tensor([0, S - 1, S, 255 % S, S // 2 + 1], device=dev)
    lens = torch.clamp(pos + 1, max=S)
    table, pools = synth.cut_pages(gen, linear, P, torch.where(pos < S, lens, 0))
    assert (table[2] == -1).all() and (table[0, 1:] == -1).all() and (table[1] >= 0).all()
    ref = [t.clone() for t in pools]
    common.reset_counts()
    out, *rest = decode_attention(q, pools[0], pools[1], lens, layer_idx=1, kv_new=(*new, pos),
                                  window=window, page_table=table, **scales(pools))
    name = "decode_attention_int8_paged" if int8 else "decode_attention_paged"
    append = "kv_append_packed_paged_fused" if int8 else "kv_append_paged_fused"
    assert common.launches[name] == 1 and common.launches[append] == 1  # one launch appends too
    assert sum(common.launches.values()) == 2 and not any(common.plain_on_cuda.values())
    assert all(r is t for r, t in zip(rest, pools))
    if int8:
        kv_append_packed_reference(*ref, *new, pos, 1, table)
    else:
        kv_append_dense_reference(*ref, *new, pos, 1, table)
    for got, want in zip(pools, ref):
        assert torch.equal(got, want)
    want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, window,
                                      *(t[1] for t in ref[2:]), page_table=table)
    # the inactive slot reads page 0, which another slot may be writing in the
    # same launch: its output is not defined (csrc/decode_attention.cu)
    live = pos < S
    assert (out[live].float() - want[live].float()).abs().max() <= 2e-2
    assert want.float().abs().max() > 0.05
    # the linear kernel on the cache the pool was cut from, appended the same way
    lin_out, *_ = decode_attention(q, linear[0], linear[1], lens, layer_idx=1,
                                   kv_new=(*new, pos), window=window, **scales(linear))
    assert (out[live].float() - lin_out[live].float()).abs().max() <= 2e-2
    for i, (pool, lin) in enumerate(zip(pools, linear)):  # the rows landed in the slots' pages
        axis = 3 if i >= 2 else 2  # the row axis: scales [B, 4, Hkv, S/4], else [B, Hkv, rows, D]
        got = gather_pages(pool[1], table, scales=i >= 2).movedim(axis, 1)
        given = (table >= 0).repeat_interleave(got.shape[1] // P, dim=1)
        assert torch.equal(got[given], lin[1].movedim(axis, 1)[given])
    zero = decode_attention(q, pools[0][0], pools[1][0],
                            torch.zeros(B, dtype=torch.int32, device=dev), page_table=table,
                            **{n: t[0] for n, t in scales(pools).items()})
    assert zero.abs().max() == 0  # a slot with no live rows attends nothing


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("D,H,Hkv,P,psz,T,window", [
    (128, 32, 32, 8, 256, 512, None), (128, 32, 8, 128, 16, 512, 512), (128, 8, 2, 19, 16, 70, None),
    (64, 4, 4, 8, 16, 64, 20), (256, 4, 1, 13, 16, 96, None), (128, 4, 4, 3, 20, 4, None),
    (128, 8, 2, 6, 64, 100, None), (64, 4, 2, 5, 128, 70, 90),  # pages of whole key tiles
])
def test_prefill_attention_paged_kernel_matches_plain(dev, int8, D, H, Hkv, P, psz, T, window):
    gen = _gen(dev, D + P * psz + T)
    B, L, S = 5, 2, P * psz
    if int8:
        linear = list(_packed_cache(gen, L, B, Hkv, S, D))
    else:
        linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
    scales = lambda t, li: dict(k_scale=t[2][li], v_scale=t[3][li]) if int8 else {}
    q = torch.randn(4, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    starts = [0, S - T, (S - T) // 2 // 4 * 4, 0]
    lens = [max(T - 5, 1), S, (S - T) // 2 // 4 * 4 + T, 0]
    pos = _chunk_positions(dev, starts, lens, T, S)
    slots = torch.tensor([3, 0, 4, B], device=dev)
    slot_lens = torch.zeros(B, dtype=torch.long, device=dev)
    slot_lens[slots[:3]] = torch.tensor(lens[:3], device=dev)
    table, pools = synth.cut_pages(gen, linear, P, slot_lens)
    assert (table[1] == -1).all() and (table[0] >= 0).all()
    common.reset_counts()
    got = prefill_attention(q, pools[0], pools[1], pos, slots, layer_idx=1, window=window,
                            page_table=table, **{n: t for n, t in zip(("k_scale", "v_scale"),
                                                                      pools[2:])})
    assert common.launches["prefill_attention_paged"] == 1
    assert sum(common.launches.values()) == 1 and not any(common.plain_on_cuda.values())
    want = prefill_attention_reference(q, pools[0][1], pools[1][1], pos, slots, window=window,
                                       page_table=table, **scales(pools, 1))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2e-2
    assert want.float().abs().max() > 0.05
    assert (got[pos >= S] == 0).all() and (pos >= S).any()
    lin = prefill_attention(q, linear[0], linear[1], pos, slots, layer_idx=1, window=window,
                            **{n: t for n, t in zip(("k_scale", "v_scale"), linear[2:])})
    assert torch.equal(got, lin)  # the same tiles in the same order: the same sums
    # flat pools, and padding in the middle of a row
    pos2 = pos.clone()
    pos2[1, T // 2] = S
    got = prefill_attention(q, pools[0][0], pools[1][0], pos2, slots, window=window,
                            page_table=table, **scales(pools, 0))
    want = prefill_attention_reference(q, pools[0][0], pools[1][0], pos2, slots, window=window,
                                       page_table=table, **scales(pools, 0))
    assert (got.float() - want.float()).abs().max() <= 2e-2
    assert (got[1, T // 2] == 0).all()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
def test_paged_append_kernels_write_only_through_a_page(dev, int8):
    """Rows whose position is outside [0, P * psz), whose table entry is -1 or
    whose entry is not a page of the pool write nothing; the others write
    exactly what the plain version writes."""
    gen = _gen(dev, 11)
    L, B, Hkv, D, P, psz, n_pages = 2, 8, 3, 128, 4, 16, 12
    S = P * psz
    if int8:
        pools = list(_packed_cache(gen, L, n_pages, Hkv, psz, D))
        new = _new_packed_rows(gen, B, Hkv, D)
        kernel, plain = kv_append_packed, kv_append_packed_reference
    else:
        pools = [torch.randn(L, n_pages, Hkv, psz, D, device=dev, generator=gen).to(torch.bfloat16)
                 for _ in range(2)]
        new = tuple(torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                    for _ in range(2))
        kernel, plain = kv_append_dense, kv_append_dense_reference
    table = torch.randperm(n_pages, generator=gen, device=dev)[:B, None].repeat(1, P)
    table = (table + torch.arange(P, device=dev)[None]) % n_pages  # some page for every entry
    table = table.to(torch.int32)
    #        in page 0..3 by byte 0..3     past S  <0  no page  not a page
    pos = torch.tensor([0, 17, 34, 63,      S,    -1,    5,      21], device=dev)
    table[6, 0] = -1
    table[7, 1] = n_pages + 5
    before = [t.clone() for t in pools]
    ref = [t.clone() for t in pools]
    out = kernel(*pools, *new, pos, 1, table)
    plain(*ref, *new, pos, 1, table)
    for got, o, want, old in zip(pools, out, ref, before):
        assert o is got and torch.equal(got, want)
        assert torch.equal(got[0], old[0])  # the other layer
        written = torch.zeros(n_pages, dtype=torch.bool, device=dev)
        written[table[torch.arange(4), pos[:4] // psz].long()] = True
        assert torch.equal(got[1][~written], old[1][~written])
        assert not torch.equal(got[1][written], old[1][written])


def _defined(table, lens, window, psz):
    """Slots whose attended positions all lie in pages of their own: the
    paged kernel's outputs that are defined (csrc/decode_attention.cu)."""
    ok = []
    for b, n in enumerate(lens.tolist()):
        lo = max(0, n - window) if window else 0
        ok.append(all(int(table[b, p // psz]) >= 0 for p in range(lo, n)))
    return torch.tensor(ok, device=table.device)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 100])
def test_fused_decode_attention_equals_append_then_plain(dev, int8, paged, D, rep, window):
    """The fused op (one launch: append, attention, combine) against the
    standalone append kernel followed by the plain attention: the cache bytes
    and scales equal bit for bit, the outputs within abs 2e-2.  New rows at
    both sides of a split boundary (255, 256), at S - 1 (length S), at an
    int8 word's last byte, at S (writes nothing; length S), and, paged, at a
    position whose page the slot does not hold (writes nothing) and in a
    slot with no page at all."""
    gen = _gen(dev, D + rep + 2 * int8 + paged)
    S, L, Hkv = 640, 2, 2
    H = Hkv * rep
    psz = 16 if rep in (1, 4) else 64  # pages smaller than a tile, and of whole tiles
    pos = torch.tensor([255, 256, S - 1, S, 3, 100, 300], device=dev)
    B = len(pos)
    lens = torch.clamp(pos + 1, max=S)
    held = torch.where(pos < S, lens, 0)
    if int8:
        linear = list(_packed_cache(gen, L, B, Hkv, S, D))
        new = _new_packed_rows(gen, B, Hkv, D)
    else:
        linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
        new = tuple(torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                    for _ in range(2))
    table = None
    if paged:
        table, cache = synth.cut_pages(gen, linear, S // psz, held)
        table[5, 100 // psz] = -1  # slot 5 holds no page for its new row
        defined = _defined(table, lens, window, psz)
        assert not defined[3] and not defined[5] and defined[[0, 1, 2, 4, 6]].all()
    else:
        cache, defined = linear, torch.ones(B, dtype=torch.bool, device=dev)
    kw = dict(k_scale=cache[2], v_scale=cache[3]) if int8 else {}
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    ref = [t.clone() for t in cache]
    common.reset_counts()
    out, *_ = decode_attention(q, cache[0], cache[1], lens, layer_idx=1, kv_new=(*new, pos),
                               window=window, page_table=table, **kw)
    name = ("decode_attention" + ("_int8" if int8 else "") + ("_paged" if paged else ""))
    append = "kv_append" + ("_packed" if int8 else "") + ("_paged" if paged else "")
    assert {k: n for k, n in common.launches.items() if n} == {name: 1, append + "_fused": 1}
    (kv_append_packed if int8 else kv_append_dense)(*ref, *new, pos, 1, table)
    assert common.launches[append] == 1  # the standalone kernel
    for got, want in zip(cache, ref):
        assert torch.equal(got, want)
    want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, window,
                                      *(t[1] for t in ref[2:]), page_table=table)
    assert (out[defined].float() - want[defined].float()).abs().max() <= 2e-2
    assert want.float().abs().max() > 0.05 and torch.isfinite(out.float()).all()
    # the workspace is reused: the second call allocates its output and nothing else
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    decode_attention(q, cache[0], cache[1], lens, layer_idx=1, kv_new=(*new, pos),
                     window=window, page_table=table, **kw)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before == 1


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_kv_append_kernel_equals_plain(dev, paged, D, pos_dtype):
    """The standalone bf16 append, one block a (slot, kv head), equal bit for
    bit to its plain version; positions read as they come, int32 or int64."""
    gen = _gen(dev, D + paged)
    L, B, Hkv, S = 2, 6, 3, 128
    cache = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
             for _ in range(2)]
    pos = torch.tensor([0, 63, 64, S - 1, S, -1], device=dev, dtype=pos_dtype)
    table = None
    if paged:
        table, cache = synth.cut_pages(gen, cache, S // 16, torch.full((B,), S, device=dev))
        table[1, 63 // 16] = -1  # no page for slot 1's row: nothing written
    new = [torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2)]
    ref = [t.clone() for t in cache]
    before = [t.clone() for t in cache]
    common.reset_counts()
    kv_append_dense(*cache, *new, pos, 1, table)
    assert {k: n for k, n in common.launches.items() if n} == {
        "kv_append_paged" if paged else "kv_append": 1}
    kv_append_dense_reference(*ref, *new, pos, 1, table)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))
    assert not torch.equal(cache[0], before[0]) and torch.equal(cache[0][0], before[0][0])


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_kv_append_packed_kernel_takes_its_inputs_as_they_come(dev, paged, D, scale_dtype,
                                                               pos_dtype):
    """The standalone packed int8 append, one block a (slot, kv head), equal
    bit for bit to its plain version on the linear cache and on a pool; f32
    scales (rounded to bf16 inside) or bf16 ones, int32 or int64 positions,
    read as they come: the call allocates nothing and launches one kernel."""
    gen = _gen(dev, D + 2 * paged)
    L, B, Hkv, S = 2, 7, 3, 128
    cache = list(_packed_cache(gen, L, B, Hkv, S, D))
    # bytes 0-3 of a word, the last row, outside [0, S), and (paged) no page
    pos = torch.tensor([0, 17, 34, 63, S - 1, S, -1], device=dev, dtype=pos_dtype)
    table = None
    if paged:
        table, cache = synth.cut_pages(gen, cache, S // 16, torch.full((B,), S, device=dev))
        table[1, 17 // 16] = -1  # no page for slot 1's row: nothing written
    kq, vq, ks, vs = _new_packed_rows(gen, B, Hkv, D)
    ks, vs = ks.to(scale_dtype), vs.to(scale_dtype)
    ref = [t.clone() for t in cache]
    before = [t.clone() for t in cache]
    kv_append_packed(*cache, kq, vq, ks, vs, pos, 1, table)  # a first call builds and warms up
    cache = [t.copy_(b) for t, b in zip(cache, before)]
    torch.cuda.synchronize()
    common.reset_counts()
    allocated = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    kv_append_packed(*cache, kq, vq, ks, vs, pos, 1, table)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocated
    name = "kv_append_packed_paged" if paged else "kv_append_packed"
    assert {k: n for k, n in common.launches.items() if n} == {name: 1}
    kv_append_packed_reference(*ref, kq, vq, ks, vs, pos, 1, table)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))
    assert not torch.equal(cache[0], before[0]) and torch.equal(cache[0][0], before[0][0])
    assert not torch.equal(cache[3], before[3])


# --- the engine's decode bursts as CUDA graphs (engine/engine.py) ---
#
# A CUDA engine captures each program (greedy, sampled) once and replays it
# for every burst; ``_eager`` runs the same burst body eagerly, which the
# graphs are held to: equal greedy tokens (the same kernels on the same
# inputs), the same launches a replay as an eager burst.

GRAPH_CACHES = {
    "bf16": dict(kv_quant=False),
    "int8": dict(kv_quant=True),
    "paged_bf16": dict(kv_quant=False, paged=True, page_size=64),
    "paged_int8": dict(kv_quant=True, paged=True, page_size=64),
    "eager_attention": dict(kv_quant=False, flash_decode=False),
}


def _graph_engine(dev, eager=False, slots=4, burst=4, flash_decode=True, seed=0, **kw):
    from xbitops_tpu_torch.engine import Engine
    from xbitops_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(seq=256), flash_decode=flash_decode)
    model = synth.random_llama_params(cfg, bits=4, group_size=128, device=dev, seed=1)
    eng = Engine(model, cfg, slots=slots, decode_burst=burst, prefill_chunk=64, seed=seed, **kw)
    eng._eager = eager
    return eng


def _graph_requests(n=6, new=12, temperature=0.0, seed=0):
    from xbitops_tpu_torch.engine import Request

    gen = torch.Generator().manual_seed(seed)
    lens = torch.linspace(5, 150, n).long().tolist()  # past 64: chunked admission
    return [Request(prompt=torch.randint(0, 256, (k,), generator=gen).tolist(),
                    max_new_tokens=new + i % 3, temperature=temperature)
            for i, k in enumerate(lens)]


@pytest.mark.parametrize("kind", list(GRAPH_CACHES))
def test_graph_engine_greedy_tokens_equal_eager(dev, kind):
    """Greedy tokens of the graph engine equal the eager engine's, request by
    request; every burst is a replay, and one replay counts the launches of
    one eager burst."""
    reqs = _graph_requests()
    eager = _graph_engine(dev, eager=True, **GRAPH_CACHES[kind])
    want = eager.generate(reqs)
    assert eager.loop_stats["graph_replays"] == 0
    eng = _graph_engine(dev, **GRAPH_CACHES[kind])
    common.reset_counts()
    got = eng.generate(reqs)
    st = eng.loop_stats
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert st["graph_captures"] == 1 and st["graph_replays"] == st["decode_steps"] / 4
    assert not any(common.plain_on_cuda.values())
    # one eager burst (all slots inactive: it writes nothing) launches what a replay counts
    eng._act_in.zero_()
    common.reset_counts()
    eng._burst(greedy=True)
    torch.cuda.synchronize()
    per_burst = {k: n for k, n in common.launches.items() if n}
    assert per_burst == eng._programs[True].launches and per_burst


def test_graph_engine_sampled_is_seeded_and_within_top_k(dev):
    """Two sampled graph engines with the same seed give the same tokens;
    each token is among the top_k logits of its step, recomputed by one
    forward over the prompt and the tokens before it; top_k=1 is greedy."""
    from xbitops_tpu_torch.models import llama

    reqs = _graph_requests(n=4, temperature=0.9, seed=3)
    runs = [_graph_engine(dev, top_k=8, seed=5, kv_quant=False) for _ in range(2)]
    outs = [e.generate(reqs) for e in runs]
    assert [c.tokens for c in outs[0]] == [c.tokens for c in outs[1]]
    # captured lazily: a sampled workload never captures the greedy program
    assert runs[0].loop_stats["graph_captures"] == 1 and set(runs[0]._programs) == {False}
    model = runs[0].model
    for r, c in zip(reqs, outs[0]):
        seq = torch.tensor(list(r.prompt) + c.tokens, device=dev)[None]
        cache = llama.KVCache.init(model.cfg, 1, dev)
        pos = torch.arange(seq.shape[1], device=dev)[None]
        logits, _ = model(seq, cache, pos, self_attend=True)
        top = logits[0, len(r.prompt) - 1 : -1].float().topk(8, dim=-1).indices
        assert all(t in row for t, row in zip(c.tokens, top.tolist())), (r.id, c.tokens)
    one = _graph_engine(dev, top_k=1, seed=5, kv_quant=False).generate(reqs)
    greedy = _graph_engine(dev, kv_quant=False).generate(_graph_requests(n=4, seed=3))
    assert [c.tokens for c in one] == [c.tokens for c in greedy]


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_graph_engine_restart_captures_again(dev, paged):
    """An injected device error at the third burst: the cache is rebuilt, the
    requests resume, the tokens equal a clean run, and the greedy graph is
    captured again for the new cache."""
    kw = dict(kv_quant=False, paged=paged, page_size=64) if paged else dict(kv_quant=False)
    reqs = _graph_requests()
    clean = _graph_engine(dev, **kw).generate(reqs)
    eng = _graph_engine(dev, max_restarts=1, **kw)
    calls = []

    def fault():
        calls.append(1)
        if len(calls) == 3:
            raise torch.AcceleratorError("injected device error")

    eng._fault_hook = fault
    got = eng.generate(reqs)
    assert eng.restarts == 1 and eng.loop_stats["graph_captures"] == 2
    assert [c.tokens for c in got] == [c.tokens for c in clean]
    assert [c.prompt_len for c in got] == [c.prompt_len for c in clean]
    if paged:
        assert sorted(eng._free_pages) == list(range(eng.cache.k.shape[1]))


def test_graph_engine_replays_with_a_slot_deferred(dev):
    """A paged pool of 4 pages of 64: the second request fills it, the first
    sits bursts out (its row of the static mask is off) until pages free; the
    tokens equal the eager engine's on the same pool."""
    from xbitops_tpu_torch.engine import Request

    gen = torch.Generator().manual_seed(7)
    reqs = [Request(prompt=torch.randint(0, 256, (60,), generator=gen).tolist(),
                    max_new_tokens=20),
            Request(prompt=torch.randint(0, 256, (150,), generator=gen).tolist(),
                    max_new_tokens=12)]
    kw = dict(kv_quant=False, paged=True, page_size=64, pool_pages=4)
    want = _graph_engine(dev, eager=True, **kw).generate(reqs)
    eng = _graph_engine(dev, **kw)
    got = eng.generate(reqs)
    assert eng.loop_stats["deferred_slot_steps"] > 0 and eng.loop_stats["graph_replays"] > 0
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert all(len(c.tokens) == r.max_new_tokens for c, r in zip(got, reqs))


def test_graph_engine_mirrored_spans_stay_host_events(dev):
    """Under ``torch.profiler`` with CUDA activity, the spans mirrored into it
    (``engine.accept``, ``engine.admit_prep``: host work alone) come back as
    host events and no span's name as a device event (a range around kernel
    launches may come back as a ``gpu_user_annotation``, which a trace would
    count as device work); ``loop_stats`` keeps the captures out of
    ``decode``, which the replays' dispatch and wait spans sum to."""
    from torch.profiler import ProfilerActivity, profile

    from xbitops_tpu_torch.utils import tracing

    eng = _graph_engine(dev, kv_quant=False)
    eng.generate(_graph_requests(n=2, new=4))  # the capture, before the profiler
    mark = tracing.span("mark").id
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    eng.generate(_graph_requests())
    torch.cuda.synchronize()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    mirrored = [e for e in events if e.name() in ("engine.accept", "engine.admit_prep")]
    assert {e.name() for e in mirrored} == {"engine.accept", "engine.admit_prep"}
    assert all(e.device_type() != cuda for e in mirrored)
    assert not [e.name() for e in events
                if e.device_type() == cuda and e.name().startswith(("engine.", "endpoint."))]
    spans = [s for s in tracing.spans() if s.id > mark]
    lt = eng.loop_stats
    assert lt["graph_captures"] == 0 and lt["graph_replays"] > 0
    dispatch_wait = sum(s.seconds for s in spans if s.name in ("engine.dispatch", "engine.wait"))
    assert lt["decode"] == pytest.approx(dispatch_wait, rel=1e-9)


# --- speculative decoding and pipelined bursts on the card ---
#
# ``forward(kv_unaligned=True)`` writes T rows a slot in T append launches a
# layer (``models/llama._write_unaligned``); a CUDA engine replays each verify
# step, with a draft model's chain inside it, as one graph, and pipelined
# bursts chain through the newest burst's tokens on the device.


def packed_cache_gpu(gen, L, B, Hkv, S, D):
    """A packed int8 cache of random bytes and scales."""
    dev = gen.device
    words = [torch.randint(-2**31, 2**31, (L, B, Hkv, S // 4, D), device=dev, generator=gen,
                           dtype=torch.int64).to(torch.int32) for _ in range(2)]
    scales = [torch.empty(L, B, 4, Hkv, S // 4, device=dev).uniform_(0.001, 0.03, generator=gen)
              .to(torch.bfloat16) for _ in range(2)]
    return words[0], words[1], scales[0], scales[1]


UNALIGNED_FORMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("int8,paged", UNALIGNED_FORMS,
                         ids=["bf16", "int8", "bf16paged", "int8paged"])
def test_unaligned_write_kernels_equal_plain(dev, int8, paged):
    """Chains of 5 positions from 0, 1, 2, 3 mod 4 (two share a word), one
    across S, an inactive slot and, paged, a chain into a page of -1: every
    cache tensor equal to the plain write's, 5 append launches a layer."""
    from xbitops_tpu_torch.models import llama

    gen = _gen(dev, 31)
    cfg = llama.LlamaConfig.tiny(seq=256)
    B, T, L, Hkv, D, S = 6, 5, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 256
    if int8:
        k, v, ks, vs = packed_cache_gpu(gen, L, B, Hkv, S, D)
        linear = [k, v, ks, vs]
    else:
        linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
    lens = torch.tensor([4, 13, 30, 251, 7, 62], device=dev)
    active = torch.tensor([True, True, True, True, False, True], device=dev)
    if paged:  # pages of 64; slot 5's chain 62..66 runs into its page 1, which is -1
        table, parts = synth.cut_pages(gen, linear, 4, torch.tensor(
            [64, 64, 64, 256, 256, 64], device=dev))
    else:
        table, parts = None, linear
    fields = dict(k=parts[0], v=parts[1], lengths=lens.to(torch.int32), page_table=table)
    if int8:
        fields.update(k_scale=parts[2], v_scale=parts[3])
    a = llama.KVCache(**fields)
    b = llama.KVCache(**{n: (t.clone() if isinstance(t, torch.Tensor) else t)
                         for n, t in fields.items()})
    pos = torch.where(active[:, None], lens[:, None] + torch.arange(T, device=dev), S).clamp(max=S)
    rows = [torch.randn(B, T, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    before = a.k.clone()
    common.reset_counts()
    for li in range(L):
        llama._write_unaligned(a, li, *rows, pos, use_kernel=True)
    name = "kv_append" + ("_packed" if int8 else "") + ("_paged" if paged else "")
    assert {k: n for k, n in common.launches.items() if n} == {name: L * T}
    for li in range(L):
        llama._write_unaligned(b, li, *rows, pos, use_kernel=False)
    for n in ("k", "v", "k_scale", "v_scale"):
        if fields.get(n) is not None:
            assert torch.equal(getattr(a, n), getattr(b, n)), n
    assert not torch.equal(a.k, before)


SPEC_CASES = {
    "ngram_bf16": dict(kv_quant=False),
    "ngram_int8": dict(kv_quant=True),
    "ngram_paged": dict(kv_quant=False, paged=True, page_size=64),
    "draft_model": dict(kv_quant=False, draft=True),
}


@pytest.mark.parametrize("kind", list(SPEC_CASES))
def test_graph_spec_engine_equals_eager(dev, kind):
    """Each verify step (with a draft model: its chain too) is one replay;
    greedy tokens and ``spec_stats`` equal the eager engine's, and one replay
    counts the launches of one eager step."""
    kw = dict(SPEC_CASES[kind])
    reqs = _graph_requests(n=5, new=10)
    engines = []
    for eager in (True, False):
        eng = _graph_engine(dev, eager=eager, burst=1, spec_tokens=3, **{
            k: v for k, v in kw.items() if k != "draft"})
        if kw.get("draft"):  # a 1-layer cut of the target: its drafts are often right
            eng = _graph_engine(dev, eager=eager, burst=1, spec_tokens=3, kv_quant=False,
                                draft_params=eng.model.with_config(
                                    dataclasses.replace(eng.cfg, num_layers=1)))
        engines.append(eng)
    want = engines[0].generate(reqs)
    common.reset_counts()
    got = engines[1].generate(reqs)
    st = engines[1].loop_stats
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert engines[1].spec_stats == engines[0].spec_stats
    assert st["graph_captures"] == 1 and st["graph_replays"] == st["decode_steps"] > 0
    assert not any(common.plain_on_cuda.values())
    launched = {k for k, n in common.launches.items() if n}
    assert {"qgemv", "prefill_attention" + ("_paged" if "paged" in kw else "")} <= launched
    eng = engines[1]
    eng._act_in.zero_()
    common.reset_counts()
    eng._spec()
    torch.cuda.synchronize()
    per_step = {k: n for k, n in common.launches.items() if n}
    assert per_step == eng._programs["spec"].launches and per_step


@pytest.mark.parametrize("depth", [1, 2])
def test_graph_pipeline_equals_sync(dev, depth):
    """Pipelined graph bursts give the synchronous graph engine's tokens."""
    reqs = _graph_requests()
    want = _graph_engine(dev, kv_quant=False).generate(reqs)
    eng = _graph_engine(dev, kv_quant=False, pipeline=depth)
    got = eng.generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert eng.loop_stats["graph_replays"] == eng.loop_stats["decode_steps"] / 4


@pytest.mark.parametrize("depth", [1, 2])
def test_graph_pipeline_admits_a_sampled_request_mid_flight(dev, depth):
    """A sampled request admitted into a freed slot while the others decode:
    the pipelined engine captures its sampled graph with bursts in flight, and
    the continuing slots still take their newest burst's last tokens.  On the
    copy-model with top_k=1 a sampled row is the greedy one, so every stream
    is the cycle and equals the synchronous graph engine's."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(seq=256)
    cp = synth.copy_llama_params(_gen(dev, 3), cfg, 4, 128, period=8)
    reqs = [Request(prompt=[(j + i) % 8 for i in range(9 + 5 * j)], max_new_tokens=8 + 6 * j)
            for j in range(4)]
    reqs += [Request(prompt=[(j + i) % 8 for i in range(12)], max_new_tokens=10,
                     temperature=0.8) for j in range(2)]
    runs = {}
    for d in (0, depth):
        eng = Engine(cp, cfg, slots=4, decode_burst=4, prefill_chunk=64, top_k=1, pipeline=d)
        runs[d] = eng.generate(reqs)
        assert eng.loop_stats["graph_captures"] == 2
    for c, r in zip(runs[depth], reqs):
        prev = [r.prompt[-1]] + c.tokens[:-1]
        assert c.tokens == [(p + 1) % 8 for p in prev] and len(c.tokens) == r.max_new_tokens
    assert [c.tokens for c in runs[depth]] == [c.tokens for c in runs[0]]
    assert [c.finish_reason for c in runs[depth]] == [c.finish_reason for c in runs[0]]


def _moe_engine(dev, eager=False, **kw):
    """A tiny random MoE model (``MoeConfig.tiny_moe``, 4 experts top-2,
    no-drop) in an engine: 4 slots, prompts past 64 admitted in chunks."""
    from xbitops_tpu_torch.engine import Engine
    from xbitops_tpu_torch.models.moe import MoeConfig

    cfg = MoeConfig.tiny_moe(seq=256)
    model = synth.random_moe_params(cfg, bits=4, group_size=128, device=dev, seed=1)
    eng = Engine(model, cfg, slots=4, prefill_chunk=64, **kw)
    eng._eager = eager
    return eng


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_moe_graph_engine_greedy_tokens_equal_eager(dev, kv_quant):
    """A MoE model's decode bursts capture as graphs (the expert loop, the
    slot cumsum and the index_copy_ dispatch have no host read-back): replayed
    greedy tokens equal the eager bursts', and a replay counts an eager
    burst's launches."""
    reqs = _graph_requests()
    want = _moe_engine(dev, eager=True, decode_burst=4, kv_quant=kv_quant).generate(reqs)
    eng = _moe_engine(dev, decode_burst=4, kv_quant=kv_quant)
    common.reset_counts()
    got = eng.generate(reqs)
    st = eng.loop_stats
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert st["graph_captures"] == 1 and st["graph_replays"] == st["decode_steps"] / 4
    assert not any(common.plain_on_cuda.values())
    eng._act_in.zero_()
    common.reset_counts()
    eng._burst(greedy=True)
    torch.cuda.synchronize()
    per_burst = {k: n for k, n in common.launches.items() if n}
    assert per_burst == eng._programs[True].launches and per_burst["qgemv"] > 0


def test_moe_graph_spec_verify_equals_eager(dev):
    """A MoE model's γ=2 verify step, replayed as one graph, gives the eager
    steps' tokens and ``spec_stats``."""
    reqs = _graph_requests(n=5, new=10)
    want_eng = _moe_engine(dev, eager=True, spec_tokens=2, kv_quant=False)
    want = want_eng.generate(reqs)
    eng = _moe_engine(dev, spec_tokens=2, kv_quant=False)
    got = eng.generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert eng.spec_stats == want_eng.spec_stats
    assert eng.loop_stats["graph_replays"] == eng.loop_stats["decode_steps"] > 0


def test_gptq_identity_hessian_is_rtn_on_card(dev):
    """With H = I GPTQ rounds to nearest: on the card too its packed weight
    equals ``quantize_array``'s bit for bit (true f32 inside the solver)."""
    from xbitops_tpu_torch.ops import gptq
    from xbitops_tpu_torch.ops.quantize import quantize_array

    w = torch.randn((512, 384), generator=_gen(dev, 4), device=dev) * 0.05
    qt = gptq.gptq_quantize_array(w, torch.eye(512, device=dev), 4, 128)
    rtn = quantize_array(w, 4, 128)
    assert all(torch.equal(a, b) for a, b in zip(qt.planes, rtn.planes))
    assert torch.equal(qt.scales, rtn.scales) and torch.equal(qt.scale_zeros, rtn.scale_zeros)
    x = torch.randn((256, 512), generator=_gen(dev, 5), device=dev)
    h = gptq.hessian_from_inputs(x)
    assert torch.allclose(h, 2 * (x.double().T @ x.double()).float(), rtol=1e-5, atol=1e-3)


# One rank's shards of Llama-2-7B at tensor parallelism (4-bit, g=128): the
# column shards of q|k|v, gate|up and lm_head and the row shards of wo and
# w_down at tp=2 (w_down's 5504 rows keep g'=128, 43 groups padded to the
# shard's own tile), and w_down's at tp=4 (2752 rows, g'=64).
TP_SHARDS = [
    ("wqkv", 4096, 12288, 2, "col", (4096, 6144)),
    ("wo", 4096, 4096, 2, "row", (2048, 4096)),
    ("w_gateup", 4096, 22016, 2, "col", (4096, 11008)),
    ("w_down", 11008, 4096, 2, "row", (5504, 4096)),
    ("lm_head", 4096, 32000, 2, "col", (4096, 16000)),
    ("w_down_tp4", 11008, 4096, 4, "row", (2752, 4096)),
]


@pytest.mark.parametrize("name,K,N,n,kind,shape", TP_SHARDS, ids=[c[0] for c in TP_SHARDS])
def test_few_rows_form_on_7b_tp_shards(dev, name, K, N, n, kind, shape):
    """Each shard layout takes the few-rows form (``csrc/qgemv_word.cu``, one
    launch) at M=8, against its plain version (rel 2e-2 of the largest
    output), on the last rank's shard."""
    from xbitops_tpu_torch import formats
    from xbitops_tpu_torch.parallel import tp
    from xbitops_tpu_torch.parallel.mesh import Mesh

    gen = _gen(dev, K + N + n)
    qt = synth.random_qtensor(gen, K, N, 4, 128)
    mesh = Mesh(("model",), (n,), (n - 1,), (None,))  # its shard only: no collective here
    if kind == "row":
        local = tp.local_qtensor(formats.row_shard_qtensor(qt, n), mesh, row_axis="model")
    else:
        local = tp.local_qtensor(qt, mesh, col_axis="model")
    assert local.shape == shape
    assert qgemv_form(8, False, local) == "gemv" and counter("gemv", local) == "qgemv"
    if name.startswith("w_down"):
        assert local.group_size == {2: 128, 4: 64}[n] and local.K % local.tile_k == 0
    a = torch.randn(8, local.K_logical, device=dev, generator=gen).to(torch.bfloat16)
    ref = qmatmul(a, local, out_dtype=torch.float32, use_kernel=False)
    common.reset_counts()
    got = qmatmul(a, local)
    assert common.launches == {**dict.fromkeys(common.launches, 0), "qgemv": 1}
    assert (got.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


# --- the fp16 and f32 KV caches: the dense forms of #2, #4 and #9 ---

DENSE_DTYPES = {"f16": torch.float16, "f32": torch.float32}


def _beyond_rounding(out, ref32):
    """Largest |out - ref32| beyond half a bf16 unit in the last place of
    ``ref32``: the error of a bf16 output ``out`` that its own rounding does not
    explain, against the plain version's unrounded f32 result."""
    half = torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32).exponent - 9)
    return ((out.float() - ref32).abs() - half).clamp(min=0).max().item()


def _check_dense_attention(out, want, want32, dtype, rows=None):
    """fp16: abs 2e-2; f32: abs 1e-4 beyond the bf16 output's rounding, and
    abs 2e-2 outright."""
    if rows is not None:
        out, want, want32 = out[rows], want[rows], want32[rows]
    assert (out.float() - want.float()).abs().max() <= 2e-2
    if dtype == torch.float32:
        assert _beyond_rounding(out, want32) <= 1e-4


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 100])
def test_dense_forms_fused_decode_equals_append_then_plain(dev, dtype, paged, D, rep, window):
    """The fp16 / f32 cache's fused op (one launch: append, attention, combine)
    against its standalone append kernel then the plain attention on the same
    cache: the rows equal bit for bit (new rows as bf16, cast in the kernel),
    the outputs as ``_check_dense_attention`` says.  New rows at both sides of
    a split boundary, at S - 1, at S (writes nothing), and, paged, at a
    position without a page and in a slot with no page."""
    gen = _gen(dev, D + rep + paged + 7 * (dtype == torch.float32))
    S, L, Hkv = 640, 2, 2
    H = Hkv * rep
    psz = 16 if rep in (1, 4) else 64
    pos = torch.tensor([255, 256, S - 1, S, 3, 100, 300], device=dev)
    B = len(pos)
    lens = torch.clamp(pos + 1, max=S)
    held = torch.where(pos < S, lens, 0)
    linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(dtype) for _ in range(2)]
    new = tuple(torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
    table = None
    if paged:
        table, cache = synth.cut_pages(gen, linear, S // psz, held)
        table[5, 100 // psz] = -1
        defined = _defined(table, lens, window, psz)
    else:
        cache, defined = linear, torch.ones(B, dtype=torch.bool, device=dev)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    ref = [t.clone() for t in cache]
    common.reset_counts()
    out, *_ = decode_attention(q, cache[0], cache[1], lens, layer_idx=1, kv_new=(*new, pos),
                               window=window, page_table=table)
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype] + ("_paged" if paged else "")
    assert {k: n for k, n in common.launches.items() if n} == {
        "decode_attention" + sfx: 1, "kv_append" + sfx + "_fused": 1}
    kv_append_dense(*ref, *new, pos, 1, table)
    assert common.launches["kv_append" + sfx] == 1
    for got, want in zip(cache, ref):
        assert got.dtype == dtype and torch.equal(got, want)
    want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, window, page_table=table)
    want32 = decode_attention_reference(q.float(), ref[0][1], ref[1][1], lens, window,
                                        page_table=table)
    _check_dense_attention(out, want, want32, dtype, defined)
    assert want.float().abs().max() > 0.05 and torch.isfinite(out.float()).all()
    # rows of another type than bf16 would be rounded to bf16 on the way: refused
    with pytest.raises(ValueError, match="must be bf16"):
        decode_attention(q, cache[0], cache[1], lens, layer_idx=0,
                         kv_new=(*(t.to(dtype) for t in new), pos), page_table=table)


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_dense_forms_kv_append_equal_plain(dev, dtype, paged, D):
    """The standalone append into an fp16 / f32 cache, equal bit for bit to
    the plain cast and write of bf16 rows (cast in the kernel); rows of
    another type are refused."""
    gen = _gen(dev, D + 2 * paged + 5 * (dtype == torch.float32))
    L, B, Hkv, S = 2, 6, 3, 128
    cache = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(dtype)
             for _ in range(2)]
    pos = torch.tensor([0, 63, 64, S - 1, S, -1], device=dev)
    table = None
    if paged:
        table, cache = synth.cut_pages(gen, cache, S // 16, torch.full((B,), S, device=dev))
        table[1, 63 // 16] = -1
    # bf16 values past fp16's range and below its normal range round as a cast does
    new = [(torch.randn(B, Hkv, D, device=dev, generator=gen)
            * torch.tensor([1e-6, 1.0, 7e4], device=dev)[torch.arange(D, device=dev) % 3])
           .to(torch.bfloat16) for _ in range(2)]
    ref = [t.clone() for t in cache]
    before = [t.clone() for t in cache]
    common.reset_counts()
    kv_append_dense(*cache, *new, pos, 1, table)
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype] + ("_paged" if paged else "")
    assert {k: n for k, n in common.launches.items() if n} == {"kv_append" + sfx: 1}
    kv_append_dense_reference(*ref, *new, pos, 1, table)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))
    assert not torch.equal(cache[0], before[0]) and torch.equal(cache[0][0], before[0][0])
    for rdt in (dtype, torch.float32):
        with pytest.raises(ValueError, match="must be bf16"):
            kv_append_dense(*cache, *(t.to(rdt) for t in new), pos, 1, table)


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("D,H,Hkv,S,T,window", [
    (128, 32, 32, 2048, 512, None), (128, 32, 8, 2048, 512, 512), (128, 8, 8, 1024, 5, None),
    (64, 4, 4, 128, 64, 20), (256, 4, 1, 512, 96, None), (256, 8, 2, 256, 5, 64),
    (64, 8, 2, 512, 100, None),
])
def test_dense_forms_prefill_attention_matches_plain(dev, dtype, paged, D, H, Hkv, S, T, window):
    """The fp16 / f32 cache's prefill attention against its plain version:
    chunks of 512 and a verify's T = 5, GQA, windows, D = 256 (the f32 form's
    one key buffer); padding queries exactly 0; paged equal to linear."""
    gen = _gen(dev, D + S + T + 3 * (dtype == torch.float32))
    B, L = 5, 2
    linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(dtype)
              for _ in range(2)]
    q = torch.randn(4, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    starts = [0, S - T, (S - T) // 2, 0]
    lens = [max(T - 2, 1), S, (S - T) // 2 + T, 0]
    pos = _chunk_positions(dev, starts, lens, T, S)
    slots = torch.tensor([3, 0, 4, B], device=dev)
    table, cache = None, linear
    if paged:
        psz = 16 if T % 2 else 64
        slot_lens = torch.zeros(B, dtype=torch.long, device=dev)
        slot_lens[slots[:3]] = torch.tensor(lens[:3], device=dev)
        table, cache = synth.cut_pages(gen, linear, S // psz, slot_lens)
    common.reset_counts()
    got = prefill_attention(q, cache[0], cache[1], pos, slots, layer_idx=1, window=window,
                            page_table=table)
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype] + ("_paged" if paged else "")
    assert {k: n for k, n in common.launches.items() if n} == {"prefill_attention" + sfx: 1}
    want = prefill_attention_reference(q, cache[0][1], cache[1][1], pos, slots, window=window,
                                       page_table=table)
    want32 = prefill_attention_reference(q.float(), cache[0][1], cache[1][1], pos, slots,
                                         window=window, page_table=table)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _check_dense_attention(got, want, want32, dtype)
    assert want.float().abs().max() > 0.05
    assert (got[pos >= S] == 0).all() and (pos >= S).any()
    if paged:
        lin = prefill_attention(q, linear[0], linear[1], pos, slots, layer_idx=1, window=window)
        assert torch.equal(got, lin)


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
def test_dense_forms_count_and_reject(dev, dtype):
    """Each dense form counts under its own name, the bf16 forms stay at 0,
    no plain version runs on the card, and a float64 cache or mixed k/v types
    raise."""
    gen = _gen(dev, 2)
    k, v = (torch.randn(1, 2, 2, 256, 128, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    q = torch.randn(2, 4, 128, device=dev, generator=gen).to(torch.bfloat16)
    lens = torch.tensor([256, 3], device=dev)
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype]
    common.reset_counts()
    out = decode_attention(q, k, v, lens, layer_idx=0)
    qc = torch.randn(2, 8, 4, 128, device=dev, generator=gen).to(torch.bfloat16)
    prefill_attention(qc, k, v, torch.arange(8, device=dev)[None].expand(2, 8),
                      torch.arange(2, device=dev), layer_idx=0)
    assert {n: c for n, c in common.launches.items() if c} == {
        "decode_attention" + sfx: 1, "prefill_attention" + sfx: 1}
    assert not any(common.plain_on_cuda.values())
    want32 = decode_attention_reference(q.float(), k[0], v[0], lens)
    _check_dense_attention(out, decode_attention_reference(q, k[0], v[0], lens), want32, dtype)
    assert common.plain_on_cuda["decode_attention" + sfx] == 2  # the plain calls count apart
    with pytest.raises(ValueError):
        decode_attention(q, k.double(), v.double(), lens, layer_idx=0)
    with pytest.raises(ValueError):  # k and v of one type
        decode_attention(q, k, v.to(torch.bfloat16), lens, layer_idx=0)
    with pytest.raises(ValueError):
        prefill_attention(qc, k.double(), v.double(), torch.zeros(2, 8, device=dev),
                          torch.arange(2, device=dev), layer_idx=0)


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_graph_engine_dense_cache_equals_eager(dev, dtype, paged):
    """An engine over an fp16 / f32 cache replays its bursts as graphs with the
    eager bursts' greedy tokens; its attention and appends run the cache's
    own forms (chunked admission through #9, decode through #2 with the
    append inside) and no bf16 form."""
    kw = dict(kv_quant=False, cache_dtype=dtype)
    if paged:
        kw.update(paged=True, page_size=64)
    reqs = _graph_requests()
    want = _graph_engine(dev, eager=True, **kw).generate(reqs)
    eng = _graph_engine(dev, **kw)
    common.reset_counts()
    got = eng.generate(reqs)
    assert eng.cache.k.dtype == dtype
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert eng.loop_stats["graph_captures"] > 0
    assert eng.loop_stats["graph_replays"] == eng.loop_stats["decode_steps"] / 4
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype] + ("_paged" if paged else "")
    launched = {k for k, n in common.launches.items() if n}
    assert {"decode_attention" + sfx, "kv_append" + sfx + "_fused",
            "prefill_attention" + sfx} <= launched
    assert not launched & {"decode_attention", "decode_attention_paged", "prefill_attention",
                           "prefill_attention_paged"}
    assert not any(common.plain_on_cuda.values())


@pytest.mark.parametrize("dtype", list(DENSE_DTYPES.values()), ids=list(DENSE_DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_graph_spec_engine_dense_cache_equals_eager(dev, dtype, paged):
    """n-gram speculation over an fp16 / f32 cache: each verify step one replay,
    tokens and ``spec_stats`` equal the eager engine's; the verify writes its
    rows through the cache's standalone append (#4) and attends through its
    prefill form (#9)."""
    kw = dict(kv_quant=False, cache_dtype=dtype, burst=1, spec_tokens=3)
    if paged:
        kw.update(paged=True, page_size=64)
    reqs = _graph_requests(n=5, new=10)
    want_eng = _graph_engine(dev, eager=True, **kw)
    want = want_eng.generate(reqs)
    eng = _graph_engine(dev, **kw)
    common.reset_counts()
    got = eng.generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert eng.spec_stats == want_eng.spec_stats
    st = eng.loop_stats
    assert st["graph_captures"] > 0 and st["graph_replays"] == st["decode_steps"] > 0
    sfx = {torch.float16: "_f16", torch.float32: "_f32"}[dtype] + ("_paged" if paged else "")
    launched = {k for k, n in common.launches.items() if n}
    assert {"kv_append" + sfx, "prefill_attention" + sfx} <= launched
    assert not any(common.plain_on_cuda.values())
