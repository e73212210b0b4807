"""Time the three forms of the fused dequant-matmul against each other on the
card, to set the routing constants of ``kernels/qgemv_kernel.py``
(``GEMV_MAX_M``, ``MMA_MIN_M``, ``BLOCKS_PER_SM``).

    python3 -m xbitops_tpu_torch.utils.qgemv_sweep [--splits | --widths | --a8 [--a8-splits] |
                                                    --library | --served]

For the five Llama-2-7B projection shapes (4-bit, g=128) and M in 1, 8, 9,
16, 32, 64, 128, 256, 2560 it prints one JSON line per (shape, M) with the
time of every form that takes the input, in ms: CUDA events around the
wrapper, the L2 cache flushed and a device sleep queued before each call, so
the weights are cold and the wrapper's host time stays out.  The CUDA-core
form is left out above M=256 (seconds a call).  With ``--splits`` it times
the split-K target of the few-rows form and of the tile (blocks per SM 1, 2,
4, 8) at M=8 and M=32, and an 8-bit and a 3-bit weight at 4096x4096.  With
``--a8`` it times the int8-activation kernel instead, grouped (4-bit g=128)
and per channel (8-bit), at M=256 and 2560 on the five shapes, beside the
bf16 tile and ``torch._int_mm`` on int8 operands of the same shape (the card's
own int8 GEMM, which reads no packed plane: for information); ``--a8-splits``
adds its split-K target (blocks per SM 1, 2, 4, 8) at M=256.  With
``--widths`` it times widths 1, 2, 3, 5, 6 and 7 at default (packed) storage,
g=128, on the five shapes at M = 1, 8 and 16: the routed form (the few-rows
form's planes kernel) beside the CUDA-core form, with the packed stream's
GB/s and the bound (bytes read and written once over 3.35 TB/s); with
``--widths --splits`` the planes kernel's split-K target (blocks per SM 1, 2,
4, 8) at M=8 instead.  With ``--library`` it times, on the five shapes at M = 8,
16, 32, 256 and 2560, the routed form against PyTorch's own weight-only
matmuls, the yardstick of the kernel table's library column (the port calls
neither): ``torch.ops.aten._weight_int4pack_mm`` on the same 4-bit g=128
weight (converted once, outside the timed window, by :func:`int4pack`), first
held to the plain version within rel 2e-2; and ``_weight_int8pack_mm`` beside
the 8-bit per-channel form, or the error it raises on CUDA tensors.  With
``--served`` it times the routed form on the served set, :data:`SERVED`
(Mistral-7B's and Mixtral-8x7B's projections, 4-bit g=128), at M = 8, 9, 13
and 16: ms cold as above, ``graph_ms`` of launches back to back in a CUDA
graph over copies of the weight that together pass L2 (:func:`in_graph`, how
a replayed decode step meets them), the bound (packed bytes, activations and
output moved once over 3.35 TB/s), the share of it in the graph, the launch
counters raised, and at M = 16 ``_weight_int4pack_mm`` on the same weights
timed both ways; then a decode step's sum of the projections' ``graph_ms`` at
each M (Mistral: 129 launches, Mixtral: 577, every expert).
It needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

# Mistral-7B's and Mixtral-8x7B's projections (K, N): the two share every shape
# (Mixtral's experts have Mistral's FFN width); (layers' launches a decode step:
# Mistral, Mixtral)
SERVED = {"wqkv": (4096, 6144, (32, 32)), "wo": (4096, 4096, (32, 32)),
          "w_gateup": (4096, 28672, (32, 256)), "w_down": (14336, 4096, (32, 256)),
          "lm_head": (4096, 32000, (1, 1))}


def timed(fn, flush, iters: int = 8, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` with cold caches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("qgemv_sweep: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from xbitops_tpu_torch.kernels import qgemv_kernel as qk
    from xbitops_tpu_torch.utils import synth

    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    shapes = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gateup": (4096, 22016),
              "w_down": (11008, 4096), "lm_head": (4096, 32000)}

    def forms_of(M, qt):
        forms = ["mma"]
        if M <= qk.GEMV_MAX_M and qk.word_layout(qt):
            forms.append("gemv")
        if M <= 256:
            forms.append("cuda_core")
        return forms

    def row(label, qt, M, forms):
        a = torch.randn(M, qt.K, device=dev, generator=gen).to(torch.bfloat16)
        ms = {f: timed(lambda f=f: qk.qmatmul_kernel(a, qt, form=f), flush,
                       iters=3 if f == "cuda_core" and M > 16 else 8) for f in forms}
        print(json.dumps(dict(case=label, K=qt.K, N=qt.N, M=M, routed=qk.qgemv_form(M, False, qt),
                              packed_MB=qt.bytes_packed() / 1e6,
                              **{f + "_ms": round(t, 5) for f, t in ms.items()})), flush=True)

    if "--a8" in sys.argv[1:]:
        return a8_rows(qk, synth, gen, dev, flush, shapes)
    if "--library" in sys.argv[1:]:
        return library_rows(qk, synth, gen, dev, flush, shapes)
    if "--served" in sys.argv[1:]:
        return served_rows(qk, synth, gen, dev, flush)
    if "--widths" in sys.argv[1:]:
        return width_rows(qk, synth, gen, dev, flush, shapes)
    if "--splits" not in sys.argv[1:]:
        for name, (K, N) in shapes.items():
            qt = synth.random_qtensor(gen, K, N, 4, 128)
            for M in (1, 8, 9, 16, 32, 64, 128, 256, 2560):
                row(name, qt, M, forms_of(M, qt))
            del qt
        return 0

    default = dict(qk.BLOCKS_PER_SM)
    for name, (K, N) in shapes.items():
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        for form, M in (("gemv", 8), ("mma", 32), ("mma", 256)):
            a = torch.randn(M, qt.K, device=dev, generator=gen).to(torch.bfloat16)
            ms = {}
            for per_sm in (1, 2, 4, 8):
                qk.BLOCKS_PER_SM[form] = per_sm
                ms[per_sm] = round(timed(lambda: qk.qmatmul_kernel(a, qt, form=form), flush), 5)
            qk.BLOCKS_PER_SM.update(default)
            print(json.dumps(dict(case=name, form=form, M=M, ms_by_blocks_per_sm=ms)), flush=True)
        del qt
    for bits in (8, 3):
        qt = synth.random_qtensor(gen, 4096, 4096, bits, 128)
        for M in (8, 32, 256):
            row(f"{bits}-bit wo", qt, M, forms_of(M, qt))
    return 0


def width_rows(qk, synth, gen, dev, flush, shapes) -> int:
    splits = "--splits" in sys.argv[1:]
    default = dict(qk.BLOCKS_PER_SM)
    for bits in (1, 2, 3, 5, 6, 7):
        for name, (K, N) in shapes.items():
            qt = synth.random_qtensor(gen, K, N, bits, 128)
            for M in ((8,) if splits else (1, 8, 16)):
                a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
                form = qk.qgemv_form(M, False, qt)
                row = dict(bits=bits, case=name, K=qt.K, N=N, M=M, routed=form,
                           counter=qk.counter(form, qt), units=qk._units(form, qt)[0])
                if splits:
                    ms = {}
                    for per_sm in (1, 2, 4, 8):
                        qk.BLOCKS_PER_SM["gemv"] = per_sm
                        ms[per_sm] = round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5)
                    qk.BLOCKS_PER_SM.update(default)
                    row["ms_by_blocks_per_sm"] = ms
                    print(json.dumps(row), flush=True)
                    continue
                moved = qt.bytes_packed() + a.numel() * 2 + M * N * 2
                row["ms"] = round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5)
                a_pad = torch.nn.functional.pad(a, (0, qt.K - K))
                row["cuda_core_ms"] = round(timed(
                    lambda: qk.qmatmul_kernel(a_pad, qt, form="cuda_core"), flush), 5)
                row["packed_GBs"] = round(qt.bytes_packed() / row["ms"] / 1e6, 1)
                row["bound_ms"] = round(1e3 * moved / 3.35e12, 5)
                row["share_of_bound"] = round(row["bound_ms"] / row["ms"], 3)
                row["x_cuda_core"] = round(row["cuda_core_ms"] / row["ms"], 2)
                print(json.dumps(row), flush=True)
            del qt
    return 0


def in_graph(fns, reps: int = 3) -> float:
    """Mean device ms a launch of ``fns`` (calls on distinct weights, together
    past L2) run back to back in one CUDA graph: how a decode step's replay
    meets them, with no host time and no flush between launches."""
    for fn in fns:
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * len(fns))


def served_rows(qk, synth, gen, dev, flush) -> int:
    from xbitops_tpu_torch.kernels import common

    Ms = (8, 9, 13, 16)
    step = {M: [0.0, 0.0] for M in Ms}
    for name, (K, N, per_step) in SERVED.items():
        qts = [synth.random_qtensor(gen, K, N, 4, 128)]
        qts += [synth.random_qtensor(gen, K, N, 4, 128)
                for _ in range(min(24, 600_000_000 // qts[0].bytes_packed()) - 1)]
        qt = qts[0]
        for M in Ms:
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            common.reset_counts()
            qk.qmatmul_kernel(a, qt)
            row = dict(case=name, K=K, N=N, M=M, routed=qk.qgemv_form(M, False, qt),
                       launches={k: v for k, v in common.launches.items() if v})
            row["ms"] = round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5)
            row["graph_ms"] = round(in_graph(
                [lambda q=q: qk.qmatmul_kernel(a, q) for q in qts]), 5)
            moved = qt.bytes_packed() + a.numel() * 2 + M * N * 2
            row["bound_ms"] = round(1e3 * moved / 3.35e12, 5)
            row["share_of_bound"] = round(row["bound_ms"] / row["graph_ms"], 3)
            row["packed_GBs"] = round(qt.bytes_packed() / row["graph_ms"] / 1e6, 1)
            if M == 16:
                packs = [int4pack(q) for q in qts]
                w4, sz = packs[0]
                row["library_ms"] = round(timed(
                    lambda: torch.ops.aten._weight_int4pack_mm(a, w4, 128, sz), flush), 5)
                row["library_graph_ms"] = round(in_graph(
                    [lambda w=w, sz=sz: torch.ops.aten._weight_int4pack_mm(a, w, 128, sz)
                     for w, sz in packs]), 5)
                del packs, w4, sz
            for i, n in enumerate(per_step):
                step[M][i] += n * row["graph_ms"]
            print(json.dumps(row), flush=True)
        del qts, qt
    for M in Ms:
        print(json.dumps(dict(M=M, step_ms_mistral_129=round(step[M][0], 4),
                              step_ms_mixtral_577=round(step[M][1], 4))), flush=True)
    return 0


def a8_rows(qk, synth, gen, dev, flush, shapes) -> int:
    from xbitops_tpu_torch.ops.qmatmul import quantize_activations

    default = dict(qk.BLOCKS_PER_SM)
    sms = qk._sm_count(dev.index)
    for name, (K, N) in shapes.items():
        for label, qt in (("grouped", synth.random_qtensor(gen, K, N, 4, 128)),
                          ("per_channel", synth.random_qtensor(gen, K, N, 8, K))):
            for M in (256, 2560):
                a = torch.randn(M, qt.K, device=dev, generator=gen)
                aq, _ = quantize_activations(a)
                plan = qk.a8_plan(qt, M, sms)
                row = dict(case=name, form=label, K=qt.K, N=N, M=M, route=plan.route,
                           splits=plan.splits)
                row["a8_ms"] = round(timed(lambda: qk.qmatmul_kernel_a8(aq, qt), flush), 5)
                row["a8_TOPs"] = round(2 * M * qt.K * N / row["a8_ms"] / 1e9, 1)
                if label == "grouped":
                    a16 = a.to(torch.bfloat16)
                    row["bf16_tile_ms"] = round(timed(lambda: qk.qmatmul_kernel(
                        a16, qt, form="mma"), flush), 5)
                    b8 = torch.randint(-128, 128, (N, qt.K), dtype=torch.int8, device=dev,
                                       generator=gen)
                    row["int_mm_ms"] = round(timed(lambda: torch._int_mm(aq, b8.t()), flush), 5)
                if M == 256 and "--a8-splits" in sys.argv[1:]:
                    ms = {}
                    for per_sm in (1, 2, 4, 8):
                        qk.BLOCKS_PER_SM["a8"] = per_sm
                        ms[per_sm] = round(timed(lambda: qk.qmatmul_kernel_a8(aq, qt), flush), 5)
                    qk.BLOCKS_PER_SM.update(default)
                    row["ms_by_blocks_per_sm"] = ms
                print(json.dumps(row), flush=True)
            del qt
    return 0


def group_rows(ts, qt):
    """Tiled scales (or scale_zeros) ``[T, gt_pad, N]`` -> one row a group,
    f32 ``[K_logical / group_size, N]``."""
    from xbitops_tpu_torch.formats import _expand_tiled_scales

    return _expand_tiled_scales(ts, qt)[: qt.K_logical : qt.group_size]


def int4pack(qt, inner_k_tiles: int = 8):
    """A 4-bit QTensor (no act-order perm) as ``_weight_int4pack_mm`` takes it:
    the codes ``q`` [N, K] two to a byte (the even k in the high nibble) through
    ``_convert_weight_to_int4pack``, and ``qScaleAndZeros`` [K / g, N, 2] bf16
    of scale ``s`` and zero ``8 s - sz``, whose ``(q - 8) s + (8 s - sz)`` is the
    QTensor's ``q s - sz``."""
    from xbitops_tpu_torch.formats import unpack_planes_reference

    q = unpack_planes_reference(qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired)
    q = q[: qt.K_logical, : qt.shape[1]].t().contiguous()  # [N, K]
    w = torch.ops.aten._convert_weight_to_int4pack(
        (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), inner_k_tiles)
    s = group_rows(qt.scales, qt)
    z = 8 * s - group_rows(qt.scale_zeros, qt)
    return w, torch.stack([s, z], dim=2)[:, : qt.shape[1]].to(torch.bfloat16).contiguous()


def library_rows(qk, synth, gen, dev, flush, shapes) -> int:
    from xbitops_tpu_torch.ops.qmatmul import qmatmul

    for name, (K, N) in shapes.items():
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        w4, sz = int4pack(qt)
        for M in (8, 16, 32, 256, 2560):
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            lib = torch.ops.aten._weight_int4pack_mm(a, w4, 128, sz)
            want = qmatmul(a, qt, use_kernel=False).float()
            err = ((lib.float() - want).abs().max() / want.abs().max()).item()
            row = dict(case=name, bits=4, K=K, N=N, M=M, routed=qk.qgemv_form(M, False, qt),
                       library="_weight_int4pack_mm", library_rel_err=round(err, 6))
            if err > 2e-2:
                row["error"] = "the library call does not compute the same function"
                print(json.dumps(row), flush=True)
                return 1
            row["ms"] = round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5)
            row["library_ms"] = round(timed(
                lambda: torch.ops.aten._weight_int4pack_mm(a, w4, 128, sz), flush), 5)
            row["library_over_port"] = round(row["library_ms"] / row["ms"], 3)
            moved = qt.bytes_packed() + a.numel() * 2 + M * N * 2
            row["bound_ms"] = round(1e3 * max(moved / 3.35e12, 2 * M * K * N / 989e12), 5)
            print(json.dumps(row), flush=True)
        del qt, w4, sz
        # 8-bit per channel, its zero point set to 128: (q - 128) s, a symmetric int8 weight
        qt = synth.random_qtensor(gen, K, N, 8, K)
        qt.scale_zeros.copy_(128 * qt.scales.float())
        from xbitops_tpu_torch.formats import unpack_planes_reference

        q = unpack_planes_reference(qt.planes, 8, qt.tile_k, qt.K, paired=qt.paired)
        w8 = (q[:K, :N] - 128).to(torch.int8).t().contiguous()  # [N, K]
        s8 = group_rows(qt.scales, qt)[0, :N].to(torch.bfloat16)
        for M in (8, 256):
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            row = dict(case=name, bits=8, per_channel=True, K=K, N=N, M=M,
                       routed=qk.qgemv_form(M, False, qt), library="_weight_int8pack_mm")
            try:
                lib = torch.ops.aten._weight_int8pack_mm(a, w8, s8)
            except (RuntimeError, NotImplementedError) as e:
                row["library_raises"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
                print(json.dumps(row), flush=True)
                break
            want = qmatmul(a, qt, use_kernel=False).float()
            row["library_rel_err"] = round(
                ((lib.float() - want).abs().max() / want.abs().max()).item(), 6)
            if row["library_rel_err"] > 2e-2:  # timed for information: no yardstick
                row["error"] = "the library call does not compute the same function"
            row["ms"] = round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5)
            row["library_ms"] = round(timed(
                lambda: torch.ops.aten._weight_int8pack_mm(a, w8, s8), flush), 5)
            print(json.dumps(row), flush=True)
        del qt
    return 0


if __name__ == "__main__":
    sys.exit(main())
