"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``xbitops_tpu_torch/csrc`` (nvcc).
   Then holds each kernel against its plain PyTorch version on the card, at
   the shapes the serving paths give it, and times both with CUDA events (the
   L2 cache is flushed before every timed launch, as the serving path finds
   it).  A time is the op's: the kernel's wrapper, with the small device
   passes it adds around its kernel (K padding, index casts, the split-K sum).
   Beside each time stands the least time the card could take (``bound_ms``:
   the larger of bytes moved once over 3.35 TB/s and operations over the
   H100's published dense rate for their type, 989 TFLOP/s in bf16 and 1,979
   TOP/s in int8) and, where one PyTorch call computes the same function,
   that call's time (``library_ms``; the port never calls it).  The fused
   matmul runs at widths 1, 2, 3, 5, 6 and 7 too (default packed storage,
   g=128, the five 7B projection shapes at M=8 and 16): each case prints its
   route and counter (the few-rows form's planes kernel), its op time,
   packed-stream GB/s and bound, and the CUDA-core form's time in the same
   run.  The standalone packed int8 append is timed on the linear cache and
   on a pool, held bit-equal to its plain version.  The W4A8
   matmul prints, for each case, its route (whole words or contiguous rows),
   its K splits and its TOP/s; per channel it must equal its plain version
   bit for bit.  Beside it, for information only, ``torch._int_mm`` on int8
   operands of the same M, K and N: the card's own int8 GEMM, which reads no
   packed plane and applies no scale (not ``library_ms``).  At Mixtral-8x7B's
   shapes: the fused matmul at M=8 on q|k|v (4096x6144), wo and, through a
   ``layer(e)`` view of a stacked QTensor of 8 experts, expert gate|up
   (4096x28672) and expert down (14336x4096); decode attention with its
   append and prefill attention at H=32, Hkv=8 (GQA rep 4), bf16 and int8,
   each beside its plain version, its bound and SDPA.  The fp16 and f32
   caches' forms (``kernels_dense``): decode attention with its append
   (B=8, H=Hkv=32 and GQA rep 4, S=2048, the seven ragged slots and one at
   S), the append alone and prefill attention (8 x 512 and the verify's
   8 x 5), each linear and paged (pages of 256), against their plain
   versions on the same cache: appends bit-equal to the plain cast, fp16
   outputs within abs 2e-2, f32 outputs within 2e-2 and within abs 1e-4
   beyond the rounding of their bf16 output (``beyond_rounding``); timed
   beside SDPA on the rows in the cache's type (q cast to it), the bound at
   2 or 4 bytes an element and the function's own operations at the tensor
   rate of the cache's type (fp16: 989, f32: TF32's 495 TFLOP/s).  A control
   shows on the card that the f32 gate catches a form that rounds the cache
   to bf16: the plain version on the cache rounded to bf16 must fail it.
2. Drives the serving path: a random 4-bit (g=128) Llama-2-7B at full width
   and depth through ``Engine.generate`` with 12 requests on 8 slots over the
   bf16 KV cache, then checks the outputs, that every kernel of that path
   launched during the run and that no plain version ran on the card, and one
   decode step against the plain path (the logits of a 2-layer cut, and each
   of the 32 blocks on one input).
3. Drives the long-context serving path on the same model: 8 requests of 40
   to 1500 prompt tokens on 8 slots over the packed int8 KV cache, prompts
   past 512 tokens admitted in chunks that attend the cache, with the same
   checks; then, on a 2-layer cut, a chunked admission and an int8 decode
   step against the plain path, and a 500-token prompt admitted in one bucket
   against four chunks, on both caches.
4. Drives the quantize-and-W4A8 path on the same model: (a) the model with
   ``prefill_a8=True`` serves 8 requests (seven prompts of 40-500 tokens in
   one bucket, one of 1100 in three chunks): every block projection of a
   forward of 32 rows or more runs on int8 activations through the grouped
   kernel; (b) every block projection goes through ``requantize_a8`` on the
   card (the dequant kernel, then the quantizer) and the 8-bit per-channel
   model serves the same requests through the per-channel kernel; the same
   requests once more with bf16 activations, for the admission rate.  Then
   one admission of 512 rows against the plain path for (a) and (b), at the
   first projection and through a 2-layer cut, and (b)'s logits against (a)'s.
5. Drives the paged serving path on the same model: ``Engine(paged=True,
   page_size=256)`` with a pool of 24 pages for 8 slots (a third of what
   ``slots x max_seq_len`` would take) serves 10 requests of 40 to 1500 prompt
   tokens over the bf16 pool, then 6 over the int8 pool (``kv_quant=True``);
   prompts past 512 tokens are admitted in chunks, and an admission waits until
   finished requests have given pages back.  Checks: every request completes,
   every page is back at the end, each paged kernel form launched and no plain
   version ran on the card; then, on a 2-layer cut, a paged chunk admission
   and a paged decode step against the plain path and against the linear
   cache's kernels.  Printed beside it: the linear engine on the same requests.
   Phase 1 holds the paged forms of the two attention kernels and the two
   appends to their plain versions too, at the serving shape and at pages of
   16 positions with GQA, a window, -1 entries and an inactive slot.
6. Drives the eager decode (``flash_decode=False``) on a 2-layer cut of the
   same model, where each step writes its new rows through the standalone
   append kernel: 6 requests through the engine over the bf16 and the int8
   cache, then 4 decode steps on each cache cut into pages of 256, against the
   linear cache and the plain path.  In the serving paths of phases 2-5 the
   decode-attention kernel appends itself; the ``kernels`` line gives an
   append form its own launches and, as ``fused_launches``, those appends.
7. Drives the 3-bit slice: a random 3-bit (g=128, packed: planes of 2 and
   1 bits) Llama-2-7B at full width and depth serves 6 greedy requests of 16
   to 500 prompt tokens on 8 slots over the bf16 cache.  Checks: no launch of
   the CUDA-core matmul, and one decode step launches the few-rows form's
   planes kernel 129 times (every projection and lm_head); then the logits
   of a 2-layer cut's decode step against the plain path (rel 2e-2).

8. Drives the entry points a user starts, on the same 4-bit model: (a) a
   ``ServingEndpoint`` in front of the full-depth engine (bf16 cache, 8
   slots, bursts of 8) answers 8 concurrent HTTP clients (prompts of 16-500
   tokens, 32 new tokens each) with the tokens ``Engine.generate`` gives for
   the same requests; (b) the same engine with ``max_restarts=1`` and a
   ``torch.AcceleratorError`` injected before its third burst: one restart,
   the graph captured again, the tokens emitted before the error equal the
   clean run's, and any later token that parts from it parts at a near-tie
   (the recomputed top two logits are the two runs' tokens); (c) a random
   AutoGPTQ checkpoint at Llama-2-7B widths cut to 2 layers goes through
   ``cli.main(["convert", ...])`` and ``["generate", ...]``, whose printed
   tokens equal a direct ``load_autogptq`` and ``Engine``; (d)
   ``cli.main(["bench"])``.

9. Drives speculative decoding and pipelined bursts: (a) the fused matmul
   at a verify's M = 8 x (γ + 1) = 16, 32 and 40 on the five 7B shapes (op,
   plain and bound); on a 2-layer cut of the random model, over each cache form
   (bf16 / int8, linear / paged), slots at positions 0-3 mod 4 near live 1000,
   a chain across S, one into a page of -1 and an inactive slot: the unaligned
   write (``_write_unaligned``: 5 append launches a layer) byte-equal to its
   plain version and timed, prefill attention at T = 5 against its plain
   version and SDPA, and the verify forward's logits within rel 2e-2 of the
   plain path; (b) the copy-model (``synth.copy_llama_params``, period 8) at
   full width and depth serves 8 requests (prompts of 16-500 tokens, 64 new)
   with n-gram speculation (γ = 4) on the bf16 and the int8 cache: tokens equal
   the plain graph engine's (the cycle), acceptance >= 0.9, every verify step
   one graph replay, equal to the eager steps' tokens, an eager step's launches
   a replay's count; then γ = 1 and 3 (the verify at M = 16 and 32), and a
   draft model (a 2-layer cut of the copy-model) whose chain runs inside the
   verify's graph; (c) the random model: pipeline=0, 1 and 2 (bursts of 8) on 8
   requests give equal tokens, and n-gram speculation's acceptance (near 0).
   Printed: the verify step's device time at each γ, tokens/s against plain
   graph decode, the launches of a verify replay.

10. Drives Mixtral and GPTQ: (a) a random 4-bit (g=128) Mixtral-8x7B
   (``MoeConfig.mixtral_like``, no-drop: 32 layers, 8 experts top-2, 32/8
   heads) at full width and depth, built on the card from random bits (its
   resident bytes printed), serves 8 greedy requests (prompts of 16-500, 32
   new tokens) on 8 slots in bursts of 8 over the bf16 and then the int8
   cache, tokens equal to eager bursts; the decode step's device time beside
   its bound (every packed weight and the live k/v once) and its launches;
   on a 2-layer cut each MoE block against the plain path from the same input
   (rel 2e-2 over the tokens routed alike; a token whose routes differ must
   sit at a router near-tie) and the share of routes that agree; then γ=4
   n-gram speculation on the model's copy-model form (tokens equal plain
   greedy); (b) a structured dense model (``utils/structured.py``) at
   Llama-2-7B widths cut to 2 layers, written as a HF checkpoint, through
   ``cli.main(["quantize", ...])`` (4-bit g=128, 16x512 structured
   calibration rows; the solver's seconds by shape) and ``["generate",
   ...]`` (the successor walk); an identity Hessian equal to round-to-nearest
   bit for bit at 4096x12288; dense against quantized NLL on held-out
   structured text; γ=4 speculation on the quantized model (tokens equal plain
   greedy, acceptance printed, with prompts that hold the walk and with
   one-token prompts); (c) a random AutoGPTQ Mixtral checkpoint at full
   widths cut to 1 layer through ``convert`` and ``generate``: its logits
   equal, bit for bit, those of the same weights built directly.

11. Drives tensor and expert parallelism, two ranks on the one card (each a
   process, ``parallel.multihost.spawn``; a gloo world, since NCCL refuses two
   ranks on one GPU, so every collective goes through the host and no time of
   this phase is a tensor-parallel speed): (a) Llama-2-7B at full width and
   depth at tp=2: its copy-model packed for two ranks serves 8 greedy requests
   (prompts of 16-500, 32 new tokens) through ``Engine(mesh=)`` (eager bursts,
   half the kv heads a rank), tokens equal to the tp=1 engine's; on the random
   4-bit model a 2-layer cut's decode logits and each of the 32 blocks within
   rel 2e-2 of tp=1; an AutoGPTQ checkpoint at 7B widths cut to 2 layers
   through ``python -m xbitops_tpu_torch convert --tp 2`` and ``generate --tp
   2`` (the command starts its two ranks), tokens equal to ``generate`` at
   tp=1; (b) Mixtral-8x7B at ep=2, each rank building only its 4 experts: the
   copy-model form of phase 10a through ``ep_prefill_slots`` and
   ``ep_decode_step``, tokens equal to phase 10a's one-rank engine; a 2-layer
   cut's MoE blocks at ep=2 within rel 2e-2 of one rank's over the tokens
   routed alike.  The ranks' launch counts of their main-path runs join the
   ``kernels`` line, and the CUDA-core matmul must not launch there either.
   Phase 1 also times one rank's matmul shards at tp=2 (q|k|v 4096x6144, wo
   2048x4096, gate|up 4096x11008, w_down 5504x4096 at g'=128, lm_head
   4096x16000; M=8, the few-rows form) and both attention kernels at 16 local
   heads.

12. Drives pipeline and sequence parallelism, two ranks on the one card as
   in phase 11 (each stage's hidden state, and each chunk's keys, move by
   ``parallel.mesh.ppermute``: an ``all_to_all_single`` through the host, so
   no time of this phase is a PP or SP speed): (a) Llama-2-7B at full width
   and depth at pp=2, 16 layers a rank (``pp.stage_model``): its copy-model
   admits 8 prompts of 16-500 tokens in one bucket of 512 through
   ``pp_prefill_slots``, then ``pp_decode_burst`` runs 32 greedy steps: tokens
   equal to phase 11a's one-rank engine's, each stage's decode through the
   decode-attention kernel with the append inside (1024 launches a rank); a
   2-layer cut of the random model through ``pp_decode_step`` within rel 2e-2
   of one rank's ``decode_step`` on the bf16 and the int8 cache; (b)
   ``sp_prefill`` at sp=2 of 2 prompts of 2048 tokens on the copy-model, then
   3 ordinary decode steps on a rank's cache: tokens equal to one rank's
   ``prefill`` and ``decode_step``; 2-layer cuts at T=2048 of the random
   model and of a random model at Mistral-7B's widths (32 q heads, 8 kv
   heads) with a window of 512: logits within rel 2e-2 of one rank's
   ``prefill``, layer 0's cache rows within rtol 5e-2 / atol 3e-2 and every
   layer's within rel 2e-2 of their largest.  The ranks' launch
   counts join the ``kernels`` line.  Phase 1 also times the matmul at M=4 (a
   PP decode microbatch, the few-rows form) and M=1024 (an SP chunk, the tile)
   on the five 7B shapes, and decode attention with its append on a
   microbatch's view ``k[:, 4:8]`` of an 8-slot cache (B=4), bf16 and int8.

13. Drives the fp16 and f32 KV caches at full width and depth: (a) the
   copy-model of Llama-2-7B (4-bit g=128, 8 slots, S=2048, bursts of 8)
   serves 9 greedy requests (prompts of 16-500 and one of 1500 admitted in 3
   chunks of 512, 32 new tokens) over the bf16, the f32 and the fp16 cache:
   tokens the cycle and equal across the three; (c) the f32 and fp16 runs
   again with eager bursts, tokens equal; (d) a pool of 24 pages of 256,
   tokens equal to the linear cache's; (e) n-gram speculation at γ=4, linear
   and paged, tokens equal (the verify's rows through the append, #4, and its
   attention through #9); (b) on the random model's 2-layer cut, a chunk
   forward of 5 x 512 at positions 512-1023 and a decode step, block by
   block against the plain path on the same cache (rel 2e-2); then each
   cache's decode step at 8 x 1000 live positions, replayed as a graph,
   beside ``utils/profiling.decode_roofline``'s bound at 2 or 4 bytes an
   element.

In every serving phase each decode burst is a replay of a CUDA graph the
engine captured (``loop_stats["graph_replays"]`` equals the bursts run); in
phases 2, 3, 5 and 7 the same requests run again with the bursts eager (the
engine's private ``_eager``): greedy tokens must be equal, and an eager
burst's launches equal what a replay counts.  Host ms/step and tokens/s of
both, the device time of a replayed step (CUDA events around each replay)
and the capture time are printed.

Any failed check raises, so the exit code is not 0.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Needs one CUDA device; without one it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor rate, published
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense tensor rate for f32 operands (TF32), published
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate, published


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref| (the repo's bf16 gate is 2e-2)."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def worst_diff(got, want) -> float:
    """Largest absolute difference over pairs of tensors, of the values as
    they are stored (bf16 rows; int32 words and their bf16 scales as numbers),
    a chunk at a time in float64."""
    worst = 0.0
    for a, b in zip(got, want):
        for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def bound(n_bytes: float, flops: float, rate: float = BF16_FLOPS_PER_S) -> dict:
    """The least time the card could take: each input byte read and each
    output byte written once at the memory rate, or the operations at the
    dense tensor rate of their type (default bf16), whichever is larger."""
    t_bytes, t_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / rate
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Timer:
    """Mean device time of a call (an op, with every launch it makes), by CUDA
    events around each call.  Before each call: a write of 256 MB (5x the
    H100's L2), so inputs are cold as the serving path finds them, then a
    ~1 ms device sleep, so the host has queued the call before the start
    event fires and its Python overhead stays out of the device time."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=device)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()  # a warm-up's temporaries are free before the timed calls
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters


def phase_kernels(dev, timer):
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.qgemv_kernel import qgemv_form, qmatmul_kernel, word16
    from xbitops_tpu_torch.ops.qmatmul import qmatmul
    from xbitops_tpu_torch.utils import synth

    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    # --- fused dequant-matmul at the 7B projection shapes: the few-rows form
    # (M = 8: a decode step), the tensor-core tile (M = 32: 32 slots decoding;
    # 256; 2560: a chunk forward of 5 x 512) and, once, the CUDA-core form ---
    shapes = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gateup": (4096, 22016),
              "w_down": (11008, 4096), "lm_head": (4096, 32000)}
    worst = 0.0
    worst_abs = {"qgemv": 0.0, "qgemv_mma": 0.0, "qgemv_cuda_core": 0.0, "qgemv_planes": 0.0}

    def held(a, qt, label, precise=False):
        """The routed kernel against the plain version; returns the counter it raised."""
        common.reset_counts()
        got = qmatmul(a, qt, precise=precise)
        name = next(k for k, v in common.launches.items() if v)
        sixteen = common.launches["qgemv_word16"]  # the few-rows form's 9-16-row instance, apart
        check(sum(common.launches.values()) == 1 + sixteen and name in worst_abs
              and sixteen == int(name == "qgemv" and word16(a.shape[0], qt))
              and not any(common.plain_on_cuda.values()), f"qmatmul {label}: {common.launches}")
        ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
        e_abs = (got.float() - ref).abs().max().item()
        worst_abs[name] = max(worst_abs[name], e_abs)
        if precise:
            check(torch.allclose(got, ref, rtol=1e-5, atol=3e-4),
                  f"qmatmul precise {label}: outside rel 1e-5 / abs 3e-4 (max abs {e_abs:.3e})")
            return name, e_abs
        e = rel_err(got, ref)
        check(e <= 2e-2, f"qmatmul {label}: rel err {e:.3e} > 2e-2")
        return name, e

    pp_sp = {}  # M = 4 (a PP decode microbatch of 8 slots at pp=2) and 1024 (an SP chunk)
    for name, (K, N) in shapes.items():
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        for M in (4, 8, 32, 256, 1024, 2560):
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            form = qgemv_form(M, False, qt)
            kname, e = held(a, qt, f"{name} M={M}")
            worst = max(worst, e)
            ms = timer(lambda: qmatmul(a, qt))
            plain_ms = timer(lambda: qmatmul(a, qt, use_kernel=False), iters=3)
            gbs = qt.bytes_packed() / ms / 1e6
            b = bound(qt.bytes_packed() + nbytes(a) + 2 * M * N, 2 * M * K * N)
            print(f"qmatmul 4-bit {name} K={K} N={N} M={M} ({form}): op {ms:.4f} ms "
                  f"({gbs:.1f} GB/s packed stream, {2 * M * K * N / ms / 1e9:.1f} TFLOP/s at op "
                  f"time), plain {plain_ms:.4f} ms, rel err {e:.2e}; bound {b['bound_ms']:.4f} ms "
                  f"by {b['bound_by']}", flush=True)
            # no single PyTorch call computes a matmul on packed planes
            if name == "w_gateup" and M == 8:
                check(kname == "qgemv" and form == "gemv", f"M=8 took {form}")
                res["qgemv"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **b)
            if name == "w_gateup" and M == 2560:
                check(kname == "qgemv_mma" and form == "mma", f"M=2560 took {form}")
                res["qgemv_mma"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **b)
            if M in (4, 1024):
                check((form, kname) == (("gemv", "qgemv") if M == 4 else ("mma", "qgemv_mma")),
                      f"{name} M={M} took {form} ({kname})")
                pp_sp[(name, M)] = dict(ms=ms, plain_ms=plain_ms, **b)
            if M == 256:  # the form this one replaced, for the record
                a_pad = torch.nn.functional.pad(a, (0, qt.K - K))
                core_ms = timer(lambda: qmatmul_kernel(a_pad, qt, form="cuda_core"), iters=3)
                print(f"  the CUDA-core form here: {core_ms:.4f} ms", flush=True)
        if name == "w_down":
            check(qt.K == 11264 and qt.K_logical == 11008, "w_down K padding")
    qt = synth.random_qtensor(gen, 4096, 4096, 4, 128)
    for M in (8, 40):
        a = torch.randn(M, 4096, device=dev, generator=gen)
        kname, e = held(a, qt, f"4096x4096 M={M}", precise=True)
        check(kname == "qgemv_cuda_core", f"precise took {kname}")
        print(f"qmatmul precise 4096x4096 M={M}: max abs err {e:.3e}", flush=True)
    # other widths and layouts, ragged M and N: 3-bit (two slot planes), 8-bit,
    # 4-bit in the slot layout (groups of 40), 4-bit paired with N % 8 != 0
    for bits, g, K, N in ((3, 128, 4096, 4096), (8, 128, 4096, 4096), (4, 40, 1280, 1000),
                          (4, 128, 4096, 1004)):
        qt = synth.random_qtensor(gen, K, N, bits, g)
        for M in (8, 13, 300):
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            _, e = held(a, qt, f"{bits}-bit g={g} {K}x{N} M={M}")
            worst = max(worst, e)
            print(f"qmatmul {bits}-bit g={g} {K}x{N} M={M} ({qgemv_form(M, False, qt)}, "
                  f"paired {qt.paired}): rel err {e:.2e}", flush=True)
    # every other width at default (packed) storage, g=128, on the five shapes at
    # the decode batch (8) and the few-rows form's largest (16): the planes kernel
    # (csrc/qgemv_word_planes.cu) beside the CUDA-core form it replaced there
    from xbitops_tpu_torch.kernels.qgemv_kernel import counter, word_planes

    widths = {}
    for bits in (1, 2, 3, 5, 6, 7):
        for name, (K, N) in shapes.items():
            qt = synth.random_qtensor(gen, K, N, bits, 128)
            check(word_planes(qt), f"{bits}-bit {name}: not the planes kernel's layout")
            for M in (8, 16):
                a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
                form = qgemv_form(M, False, qt)
                kname, e = held(a, qt, f"{bits}-bit {name} M={M}")
                check(form == "gemv" and kname == counter(form, qt) == "qgemv_planes",
                      f"{bits}-bit {name} M={M} took {form} ({kname})")
                worst = max(worst, e)
                ms = timer(lambda: qmatmul(a, qt), iters=5)
                a_pad = torch.nn.functional.pad(a, (0, qt.K - K))
                core_ms = timer(lambda: qmatmul_kernel(a_pad, qt, form="cuda_core"), iters=3)
                b = bound(qt.bytes_packed() + nbytes(a) + 2 * M * N, 2 * M * K * N)
                widths[(bits, name, M)] = dict(ms=ms, core_ms=core_ms, **b)
                print(f"qmatmul {bits}-bit {name} K={qt.K} N={N} M={M} ({form}, counter "
                      f"{kname}): op {ms:.4f} ms ({qt.bytes_packed() / ms / 1e6:.1f} GB/s packed "
                      f"stream, {b['bound_ms'] / ms:.1%} of the bound), bound "
                      f"{b['bound_ms']:.4f} ms by {b['bound_by']}; the CUDA-core form here "
                      f"{core_ms:.4f} ms ({core_ms / ms:.2f}x); rel err {e:.2e}", flush=True)
                if (bits, name, M) == (3, "w_gateup", 8):
                    plain_ms = timer(lambda: qmatmul(a, qt, use_kernel=False), iters=2)
                    res["qgemv_planes"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **b)
            del qt
    for M in (8, 16):
        row = {bits: sum(v["ms"] for (b, _, m), v in widths.items() if b == bits and m == M)
               for bits in (1, 2, 3, 5, 6, 7)}
        core = {bits: sum(v["core_ms"] for (b, _, m), v in widths.items()
                          if b == bits and m == M) for bits in row}
        share = {bits: sum(v["bound_ms"] for (b, _, m), v in widths.items()
                           if b == bits and m == M) / row[bits] for bits in row}
        print(f"qmatmul planes kernel, M={M}, the five shapes summed, ms by width: "
              f"{ {b: round(t, 4) for b, t in row.items()} }; CUDA-core form "
              f"{ {b: round(t, 4) for b, t in core.items()} }; share of the bound "
              f"{ {b: round(x, 3) for b, x in share.items()} }", flush=True)
    for M in (4, 1024):
        row = {n: v for (n, m), v in pp_sp.items() if m == M}
        print(f"qmatmul 4-bit, the five 7B shapes at M={M} "
              f"({'a PP decode microbatch, few-rows form' if M == 4 else 'an SP chunk, the tile'}"
              f"), op / bound / plain ms: "
              + ", ".join(f"{n} {v['ms']:.4f} / {v['bound_ms']:.4f} / {v['plain_ms']:.4f}"
                          for n, v in row.items()), flush=True)
    res["pp_sp_matmul"] = pp_sp
    print(f"qmatmul: worst rel err {worst:.2e} (gate 2e-2), worst abs err {worst_abs}",
          flush=True)
    for kname in ("qgemv", "qgemv_mma", "qgemv_planes"):  # the CUDA-core form: no serving path
        res[kname]["max_abs_err"] = worst_abs[kname]

    res["word16"] = kernels_word16(dev, gen)
    res.update(kernels_quant(dev, timer, gen, shapes))
    res.update(kernels_decode(dev, timer, gen))
    res.update(kernels_prefill(dev, timer, gen))
    res["pp_view"] = kernels_pp_view(dev, timer, gen)
    res.update(kernels_paged(dev, timer, gen))
    res.update(kernels_dense(dev, timer, gen))
    res["mixtral"] = kernels_at(dev, timer, gen, "Mixtral", mixtral_mats(gen), (8, 40, 2560), 32, 8)
    # one rank's shards of 7B at tp=2: the five matmuls at M = 8, attention at
    # 16 local heads
    res["tp"] = kernels_at(dev, timer, gen, "7B tp=2 shard", tp_shard_mats(gen), (8,), 16, 16)
    for v in (*res["mixtral"].values(), *res["tp"].values()):  # the matmul held there too
        if v.get("kernel") in ("qgemv", "qgemv_mma"):
            row = res[v["kernel"]]
            row["max_abs_err"] = max(row["max_abs_err"], v["max_abs_err"])
    return res


def kernels_word16(dev, gen):
    """The few-rows form's 9-16-row instance (``qgemv_word_kernel16``, every
    decode step of 16 slots): at M = 9, 13 and 16 on Mistral-7B's and
    Mixtral-8x7B's projections, an expert's ``layer(e)`` view, and the
    layout's edges (N % 256, N % 8 and N % 4 not 0, K padded: Ka < K), against
    the plain version (rel 2e-2) and the CUDA-core form in f32 (rel 1e-4 of
    the largest output); a second call gives the same bits and the split-K
    tickets come back to 0; a graph replay gives the same bits.  Its times:
    ``utils/qgemv_sweep.py --served``."""
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.qgemv_kernel import (
        _stream_counters,
        qgemv_form,
        qmatmul_kernel,
        word16,
    )
    from xbitops_tpu_torch.models.moe import stack_experts
    from xbitops_tpu_torch.ops.qmatmul import qmatmul
    from xbitops_tpu_torch.utils import synth
    from xbitops_tpu_torch.utils.qgemv_sweep import SERVED

    tickets = _stream_counters(dev, torch.cuda.current_stream(dev).cuda_stream)

    def held(a, qt, label):
        M = a.shape[0]
        check(word16(M, qt) and qgemv_form(M, False, qt) == "gemv", f"{label}: not the instance")
        common.reset_counts()
        got = qmatmul_kernel(a, qt, out_dtype=torch.float32)
        check({k: n for k, n in common.launches.items() if n} == {"qgemv": 1, "qgemv_word16": 1},
              f"{label}: launches {dict(common.launches)}")
        ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
        top = ref.abs().max()
        core = qmatmul_kernel(torch.nn.functional.pad(a, (0, qt.K - a.shape[1])), qt,
                              out_dtype=torch.float32, form="cuda_core")
        e_core = ((got - core).abs().max() / top).item()
        e = rel_err(qmatmul_kernel(a, qt), ref)
        again = qmatmul_kernel(a, qt, out_dtype=torch.float32)
        torch.cuda.synchronize()
        check(e_core <= 1e-4 and e <= 2e-2 and torch.equal(again, got)
              and tickets.abs().max().item() == 0,
              f"{label}: rel err {e:.2e} (plain), {e_core:.2e} (CUDA-core form), equal again "
              f"{torch.equal(again, got)}, tickets {tickets.abs().max().item()}")
        return got, e, e_core

    worst, worst_core = 0.0, 0.0
    cases = [(n, synth.random_qtensor(gen, K, N, 4, 128)) for n, (K, N, _) in SERVED.items()]
    cases.append(("expert gate|up, layer(5)", stack_experts(
        [synth.random_qtensor(gen, 4096, 28672, 4, 128) for _ in range(8)]).layer(5)))
    check(cases[-1][1].planes[0].storage_offset() > 0, "the expert view has no offset")
    for K, N, g, tk in ((2048, 160, 128, None), (2048, 100, 128, None), (2048, 99, 128, None),
                        (11008, 4096, 128, None), (1024, 300, 256, 512)):
        cases.append((f"{K}x{N} g={g}", synth.random_qtensor(gen, K, N, 4, g, tile_k=tk)))
    for name, qt in cases:
        for M in (9, 13, 16):
            a = torch.randn(M, qt.K_logical, device=dev, generator=gen).to(torch.bfloat16)
            got, e, e_core = held(a, qt, f"word16 {name} M={M}")
            worst, worst_core = max(worst, e), max(worst_core, e_core)
            if M == 16 and name in ("wo", "2048x99 g=128"):  # one split / 8; 4-byte copies
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = qmatmul_kernel(a, qt, out_dtype=torch.float32)
                graph.replay()
                torch.cuda.synchronize()
                check(torch.equal(out, got), f"word16 {name}: a graph replay differs")
    del cases
    print(f"qmatmul 9-16-row instance: worst rel err {worst:.2e} (plain, gate 2e-2), "
          f"{worst_core:.2e} (CUDA-core form in f32, gate 1e-4)", flush=True)
    return dict(worst_rel_err=worst, worst_rel_err_core=worst_core)


def step16(model, cfg, dev, label: str, want: int) -> dict:
    """One decode step of 16 slots (the benchmark's cells run 16): every
    projection and the lm_head on the few-rows form's 9-16-row instance,
    ``want`` launches of it (a 32-layer dense model 129, Mixtral 577)."""
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama

    small = dataclasses.replace(cfg, max_seq_len=256)
    cache = llama.KVCache.init(small, 16, dev, quantized=True)
    tokens = torch.arange(16, device=dev) * 997 % cfg.vocab_size
    common.reset_counts()
    logits, _ = llama.decode_step(model, tokens, cache)
    torch.cuda.synchronize()
    step = {k: n for k, n in common.launches.items() if n}
    check(step.get("qgemv_word16") == want and step.get("qgemv") == want
          and "qgemv_mma" not in step and "qgemv_cuda_core" not in step
          and torch.isfinite(logits.float()).all().item(),
          f"{label}, a decode step of 16 slots: launches {step}, want qgemv_word16 {want}")
    print(f"{label}, a decode step of 16 slots: launches {step}", flush=True)
    return step


def kernels_quant(dev, timer, gen, shapes):
    """The dequant kernel and the two int8-activation matmul kernels against
    their plain versions, and the reference-API ops on interchange tensors."""
    from xbitops_tpu_torch import formats
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.dequant_kernel import dequant_kernel, dequant_kernel_reference
    from xbitops_tpu_torch.kernels.qgemv_kernel import (
        _sm_count,
        a8_per_channel,
        a8_plan,
        qmatmul_kernel_a8,
        qmatmul_kernel_a8_reference,
    )
    from xbitops_tpu_torch.ops.dequant import dequant
    from xbitops_tpu_torch.ops.qmatmul import gemv, qmatmul, quantize_activations
    from xbitops_tpu_torch.ops.quantize import requantize_a8
    from xbitops_tpu_torch.utils import synth

    res = {}
    names = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "f32"}

    # --- dequant: equal to the plain version, bit for bit ---
    def dequant_case(qt, label, timed):
        for dt, dname in names.items():
            got, ref = dequant_kernel(qt, dt), dequant_kernel_reference(qt, dt)
            check(torch.equal(got, ref), f"dequant {label} -> {dname}: differs from its plain version")
            err = worst_diff((got,), (ref,))
            if not timed:
                continue
            ms = timer(lambda: dequant_kernel(qt, dt))
            plain_ms = timer(lambda: dequant_kernel_reference(qt, dt), iters=2, warmup=1)
            b = bound(qt.bytes_packed() + nbytes(got), 2 * qt.K * qt.N)
            print(f"dequant {label} -> {dname}: equal; op {ms:.4f} ms "
                  f"({(qt.bytes_packed() + nbytes(got)) / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
            if label == "4-bit w_gateup" and dt == torch.float32:
                # the case requantize_a8 runs; no PyTorch call reads packed planes
                res["dequant"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                      max_abs_err=err, **b)
            del got, ref

    for bits in range(1, 9):
        dequant_case(synth.random_qtensor(gen, 4096, 4096, bits, 128), f"{bits}-bit 4096x4096",
                     timed=False)
    print("dequant: widths 1-8 at 4096x4096 equal to the plain version in bf16, fp16, f32",
          flush=True)
    for name, (K, N) in shapes.items():
        dequant_case(synth.random_qtensor(gen, K, N, 4, 128), f"4-bit {name}",
                     timed=name in ("w_gateup", "w_down"))

    # --- the int8-activation matmuls ---
    worst = {"qgemv_a8": 0.0, "qgemv_a8_perchannel": 0.0}

    def a8_case(qt, label, M, keep=None):
        kname = "qgemv_a8_perchannel" if a8_per_channel(qt) else "qgemv_a8"
        a = torch.randn(M, qt.K_logical, device=dev, generator=gen).to(torch.bfloat16)
        a_pad = torch.nn.functional.pad(a.float(), (0, qt.K - qt.K_logical))
        aq, a_scale = quantize_activations(a_pad)
        raw, raw_ref = qmatmul_kernel_a8(aq, qt), qmatmul_kernel_a8_reference(aq, qt)
        got, ref = raw * a_scale, raw_ref * a_scale
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        worst[kname] = max(worst[kname], err)
        if kname == "qgemv_a8":  # the groups' f32 folds may fuse their multiply-adds
            ok = torch.allclose(got, ref, rtol=1e-5, atol=3e-4)
            gate = "rel 1e-5 / abs 3e-4"
        else:  # integer sums and one rescale, f32 operation for f32 operation
            ok = torch.equal(raw, raw_ref)
            gate = "equality with the plain version"
        check(ok, f"{kname} {label} M={M}: max abs err {err:.3e} (largest output {top:.3e}) "
                  f"outside {gate}")
        del got, ref, raw, raw_ref
        plan = a8_plan(qt, M, _sm_count(dev.index))
        ms = timer(lambda: qmatmul_kernel_a8(aq, qt), iters=5)
        op_ms = timer(lambda: qmatmul(a, qt, a8=True), iters=5)
        plain_ms = timer(lambda: qmatmul_kernel_a8_reference(aq, qt), iters=1, warmup=1)
        bf16_ms = timer(lambda: qmatmul(a, qt), iters=3, warmup=1)
        # for information only: the card's own int8 GEMM on int8 operands of
        # the same M, K, N (it reads no packed plane and applies no scale;
        # the port never calls it)
        b8 = torch.randint(-128, 128, (qt.N, qt.K), dtype=torch.int8, device=dev, generator=gen)
        int_mm_ms = timer(lambda: torch._int_mm(aq, b8.t()), iters=3, warmup=1)
        del b8
        ops = 2 * M * qt.K * qt.N
        b = bound(qt.bytes_packed() + nbytes(aq) + 4 * M * qt.N, ops, INT8_OPS_PER_S)
        print(f"{kname} {label} K={qt.K} N={qt.N} M={M} (route {plan.route}, "
              f"{'whole words' if plan.route != 'rows' else 'contiguous rows'}, splits "
              f"{plan.splits}): max abs err {err:.2e} of {top:.2e}; "
              f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), op with the activation "
              f"quantization {op_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b['bound_ms']:.4f} ms "
              f"by {b['bound_by']}; for information, the bf16 qmatmul here {bf16_ms:.4f} ms, "
              f"torch._int_mm on int8 operands {int_mm_ms:.4f} ms "
              f"({ops / int_mm_ms / 1e9:.1f} TOP/s)", flush=True)
        if keep:
            res[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **b)

    for name, (K, N) in shapes.items():
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        common.reset_counts()
        rq = requantize_a8(qt)
        check(common.launches["dequant"] == 1 and rq.bits == 8 and a8_per_channel(rq)
              and rq.K == K, f"requantize_a8 {name}: not 8-bit per channel through the kernel")
        for M in (256, 2560):
            keep = name == "w_gateup" and M == 2560
            a8_case(qt, f"4-bit g=128 {name}", M, keep)
            a8_case(rq, f"8-bit per-channel {name}", M, keep)
        del qt, rq
    for bits in (3, 7):  # planes combined into one integer before the dot
        a8_case(synth.random_qtensor(gen, 4096, 4096, bits, 128), f"{bits}-bit g=128 wo", 256)
    for kname, err in worst.items():
        res[kname]["max_abs_err"] = err

    # --- the reference-API ops on GPTQ interchange tensors, fp16 ---
    K, N, g = 4096, 11008, 128
    rng = np.random.default_rng(SEED)
    wq = rng.integers(0, 16, (K, N)).astype(np.uint8)
    zeros = rng.integers(0, 16, (K // g, N)).astype(np.uint8)
    scales = rng.uniform(0.002, 0.01, (K // g, N)).astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, 4)
    args = [torch.from_numpy(x).to(dev) for x in (qweight, scales, qzeros)]
    common.reset_counts()
    w = dequant(*args, g, 4, K)
    ref = formats.dequant_reference(*args, g, 4, K)
    e = (w.float() - ref.float()).abs().max().item()
    check(w.dtype == torch.float16 and w.shape == (K, N), "dequant: dtype or shape")
    check(e <= 1e-3, f"dequant from interchange tensors: abs err {e:.3e} > 1e-3")
    a = torch.randn(8, K, device=dev, generator=gen).to(torch.float16)
    out = gemv(a, *args, g, 4, K)
    want = a.float() @ ref.float()
    e2 = rel_err(out, want)
    check(out.dtype == torch.float16 and e2 <= 2e-2, f"gemv from interchange tensors: rel {e2:.3e}")
    check(common.launches["dequant"] == 1 and common.launches["qgemv"] == 1
          and not any(common.plain_on_cuda.values()), "dequant / gemv did not launch their kernels")
    print(f"dequant and gemv from GPTQ interchange tensors {K}x{N} fp16: dequant max abs err "
          f"{e:.1e} vs dequant_reference (equal: {torch.equal(w, ref)}), gemv M=8 rel err {e2:.2e}",
          flush=True)
    return res


def packed_cache(gen, L, B, Hkv, S, D):
    """A random packed int8 cache: words k, v [L, B, Hkv, S/4, D] and bf16
    scales [L, B, 4, Hkv, S/4], sized so that dequantized values are O(1)."""
    dev = gen.device
    k, v = (torch.randint(-(2**31), 2**31, (L, B, Hkv, S // 4, D), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32) for _ in range(2))
    ks, vs = (torch.empty((L, B, 4, Hkv, S // 4), device=dev).uniform_(0.005, 0.02, generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    return k, v, ks, vs


def sdpa(q, k, v, mask):
    """The yardstick: one PyTorch attention call.  q [B, H, Tq, D]; k/v
    [B, Hkv, S, D] bf16 (``enable_gqa`` where Hkv < H: each kv head serves
    H / Hkv query heads, with no copy of the cache); mask bool,
    broadcastable to [B, H, Tq, S]."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=k.shape[1] < q.shape[1])


def fused_once(call, name: str, append: str, cache):
    """Run a decode-attention call that appends (``kv_new``) into the tensors
    ``cache``.  Returns the first call's output and a copy of ``cache`` as
    that call left it: those are what is held against the plain version.  A
    second call (the workspace is made by then) must be one launch of
    ``name``, counted as an append in form ``append``, allocate its output and
    nothing else, and write the bytes the first wrote."""
    from xbitops_tpu_torch.kernels import common

    out = call()[0]
    torch.cuda.synchronize()
    after = [t.clone() for t in cache]
    common.reset_counts()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    call()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    launched = {k: n for k, n in common.launches.items() if n}
    check(launched == {name: 1, append + "_fused": 1},
          f"{name} with kv_new: launches {launched}, want one fused launch")
    check(allocs == 1, f"{name} with kv_new allocated {allocs} tensors, want 1 (its output)")
    check(all(torch.equal(a, t) for a, t in zip(after, cache)),
          f"{name}: a second call with the same kv_new wrote other bytes")
    return out, after


def kernels_decode(dev, timer, gen):
    """Decode attention with the fused append, bf16 and int8, and the two
    appends alone, at the 7B shapes with ragged lengths."""
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        _unpack_kv_words,
        kv_append_dense,
        kv_append_dense_reference,
        kv_append_packed,
        kv_append_packed_reference,
    )

    res = {}
    S, D = 2048, 128
    lens_live = [1, 7, 128, 1000, 2047, 2048, 513]  # + one inactive slot
    B = len(lens_live) + 1
    pos = torch.tensor([n - 1 for n in lens_live] + [S], device=dev)  # inactive: S
    lens = torch.clamp(pos + 1, max=S)
    s_idx = torch.arange(S, device=dev)
    att_err = att8_err = 0.0
    for H, Hkv, window in ((32, 32, None), (32, 8, None), (32, 32, 512)):
        timed = H == Hkv and window is None
        q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
        live_rows = int(lens.sum()) * Hkv * D
        mask = (s_idx[None] < lens[:, None])[:, None, None, :]  # [B, 1, 1, S]
        if window is not None:
            mask = mask & (s_idx[None] >= (lens - window).clamp(min=0)[:, None])[:, None, None, :]

        # --- bf16 cache ---
        k = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
        v = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
        kn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
        vn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
        k_ref, v_ref = k.clone(), v.clone()
        out, after = fused_once(lambda: decode_attention(q, k, v, lens, layer_idx=1,
                                                         kv_new=(kn, vn, pos), window=window),
                                "decode_attention", "kv_append", (k, v))
        kv_append_dense_reference(k_ref, v_ref, kn, vn, pos, 1)
        ref = decode_attention_reference(q, k_ref[1], v_ref[1], lens, window)
        same = all(torch.equal(a, b) for a, b in zip(after, (k_ref, v_ref)))
        del after
        e = (out.float() - ref.float()).abs().max().item()
        lib = sdpa(q[:, :, None], k[1], v[1], mask)[:, :, 0]
        e_lib = (lib[:-1].float() - ref[:-1].float()).abs().max().item()
        print(f"decode_attention+append bf16 B={B} H={H} Hkv={Hkv} S={S} window={window}: "
              f"rows exact {same}, max abs err {e:.2e} (library call vs plain {e_lib:.2e})",
              flush=True)
        check(same, "appended cache rows differ from the plain append")
        check(e <= 2e-2, f"decode attention abs err {e:.3e} > 2e-2")
        check(e_lib <= 2e-2, f"the library yardstick does not compute the same function: {e_lib}")
        att_err = max(att_err, e)
        if timed:
            ms = timer(lambda: decode_attention(q, k, v, lens, layer_idx=1,
                                                kv_new=(kn, vn, pos)))
            plain_ms = timer(lambda: (
                kv_append_dense_reference(k, v, kn, vn, pos, 1),
                decode_attention_reference(q, k[1], v[1], lens)), iters=3)
            # yardstick, like for like: the op appends the new rows and then attends, so
            # the library side is two index_copy_ of the B * Hkv new rows (k and v) and
            # one attention call; the attention call alone is printed beside it
            act = pos < S
            rows = ((torch.arange(B, device=dev)[:, None] * Hkv
                     + torch.arange(Hkv, device=dev)[None]) * S + pos[:, None])[act].reshape(-1)
            kf1, vf1 = k[1].view(-1, D), v[1].view(-1, D)
            kr1, vr1 = kn[act].reshape(-1, D), vn[act].reshape(-1, D)
            library_ms = timer(lambda: (kf1.index_copy_(0, rows, kr1),
                                        vf1.index_copy_(0, rows, vr1),
                                        sdpa(q[:, :, None], k[1], v[1], mask)))
            check(torch.equal(k, k_ref) and torch.equal(v, v_ref),
                  "the index_copy_ yardstick does not write the rows the op writes")
            sdpa_ms = timer(lambda: sdpa(q[:, :, None], k[1], v[1], mask))
            b = bound(2 * 2 * live_rows + nbytes(q, out, kn, vn), 4 * H * D * int(lens.sum()))
            print(f"decode_attention+append bf16 MHA: op {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (2 index_copy_ + SDPA) {library_ms:.4f} ms (SDPA alone, which appends "
                  f"nothing, {sdpa_ms:.4f} ms), bound {b['bound_ms']:.4f} ms by {b['bound_by']}",
                  flush=True)
            res["decode_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
            k2, v2 = k.clone(), v.clone()
            kn2, vn2 = kn + 1, vn - 1
            kv_append_dense(k, v, kn2, vn2, pos, 0)
            kv_append_dense_reference(k2, v2, kn2, vn2, pos, 0)
            app_err = worst_diff((k, v), (k2, v2))
            app_ok = torch.equal(k, k2) and torch.equal(v, v2)
            ms = timer(lambda: kv_append_dense(k, v, kn2, vn2, pos, 0))
            plain_ms = timer(lambda: kv_append_dense_reference(k, v, kn2, vn2, pos, 0))
            # yardstick: index_copy_ of the B * Hkv new rows, once for k and once for v
            kf, vf = k[0].view(-1, D), v[0].view(-1, D)
            kr, vr = kn2[act].reshape(-1, D), vn2[act].reshape(-1, D)
            library_ms = timer(lambda: (kf.index_copy_(0, rows, kr), vf.index_copy_(0, rows, vr)))
            check(torch.equal(k, k2) and torch.equal(v, v2),
                  "the index_copy_ yardstick does not compute the same function")
            b = bound(2 * nbytes(kn2, vn2), 0)
            print(f"kv_append B={B} Hkv={Hkv} S={S}: exact {app_ok}, op {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library (2 index_copy_) {library_ms:.4f} ms, "
                  f"bound {b['bound_ms']:.5f} ms by {b['bound_by']} (launch-bound)", flush=True)
            check(app_ok, "kv_append differs from its plain version")
            res["kv_append"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                    max_abs_err=app_err, **b)
        del k, v, k_ref, v_ref

        # --- packed int8 cache ---
        cache = packed_cache(gen, 2, B, Hkv, S, D)
        kq, vq = (torch.randint(1, 256, (B, Hkv, D), generator=gen, device=dev,
                                dtype=torch.int32) for _ in range(2))
        ksn, vsn = (torch.empty((B, Hkv), device=dev).uniform_(0.005, 0.02, generator=gen)
                    for _ in range(2))
        new = (kq, vq, ksn, vsn, pos)
        ref_cache = [t.clone() for t in cache]
        out, after = fused_once(lambda: decode_attention(
            q, cache[0], cache[1], lens, layer_idx=1, k_scale=cache[2], v_scale=cache[3],
            kv_new=new, window=window), "decode_attention_int8", "kv_append_packed", cache)
        kv_append_packed_reference(*ref_cache, *new, 1)
        ref = decode_attention_reference(q, ref_cache[0][1], ref_cache[1][1], lens, window,
                                         ref_cache[2][1], ref_cache[3][1])
        same = all(torch.equal(a, b) for a, b in zip(after, ref_cache))
        del after
        e = (out.float() - ref.float()).abs().max().item()
        print(f"decode_attention+append int8 B={B} H={H} Hkv={Hkv} S={S} window={window}: "
              f"words and scales exact {same}, max abs err {e:.2e}", flush=True)
        check(same, "appended int8 words or scales differ from the plain append")
        check(e <= 2e-2, f"int8 decode attention abs err {e:.3e} > 2e-2")
        att8_err = max(att8_err, e)
        if timed:
            k8, v8, ks8, vs8 = cache
            ms = timer(lambda: decode_attention(q, k8, v8, lens, layer_idx=1, k_scale=ks8,
                                                v_scale=vs8, kv_new=new))
            plain_ms = timer(lambda: (
                kv_append_packed_reference(k8, v8, ks8, vs8, *new, 1),
                decode_attention_reference(q, k8[1], v8[1], lens, None, ks8[1], vs8[1])),
                iters=3)
            # yardstick: the same call as for the bf16 cache, on the rows dequantized to bf16
            kd = _unpack_kv_words(k8[1], ks8[1]).to(torch.bfloat16)
            vd = _unpack_kv_words(v8[1], vs8[1]).to(torch.bfloat16)
            # (no PyTorch call writes a byte of a packed word, so this side appends nothing)
            library_ms = timer(lambda: sdpa(q[:, :, None], kd, vd, mask))
            del kd, vd
            # a live position: D bytes and one bf16 scale, for k and for v
            b = bound(2 * (live_rows + 2 * int(lens.sum()) * Hkv) + nbytes(q, out, kq, vq),
                      4 * H * D * int(lens.sum()))
            print(f"decode_attention+append int8 MHA: op {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (SDPA on bf16 rows, no append: none exists for the packed write) "
                  f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
            res["decode_attention_int8"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                                **b)
            # the packed append alone: pos % 4 takes all four values, one slot sits at S
            pos4 = torch.tensor([4, 9, 18, 31, 2047, 1000, 514, S], device=dev)
            new4 = (kq, vq, ksn, vsn, pos4)
            ref_cache = [t.clone() for t in cache]
            at_s = [t[0, B - 1].clone() for t in cache]
            kv_append_packed(*cache, *new4, 0)
            kv_append_packed_reference(*ref_cache, *new4, 0)
            app_err = worst_diff(cache, ref_cache)
            app_ok = all(torch.equal(a, b) for a, b in zip(cache, ref_cache))
            check(app_ok, "kv_append_packed differs from its plain version")
            check(all(torch.equal(t[0, B - 1], a) for t, a in zip(cache, at_s)),
                  "the slot at position S was written")
            ms = timer(lambda: kv_append_packed(*cache, *new4, 0))
            plain_ms = timer(lambda: kv_append_packed_reference(*cache, *new4, 0))
            # one byte of B * Hkv * D words read and written, for k and v, and the scales
            b = bound(2 * (2 * 4 + 4) * (B - 1) * Hkv * D + 2 * 2 * 2 * (B - 1) * Hkv, 0)
            print(f"kv_append_packed B={B} Hkv={Hkv} S={S}: exact {app_ok}, op {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
                  f"(launch-bound)", flush=True)
            # no single PyTorch call rewrites one byte of a word
            res["kv_append_packed"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                           max_abs_err=app_err, **b)
        del cache, ref_cache
    res["decode_attention"]["max_abs_err"] = att_err
    res["decode_attention_int8"]["max_abs_err"] = att8_err

    # The JAX package picks the int8 cache from max_seq_len 1024 on, a rule
    # found on a TPU: what the H100 says at 8 slots of 1000 live positions.
    H = Hkv = 32
    B = 8
    lens = torch.full((B,), 1000, device=dev)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(1, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(1, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    k8, v8, ks8, vs8 = packed_cache(gen, 1, B, Hkv, S, D)
    times = []
    for _ in range(2):  # in turns
        times.append((timer(lambda: decode_attention(q, k, v, lens, layer_idx=0)),
                      timer(lambda: decode_attention(q, k8, v8, lens, layer_idx=0, k_scale=ks8,
                                                     v_scale=vs8))))
    bf, i8 = (sum(t[i] for t in times) / len(times) for i in (0, 1))
    print(f"decode attention B=8 live=1000 S={S} MHA, no append: bf16 cache {bf:.4f} ms, int8 "
          f"cache {i8:.4f} ms (int8 / bf16 = {i8 / bf:.3f})", flush=True)
    res["live1000"] = dict(bf16_ms=bf, int8_ms=i8)
    return res


# The fp16 and f32 caches' forms of #2, #9 and #4 (csrc/kvtype.cuh).  Their
# q and outputs stay bf16.  A bound counts the function's own operations at
# the card's tensor rate for the cache's type, not the work of the kernel's
# design (the f32 forms' split into bf16 products).
DENSE = {"f16": torch.float16, "f32": torch.float32}
DENSE_RATE = {torch.float16: BF16_FLOPS_PER_S, torch.float32: TF32_FLOPS_PER_S}
F32_GATE = 1e-4  # abs, beyond the rounding of the bf16 output


def beyond_rounding(out, ref32) -> float:
    """Largest |out - ref32| beyond half a bf16 unit in the last place of
    ``ref32``: the error of a bf16 output ``out`` that its own rounding does not
    explain, against the plain version's unrounded f32 result."""
    half = torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32).exponent - 9)
    return ((out.float() - ref32).abs() - half).clamp(min=0).max().item()


def held_dense(out, want, want32, dtype, label):
    """A dense form's bf16 output against its plain version on the same cache:
    abs 2e-2 (the bf16 forms' tolerance) for both types, and for f32
    ``F32_GATE`` beyond the output's own rounding: both sides are bf16, so
    where the two f32 results straddle a rounding boundary they part by one
    unit in the last place (7.8e-3 at |out| in [1, 2)) whatever the
    arithmetic, while a form that rounds the cache, or only v, to bf16 leaves
    ~3e-3 beyond it (``f32_control``).  Returns both errors."""
    e = (out.float() - want.float()).abs().max().item()
    check(e <= 2e-2, f"{label}: abs err {e:.3e} > 2e-2")
    check(torch.isfinite(out.float()).all().item(), f"{label}: non-finite output")
    if dtype != torch.float32:
        return e, None
    b = beyond_rounding(out, want32)
    check(b <= F32_GATE, f"{label}: abs err {b:.3e} beyond the bf16 output's rounding "
          f"> {F32_GATE:.0e}")
    return e, b


def f32_control(plain, want32, label) -> float:
    """The f32 gate's control: ``plain`` is the plain version run on the
    cache rounded to bf16 (what a form that rounds the cache would give); it
    must fail ``held_dense``'s gate.  Returns its error beyond the rounding."""
    b = beyond_rounding(plain, want32)
    check(b > F32_GATE, f"{label}: the f32 gate passes the cache rounded to bf16 ({b:.3e})")
    print(f"{label}: control (plain version on the cache rounded to bf16) {b:.2e} beyond the "
          f"bf16 output's rounding, gate {F32_GATE:.0e}: fails it as it must", flush=True)
    return b


def kernels_dense(dev, timer, gen):
    """The fp16 and f32 caches' forms of decode attention with its append (#2),
    the append alone (#4) and prefill attention (#9), linear and paged (pages of
    256 cut from the linear cache), at the bf16 forms' shapes: held to their
    plain versions on the same cache and timed beside SDPA on the rows in the
    cache's type (q cast to it)."""
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        gather_pages,
        kv_append_dense,
        kv_append_dense_reference,
    )
    from xbitops_tpu_torch.kernels.prefill_attention import (
        prefill_attention,
        prefill_attention_reference,
    )
    from xbitops_tpu_torch.utils.synth import cut_pages

    res = {}
    S, D, L, psz = 2048, 128, 2, 256
    P = S // psz
    lens_live = [1, 7, 128, 1000, 2047, 2048, 513]  # + one inactive slot: no page, length S
    B = len(lens_live) + 1
    pos = torch.tensor([n - 1 for n in lens_live] + [S], device=dev)
    lens = torch.clamp(pos + 1, max=S)
    held = torch.where(pos < S, lens, 0)
    act = pos < S
    s_idx = torch.arange(S, device=dev)
    mask = (s_idx[None] < lens[:, None])[:, None, None, :]
    ar = torch.arange(B, device=dev)
    # chunked admission (8 rows of 512, ragged, one inert) and a verify (8 slots of 5)
    N, T = 8, 512
    starts = torch.tensor([0, 512, 1024, 1536, 1024, 0, 512, 0], device=dev)
    plens = torch.tensor([512, 1024, 1536, 2048, 1324, 100, 900, 0], device=dev)
    pslots = torch.tensor([3, 0, 7, 1, 5, 2, 6, N], device=dev)
    ppos = starts[:, None] + torch.arange(T, device=dev)[None]
    ppos = torch.where(ppos < plens[:, None], ppos, S)
    vstart = torch.tensor([3, 100, 1000, 2043, 511, 0, 1500, S], device=dev)  # last: inactive
    vpos = (vstart[:, None] + torch.arange(5, device=dev)[None]).clamp(max=S)
    chunks = {"chunk": (ppos, pslots), "verify": (vpos, ar)}
    controls = res["f32_control"] = {}  # the f32 gate's controls, by form

    for kind, dtype in DENSE.items():
        esz = torch.finfo(dtype).bits // 8
        rate = DENSE_RATE[dtype]
        worst = {}

        def keep(name, errs):
            w = worst.setdefault(name, [0.0, 0.0])
            w[0] = max(w[0], errs[0])
            w[1] = max(w[1], errs[1] or 0.0)

        # --- #2 with its append: MHA (timed) and GQA rep 4 ---
        for H, Hkv in ((32, 32), (32, 8)):
            timed = H == Hkv
            q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
            linear = [torch.randn(L, B, Hkv, S, D, device=dev, generator=gen).to(dtype)
                      for _ in range(2)]
            new = [torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(2)]
            table, pools = cut_pages(gen, linear, P, held)
            for paged in (False, True):
                cache, tbl = (pools, table) if paged else (linear, None)
                sfx = f"_{kind}" + ("_paged" if paged else "")
                name, label = "decode_attention" + sfx, f"decode_attention{sfx}+append H={H} Hkv={Hkv}"
                ref = [t.clone() for t in cache]
                call = (lambda c=cache, t=tbl: decode_attention(
                    q, c[0], c[1], lens, layer_idx=1, kv_new=(*new, pos), page_table=t))
                out, after = fused_once(call, name, "kv_append" + sfx, cache)
                kv_append_dense_reference(*ref, *new, pos, 1, tbl)
                same = all(torch.equal(a, b) for a, b in zip(after, ref))
                del after
                want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, page_table=tbl)
                want32 = decode_attention_reference(q.float(), ref[0][1], ref[1][1], lens,
                                                    page_table=tbl)
                # a paged inactive slot reads page 0, which another slot may be writing
                # in the same launch: its output is not defined
                rows = slice(0, B - 1) if paged else slice(None)
                errs = held_dense(out[rows], want[rows], want32[rows], dtype, label)
                if dtype == torch.float32 and timed and not paged:
                    ctrl = decode_attention_reference(q, ref[0][1].bfloat16(),
                                                      ref[1][1].bfloat16(), lens)
                    controls[name] = f32_control(ctrl, want32, label)
                    del ctrl
                check(same, f"{label}: appended rows differ from the plain append (cast)")
                print(f"{label} B={B} S={S}{' page_size=256' if paged else ''}: rows exact "
                      f"{same}, max abs err {errs[0]:.2e}"
                      + (f", {errs[1]:.2e} beyond the bf16 output's rounding" if errs[1] is not None
                         else ""), flush=True)
                keep(name, errs)
                if not timed:
                    continue
                ms = timer(call)
                plain_ms = timer(lambda c=cache, t=tbl: (
                    kv_append_dense_reference(*c, *new, pos, 1, t),
                    decode_attention_reference(q, c[0][1], c[1][1], lens, page_table=t)), iters=3)
                # yardstick: two index_copy_ of the new rows (cast to the cache's type
                # beforehand) and SDPA on the rows in the cache's type, q cast to it
                qd = q.to(dtype)
                if paged:
                    pg = table[ar, (pos // psz).clamp(max=P - 1)].long()
                    rws = ((pg[:, None] * Hkv + torch.arange(Hkv, device=dev)[None]) * psz
                           + (pos % psz)[:, None])[act].reshape(-1)
                    kd, vd = gather_pages(cache[0][1], table), gather_pages(cache[1][1], table)
                else:
                    rws = ((ar[:, None] * Hkv + torch.arange(Hkv, device=dev)[None]) * S
                           + pos[:, None])[act].reshape(-1)
                    kd, vd = cache[0][1], cache[1][1]
                kf, vf = cache[0][1].view(-1, D), cache[1][1].view(-1, D)
                nk, nv = (t[act].reshape(-1, D).to(dtype) for t in new)
                lib = sdpa(qd[:, :, None], kd, vd, mask)[:, :, 0]
                e_lib = (lib[:-1].float() - want[:-1].float()).abs().max().item()
                check(e_lib <= 2e-2, f"{label}: the library yardstick differs: {e_lib}")
                library_ms = timer(lambda: (kf.index_copy_(0, rws, nk), vf.index_copy_(0, rws, nv),
                                            sdpa(qd[:, :, None], kd, vd, mask)))
                check(all(torch.equal(a, c) for a, c in zip(cache, ref)),
                      f"{label}: the index_copy_ yardstick does not write the op's rows")
                if paged:  # rows moved: the held ones and page 0 (the inactive slot's clamp)
                    owner = (table == 0).nonzero()
                    shared = 0 if not len(owner) else int(
                        (held[owner[0, 0]] - owner[0, 1] * psz).clamp(0, psz))
                    n_moved = int(held.sum()) + psz - shared
                else:
                    n_moved = int(lens.sum())
                b = bound(2 * esz * n_moved * Hkv * D + nbytes(q, out, *new),
                          4 * H * D * int(lens.sum()), rate)
                print(f"{label}: op {ms:.4f} ms, plain {plain_ms:.4f} ms, library (2 index_copy_ "
                      f"+ SDPA in {kind}) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']}", flush=True)
                res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
                del kd, vd, lib

                # --- #4 alone: bf16 rows cast in the kernel; slot 6 has no page at 800 ---
                aname = "kv_append" + sfx
                pos4 = torch.tensor([0, 5, 18, 999, 2046, 2047, 800, S], device=dev)
                ref = [t.clone() for t in cache]
                new4 = [t + 1 for t in new]
                kv_append_dense(*cache, *new4, pos4, 0, tbl)
                kv_append_dense_reference(*ref, *new4, pos4, 0, tbl)
                app_ok = all(torch.equal(a, c) for a, c in zip(cache, ref))
                check(app_ok, f"{aname} differs from its plain version (the cast included)")
                ms = timer(lambda c=cache, t=tbl: kv_append_dense(*c, *new4, pos4, 0, t))
                plain_ms = timer(lambda c=cache, t=tbl: kv_append_dense_reference(
                    *c, *new4, pos4, 0, t))
                if paged:
                    wrote = table[ar, (pos4 // psz).clamp(max=P - 1)]
                    ok = (pos4 < S) & (wrote >= 0)
                    rws = ((wrote.long().clamp(min=0)[:, None] * Hkv
                            + torch.arange(Hkv, device=dev)[None]) * psz
                           + (pos4 % psz)[:, None])[ok].reshape(-1)
                else:
                    ok = pos4 < S
                    rws = ((ar[:, None] * Hkv + torch.arange(Hkv, device=dev)[None]) * S
                           + pos4[:, None])[ok].reshape(-1)
                kf, vf = cache[0][0].view(-1, D), cache[1][0].view(-1, D)
                nk, nv = (t[ok].reshape(-1, D).to(dtype) for t in new4)
                library_ms = timer(lambda: (kf.index_copy_(0, rws, nk), vf.index_copy_(0, rws, nv)))
                check(all(torch.equal(a, c) for a, c in zip(cache, ref)),
                      f"{aname}: the index_copy_ yardstick does not write the op's rows")
                n_rows = int(ok.sum())
                b = bound(2 * n_rows * Hkv * D * (2 + esz) + (nbytes(table) if paged else 0), 0)
                print(f"{aname} B={B} Hkv={Hkv}: exact {app_ok}, op {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library (2 index_copy_ of rows cast beforehand) "
                      f"{library_ms:.4f} ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
                      f"(launch-bound)", flush=True)
                res[aname] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  max_abs_err=worst_diff(cache, ref), **b)
            del linear, pools, ref, new

        # --- #9: the chunk (timed, the row's numbers) and the verify's T = 5 ---
        H = Hkv = 32
        linear = [torch.randn(1, N, Hkv, S, D, device=dev, generator=gen).to(dtype)
                  for _ in range(2)]
        slot_lens = torch.zeros(N, dtype=torch.long, device=dev)
        slot_lens[pslots[:-1]] = plens[:-1]
        slot_lens = torch.maximum(slot_lens, torch.where(vstart < S, vstart + 5, 0))
        table, pools = cut_pages(gen, linear, P, slot_lens.clamp(max=S))
        for which, (cpos, cslots) in chunks.items():
            live = cpos < S
            q = torch.randn(N, cpos.shape[1], H, D, device=dev, generator=gen).to(torch.bfloat16)
            vis = cpos[live] + 1
            flops = 4 * H * D * int(vis.sum())
            rows_read = sum(int(cpos[i][live[i]].max()) + 1 for i in range(N) if live[i].any())
            for paged in (False, True):
                cache, tbl = (pools, table) if paged else (linear, None)
                sfx = f"_{kind}" + ("_paged" if paged else "")
                name = "prefill_attention" + sfx
                label = f"{name} N={N} T={cpos.shape[1]} ({which})"
                call = (lambda c=cache, t=tbl: prefill_attention(
                    q, c[0], c[1], cpos, cslots, layer_idx=0, page_table=t))
                out = call()
                want = prefill_attention_reference(q, cache[0][0], cache[1][0], cpos, cslots,
                                                   page_table=tbl)
                want32 = prefill_attention_reference(q.float(), cache[0][0], cache[1][0], cpos,
                                                     cslots, page_table=tbl)
                errs = held_dense(out, want, want32, dtype, label)
                if dtype == torch.float32 and which == "chunk" and not paged:
                    ctrl = prefill_attention_reference(q, cache[0][0].bfloat16(),
                                                       cache[1][0].bfloat16(), cpos, cslots)
                    controls[name] = f32_control(ctrl, want32, label)
                    del ctrl
                pads = bool((out[~live] == 0).all())
                check(pads, f"{label}: a padding query's output is not exactly 0")
                check(want.float().abs().max().item() > 0.05, "the plain version attended nothing")
                if paged:
                    lin = prefill_attention(q, linear[0], linear[1], cpos, cslots, layer_idx=0)
                    check(torch.equal(out, lin), f"{label}: differs from the linear kernel")
                keep(name, errs)
                ms = timer(call)
                plain_ms = timer(lambda c=cache, t=tbl: prefill_attention_reference(
                    q, c[0][0], c[1][0], cpos, cslots, page_table=t), iters=3)
                rws = cslots.clamp(0, N - 1).long()
                if paged:
                    t2 = table[rws]
                    kd, vd = gather_pages(cache[0][0], t2), gather_pages(cache[1][0], t2)
                else:
                    kd, vd = cache[0][0][rws], cache[1][0][rws]
                m = (s_idx[None, None] <= cpos[:, :, None])[:, None] & live[:, None, :, None]
                qh = q.to(dtype).transpose(1, 2)
                lib = sdpa(qh, kd, vd, m).transpose(1, 2)
                e_lib = (lib[live].float() - want[live].float()).abs().max().item()
                check(e_lib <= 2e-2, f"{label}: the library yardstick differs: {e_lib}")
                library_ms = timer(lambda: sdpa(qh, kd, vd, m))
                del kd, vd, lib, m
                b = bound(2 * esz * rows_read * Hkv * D + nbytes(q, out), flops, rate)
                print(f"{label}: max abs err {errs[0]:.2e}"
                      + (f" ({errs[1]:.2e} beyond the output's rounding)" if errs[1] is not None
                         else "")
                      + f", padding exactly 0 {pads}; op {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                      f"TFLOP/s of the function), plain {plain_ms:.4f} ms, library (SDPA in "
                      f"{kind}) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']}", flush=True)
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
                if which == "chunk":
                    res[name] = row
                else:
                    res[name + "_verify"] = row
        del linear, pools
        for name, (e, b) in worst.items():
            res[name]["max_abs_err"] = e
            if dtype == torch.float32:
                res[name]["max_abs_err_beyond_rounding"] = b
        torch.cuda.empty_cache()
    return res


def kernels_pp_view(dev, timer, gen):
    """Decode attention with its append on a PP decode microbatch: slots 4-7
    of an 8-slot cache as the view ``k[:, 4:8]`` that ``parallel/pp.py`` hands
    a stage's blocks (B=4, H=Hkv=32, S=2048, ragged lengths, one slot at S),
    bf16 and int8, against the plain version on the same view, the other
    slots' bytes untouched; beside SDPA."""
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        _unpack_kv_words,
        kv_append_dense_reference,
        kv_append_packed_reference,
    )

    S, D, H, B, lo = 2048, 128, 32, 4, 4
    pos = torch.tensor([999, 6, 2046, S], device=dev)  # the last slot at S: inactive
    lens = torch.clamp(pos + 1, max=S)
    act = pos < S
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None, :]
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    live_rows = int(lens.sum()) * H * D
    res = {}
    for int8 in (False, True):
        if int8:
            whole = list(packed_cache(gen, 2, 2 * B, H, S, D))
            new = tuple(torch.randint(1, 256, (B, H, D), generator=gen, device=dev,
                                      dtype=torch.int32) for _ in range(2)) + tuple(
                torch.empty((B, H), device=dev).uniform_(0.005, 0.02, generator=gen)
                for _ in range(2)) + (pos,)
            name, append, reference = "decode_attention_int8", "kv_append_packed", \
                kv_append_packed_reference
        else:
            whole = [torch.randn(2, 2 * B, H, S, D, device=dev, generator=gen).to(torch.bfloat16)
                     for _ in range(2)]
            new = tuple(torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
                        for _ in range(2)) + (pos,)
            name, append, reference = "decode_attention", "kv_append", kv_append_dense_reference
        view = [t[:, lo:lo + B] for t in whole]
        scales = dict(k_scale=view[2], v_scale=view[3]) if int8 else {}
        call = lambda: decode_attention(q, view[0], view[1], lens, layer_idx=1, kv_new=new,
                                        **scales)
        ref_whole = [t.clone() for t in whole]
        out, after = fused_once(call, name, append, whole)
        ref_view = [t[:, lo:lo + B] for t in ref_whole]
        reference(*ref_view, *new, 1)
        ref = decode_attention_reference(q, ref_view[0][1], ref_view[1][1], lens, None,
                                         *([ref_view[2][1], ref_view[3][1]] if int8 else []))
        same = all(torch.equal(a, b) for a, b in zip(after, ref_whole))
        e = (out.float() - ref.float()).abs().max().item()
        check(same and e <= 2e-2, f"{name} on a slot-range view: bytes exact {same}, err {e:.3e}")
        del after, ref_whole
        ms = timer(call)
        plain_ms = timer(lambda: (reference(*view, *new, 1), decode_attention_reference(
            q, view[0][1], view[1][1], lens, None,
            *([view[2][1], view[3][1]] if int8 else []))), iters=3)
        if int8:  # SDPA on the rows as bf16: no PyTorch call writes a byte of a packed word
            kd = _unpack_kv_words(view[0][1], view[2][1]).to(torch.bfloat16)
            vd = _unpack_kv_words(view[1][1], view[3][1]).to(torch.bfloat16)
            library_ms = timer(lambda: sdpa(q[:, :, None], kd, vd, mask))
            del kd, vd
            b = bound(2 * (live_rows + 2 * int(lens.sum()) * H) + nbytes(q, out, *new[:2]),
                      4 * H * D * int(lens.sum()))
        else:  # 2 index_copy_ of the new rows and SDPA, like for like
            rows = ((torch.arange(B, device=dev)[:, None] * H
                     + torch.arange(H, device=dev)[None]) * S + pos[:, None])[act].reshape(-1)
            k1, v1 = view[0][1], view[1][1]  # one layer of the view: contiguous
            kf, vf = k1.view(-1, D), v1.view(-1, D)
            kr, vr = new[0][act].reshape(-1, D), new[1][act].reshape(-1, D)
            library_ms = timer(lambda: (kf.index_copy_(0, rows, kr), vf.index_copy_(0, rows, vr),
                                        sdpa(q[:, :, None], k1, v1, mask)))
            b = bound(2 * 2 * live_rows + nbytes(q, out, *new[:2]), 4 * H * D * int(lens.sum()))
        print(f"{name}+append on a PP microbatch's view k[:, 4:8] of an 8-slot cache, B={B} "
              f"H=Hkv={H} S={S}: op {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"({'SDPA on bf16 rows, no append' if int8 else '2 index_copy_ + SDPA'}) "
              f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}; bytes "
              f"exact (the other slots untouched), max abs err {e:.2e}", flush=True)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=e, **b)
        del whole, view
    return res


def kernels_prefill(dev, timer, gen):
    """Chunked-prefill attention at the 7B shapes: 8 rows of 512 queries with
    ragged starts, a prompt that ends mid-chunk and an inert row."""
    from xbitops_tpu_torch.kernels.kv_append import _unpack_kv_words
    from xbitops_tpu_torch.kernels.prefill_attention import (
        prefill_attention,
        prefill_attention_reference,
    )

    S, D, H, N, T, B = 2048, 128, 32, 8, 512, 8
    starts = torch.tensor([0, 512, 1024, 1536, 1024, 0, 512, 0], device=dev)
    lens = torch.tensor([512, 1024, 1536, 2048, 1324, 100, 900, 0], device=dev)  # last: inert
    slots = torch.tensor([3, 0, 7, 1, 5, 2, 6, B], device=dev)
    pos = starts[:, None] + torch.arange(T, device=dev)[None]
    pos = torch.where(pos < lens[:, None], pos, S)
    live = pos < S
    s_idx = torch.arange(S, device=dev)
    res, worst = {}, 0.0
    for Hkv, window in ((32, None), (8, None), (32, 512)):
        timed = Hkv == H and window is None
        q = torch.randn(N, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
        visible = pos[live] + 1 if window is None else torch.clamp(pos[live] + 1, max=window)
        flops = 4 * H * D * int(visible.sum())
        lo = torch.zeros_like(lens) if window is None else (starts - (window - 1)).clamp(min=0)
        rows_read = int((torch.minimum(lens, starts + T) - lo).clamp(min=0).sum()) * Hkv * D
        for int8 in (False, True):
            if int8:
                k, v, ks, vs = (t[0] for t in packed_cache(gen, 1, B, Hkv, S, D))
                scales = dict(k_scale=ks, v_scale=vs)
                cache_bytes = 2 * rows_read + 2 * 2 * rows_read // D
            else:
                k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                        for _ in range(2))
                scales = {}
                cache_bytes = 2 * 2 * rows_read
            out = prefill_attention(q, k, v, pos, slots, window=window, **scales)
            ref = prefill_attention_reference(q, k, v, pos, slots, window=window, **scales)
            e = (out.float() - ref.float()).abs().max().item()
            pads_zero = bool((out[~live] == 0).all())
            name = "int8" if int8 else "bf16"
            print(f"prefill_attention {name} N={N} T={T} H={H} Hkv={Hkv} S={S} window={window}: "
                  f"max abs err {e:.2e}, padding queries exactly 0: {pads_zero}", flush=True)
            check(e <= 2e-2, f"prefill attention ({name}) abs err {e:.3e} > 2e-2")
            check(pads_zero, "a padding query's output is not exactly 0")
            check(ref.float().abs().max().item() > 0.05, "the plain version attended nothing")
            worst = max(worst, e)
            if timed:
                ms = timer(lambda: prefill_attention(q, k, v, pos, slots, **scales))
                plain_ms = timer(lambda: prefill_attention_reference(q, k, v, pos, slots,
                                                                     **scales), iters=3)
                # yardstick: one attention call on the slots' bf16 rows, masked by position
                rows = slots.clamp(0, B - 1)
                if int8:
                    kd = _unpack_kv_words(k[rows], ks[rows]).to(torch.bfloat16)
                    vd = _unpack_kv_words(v[rows], vs[rows]).to(torch.bfloat16)
                else:
                    kd, vd = k[rows], v[rows]
                mask = (s_idx[None, None] <= pos[:, :, None])[:, None] & live[:, None, :, None]
                qh = q.transpose(1, 2)
                lib = sdpa(qh, kd, vd, mask).transpose(1, 2)
                e_lib = (lib[live].float() - ref[live].float()).abs().max().item()
                check(e_lib <= 2e-2, f"the library yardstick differs from the plain one: {e_lib}")
                library_ms = timer(lambda: sdpa(qh, kd, vd, mask))
                del kd, vd, mask, lib
                b = bound(cache_bytes + nbytes(q, out), flops)
                print(f"prefill_attention {name} MHA: op {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                      f"TFLOP/s of {flops / 1e9:.1f} GFLOP), plain {plain_ms:.4f} ms, library "
                      f"(on bf16 rows) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']}", flush=True)
                res["prefill_attention_" + name] = dict(ms=ms, plain_ms=plain_ms,
                                                        library_ms=library_ms, **b)
            del k, v, out, ref
    # the long-context serving path runs the int8 form
    res["prefill_attention"] = dict(res["prefill_attention_int8"], max_abs_err=worst)
    return res


def mixtral_mats(gen):
    """Mixtral-8x7B's matmul weights, name -> (QTensor, note): q|k|v
    (4096x6144), wo (4096x4096) and, through a ``layer(e)`` view of a stacked
    QTensor of 8 experts (a storage offset), expert gate|up (4096x28672) and
    expert down (14336x4096, 112 groups)."""
    from xbitops_tpu_torch.models.moe import stack_experts
    from xbitops_tpu_torch.utils import synth

    for name, (K, N, experts) in {"wqkv": (4096, 6144, 0), "wo": (4096, 4096, 0),
                                  "expert_gateup": (4096, 28672, 8),
                                  "expert_down": (14336, 4096, 8)}.items():
        if experts:
            qt = stack_experts([synth.random_qtensor(gen, K, N, 4, 128)
                                for _ in range(experts)]).layer(5)
            check(qt.planes[0].storage_offset() > 0, f"{name}: the expert view has no offset")
            yield name, qt, ", expert view"
        else:
            yield name, synth.random_qtensor(gen, K, N, 4, 128), ""


def tp_shard_mats(gen):
    """One rank's shards of Llama-2-7B at tp=2 (4-bit, g=128), as
    ``parallel.model_tp.shard_params`` gives them: the column shards of q|k|v
    (4096x6144), gate|up (4096x11008) and lm_head (4096x16000), and the row
    shards of wo (2048x4096) and w_down (5504x4096: g'=128, 43 groups, the
    shard padded to its own tile), repacked from the whole weight
    (``formats.row_shard_qtensor``).  Rank 1's shard."""
    from xbitops_tpu_torch import formats
    from xbitops_tpu_torch.parallel import tp
    from xbitops_tpu_torch.parallel.mesh import Mesh
    from xbitops_tpu_torch.utils import synth

    mesh = Mesh(("model",), (2,), (1,), (None,))  # a shard, without its collectives
    for name, K, N, kind in (("wqkv", 4096, 12288, "col"), ("wo", 4096, 4096, "row"),
                             ("w_gateup", 4096, 22016, "col"), ("w_down", 11008, 4096, "row"),
                             ("lm_head", 4096, 32000, "col")):
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        if kind == "row":
            yield name, tp.local_qtensor(formats.row_shard_qtensor(qt, 2), mesh,
                                         row_axis="model"), ", row shard"
        else:
            yield name, tp.local_qtensor(qt, mesh, col_axis="model"), ", column shard"


def kernels_at(dev, timer, gen, label, mats, Ms, H, Hkv):
    """Phase 1 at a model's shapes: the fused matmul at each M of ``Ms`` (8: a
    decode step of 8 slots, the few-rows form; 40: a γ=4 verify and 2560: a
    chunk forward of 5 x 512, both the tile) on each of ``mats`` (name,
    QTensor, note); decode attention with its append and prefill attention at
    ``H`` query and ``Hkv`` kv heads, D=128, S=2048, 8 slots, bf16 and int8,
    beside SDPA."""
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        _unpack_kv_words,
        kv_append_dense_reference,
        kv_append_packed_reference,
    )
    from xbitops_tpu_torch.kernels.prefill_attention import (
        prefill_attention,
        prefill_attention_reference,
    )
    from xbitops_tpu_torch.kernels.qgemv_kernel import qgemv_form
    from xbitops_tpu_torch.ops.qmatmul import qmatmul

    res = {}
    for name, qt, note in mats:
        K, N = qt.shape
        for M in Ms:
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            form = qgemv_form(M, False, qt)
            kname = "qgemv" if M == 8 else "qgemv_mma"
            common.reset_counts()
            got = qmatmul(a, qt)
            check({k: n for k, n in common.launches.items() if n} == {kname: 1}
                  and form == ("gemv" if M == 8 else "mma")
                  and not any(common.plain_on_cuda.values()),
                  f"{label} {name} M={M}: {form}, launches {dict(common.launches)}")
            ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
            e, e_abs = rel_err(got, ref), (got.float() - ref).abs().max().item()
            check(e <= 2e-2, f"{label} {name} M={M}: rel err {e:.3e} > 2e-2")
            del got, ref
            ms = timer(lambda: qmatmul(a, qt))
            plain_ms = timer(lambda: qmatmul(a, qt, use_kernel=False), iters=2)
            b = bound(qt.bytes_packed() + nbytes(a) + 2 * M * N, 2 * M * K * N)
            print(f"{label} qmatmul 4-bit {name} K={K} (packed {qt.K}, g={qt.group_size}) N={N} "
                  f"M={M} ({form}{note}): op {ms:.4f} ms "
                  f"({qt.bytes_packed() / ms / 1e6:.1f} GB/s packed stream, "
                  f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.1%} of the "
                  f"bound), plain {plain_ms:.4f} ms, rel err {e:.2e}, max abs err {e_abs:.2e}; "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}; library: none exists",
                  flush=True)
            res[f"qgemv_{name}" + ("" if M == 8 else f"_M{M}")] = dict(
                kernel=kname, ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=e_abs, **b)
            del a
        del qt

    # decode attention with its append, ragged: 7 live slots and one at S
    S, D = 2048, 128
    lens_live = [1, 7, 128, 1000, 2047, 2048, 513]
    B = len(lens_live) + 1
    pos = torch.tensor([n - 1 for n in lens_live] + [S], device=dev)
    lens = torch.clamp(pos + 1, max=S)
    s_idx = torch.arange(S, device=dev)
    mask = (s_idx[None] < lens[:, None])[:, None, None, :]
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    live_rows = int(lens.sum()) * Hkv * D
    act = pos < S
    rows = ((torch.arange(B, device=dev)[:, None] * Hkv
             + torch.arange(Hkv, device=dev)[None]) * S + pos[:, None])[act].reshape(-1)
    k = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
    kn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    vn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
    k_ref, v_ref = k.clone(), v.clone()
    out, after = fused_once(lambda: decode_attention(q, k, v, lens, layer_idx=1,
                                                     kv_new=(kn, vn, pos)),
                            "decode_attention", "kv_append", (k, v))
    kv_append_dense_reference(k_ref, v_ref, kn, vn, pos, 1)
    ref = decode_attention_reference(q, k_ref[1], v_ref[1], lens)
    same = all(torch.equal(x, y) for x, y in zip(after, (k_ref, v_ref)))
    e = (out.float() - ref.float()).abs().max().item()
    check(same and e <= 2e-2, f"{label} decode attention bf16: rows exact {same}, err {e:.3e}")
    e_lib = (sdpa(q[:, :, None], k_ref[1], v_ref[1], mask)[:-1, :, 0].float()
             - ref[:-1].float()).abs().max().item()
    check(e_lib <= 2e-2, f"Mixtral: the SDPA yardstick differs from the plain one: {e_lib}")
    del after
    ms = timer(lambda: decode_attention(q, k, v, lens, layer_idx=1, kv_new=(kn, vn, pos)))
    plain_ms = timer(lambda: (kv_append_dense_reference(k, v, kn, vn, pos, 1),
                              decode_attention_reference(q, k[1], v[1], lens)), iters=3)
    kf1, vf1 = k[1].view(-1, D), v[1].view(-1, D)
    kr1, vr1 = kn[act].reshape(-1, D), vn[act].reshape(-1, D)
    library_ms = timer(lambda: (kf1.index_copy_(0, rows, kr1), vf1.index_copy_(0, rows, vr1),
                                sdpa(q[:, :, None], k[1], v[1], mask)))
    b = bound(2 * 2 * live_rows + nbytes(q, out, kn, vn), 4 * H * D * int(lens.sum()))
    print(f"{label} decode_attention+append bf16 B={B} H={H} Hkv={Hkv} (rep {H // Hkv}) S={S}: op "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (2 index_copy_ + SDPA, GQA) "
          f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}; rows exact, "
          f"max abs err {e:.2e}", flush=True)
    res["decode_attention_bf16"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                        max_abs_err=e, **b)
    del k, v, k_ref, v_ref
    cache = packed_cache(gen, 2, B, Hkv, S, D)
    kq, vq = (torch.randint(1, 256, (B, Hkv, D), generator=gen, device=dev, dtype=torch.int32)
              for _ in range(2))
    ksn, vsn = (torch.empty((B, Hkv), device=dev).uniform_(0.005, 0.02, generator=gen)
                for _ in range(2))
    new = (kq, vq, ksn, vsn, pos)
    ref_cache = [t.clone() for t in cache]
    out, after = fused_once(lambda: decode_attention(
        q, cache[0], cache[1], lens, layer_idx=1, k_scale=cache[2], v_scale=cache[3],
        kv_new=new), "decode_attention_int8", "kv_append_packed", cache)
    kv_append_packed_reference(*ref_cache, *new, 1)
    ref = decode_attention_reference(q, ref_cache[0][1], ref_cache[1][1], lens, None,
                                     ref_cache[2][1], ref_cache[3][1])
    same = all(torch.equal(x, y) for x, y in zip(after, ref_cache))
    e = (out.float() - ref.float()).abs().max().item()
    check(same and e <= 2e-2, f"{label} decode attention int8: words exact {same}, err {e:.3e}")
    del after, ref_cache
    k8, v8, ks8, vs8 = cache
    ms = timer(lambda: decode_attention(q, k8, v8, lens, layer_idx=1, k_scale=ks8, v_scale=vs8,
                                        kv_new=new))
    plain_ms = timer(lambda: (kv_append_packed_reference(k8, v8, ks8, vs8, *new, 1),
                              decode_attention_reference(q, k8[1], v8[1], lens, None, ks8[1],
                                                         vs8[1])), iters=3)
    kd = _unpack_kv_words(k8[1], ks8[1]).to(torch.bfloat16)
    vd = _unpack_kv_words(v8[1], vs8[1]).to(torch.bfloat16)
    library_ms = timer(lambda: sdpa(q[:, :, None], kd, vd, mask))
    del kd, vd
    b = bound(2 * (live_rows + 2 * int(lens.sum()) * Hkv) + nbytes(q, out, kq, vq),
              4 * H * D * int(lens.sum()))
    print(f"{label} decode_attention+append int8 B={B} H={H} Hkv={Hkv} S={S}: op {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (SDPA on bf16 rows, no append) {library_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}; words exact, max abs err {e:.2e}",
          flush=True)
    res["decode_attention_int8"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                        max_abs_err=e, **b)
    del cache, k8, v8, ks8, vs8

    # prefill attention: 8 rows of 512 queries, ragged starts, one inert row
    N, T = 8, 512
    starts = torch.tensor([0, 512, 1024, 1536, 1024, 0, 512, 0], device=dev)
    plens = torch.tensor([512, 1024, 1536, 2048, 1324, 100, 900, 0], device=dev)
    slots = torch.tensor([3, 0, 7, 1, 5, 2, 6, B], device=dev)
    ppos = starts[:, None] + torch.arange(T, device=dev)[None]
    ppos = torch.where(ppos < plens[:, None], ppos, S)
    live = ppos < S
    flops = 4 * H * D * int((ppos[live] + 1).sum())
    rows_read = int((torch.minimum(plens, starts + T)).clamp(min=0).sum()) * Hkv * D
    pq = torch.randn(N, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    pmask = (s_idx[None, None] <= ppos[:, :, None])[:, None] & live[:, None, :, None]
    qh = pq.transpose(1, 2)
    srows = slots.clamp(0, B - 1)
    for int8 in (False, True):
        if int8:
            k, v, ks, vs = (t[0] for t in packed_cache(gen, 1, B, Hkv, S, D))
            scales = dict(k_scale=ks, v_scale=vs)
            kd = _unpack_kv_words(k[srows], ks[srows]).to(torch.bfloat16)
            vd = _unpack_kv_words(v[srows], vs[srows]).to(torch.bfloat16)
            cache_bytes = 2 * rows_read + 2 * 2 * rows_read // D
        else:
            k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                    for _ in range(2))
            scales = {}
            kd, vd = k[srows], v[srows]
            cache_bytes = 2 * 2 * rows_read
        out = prefill_attention(pq, k, v, ppos, slots, **scales)
        ref = prefill_attention_reference(pq, k, v, ppos, slots, **scales)
        e = (out.float() - ref.float()).abs().max().item()
        check(e <= 2e-2 and bool((out[~live] == 0).all()),
              f"{label} prefill attention ({'int8' if int8 else 'bf16'}): err {e:.3e}")
        e_lib = (sdpa(qh, kd, vd, pmask).transpose(1, 2)[live].float()
                 - ref[live].float()).abs().max().item()
        check(e_lib <= 2e-2, f"Mixtral: the SDPA yardstick differs from the plain one: {e_lib}")
        ms = timer(lambda: prefill_attention(pq, k, v, ppos, slots, **scales))
        plain_ms = timer(lambda: prefill_attention_reference(pq, k, v, ppos, slots, **scales),
                         iters=2)
        library_ms = timer(lambda: sdpa(qh, kd, vd, pmask))
        b = bound(cache_bytes + nbytes(pq, out), flops)
        name = "int8" if int8 else "bf16"
        print(f"{label} prefill_attention {name} N={N} T={T} H={H} Hkv={Hkv} S={S}: op {ms:.4f} "
              f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library (SDPA on "
              f"bf16 rows) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
              f"max abs err {e:.2e}", flush=True)
        res["prefill_attention_" + name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=e, **b)
        del k, v, kd, vd, out, ref
    return res


def kernels_paged(dev, timer, gen):
    """The paged forms of decode attention, prefill attention and the two
    appends against their plain versions and against the linear kernels on the
    cache the pools were cut from: at the serving shape (pages of 256, timed)
    and at pages of 16 with GQA, a window, -1 entries and an inactive slot."""
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        _unpack_kv_words,
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
    from xbitops_tpu_torch.utils.synth import cut_pages

    res = {}
    S, D, L = 2048, 128, 2
    lens_live = [1, 7, 128, 1000, 2047, 2048, 513]  # + one inactive slot: no page, length S
    B = len(lens_live) + 1
    pos = torch.tensor([n - 1 for n in lens_live] + [S], device=dev)
    lens = torch.clamp(pos + 1, max=S)
    held = torch.where(pos < S, lens, 0)  # positions a slot holds pages for
    s_idx = torch.arange(S, device=dev)
    worst = dict.fromkeys(("decode_attention_paged", "decode_attention_int8_paged"), 0.0)

    def linear_cache(Hkv, int8, batch=B):
        if int8:
            return list(packed_cache(gen, L, batch, Hkv, S, D))
        return [torch.randn(L, batch, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2)]

    def scales_of(t, li=None):
        if len(t) != 4:
            return {}
        return dict(k_scale=t[2] if li is None else t[2][li],
                    v_scale=t[3] if li is None else t[3][li])

    # --- decode attention with the append through the table, and the appends alone ---
    for H, Hkv, psz, window in ((32, 32, 256, None), (32, 8, 16, None), (32, 32, 16, 512)):
        timed = psz == 256
        P = S // psz
        q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
        mask = (s_idx[None] < lens[:, None])[:, None, None, :]
        if window is not None:
            mask = mask & (s_idx[None] >= (lens - window).clamp(min=0)[:, None])[:, None, None, :]
        n_attended = int(lens.sum())  # the inactive slot attends S positions too
        for int8 in (False, True):
            name = "decode_attention_int8_paged" if int8 else "decode_attention_paged"
            append, append_plain = ((kv_append_packed, kv_append_packed_reference) if int8
                                    else (kv_append_dense, kv_append_dense_reference))
            linear = linear_cache(Hkv, int8)
            table, pools = cut_pages(gen, linear, P, held)
            check(bool((table[-1] == -1).all() and (table[0, 1:] == -1).all()),
                  "the table should hold -1 entries")
            if int8:
                new = [torch.randint(1, 256, (B, Hkv, D), generator=gen, device=dev,
                                     dtype=torch.int32) for _ in range(2)]
                new += [torch.empty((B, Hkv), device=dev).uniform_(0.005, 0.02, generator=gen)
                        for _ in range(2)]
            else:
                new = [torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
                       for _ in range(2)]
            ref = [t.clone() for t in pools]
            out, after = fused_once(lambda: decode_attention(
                q, pools[0], pools[1], lens, layer_idx=1, kv_new=(*new, pos), window=window,
                page_table=table, **scales_of(pools)), name,
                "kv_append_packed_paged" if int8 else "kv_append_paged", pools)
            append_plain(*ref, *new, pos, 1, table)
            want = decode_attention_reference(q, ref[0][1], ref[1][1], lens, window,
                                              *(t[1] for t in ref[2:]), page_table=table)
            same = all(torch.equal(a, b) for a, b in zip(after, ref))
            del after
            # the inactive slot (last) reads page 0, which another slot may be
            # writing in the same launch: its output is not defined
            e = (out[:-1].float() - want[:-1].float()).abs().max().item()
            lin, *_ = decode_attention(q, linear[0], linear[1], lens, layer_idx=1,
                                       kv_new=(*new, pos), window=window, **scales_of(linear))
            e_lin = (out[:-1].float() - lin[:-1].float()).abs().max().item()
            print(f"{name}+append B={B} H={H} Hkv={Hkv} S={S} page_size={psz} window={window}: "
                  f"pools exact {same}, max abs err {e:.2e} vs plain, {e_lin:.2e} vs the linear "
                  f"kernel", flush=True)
            check(same, f"{name}: appended pools differ from the plain paged append")
            check(e <= 2e-2, f"{name} abs err {e:.3e} > 2e-2")
            check(e_lin <= 2e-2, f"{name} differs from the linear kernel by {e_lin:.3e}")
            check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite output")
            worst[name] = max(worst[name], e)
            if not timed:
                del linear, pools, ref
                continue
            kw = scales_of(pools)
            ms = timer(lambda: decode_attention(q, pools[0], pools[1], lens, layer_idx=1,
                                                kv_new=(*new, pos), page_table=table, **kw))
            plain_ms = timer(lambda: (
                append_plain(*pools, *new, pos, 1, table),
                decode_attention_reference(q, pools[0][1], pools[1][1], lens, None,
                                           *(t[1] for t in pools[2:]), page_table=table)),
                iters=3)
            lin_ms = timer(lambda: decode_attention(q, linear[0], linear[1], lens, layer_idx=1,
                                                    kv_new=(*new, pos), **scales_of(linear)))
            # yardstick: one attention call on the slots' rows, gathered (and for int8
            # dequantized to bf16) beforehand: the gather is not in its time
            kd, vd = gather_pages(pools[0][1], table), gather_pages(pools[1][1], table)
            if int8:
                kd = _unpack_kv_words(kd, gather_pages(pools[2][1], table, scales=True))
                vd = _unpack_kv_words(vd, gather_pages(pools[3][1], table, scales=True))
                kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
            lib = sdpa(q[:, :, None], kd, vd, mask)[:, :, 0]
            e_lib = (lib[:-1].float() - want[:-1].float()).abs().max().item()
            check(e_lib <= 2e-2, f"the library yardstick differs from the plain one: {e_lib}")
            if int8:  # no PyTorch call writes a byte of a packed word: no append on this side
                library_ms = timer(lambda: sdpa(q[:, :, None], kd, vd, mask))
                lib_what = "SDPA on gathered bf16 rows, no append"
            else:
                # like for like: the op appends through the table, so two index_copy_ of
                # the new rows into the pool (row numbers found beforehand), then SDPA
                act = pos < S
                pg = table[torch.arange(B, device=dev), (pos // psz).clamp(max=P - 1)].long()
                prow = ((pg[:, None] * Hkv + torch.arange(Hkv, device=dev)[None]) * psz
                        + (pos % psz)[:, None])[act].reshape(-1)
                kp1, vp1 = pools[0][1].view(-1, D), pools[1][1].view(-1, D)
                nk, nv = new[0][act].reshape(-1, D), new[1][act].reshape(-1, D)
                library_ms = timer(lambda: (kp1.index_copy_(0, prow, nk),
                                            vp1.index_copy_(0, prow, nv),
                                            sdpa(q[:, :, None], kd, vd, mask)))
                check(all(torch.equal(a, c) for a, c in zip(pools, ref)),
                      "the index_copy_ yardstick does not write the rows the op writes")
                lib_what = "2 index_copy_ + SDPA on gathered bf16 rows"
            del kd, vd, lib
            # Rows moved once: those the slots hold, and pool page 0, which every
            # entry of the inactive slot's row of -1 clamps to (less the rows of
            # page 0 that a slot holds and so reads anyway).
            owner = (table == 0).nonzero()
            shared = 0 if not len(owner) else int(
                (held[owner[0, 0]] - owner[0, 1] * psz).clamp(0, psz))
            n_moved = int(held.sum()) + psz - shared
            row_bytes = (D + 2) if int8 else 2 * D  # a position of one head: k or v
            b = bound(2 * row_bytes * n_moved * Hkv + nbytes(q, out, table, *new[:2]),
                      4 * H * D * n_attended)
            print(f"{name}+append MHA page_size={psz}: op {ms:.4f} ms (the linear op here "
                  f"{lin_ms:.4f} ms), plain {plain_ms:.4f} ms, library ({lib_what}) "
                  f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
                  f"({n_moved} distinct rows a head moved, {n_attended} attended)", flush=True)
            res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, linear_ms=lin_ms,
                             **b)

            # the append alone: positions in four different pages and bytes, one slot with
            # no page for its position, one past the capacity
            aname = "kv_append_packed_paged" if int8 else "kv_append_paged"
            pos4 = torch.tensor([0, 5, 18, 999, 2046, 2047, 800, S], device=dev)
            ref = [t.clone() for t in pools]
            before = [t[0].clone() for t in pools]
            append(*pools, *new, pos4, 0, table)
            append_plain(*ref, *new, pos4, 0, table)
            app_err = worst_diff(pools, ref)
            app_ok = all(torch.equal(a, c) for a, c in zip(pools, ref))
            check(app_ok, f"{aname} differs from its plain version")
            wrote = [int(table[i, int(pos4[i]) // psz]) for i in range(B - 1)]
            check(wrote[-1] == -1 and min(wrote[:-1]) >= 0, "slot 6 should have no page at 800")
            keep = torch.ones(pools[0].shape[1], dtype=torch.bool, device=dev)
            keep[wrote[:-1]] = False
            check(all(torch.equal(t[0][keep], old[keep]) for t, old in zip(pools, before))
                  and not torch.equal(pools[0][0][~keep], before[0][~keep]),
                  f"{aname} wrote outside the six pages of the six slots that hold one")
            ms = timer(lambda: append(*pools, *new, pos4, 0, table))
            plain_ms = timer(lambda: append_plain(*pools, *new, pos4, 0, table))
            library_ms = None  # no single PyTorch call rewrites one byte of a word
            n_rows = B - 2
            if int8:
                b = bound(2 * (2 * 4 + 4) * n_rows * Hkv * D + 2 * 2 * 2 * n_rows * Hkv
                          + nbytes(table), 0)
            else:
                # yardstick: index_copy_ of the new rows, once for k and once for v, at
                # row numbers of the flattened pool found through the table beforehand
                act = torch.tensor([w >= 0 for w in wrote] + [False], device=dev)
                pages = torch.tensor([max(w, 0) for w in wrote] + [0], device=dev)
                rows = ((pages[:, None] * Hkv + torch.arange(Hkv, device=dev)[None]) * psz
                        + (pos4 % psz)[:, None])[act].reshape(-1)
                kf, vf = pools[0][0].view(-1, D), pools[1][0].view(-1, D)
                kr, vr = new[0][act].reshape(-1, D), new[1][act].reshape(-1, D)
                library_ms = timer(lambda: (kf.index_copy_(0, rows, kr),
                                            vf.index_copy_(0, rows, vr)))
                check(all(torch.equal(a, c) for a, c in zip(pools, ref)),
                      "the index_copy_ yardstick does not compute the same function")
                b = bound(2 * 2 * n_rows * Hkv * D * 2 + nbytes(table), 0)
            print(f"{aname} B={B} Hkv={Hkv} page_size={psz}: exact {app_ok}, op {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {library_ms}, bound {b['bound_ms']:.5f} ms "
                  f"by {b['bound_by']} (launch-bound)", flush=True)
            res[aname] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              max_abs_err=app_err, **b)
            del linear, pools, ref, before
    for name, e in worst.items():
        res[name]["max_abs_err"] = e

    # --- prefill attention: the chunk shapes of the linear case, behind a table ---
    N, T, H = 8, 512, 32
    starts = torch.tensor([0, 512, 1024, 1536, 1024, 0, 512, 0], device=dev)
    plens = torch.tensor([512, 1024, 1536, 2048, 1324, 100, 900, 0], device=dev)  # last: inert
    slots = torch.tensor([3, 0, 7, 1, 5, 2, 6, N], device=dev)
    ppos = starts[:, None] + torch.arange(T, device=dev)[None]
    ppos = torch.where(ppos < plens[:, None], ppos, S)
    live = ppos < S
    slot_lens = torch.zeros(N, dtype=torch.long, device=dev)
    slot_lens[slots[:-1]] = plens[:-1]
    worst_pf = 0.0
    for Hkv, psz, window in ((32, 256, None), (8, 16, None), (32, 16, 512)):
        timed = psz == 256
        q = torch.randn(N, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
        visible = ppos[live] + 1 if window is None else torch.clamp(ppos[live] + 1, max=window)
        flops = 4 * H * D * int(visible.sum())
        lo = torch.zeros_like(plens) if window is None else (starts - (window - 1)).clamp(min=0)
        rows_read = int((torch.minimum(plens, starts + T) - lo).clamp(min=0).sum()) * Hkv * D
        for int8 in (False, True):
            linear = linear_cache(Hkv, int8, batch=N)
            table, pools = cut_pages(gen, linear, S // psz, slot_lens)
            out = prefill_attention(q, pools[0], pools[1], ppos, slots, layer_idx=1,
                                    window=window, page_table=table, **scales_of(pools))
            want = prefill_attention_reference(q, pools[0][1], pools[1][1], ppos, slots,
                                               window=window, page_table=table,
                                               **scales_of(pools, 1))
            lin = prefill_attention(q, linear[0], linear[1], ppos, slots, layer_idx=1,
                                    window=window, **scales_of(linear))
            e = (out.float() - want.float()).abs().max().item()
            kind = "int8" if int8 else "bf16"
            print(f"prefill_attention_paged {kind} N={N} T={T} H={H} Hkv={Hkv} page_size={psz} "
                  f"window={window}: max abs err {e:.2e}, padding queries exactly 0: "
                  f"{bool((out[~live] == 0).all())}, equal to the linear kernel: "
                  f"{torch.equal(out, lin)}", flush=True)
            check(e <= 2e-2, f"paged prefill attention ({kind}) abs err {e:.3e} > 2e-2")
            check(bool((out[~live] == 0).all()), "a padding query's output is not exactly 0")
            check(want.float().abs().max().item() > 0.05, "the plain version attended nothing")
            check(torch.equal(out, lin), "paged prefill attention differs from the linear kernel")
            worst_pf = max(worst_pf, e)
            if timed:
                kw, lkw = scales_of(pools), scales_of(linear)
                ms = timer(lambda: prefill_attention(q, pools[0], pools[1], ppos, slots,
                                                     layer_idx=1, page_table=table, **kw))
                lin_ms = timer(lambda: prefill_attention(q, linear[0], linear[1], ppos, slots,
                                                         layer_idx=1, **lkw))
                plain_ms = timer(lambda: prefill_attention_reference(
                    q, pools[0][1], pools[1][1], ppos, slots, page_table=table,
                    **scales_of(pools, 1)), iters=3)
                # yardstick: one attention call on the rows' gathered pages as bf16
                tbl = table[slots.clamp(0, N - 1).long()]
                kd, vd = gather_pages(pools[0][1], tbl), gather_pages(pools[1][1], tbl)
                if int8:
                    kd = _unpack_kv_words(kd, gather_pages(pools[2][1], tbl, scales=True))
                    vd = _unpack_kv_words(vd, gather_pages(pools[3][1], tbl, scales=True))
                    kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
                mask = (s_idx[None, None] <= ppos[:, :, None])[:, None] & live[:, None, :, None]
                qh = q.transpose(1, 2)
                lib = sdpa(qh, kd, vd, mask).transpose(1, 2)
                e_lib = (lib[live].float() - want[live].float()).abs().max().item()
                check(e_lib <= 2e-2, f"the library yardstick differs from the plain one: {e_lib}")
                library_ms = timer(lambda: sdpa(qh, kd, vd, mask))
                del kd, vd, mask, lib
                cache_bytes = 2 * rows_read + 2 * 2 * rows_read // D if int8 else 2 * 2 * rows_read
                b = bound(cache_bytes + nbytes(q, out, table), flops)
                print(f"prefill_attention_paged {kind} MHA page_size={psz}: op {ms:.4f} ms (the "
                      f"linear op here {lin_ms:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s), plain "
                      f"{plain_ms:.4f} ms, library (on gathered bf16 rows) {library_ms:.4f} ms, "
                      f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
                res["prefill_attention_paged_" + kind] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms, linear_ms=lin_ms, **b)
            del linear, pools, out, want, lin
    res["prefill_attention_paged"] = dict(res["prefill_attention_paged_int8"],
                                          max_abs_err=worst_pf)

    # --- paged against linear decode attention at 8 slots of 1000 live positions ---
    H = Hkv = 32
    B8 = 8
    lens8 = torch.full((B8,), 1000, device=dev)
    q = torch.randn(B8, H, D, device=dev, generator=gen).to(torch.bfloat16)
    times = {}
    for int8 in (False, True):
        linear = [t[:1] for t in linear_cache(Hkv, int8, batch=B8)]
        cuts = {psz: cut_pages(gen, linear, S // psz, lens8) for psz in (256, 16)}
        runs = {"linear": lambda: decode_attention(q, linear[0], linear[1], lens8, layer_idx=0,
                                                   **scales_of(linear))}
        for psz, (table, pools) in cuts.items():
            runs[f"pages of {psz}"] = (lambda table=table, pools=pools: decode_attention(
                q, pools[0], pools[1], lens8, layer_idx=0, page_table=table, **scales_of(pools)))
        got = {k: [] for k in runs}
        for _ in range(2):  # in turns
            for k, fn in runs.items():
                got[k].append(timer(fn))
        times["int8" if int8 else "bf16"] = {k: sum(v) / len(v) for k, v in got.items()}
        del linear, cuts, runs
    for kind, t in times.items():
        print(f"decode attention B=8 live=1000 S={S} MHA, no append, {kind}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + f" (pages of 256 / linear = {t['pages of 256'] / t['linear']:.3f}, pages of 16 / "
              f"linear = {t['pages of 16'] / t['linear']:.3f})", flush=True)
    res["paged_live1000"] = times
    return res


# The kernels each serving path must launch; decode appends its new rows
# inside the attention kernel ("kv_append*_fused" count those launches).
BF16_PATH = ("qgemv", "qgemv_mma", "kv_append_fused", "decode_attention")
INT8_PATH = ("qgemv", "qgemv_mma", "prefill_attention", "kv_append_packed_fused",
             "decode_attention_int8")


def two_layer_cut(model):
    return model.with_config(dataclasses.replace(model.cfg, num_layers=2))


def graph_rates(eng, label):
    """Check that every decode burst of the engine's last run was a replay of
    a captured CUDA graph, and return that run's rates: host ms/step and
    tokens/s, device ms a step (CUDA events around each replay, over the
    burst), the captures and their time."""
    st = dict(eng.loop_stats)
    bursts = st["decode_steps"] / eng.decode_burst
    check(st["graph_replays"] == bursts > 0,
          f"{label}: {st['graph_replays']:.0f} graph replays for {bursts:.0f} decode bursts")
    return dict(ms_step=1e3 * st["decode"] / st["decode_steps"],
                tok_s=st["decode_tokens"] / st["decode"],
                device_ms_step=1e3 * st["graph_device"] / st["decode_steps"],
                captures=st["graph_captures"], capture_s=st["graph_capture"],
                replays=st["graph_replays"])


def against_eager(eng, reqs, out, label):
    """The engine's run that gave ``out`` was all graph replays: run the same
    requests again with the bursts eager (the engine's private ``_eager``)
    and require equal tokens for every greedy request, then one eager burst
    (all slots inactive: it writes nothing) whose launches must equal what
    each captured graph counts a replay.  Returns the graph run's rates and
    the eager run's."""
    from xbitops_tpu_torch.kernels import common

    rates = graph_rates(eng, label)
    eng._eager = True
    try:
        eager_out = eng.generate(reqs)
        st = dict(eng.loop_stats)
        eng._act_in.zero_()
        common.reset_counts()
        eng._burst(greedy=True)
        torch.cuda.synchronize()
    finally:
        eng._eager = False
    per_burst = {k: n for k, n in common.launches.items() if n}
    check(st.get("graph_replays", 0) == 0, f"{label}: the eager run replayed a graph")
    greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0]
    parted = [out[i].id for i in greedy if out[i].tokens != eager_out[i].tokens]
    check(not parted, f"{label}: graph and eager greedy tokens differ in requests {parted}")
    for greedy_prog, prog in eng._programs.items():
        check(prog.launches == per_burst, f"{label}: a replay of the "
              f"{'greedy' if greedy_prog else 'sampled'} graph counts {prog.launches}, an eager "
              f"burst launches {per_burst}")
    rates.update(eager_ms_step=1e3 * st["decode"] / st["decode_steps"],
                 eager_tok_s=st["decode_tokens"] / st["decode"],
                 launches_per_replay=sum(per_burst.values()))
    same = sum(a == b for c, d in zip(out, eager_out) for a, b in zip(c.tokens, d.tokens))
    print(f"{label}: decode through graphs {rates['ms_step']:.2f} ms/step, {rates['tok_s']:.1f} "
          f"tokens/s (device {rates['device_ms_step']:.3f} ms a replayed step; "
          f"{rates['captures']:.0f} captures in {rates['capture_s']:.2f} s, "
          f"{rates['replays']:.0f} replays of {rates['launches_per_replay']} launches each); "
          f"eager bursts {rates['eager_ms_step']:.2f} ms/step, {rates['eager_tok_s']:.1f} "
          f"tokens/s; greedy tokens equal in all {len(greedy)} greedy requests ({same} of "
          f"{sum(len(c.tokens) for c in out)} tokens equal, sampled included)", flush=True)
    return rates


def phase_serving(dev, model):
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama

    cfg = model.cfg
    eng = Engine(model, cfg, slots=8, decode_burst=8, top_k=50, kv_quant=False, seed=SEED)
    rng = np.random.default_rng(SEED)
    lengths = np.linspace(16, 500, 12).astype(int)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=32,
                    temperature=0.8 if i in (3, 9) else 0.0) for i, n in enumerate(lengths)]

    common.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches, plain = dict(common.launches), dict(common.plain_on_cuda)

    check(len(out) == 12, f"{len(out)} completions, want 12")
    for c, r in zip(out, reqs):
        check(len(c.tokens) == 32 and c.finish_reason == "length",
              f"request {c.id}: {len(c.tokens)} tokens, {c.finish_reason}")
        check(c.prompt_len == len(r.prompt), f"request {c.id}: prompt_len")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens), f"request {c.id}: token range")
    for name in BF16_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched on the serving path")
    check(not any(plain.values()), f"plain versions ran on the card: {plain}")
    st = dict(eng.loop_stats)
    ms_step = 1e3 * st["decode"] / st["decode_steps"]
    tok_s = st["decode_tokens"] / st["decode"]
    print(f"serving (bf16 cache): 12 requests, 8 slots, burst 8, {wall:.2f} s wall; prefill "
          f"{st['admit_prefill']:.2f} s; decode {st['decode_steps']:.0f} steps "
          f"{ms_step:.2f} ms/step, {tok_s:.1f} tokens/s; launches {launches}", flush=True)
    graphs = against_eager(eng, reqs, out, "serving (bf16 cache)")

    # One decode step through the kernels against the plain path, on clones
    # of the engine's cache.  Each op agrees to f32 rounding (~5e-7) before
    # its bf16 output rounding; the rare 1-ulp output flips that leaves grow
    # through this untrained random model's layers (H100 80GB HBM3, 700 W:
    # max rel 7e-3 after 1 layer, 2e-2 after 8, 5e-2 after 32).  So the gates
    # are: decode_step logits of a 2-layer cut of the same full-width model
    # within rel 2e-2, and every one of the 32 blocks, fed the same input,
    # within rel 2e-2; the full-depth logits are reported.
    tokens = torch.tensor([c.tokens[-1] for c in out[:8]], device=dev)
    cut = two_layer_cut(model)
    errs = {}
    for m in (cut, model):
        n = m.cfg.num_layers
        a, b = clone_cache(eng.cache, n), clone_cache(eng.cache, n)
        la, _ = llama.decode_step(m, tokens, a)
        lb, _ = llama.decode_step(m, tokens, b, use_kernel=False)
        del a, b
        errs[n] = rel_err(la, lb)
        print(f"decode_step {n} layers, kernels vs plain: logits rel err {errs[n]:.2e}",
              flush=True)
        check(torch.isfinite(la.float()).all().item(), "non-finite logits")
    check(errs[2] <= 2e-2, f"decode_step (2-layer cut) logits rel err {errs[2]:.3e} > 2e-2")
    layer_errs = block_errs(model, tokens, eng.cache)
    worst = max(range(len(layer_errs)), key=layer_errs.__getitem__)
    print(f"decode step, each of {len(layer_errs)} blocks on the same input, kernels vs "
          f"plain: worst rel err {layer_errs[worst]:.2e} (block {worst})", flush=True)
    check(layer_errs[worst] <= 2e-2, f"block {worst}: rel err {layer_errs[worst]:.3e} > 2e-2")
    step16(model, cfg, dev, "7B", 4 * cfg.num_layers + 1)
    return launches, dict(ms_step=ms_step, tok_s=tok_s, admit_s=st["admit_prefill"],
                          admit_rows=st["admit_rows"], graphs=graphs)


def phase_long_context(dev, model):
    """Long-context serving over the packed int8 cache: prompts past the last
    bucket are admitted in chunks of 512 that attend the cache."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama

    cfg = model.cfg
    eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=True, prefill_chunk=512,
                 seed=SEED)
    check(eng.cache.quantized and eng.cache.k.dtype == torch.int32, "the cache is not int8")
    rng = np.random.default_rng(SEED + 1)
    lengths = (600, 900, 1100, 1300, 1500, 40, 200, 500)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=16)
            for n in lengths]

    common.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches, plain = dict(common.launches), dict(common.plain_on_cuda)

    check(len(out) == 8, f"{len(out)} completions, want 8")
    for c, r in zip(out, reqs):
        check(len(c.tokens) == 16 and c.finish_reason == "length",
              f"request {c.id}: {len(c.tokens)} tokens, {c.finish_reason}")
        check(c.prompt_len == len(r.prompt), f"request {c.id}: prompt_len")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens), f"request {c.id}: token range")
    for name in INT8_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched on the long-context path")
    check(not any(plain.values()), f"plain versions ran on the card: {plain}")
    check(eng.cache.lengths.tolist() == [n + 16 for n in lengths], "cache lengths")
    st = dict(eng.loop_stats)
    check(st["chunks"] == 3, f"{st['chunks']} chunk forwards, want 3")
    ms_step = 1e3 * st["decode"] / st["decode_steps"]
    tok_s = st["decode_tokens"] / st["decode"]
    print(f"long-context serving (int8 cache): 8 requests of {min(lengths)}-{max(lengths)} "
          f"prompt tokens, 8 slots, burst 8, {wall:.2f} s wall; chunked prefill "
          f"{st['admit_prefill_chunks']:.2f} s in {st['chunks']:.0f} chunk forwards, bucketed "
          f"prefill {st['admit_prefill']:.2f} s; decode {st['decode_steps']:.0f} steps "
          f"{ms_step:.2f} ms/step, {tok_s:.1f} tokens/s; launches {launches}", flush=True)
    graphs = against_eager(eng, reqs, out, "long-context serving (int8 cache)")
    del eng
    torch.cuda.empty_cache()

    # The 2-layer cut of the same model (the depth at which kernel and plain
    # logits of this random model still agree within the bf16 gate): a
    # chunked admission of 4 prompts in 2 chunks of 512, then one decode step,
    # kernels against the plain versions, each on its own int8 cache.
    cut = two_layer_cut(model)
    lens = torch.tensor([1024, 900, 700, 600], device=dev)
    slots = torch.tensor([2, 0, 3, 1], device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024))).to(dev)
    caches = [llama.KVCache.init(cut.cfg, 4, dev, quantized=True) for _ in range(2)]
    for ci in range(2):
        args = (tokens[:, ci * 512 : (ci + 1) * 512], torch.full((4,), ci * 512, device=dev),
                lens, slots)
        resets = torch.full((4,), ci == 0, device=dev)
        la, _ = llama.prefill_slots_chunk(cut, *args, caches[0], resets=resets)
        lb, _ = llama.prefill_slots_chunk(cut, *args, caches[1], resets=resets,
                                          use_kernel=False)
    e = rel_err(la, lb)
    print(f"prefill_slots_chunk 2 layers, 2 chunks of 512, int8 cache, kernels vs plain: "
          f"logits rel err {e:.2e}", flush=True)
    check(torch.isfinite(la.float()).all().item(), "non-finite logits")
    check(e <= 2e-2, f"chunked admission (2-layer cut) logits rel err {e:.3e} > 2e-2")
    check(caches[0].lengths.tolist() == caches[1].lengths.tolist() == [900, 600, 1024, 700],
          "cache lengths after the chunked admission")
    step_tok = la.float().argmax(dim=-1)[torch.argsort(slots)]  # slot order
    la, _ = llama.decode_step(cut, step_tok, caches[0])
    lb, _ = llama.decode_step(cut, step_tok, caches[1], use_kernel=False)
    e = rel_err(la, lb)
    print(f"decode_step 2 layers, int8 cache, kernels vs plain: logits rel err {e:.2e}",
          flush=True)
    check(e <= 2e-2, f"int8 decode_step (2-layer cut) logits rel err {e:.3e} > 2e-2")
    del caches

    # A 500-token prompt admitted in four chunks of 128 against one chunk of
    # 512 (both attend the cache: gate rel 2e-2 on either cache) and against
    # one bucket of 512 (bucketed admission attends the prompt's own rows
    # before they are quantized, so on the int8 cache the difference holds
    # the int8 rounding of k and v as well: gate rel 2e-2 on the bf16 cache,
    # 1e-1 on the int8 cache).
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, 500)).to(dev)
    padded = torch.zeros(512, dtype=torch.long, device=dev)
    padded[:500] = prompt
    for quantized in (False, True):
        a, b, c = (llama.KVCache.init(cut.cfg, 2, dev, quantized=quantized) for _ in range(3))
        l_bucket, _ = llama.prefill_slot(cut, padded, 500, 1, a)
        l_one, _ = llama.prefill_slot_chunk(cut, padded, 0, 500, 1, c, reset=True)
        for start in range(0, 512, 128):
            l_four, _ = llama.prefill_slot_chunk(cut, padded[start : start + 128], start, 500, 1,
                                                 b, reset=start == 0)
        e_chunk, e_bucket = rel_err(l_four, l_one), rel_err(l_four, l_bucket)
        print(f"500-token prompt, 2 layers, {'int8' if quantized else 'bf16'} cache: 4 chunks of "
              f"128 vs 1 chunk of 512 logits rel err {e_chunk:.2e}; vs bucketed {e_bucket:.2e}",
              flush=True)
        check(a.lengths.tolist() == b.lengths.tolist() == c.lengths.tolist() == [0, 500],
              "cache lengths")
        check(e_chunk <= 2e-2, f"4 chunks vs 1 chunk logits rel err {e_chunk:.3e} > 2e-2")
        gate = 1e-1 if quantized else 2e-2
        check(e_bucket <= gate, f"bucketed vs chunked logits rel err {e_bucket:.3e} > {gate}")
    return launches, dict(ms_step=ms_step, tok_s=tok_s, chunks=st["chunks"],
                          chunk_s=st["admit_prefill_chunks"], graphs=graphs)


def phase_w4a8(dev, model):
    """The quantize-and-W4A8 path at full width and depth: W4A8 admission on
    the 4-bit grouped model, then on its 8-bit per-channel requantization."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops.quantize import requantize_a8

    cfg8 = dataclasses.replace(model.cfg, prefill_a8=True)
    rng = np.random.default_rng(SEED + 2)
    lengths = (40, 120, 200, 280, 360, 440, 500, 1100)
    new = 8
    reqs = [Request(prompt=rng.integers(0, cfg8.vocab_size, n).tolist(), max_new_tokens=new)
            for n in lengths]
    forwards = 1 + 3  # at T >= 32: one bucket of 7 x 512 rows, 3 chunks of the 1100-token prompt
    n_proj = 4 * cfg8.num_layers

    def serve(m, label):
        eng = Engine(m, m.cfg, slots=8, decode_burst=8, kv_quant=False, prefill_chunk=512,
                     seed=SEED)
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        wall = time.perf_counter() - t0
        check(len(out) == len(reqs), f"{label}: {len(out)} completions")
        for c, r in zip(out, reqs):
            check(len(c.tokens) == new and c.finish_reason == "length",
                  f"{label} request {c.id}: {len(c.tokens)} tokens, {c.finish_reason}")
            check(c.prompt_len == len(r.prompt), f"{label} request {c.id}: prompt_len")
            check(all(0 <= t < cfg8.vocab_size for t in c.tokens), f"{label} request {c.id}: range")
        check(eng.cache.lengths.tolist() == [n + new for n in lengths], f"{label}: cache lengths")
        graph_rates(eng, label)
        st = eng.loop_stats
        check(st["chunks"] == 3, f"{label}: {st['chunks']} chunk forwards, want 3")
        rows, secs = st["admit_rows"] + st["chunk_rows"], st["admit_prefill"] + st["admit_prefill_chunks"]
        print(f"{label}: 8 requests, prompts {min(lengths)}-{max(lengths)}, {wall:.2f} s wall; "
              f"admission {secs:.3f} s for {rows:.0f} padded rows ({rows / secs:.0f} rows/s: "
              f"bucket {st['admit_prefill']:.3f} s, 3 chunks {st['admit_prefill_chunks']:.3f} s); "
              f"decode {1e3 * st['decode'] / st['decode_steps']:.2f} ms/step", flush=True)
        del eng
        torch.cuda.empty_cache()
        return dict(admit_s=secs, rows=rows)

    # (a) the 4-bit g=128 model, W4A8 admission through the grouped kernel
    model_a = model.with_config(cfg8)
    common.reset_counts()
    stats_a = serve(model_a, "W4A8 serving (a), 4-bit g=128")
    launches_a, plain = dict(common.launches), dict(common.plain_on_cuda)
    check(launches_a["qgemv_a8"] == forwards * n_proj,
          f"qgemv_a8 launched {launches_a['qgemv_a8']} times, want {forwards * n_proj}")
    check(launches_a["qgemv_a8_perchannel"] == 0 and launches_a["qgemv"] > 0,
          f"(a) launches {launches_a}")
    check(not any(plain.values()), f"(a) plain versions ran on the card: {plain}")

    # (b) every block projection requantized on the card, one at a time (the
    # dense f32 form of w_gateup alone is 360 MB), then the same requests
    common.reset_counts()
    t0 = time.perf_counter()
    blocks = []
    for b in model.blocks:
        proj = {n: requantize_a8(c.qtensor) for n, c in b.named_children()}
        blocks.append(llama.LlamaBlock(cfg8, proj, b.ln_attn, b.ln_mlp))
    model_b = llama.Llama(cfg8, model.embed, blocks, model.ln_final, model.lm_head.qtensor)
    torch.cuda.synchronize()
    t_rq = time.perf_counter() - t0
    check(common.launches["dequant"] == n_proj, f"dequant launched {common.launches['dequant']}")
    qt = model_b.blocks[0].w_down.qtensor
    check(qt.bits == 8 and qt.group_size == qt.K == cfg8.intermediate_size,
          f"requantized w_down: bits {qt.bits}, group {qt.group_size}, K {qt.K}")
    print(f"requantize_a8 of {n_proj} projections on the card: {t_rq:.2f} s", flush=True)
    stats_b = serve(model_b, "W4A8 serving (b), 8-bit per-channel")
    launches_b, plain = dict(common.launches), dict(common.plain_on_cuda)
    check(launches_b["qgemv_a8_perchannel"] == forwards * n_proj and launches_b["qgemv_a8"] == 0
          and launches_b["qgemv"] > 0, f"(b) launches {launches_b}")
    check(not any(plain.values()), f"(b) plain versions ran on the card: {plain}")

    # the same requests with bf16 activations (not counted: it adds no kernel)
    stats_16 = serve(model, "the same requests, prefill_a8=False")

    # 2-layer cuts: one admission of T=512 (two prompts), kernels vs plain,
    # and the 8-bit per-channel model against the 4-bit one.  A projection
    # alone agrees to its bf16 output rounding (gate rel 1e-2).  Through
    # layers the int8 rounding of the activations amplifies such a 1-ulp
    # difference: where it moves a row's largest value, the row's scale moves
    # and a good part of the row lands on other int8 steps.  The two paths
    # then differ by about as much as int8 activations differ from bf16 ones
    # (printed beside it), so the logits are gated at rel 1e-1, not 2e-2.
    tokens = torch.from_numpy(rng.integers(0, cfg8.vocab_size, (2, 512))).to(dev)
    lens, slots = torch.tensor([512, 300], device=dev), torch.tensor([1, 0], device=dev)

    def admit(m, **kw):
        cut = two_layer_cut(m)
        return llama.prefill_slots(cut, tokens, lens, slots,
                                   llama.KVCache.init(cut.cfg, 2, dev), **kw)[0]

    l16 = admit(model)
    logits = {}
    for label, m in (("a", model_a), ("b", model_b)):
        hx = llama.rms_norm(m.embed[tokens].to(torch.bfloat16), m.blocks[0].ln_attn, cfg8.rms_eps)
        e1 = rel_err(m.blocks[0].wqkv(hx, True, True), m.blocks[0].wqkv(hx, False, True))
        la, lb = admit(m), admit(m, use_kernel=False)
        e, e16 = rel_err(la, lb), rel_err(la, l16)
        print(f"W4A8 admission ({label}), T=512, kernels vs plain: first projection rel err "
              f"{e1:.2e}; 2 layers, logits rel err {e:.2e} (against the 4-bit model with bf16 "
              f"activations, both through the kernels: {e16:.2e})", flush=True)
        check(torch.isfinite(la.float()).all().item(), f"({label}) non-finite logits")
        check(e1 <= 1e-2, f"W4A8 ({label}) first projection rel err {e1:.3e} > 1e-2")
        check(e <= 1e-1, f"W4A8 admission ({label}) (2-layer cut) logits rel err {e:.3e} > 1e-1")
        logits[label] = la
    e = rel_err(logits["b"], logits["a"])
    print(f"W4A8 admission, 2 layers: 8-bit per-channel vs 4-bit g=128 logits rel err {e:.2e}",
          flush=True)
    check(e <= 1e-1, f"requantized model's logits rel err {e:.3e} > 1e-1 of the 4-bit model's")
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return launches, dict(a=stats_a, b=stats_b, bf16=stats_16, requantize_s=t_rq)


PAGED_BF16_PATH = ("qgemv", "qgemv_mma", "kv_append_paged_fused", "decode_attention_paged",
                   "prefill_attention_paged")
PAGED_INT8_PATH = ("qgemv", "qgemv_mma", "kv_append_packed_paged_fused",
                   "decode_attention_int8_paged", "prefill_attention_paged")


def first_splits(model, batch, out, lin_out, kind, quantized, names=("paged", "linear")):
    """Where two runs' greedy tokens part (``names``: the paged and the linear
    engine's, unless given), a request
    at a time: the index of the first token that differs and, from a third
    computation of that step's logits (the prompt and the tokens both engines
    agreed on, admitted in chunks of 512 into a linear cache, all such
    requests as one batch), the two largest logits.  A near-tie shows as a gap
    far below the logits' scale with the two engines' tokens as the top two.
    Printed; phase 8 gates a restart's splits on it."""
    from xbitops_tpu_torch.models import llama

    dev, rows = model.device, []
    for r, c, d in zip(batch, out, lin_out):
        i = next((j for j, (a, b) in enumerate(zip(c.tokens, d.tokens)) if a != b), None)
        if i is not None:
            rows.append((c.id, i, list(r.prompt) + c.tokens[:i], c.tokens[i], d.tokens[i]))
    if not rows:
        print(f"{names[0]} {kind}: every token equals the {names[1]} run's", flush=True)
        return []
    n, C = len(rows), 512
    cache = llama.KVCache.init(model.cfg, n, dev, quantized=quantized)
    lens = torch.tensor([len(ctx) for *_, ctx, _, _ in rows], device=dev)
    logits = torch.zeros(n, model.cfg.vocab_size, device=dev)
    for ci in range(-(-int(lens.max()) // C)):
        tokens = torch.zeros(n, C, dtype=torch.long)
        slots = torch.full((n,), n)
        for j, (_, _, ctx, _, _) in enumerate(rows):
            piece = ctx[ci * C : (ci + 1) * C]
            if piece:
                tokens[j, : len(piece)] = torch.tensor(piece)
                slots[j] = j
        lg, _ = llama.prefill_slots_chunk(
            model, tokens.to(dev), torch.full((n,), ci * C, device=dev),
            torch.where(slots.to(dev) < n, lens, 0), slots.to(dev), cache,
            resets=torch.full((n,), ci == 0, device=dev))
        final = (lens - 1) // C == ci
        logits[final] = lg.float()[final]
    top = logits.topk(2, dim=-1)
    found = []
    for j, (rid, i, ctx, tp, tl) in enumerate(rows):
        v, ix = top.values[j].tolist(), top.indices[j].tolist()
        scale = logits[j].abs().max().item()
        found.append(dict(request=rid, index=i, context=len(ctx), paged=tp, linear=tl, top2=ix,
                          gap=v[0] - v[1], gap_rel=(v[0] - v[1]) / scale,
                          top2_are_the_two=sorted(ix) == sorted((tp, tl))))
        print(f"{names[0]} {kind} request {rid}: tokens part at index {i} (context {len(ctx)}): "
              f"{names[0]} {tp}, {names[1]} {tl}; recomputed top two {ix} with logits "
              f"{v[0]:.4f}, {v[1]:.4f}: gap {v[0] - v[1]:.4f}, {(v[0] - v[1]) / scale:.2e} of the largest |logit| "
              f"{scale:.3f}; the top two are the engines' two tokens: "
              f"{found[-1]['top2_are_the_two']}", flush=True)
    del cache
    torch.cuda.empty_cache()
    return found


def phase_paged(dev, model):
    """The paged serving path: a pool of 24 pages of 256 positions for 8 slots
    of 2048, once bf16 and once int8, beside the linear engine on the same
    requests; two requests on a pool of 4 pages, one of which sits bursts out
    until the other frees pages; then a paged chunk admission and decode step
    on a 2-layer cut."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 3)
    pool_pages, psz = 24, 256
    # the first five prompts take 19 pages, the sixth needs 6: it waits with slots free
    lengths = (1500, 1100, 900, 700, 40, 1300, 300, 120, 500, 60)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=16 if i % 2 else 32) for i, n in enumerate(lengths)]
    demand = sum(-(-(len(r.prompt) + r.max_new_tokens) // psz) for r in reqs)
    check(demand > pool_pages, f"the requests' joint demand ({demand} pages) fits the pool")
    kw = dict(slots=8, decode_burst=8, prefill_chunk=512, seed=SEED)
    out_launches, stats = {}, {}
    for kv_quant, path in ((False, PAGED_BF16_PATH), (True, PAGED_INT8_PATH)):
        kind = "int8" if kv_quant else "bf16"
        batch = reqs[:6] if kv_quant else reqs
        eng = Engine(model, cfg, paged=True, pool_pages=pool_pages, page_size=psz,
                     kv_quant=kv_quant, **kw)
        check(eng.cache.paged and eng.cache.k.shape[1] == pool_pages
              and eng.cache.quantized == kv_quant, f"the {kind} cache is not the paged pool")
        common.reset_counts()
        t0 = time.perf_counter()
        out = eng.generate(batch)
        wall = time.perf_counter() - t0
        launches, plain = dict(common.launches), dict(common.plain_on_cuda)
        check(len(out) == len(batch), f"paged {kind}: {len(out)} completions")
        for c, r in zip(out, batch):
            check(len(c.tokens) == r.max_new_tokens and c.finish_reason == "length",
                  f"paged {kind} request {c.id}: {len(c.tokens)} tokens, {c.finish_reason}")
            check(c.prompt_len == len(r.prompt), f"paged {kind} request {c.id}: prompt_len")
            check(all(0 <= t < cfg.vocab_size for t in c.tokens),
                  f"paged {kind} request {c.id}: token range")
        check(sorted(eng._free_pages) == list(range(pool_pages))
              and bool((eng.cache.page_table == -1).all()) and not any(eng._slot_pages),
              f"paged {kind}: pages are still held after generate")
        for name in path:
            check(launches[name] > 0, f"kernel {name} was not launched on the paged {kind} path")
        linear_forms = [n for n in launches if launches[n] and n not in path]
        check(not linear_forms, f"paged {kind}: other kernels launched: {linear_forms}")
        check(not any(plain.values()), f"paged {kind}: plain versions ran on the card: {plain}")
        st = dict(eng.loop_stats)
        check(st["admission_waits"] > 0, f"paged {kind}: no admission waited for pages")
        graphs = against_eager(eng, batch, out, f"paged serving ({kind} pool)")
        check(sorted(eng._free_pages) == list(range(pool_pages)),
              f"paged {kind}: pages are still held after the eager run")
        del eng
        torch.cuda.empty_cache()

        # the linear engine on the same requests (not counted: it adds no kernel)
        lin_eng = Engine(model, cfg, kv_quant=kv_quant, **kw)
        lin_out = lin_eng.generate(batch)
        lst = dict(lin_eng.loop_stats)
        graph_rates(lin_eng, f"linear serving ({kind} cache)")
        del lin_eng
        torch.cuda.empty_cache()
        same = sum(a == b for c, d in zip(out, lin_out) for a, b in zip(c.tokens, d.tokens))
        total = sum(len(c.tokens) for c in out)

        def rates(s):
            rows = s["admit_rows"] + s["chunk_rows"]
            secs = s["admit_prefill"] + s["admit_prefill_chunks"]
            return dict(ms_step=1e3 * s["decode"] / s["decode_steps"],
                        tok_s=s["decode_tokens"] / s["decode"], rows_s=rows / secs,
                        steps=s["decode_steps"], chunks=s["chunks"])

        pg, ln = rates(st), rates(lst)
        print(f"paged serving ({kind} pool of {pool_pages} pages of {psz} for 8 slots): "
              f"{len(batch)} requests, prompts {min(lengths)}-{max(lengths)}, {wall:.2f} s wall; "
              f"{st['admission_waits']:.0f} admission waits, "
              f"{st.get('deferred_slot_steps', 0):.0f} deferred slot steps; paged "
              f"{pg['ms_step']:.2f} ms/step over {pg['steps']:.0f} steps, {pg['tok_s']:.1f} "
              f"tokens/s, admission {pg['rows_s']:.0f} padded rows/s in {pg['chunks']:.0f} chunk "
              f"forwards; the linear engine on the same requests {ln['ms_step']:.2f} ms/step "
              f"over {ln['steps']:.0f} steps, {ln['tok_s']:.1f} tokens/s, {ln['rows_s']:.0f} "
              f"rows/s; tokens equal to the linear engine's: {same} of {total}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        splits = first_splits(model, batch, out, lin_out, kind, kv_quant)
        # the paged engine again on a pool that never makes a request wait: the
        # linear engine's schedule, so only the cache's form differs (not counted)
        full = cfg.max_seq_len // psz * kw["slots"]
        eng = Engine(model, cfg, paged=True, pool_pages=full, page_size=psz, kv_quant=kv_quant,
                     **kw)
        full_out = eng.generate(batch)
        waits = eng.loop_stats.get("admission_waits", 0)
        graph_rates(eng, f"paged serving ({kind} pool of {full} pages)")
        del eng
        torch.cuda.empty_cache()
        same_full = sum(a == b for c, d in zip(full_out, lin_out)
                        for a, b in zip(c.tokens, d.tokens))
        print(f"paged serving ({kind} pool of {full} pages, {waits:.0f} admission waits: the "
              f"linear engine's schedule): tokens equal to the linear engine's: {same_full} of "
              f"{total}", flush=True)
        out_launches[kind] = launches
        stats[kind] = dict(paged=pg, linear=ln, equal_tokens=same, tokens=total, splits=splits,
                           equal_tokens_full_pool=same_full, graphs=graphs)

    # Deferral: a pool of 4 pages.  The prompt of 250 takes one page and the
    # one of 700 three, so the pool is full at admission; the first needs its
    # second page at position 256, inside its first burst, and sits bursts out
    # until the second request has finished and released its pages.
    pair = [Request(prompt=rng.integers(0, cfg.vocab_size, 250).tolist(), max_new_tokens=24),
            Request(prompt=rng.integers(0, cfg.vocab_size, 700).tolist(), max_new_tokens=16)]
    for kv_quant in (False, True):
        kind = "int8" if kv_quant else "bf16"
        eng = Engine(model, cfg, paged=True, pool_pages=4, page_size=psz, kv_quant=kv_quant, **kw)
        common.reset_counts()
        out = eng.generate(pair)
        launches, plain = dict(common.launches), dict(common.plain_on_cuda)
        st = dict(eng.loop_stats)
        check(st.get("deferred_slot_steps", 0) > 0, f"paged {kind}, pool of 4: no slot deferred")
        graph_rates(eng, f"paged serving ({kind} pool of 4 pages)")
        check(all(len(c.tokens) == r.max_new_tokens and c.finish_reason == "length"
                  for c, r in zip(out, pair)), f"paged {kind}, pool of 4: a request was cut")
        check(sorted(eng._free_pages) == list(range(4))
              and bool((eng.cache.page_table == -1).all()),
              f"paged {kind}, pool of 4: pages are still held after generate")
        check(not any(plain.values()), f"paged {kind}, pool of 4: plain versions ran: {plain}")
        del eng
        torch.cuda.empty_cache()
        lin_eng = Engine(model, cfg, kv_quant=kv_quant, **kw)
        lin_out = lin_eng.generate(pair)
        del lin_eng
        torch.cuda.empty_cache()
        same = sum(a == b for c, d in zip(out, lin_out) for a, b in zip(c.tokens, d.tokens))
        print(f"paged serving ({kind} pool of 4 pages of {psz}), prompts 250 and 700: "
              f"{st['deferred_slot_steps']:.0f} deferred slot steps, "
              f"{st.get('admission_waits', 0):.0f} admission waits, {st['decode_steps']:.0f} "
              f"steps; tokens equal to the linear engine's: {same} of 40", flush=True)
        first_splits(model, pair, out, lin_out, f"{kind}, pool of 4", kv_quant)
        for k, v in launches.items():
            out_launches[kind][k] += v

    # The 2-layer cut: 4 prompts admitted in 2 chunks of 512 into a paged
    # cache with a shuffled table, then one decode step: the paged kernels
    # against the plain path on its own paged cache (gate rel 2e-2), and
    # against the linear cache's kernels (the same rows: printed and gated too).
    cut = two_layer_cut(model)
    lens = torch.tensor([1024, 900, 700, 600], device=dev)
    slots = torch.tensor([2, 0, 3, 1], device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        # a shuffled table that holds each slot's prompt and one more position
        need = torch.zeros(4, dtype=torch.long, device=dev)
        need[slots] = lens + 1
        pages = cut.cfg.max_seq_len // psz
        order = torch.randperm(20, generator=gen, device=dev).reshape(4, 5)
        order = torch.nn.functional.pad(order, (0, pages - 5), value=-1)
        given = torch.arange(pages, device=dev)[None] * psz < need[:, None]
        table = torch.where(given, order, -1).to(torch.int32)
        check(int((table >= 0).sum()) == 15, "the cut's table should hold 15 pages")
        caches = []
        for _ in range(2):
            c = llama.KVCache.init_paged(cut.cfg, 4, 20, psz, device=dev, quantized=quantized)
            c.page_table.copy_(table)
            caches.append(c)
        caches.append(llama.KVCache.init(cut.cfg, 4, dev, quantized=quantized))
        for ci in range(2):
            args = (tokens[:, ci * 512 : (ci + 1) * 512], torch.full((4,), ci * 512, device=dev),
                    lens, slots)
            resets = torch.full((4,), ci == 0, device=dev)
            la, _ = llama.prefill_slots_chunk(cut, *args, caches[0], resets=resets)
            lb, _ = llama.prefill_slots_chunk(cut, *args, caches[1], resets=resets,
                                              use_kernel=False)
            lc, _ = llama.prefill_slots_chunk(cut, *args, caches[2], resets=resets)
        e, e_lin = rel_err(la, lb), rel_err(la, lc)
        print(f"paged prefill_slots_chunk 2 layers, 2 chunks of 512, {kind} pool: logits rel "
              f"err {e:.2e} vs the plain path, {e_lin:.2e} vs the linear cache's kernels",
              flush=True)
        check(torch.isfinite(la.float()).all().item(), "non-finite logits")
        check(e <= 2e-2, f"paged chunked admission ({kind}) logits rel err {e:.3e} > 2e-2")
        check(e_lin <= 2e-2, f"paged vs linear chunked admission ({kind}): {e_lin:.3e} > 2e-2")
        check(all(c.lengths.tolist() == [900, 600, 1024, 700] for c in caches),
              "cache lengths after the paged chunked admission")
        step_tok = la.float().argmax(dim=-1)[torch.argsort(slots)]  # slot order
        la, _ = llama.decode_step(cut, step_tok, caches[0])
        lb, _ = llama.decode_step(cut, step_tok, caches[1], use_kernel=False)
        lc, _ = llama.decode_step(cut, step_tok, caches[2])
        e, e_lin = rel_err(la, lb), rel_err(la, lc)
        print(f"paged decode_step 2 layers, {kind} pool: logits rel err {e:.2e} vs the plain "
              f"path, {e_lin:.2e} vs the linear cache's kernels", flush=True)
        check(e <= 2e-2, f"paged decode_step ({kind}) logits rel err {e:.3e} > 2e-2")
        check(e_lin <= 2e-2, f"paged vs linear decode_step ({kind}): {e_lin:.3e} > 2e-2")
        del caches
    launches = {k: out_launches["bf16"][k] + out_launches["int8"][k] for k in out_launches["bf16"]}
    return launches, stats


# The standalone append kernel of each cache form: the one-row write of a
# decode step that attends eagerly (``flash_decode=False``).
EAGER_APPENDS = {"bf16": "kv_append", "int8": "kv_append_packed",
                 "paged bf16": "kv_append_paged", "paged int8": "kv_append_packed_paged"}


def phase_eager_decode(dev, model):
    """Decode with ``flash_decode=False`` on a 2-layer cut of the full-width
    model: each step writes its new rows with the standalone append kernel
    (``csrc/kv_append.cu``) and attends in PyTorch.  The linear caches serve
    requests through the engine.  The engine pages a cache only for the
    decode-attention kernel, so the paged forms run ``decode_step`` on the
    engine's cache cut into pages of 256 behind a shuffled table, held against
    the linear cache on the same tokens and against the plain path."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.utils.synth import cut_pages

    cfg = dataclasses.replace(model.cfg, num_layers=2, flash_decode=False)
    cut = model.with_config(cfg)
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=16)
            for n in (16, 100, 250, 300, 400, 500)]
    steps, psz = 4, 256
    out_launches = {}
    for kv_quant in (False, True):
        kind = "int8" if kv_quant else "bf16"
        eng = Engine(cut, cfg, slots=8, decode_burst=8, kv_quant=kv_quant, seed=SEED)
        check(eng.cache.quantized == kv_quant and not eng.cache.paged, f"the {kind} cache")
        common.reset_counts()
        out = eng.generate(reqs)
        launches, plain = dict(common.launches), dict(common.plain_on_cuda)
        check(all(len(c.tokens) == 16 and c.finish_reason == "length" for c in out),
              f"eager decode, {kind}: a request was cut")
        check(launches[EAGER_APPENDS[kind]] > 0,
              f"eager decode, {kind}: {EAGER_APPENDS[kind]} was not launched")
        graph_rates(eng, f"eager decode, {kind}")  # the eager attention, replayed from a graph
        attn = {n: v for n, v in launches.items() if n.startswith("decode_attention") and v}
        check(not attn, f"eager decode, {kind}: the decode-attention kernel ran: {attn}")
        check(not any(plain.values()), f"eager decode, {kind}: plain versions ran: {plain}")
        cache = eng.cache
        del eng

        # the next steps: on the linear cache through the kernels (not counted),
        # then on the paged cut of it (counted), both fed the linear run's tokens
        tok = torch.tensor([c.tokens[-1] for c in out] + [0] * (8 - len(out)), device=dev)
        parts = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if kv_quant else [])
        table, pools = cut_pages(gen, parts, cfg.max_seq_len // psz,
                                 cache.lengths.long() + steps)
        paged = llama.KVCache(pools[0], pools[1], cache.lengths.clone(), *pools[2:],
                              page_table=table)
        first = clone_cache(paged)
        lin_logits, toks = [], [tok]
        for _ in range(steps):
            lg, _ = llama.decode_step(cut, toks[-1], cache)
            lin_logits.append(lg)
            toks.append(lg.float().argmax(dim=-1))
        common.reset_counts()
        pg_logits = [llama.decode_step(cut, t, paged)[0] for t in toks[:steps]]
        paged_launches, plain = dict(common.launches), dict(common.plain_on_cuda)
        want, _ = llama.decode_step(cut, tok, first, use_kernel=False)
        e_lin = max(rel_err(a, b) for a, b in zip(pg_logits, lin_logits))
        e = rel_err(pg_logits[0], want)
        pk = "paged " + kind
        print(f"eager decode (flash_decode=False), 2 layers, {kind} cache: 6 requests, "
              f"{sum(len(c.tokens) for c in out)} tokens through the engine; {steps} steps on "
              f"the {kind} cache cut into pages of {psz}: logits rel err {e_lin:.2e} vs the "
              f"linear cache, {e:.2e} vs the plain path; launches "
              f"{ {k: v for k, v in launches.items() if v} }, paged "
              f"{ {k: v for k, v in paged_launches.items() if v} }", flush=True)
        check(all(torch.isfinite(x.float()).all().item() for x in pg_logits), "non-finite logits")
        check(e_lin <= 2e-2, f"eager decode, {pk} vs linear: rel err {e_lin:.3e} > 2e-2")
        check(e <= 2e-2, f"eager decode, {pk} vs the plain path: rel err {e:.3e} > 2e-2")
        check(paged_launches[EAGER_APPENDS[pk]] == 2 * steps,
              f"eager decode, {pk}: {EAGER_APPENDS[pk]} launched "
              f"{paged_launches[EAGER_APPENDS[pk]]} times, want {2 * steps}")
        check(not any(plain.values()), f"eager decode, {pk}: plain versions ran: {plain}")
        out_launches[kind], out_launches[pk] = launches, paged_launches
        del cache, paged, first, pools
        torch.cuda.empty_cache()
    return {k: sum(ln[k] for ln in out_launches.values()) for k in out_launches["bf16"]}


def phase_three_bit(dev, cfg):
    """The 3-bit slice: a random 3-bit g=128 Llama-2-7B at default (packed)
    storage, planes of 2 and 1 bits, serves greedy requests on the bf16
    cache.  Every decode projection, lm_head included, runs on the few-rows
    form's planes kernel (csrc/qgemv_word_planes.cu): 129 launches a decode
    step and none of the CUDA-core form.  Then one decode step of a 2-layer
    cut against the plain path."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.qgemv_kernel import qgemv_form, word_planes
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.utils import synth

    t0 = time.perf_counter()
    model = synth.random_llama_params(cfg, bits=3, group_size=128, device=dev, seed=SEED)
    torch.cuda.synchronize()
    wqkv = model.blocks[0].wqkv.qtensor
    check(wqkv.bits == 3 and wqkv.plane_bits == (2, 1) and wqkv.tile_k == 4096
          and word_planes(wqkv) and qgemv_form(8, False, wqkv) == "gemv",
          f"3-bit layout: bits {wqkv.bits}, planes {wqkv.plane_bits}, tile_k {wqkv.tile_k}")
    packed = sum(getattr(blk, n).qtensor.bytes_packed() for blk in model.blocks
                 for n in ("wqkv", "wo", "w_gateup", "w_down"))
    packed += model.lm_head.qtensor.bytes_packed()
    print(f"3-bit 7B model built in {time.perf_counter() - t0:.1f} s ({packed / 1e9:.2f} GB "
          f"packed: the matmuls' bound a decode step is {1e3 * packed / HBM_BYTES_PER_S:.3f} ms)",
          flush=True)
    eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=False, seed=SEED)
    rng = np.random.default_rng(SEED + 7)
    lengths = np.linspace(16, 500, 6).astype(int)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=16)
            for n in lengths]
    common.reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches, plain = dict(common.launches), dict(common.plain_on_cuda)
    check(len(out) == 6 and all(len(c.tokens) == 16 and c.finish_reason == "length"
                                and all(0 <= t < cfg.vocab_size for t in c.tokens) for c in out),
          "3-bit serving: a request was cut or a token is out of range")
    check(launches["qgemv_planes"] > 0 and launches["qgemv_cuda_core"] == 0
          and not any(plain.values()),
          f"3-bit serving: launches {launches}, plain versions on the card {plain}")
    st = dict(eng.loop_stats)
    ms_step = 1e3 * st["decode"] / st["decode_steps"]
    tok_s = st["decode_tokens"] / st["decode"]
    graphs = against_eager(eng, reqs, out, "3-bit serving (bf16 cache)")

    # one decode step alone: every projection on the planes kernel
    tokens = torch.tensor([c.tokens[-1] for c in out] + [0] * (8 - len(out)), device=dev)
    step_cache = clone_cache(eng.cache)
    common.reset_counts()
    logits, _ = llama.decode_step(model, tokens, step_cache)
    torch.cuda.synchronize()
    step = {k: v for k, v in common.launches.items() if v}
    check(step.get("qgemv_planes") == 4 * cfg.num_layers + 1 and "qgemv_cuda_core" not in step
          and "qgemv" not in step and "qgemv_mma" not in step,
          f"3-bit decode step: launches {step}, want qgemv_planes {4 * cfg.num_layers + 1}")
    check(torch.isfinite(logits.float()).all().item(), "3-bit decode step: non-finite logits")
    del step_cache
    # the 2-layer cut against the plain path, each on its own clone of the cache
    cut = two_layer_cut(model)
    a, b = clone_cache(eng.cache, 2), clone_cache(eng.cache, 2)
    la, _ = llama.decode_step(cut, tokens, a)
    lb, _ = llama.decode_step(cut, tokens, b, use_kernel=False)
    err = rel_err(la, lb)
    check(err <= 2e-2, f"3-bit decode_step (2-layer cut) logits rel err {err:.3e} > 2e-2")
    print(f"3-bit serving (bf16 cache): 6 requests of 16-500 prompt tokens, 8 slots, burst 8, "
          f"{wall:.2f} s wall; decode {st['decode_steps']:.0f} steps {ms_step:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s; a decode step launches {step.get('qgemv_planes', 0)} of qgemv_planes "
          f"and no CUDA-core form; 2-layer cut vs plain: logits rel err {err:.2e}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    del eng, model, cut, a, b
    torch.cuda.empty_cache()
    return launches, dict(ms_step=ms_step, tok_s=tok_s, graphs=graphs)


def write_autogptq(path, cfg, layers: int, rng) -> None:
    """A random AutoGPTQ checkpoint (4-bit, g=128, "gptq" format: zero - 1
    stored, trivial g_idx) at ``cfg``'s widths with ``layers`` layers: the
    projections' qweight, qzeros, scales and g_idx, fp16 embedding, norms and
    a dense fp16 lm_head, as AutoGPTQ leaves it."""
    import json as _json
    from pathlib import Path

    from safetensors import numpy as st_np

    h, ffn, g = cfg.hidden_size, cfg.intermediate_size, 128
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    tensors = {}
    for i in range(layers):
        pre = f"model.layers.{i}"
        for name, k, n in (("self_attn.q_proj", h, qdim), ("self_attn.k_proj", h, kvdim),
                           ("self_attn.v_proj", h, kvdim), ("self_attn.o_proj", qdim, h),
                           ("mlp.gate_proj", h, ffn), ("mlp.up_proj", h, ffn),
                           ("mlp.down_proj", ffn, h)):
            # |q - z| <= 8 with q in 0..15 around z = 8: scales of k^-0.5 / 4.6
            # give the weights a spread of about k^-0.5
            scale = k ** -0.5 / 4.6
            tensors[f"{pre}.{name}.qweight"] = rng.integers(
                0, 2**32, (k // 8, n), dtype=np.uint32).view(np.int32)
            tensors[f"{pre}.{name}.qzeros"] = np.full((k // g, n // 8), 0x77777777, np.int32)
            tensors[f"{pre}.{name}.scales"] = rng.uniform(
                0.8 * scale, 1.2 * scale, (k // g, n)).astype(np.float16)
            tensors[f"{pre}.{name}.g_idx"] = (np.arange(k) // g).astype(np.int32)
        tensors[f"{pre}.input_layernorm.weight"] = np.ones(h, np.float16)
        tensors[f"{pre}.post_attention_layernorm.weight"] = np.ones(h, np.float16)
    tensors["model.embed_tokens.weight"] = (
        rng.standard_normal((cfg.vocab_size, h), dtype=np.float32) * 0.02).astype(np.float16)
    tensors["model.norm.weight"] = np.ones(h, np.float16)
    tensors["lm_head.weight"] = (
        rng.standard_normal((cfg.vocab_size, h), dtype=np.float32) * h ** -0.5).astype(np.float16)
    p = Path(path)
    st_np.save_file(tensors, str(p / "model.safetensors"))
    (p / "config.json").write_text(_json.dumps(dict(
        model_type="llama", vocab_size=cfg.vocab_size, hidden_size=h, intermediate_size=ffn,
        num_hidden_layers=layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, max_position_embeddings=4096)))
    (p / "quantize_config.json").write_text(_json.dumps(dict(bits=4, group_size=g,
                                                              desc_act=False)))


def phase_entry_points(dev, model):
    """The entry points a user starts: (a) the HTTP endpoint in front of the
    full-depth engine (bf16 cache, 8 slots, bursts of 8) answers 8 concurrent
    clients, whose tokens must equal ``Engine.generate``'s on the same
    requests; (b) the same engine with ``max_restarts=1`` and a device error
    injected before its third burst; (c) a random AutoGPTQ checkpoint at 7B
    widths, cut to 2 layers, through ``cli.main(["convert", ...])`` and
    ``["generate", ...]``, whose tokens must equal a direct ``load_autogptq``
    and ``Engine``; (d) ``cli.main(["bench"])``."""
    import contextlib
    import io
    import re
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    from xbitops_tpu_torch import cli
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.engine.server import ServingEndpoint
    from xbitops_tpu_torch.io import load_autogptq
    from xbitops_tpu_torch.kernels import common

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in np.linspace(16, 500, 8).astype(int)]
    new = 32
    eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=False, seed=SEED)
    # one wave: the worker waits for 8 requests (its slots) or 5 s
    ep = ServingEndpoint(eng, port=0, batch_window_s=5.0)
    ep.start()
    results = [None] * len(prompts)

    def client(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{ep.port}/v1/completions",
            data=json.dumps({"prompt": prompts[i], "max_tokens": new}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            results[i] = (r.status, json.loads(r.read()))

    common.reset_counts()
    t0 = time.perf_counter()
    threads = []
    for i in range(len(prompts)):  # in order, so the wave's slots follow the clients
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
        time.sleep(0.05)
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    launches_a, plain = dict(common.launches), dict(common.plain_on_cuda)
    served = graph_rates(eng, "HTTP serving")
    ep.shutdown()
    check(all(r is not None and r[0] == 200 for r in results), f"HTTP answers: {results}")
    http = [r[1]["choices"][0]["tokens"] for r in results]
    for r, p in zip(results, prompts):
        check(r[1]["usage"] == dict(prompt_tokens=len(p), completion_tokens=new,
                                    total_tokens=len(p) + new), f"HTTP usage {r[1]['usage']}")
    for name in BF16_PATH:
        check(launches_a[name] > 0, f"kernel {name} was not launched behind the HTTP endpoint")
    check(not any(plain.values()), f"HTTP serving: plain versions ran on the card: {plain}")
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
    clean = eng.generate(reqs)
    check([c.tokens for c in clean] == http,
          "HTTP tokens differ from Engine.generate's on the same requests")
    print(f"HTTP serving: 8 concurrent clients, prompts {len(prompts[0])}-{len(prompts[-1])} "
          f"tokens, {new} tokens each, {wall:.2f} s from the first request to the last answer "
          f"({8 * new / wall:.1f} tokens/s over HTTP; the engine's first wave, so the graph's "
          f"capture, {served['capture_s']:.2f} s, is in it); decode {served['ms_step']:.2f} ms/step, "
          f"{served['tok_s']:.1f} tokens/s, device {served['device_ms_step']:.3f} ms a replayed "
          f"step; tokens equal Engine.generate's on the same requests", flush=True)

    # (b) a device error before the third burst: the cache is rebuilt, the
    # requests resume as prompt + the 17 tokens each has emitted, the greedy
    # graph is captured again for the new cache
    calls = []

    def fault():
        calls.append(1)
        if len(calls) == 3:
            raise torch.AcceleratorError("injected device error")

    eng.max_restarts, eng._fault_hook = 1, fault
    common.reset_counts()
    out = eng.generate(reqs)
    launches_b = dict(common.launches)
    eng._fault_hook = None
    st = dict(eng.loop_stats)
    check(eng.restarts == 1 and st.get("graph_captures") == 1,
          f"restart: {eng.restarts} restarts, {st.get('graph_captures')} captures in the run")
    graph_rates(eng, "restarted serving")
    check(all(len(c.tokens) == new and c.finish_reason == "length"
              and c.prompt_len == len(r.prompt) for c, r in zip(out, reqs)),
          "restart: a completion was cut or lost its prompt length")
    before = 1 + 2 * eng.decode_burst  # the admission's token and two bursts
    check(all(c.tokens[:before] == d.tokens[:before] for c, d in zip(out, clean)),
          "restart: the tokens emitted before the error changed")
    same = sum(a == b for c, d in zip(out, clean) for a, b in zip(c.tokens, d.tokens))
    print(f"restart (device error before burst 3, max_restarts=1): {eng.restarts} restart, "
          f"graph captured again ({st.get('graph_captures', 0):.0f} capture in the run); tokens equal "
          f"to the clean run: {same} of {new * len(reqs)}", flush=True)
    splits = first_splits(model, reqs, out, clean, "serving", False, ("restarted", "clean"))
    check(all(sp["index"] >= before and sp["top2_are_the_two"] for sp in splits),
          f"restart: tokens part from the clean run other than at a near-tie: {splits}")
    del eng, ep
    gc.collect()  # the endpoint and its HTTP server refer to each other
    torch.cuda.empty_cache()

    # (c) an AutoGPTQ checkpoint through the command line
    root = Path(__file__).resolve().parent
    gcfg = dataclasses.replace(cfg, num_layers=2)
    gprompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (16, 90, 300, 700)]
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        src, packed = Path(tmp) / "autogptq", Path(tmp) / "packed"
        src.mkdir()
        t0 = time.perf_counter()
        write_autogptq(src, gcfg, 2, rng)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["convert", "--ckpt", str(src), "--out", str(packed), "--device",
                            dev.type]) == 0, "cli convert failed")
        t_convert = time.perf_counter() - t0
        args = ["generate", "--ckpt", str(packed), "--max-tokens", "16", "--slots", "8",
                "--device", dev.type]
        for p in gprompts:
            args += ["--prompt", " ".join(map(str, p))]
        buf = io.StringIO()
        common.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            check(cli.main(args) == 0, "cli generate failed")
        t_generate = time.perf_counter() - t0
        launches_c, plain = dict(common.launches), dict(common.plain_on_cuda)
        lines = [re.fullmatch(r"\[(\d+)\] \[(.*)\] \((\w+)\)", x)
                 for x in buf.getvalue().splitlines()]
        check(len(lines) == len(gprompts) and all(lines), f"cli generate printed {buf.getvalue()}")
        printed = [[int(t) for t in m.group(2).split(", ")] for m in lines]
        gmodel, gcfg_loaded = load_autogptq(str(src), device=dev)
        direct = Engine(gmodel, gcfg_loaded, slots=8).generate(
            [Request(prompt=p, max_new_tokens=16, id=i) for i, p in enumerate(gprompts)])
        check(printed == [c.tokens for c in direct] and all(m.group(3) == "length" for m in lines),
              "cli generate's tokens differ from load_autogptq + Engine's")
        check(not any(plain.values()), f"cli generate: plain versions ran on the card: {plain}")
        for name in ("qgemv", "qgemv_mma", "decode_attention_int8", "prefill_attention"):
            check(launches_c[name] > 0, f"cli generate: kernel {name} was not launched")
        print(f"AutoGPTQ checkpoint at Llama-2-7B widths cut to 2 of 32 layers (random 4-bit "
              f"g=128, dense fp16 lm_head; S=4096, so the int8 cache): written in {t_write:.1f} "
              f"s, `convert` {t_convert:.1f} s, `generate` of 4 prompts of 16-700 tokens "
              f"{t_generate:.1f} s; tokens equal a direct load_autogptq + Engine", flush=True)
        del gmodel
        torch.cuda.empty_cache()

    # (d) the fused matmul on the projection shapes, through the command line
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(["bench", "--batch", "8"]) == 0, "cli bench failed")
    rows = [json.loads(x) for x in buf.getvalue().splitlines()]
    check(len(rows) == 4 and all(r["us"] > 0 for r in rows), f"cli bench printed {rows}")
    print("cli bench (4-bit g=128, M=8, L2 flushed before each call): " + "; ".join(
        f"{r['K']}x{r['N']} {r['us']:.1f} us, {r['gbps']:.0f} GB/s" for r in rows), flush=True)
    launches = {k: launches_a[k] + launches_b[k] + launches_c[k] for k in launches_a}
    return launches, dict(http=served, http_wall=wall, restart_equal=same, bench=rows)


def follows_cycle(c, prompt, period: int) -> bool:
    """The copy-model's greedy stream: each token the successor of the one before."""
    prev = [prompt[-1]] + c.tokens[:-1]
    return all(t == (p + 1) % period for p, t in zip(prev, c.tokens))


def phase_spec(dev, model):
    """Speculative decoding and pipelined bursts (phase 9): the verify's
    kernels at its shapes, then the engine at full depth."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels.kv_append import _unpack_kv_words, gather_pages, paged_rows
    from xbitops_tpu_torch.kernels.prefill_attention import (
        prefill_attention,
        prefill_attention_reference,
    )
    from xbitops_tpu_torch.kernels.qgemv_kernel import qgemv_form
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops.qmatmul import qmatmul
    from xbitops_tpu_torch.utils import synth

    cfg = model.cfg
    H, Hkv, D, S = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
    B, T = 8, 5  # 8 slots, γ = 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    timer = Timer(dev)
    res = {}

    # (a) the fused matmul at a verify's M = B (γ + 1): 16 (γ = 1), 32 (3), 40 (4)
    b0 = model.blocks[0]
    weights = dict(wqkv=b0.wqkv.qtensor, wo=b0.wo.qtensor, w_gateup=b0.w_gateup.qtensor,
                   w_down=b0.w_down.qtensor, lm_head=model.lm_head.qtensor)
    for M in (16, 32, 40):
        total = 0.0
        for name, qt in weights.items():
            K, N = qt.K_logical, qt.shape[1]
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            form = qgemv_form(M, False, qt)
            e = rel_err(qmatmul(a, qt), qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False))
            check(e <= 2e-2, f"verify matmul {name} M={M}: rel err {e:.3e} > 2e-2")
            ms = timer(lambda: qmatmul(a, qt), iters=5)
            plain_ms = timer(lambda: qmatmul(a, qt, use_kernel=False), iters=2, warmup=1)
            b = bound(qt.bytes_packed() + nbytes(a) + 2 * M * N, 2 * M * K * N)
            total += ms * (1 if name == "lm_head" else cfg.num_layers)
            print(f"verify matmul {name} K={K} N={N} M={M} ({form}): op {ms:.4f} ms "
                  f"({qt.bytes_packed() / ms / 1e6:.1f} GB/s packed), plain {plain_ms:.4f} ms, "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, rel err {e:.2e}; library: "
                  f"none exists", flush=True)
        res[f"matmul_ms_M{M}"] = total
        print(f"verify matmul at M={M}: the 129 projections of a 32-layer forward sum to "
              f"{total:.3f} ms of op time", flush=True)

    # (b) on a 2-layer cut, each cache form: the unaligned write (T appends a
    # layer) byte-equal to its plain version, prefill attention at T = 5, and
    # the verify forward's logits within rel 2e-2 of the plain path.  Slots at
    # positions 0-3 mod 4 around live 1000, one chain across S, one into a page
    # of -1 (paged), slot 7 inactive.
    cut = two_layer_cut(model)
    lens = torch.tensor([1000, 1001, 1002, 1003, 1022, 2045, 999, 998], device=dev)
    active = torch.tensor([True] * 7 + [False], device=dev)
    pos = torch.where(active[:, None], lens[:, None] + torch.arange(T, device=dev), S)
    pos = pos.clamp(max=S)
    held = (lens + T).clamp(max=S)
    held[4] = 1024  # slot 4's chain 1022..1026 runs into its page 4, which it does not hold
    valid = pos < S
    tokens = torch.randint(0, cfg.vocab_size, (B, T), device=dev, generator=gen)
    rows = [torch.randn(B, T, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    q = torch.randn(B, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
    slots = torch.arange(B, device=dev)
    s_idx = torch.arange(S, device=dev)
    for int8 in (False, True):
        if int8:
            linear = list(packed_cache(gen, 2, B, Hkv, S, D))
        else:
            linear = [torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
                      for _ in range(2)]
        for paged in (False, True):
            kind = ("paged " if paged else "") + ("int8" if int8 else "bf16")
            table, parts = synth.cut_pages(gen, linear, S // 256, held) if paged else (None, linear)
            names = ("k", "v", "k_scale", "v_scale")[: len(parts)]

            def make():
                return llama.KVCache(**dict(zip(names, (t.clone() for t in parts))),
                                     lengths=lens.to(torch.int32), page_table=table)

            a, b = make(), make()
            common.reset_counts()
            for li in range(2):
                llama._write_unaligned(a, li, *rows, pos, use_kernel=True)
            name = "kv_append" + ("_packed" if int8 else "") + ("_paged" if paged else "")
            launched = {k: n for k, n in common.launches.items() if n}
            check(launched == {name: 2 * T}, f"unaligned write ({kind}): launches {launched}")
            for li in range(2):
                llama._write_unaligned(b, li, *rows, pos, use_kernel=False)
            same = all(torch.equal(getattr(a, n), getattr(b, n)) for n in names)
            check(same, f"unaligned write ({kind}): the cache differs from the plain write's")
            # timed as the verify runs it, inside a CUDA graph: eagerly its ~100
            # small PyTorch ops (the int8 rows' quantization) outlast the Timer's
            # head start, and the host's time to queue them would be counted
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                llama._write_unaligned(a, 0, *rows, pos, use_kernel=True)
            ms = timer(graph.replay)
            del graph
            plain_ms = timer(lambda: llama._write_unaligned(b, 0, *rows, pos, use_kernel=False),
                             iters=3)
            n_rows = int(valid.sum()) * Hkv * D  # elements of k (or v) written
            if paged:
                ok, blk, row = paged_rows(table, slots, pos, 256, parts[0].shape[1])
            else:
                ok, blk, row = valid, slots[:, None].expand_as(pos), pos
            ok = ok & valid
            n_rows = int(ok.sum()) * Hkv * D
            library_ms = None
            if not int8:  # one index_put_ of the rows for k, one for v (no call writes a byte
                # of a packed word)
                h = torch.arange(Hkv, device=dev)
                idx = (blk[ok][:, None], h[None, :], row[ok][:, None])
                kr, vr = rows[0][ok], rows[1][ok]
                library_ms = timer(lambda: (b.k[0].index_put_(idx, kr), b.v[0].index_put_(idx, vr)))
            wb = bound(2 * n_rows * 2 + 2 * n_rows * (1 if int8 else 2)
                       + (2 * 2 * n_rows // D if int8 else 0), 0)
            lib = "none exists" if library_ms is None else f"(2 index_put_) {library_ms:.4f} ms"
            print(f"unaligned write ({kind}), one layer, {T} appends of B={B} Hkv={Hkv}: "
                  f"byte-equal to plain {same}, op {ms:.4f} ms (a graph replay), plain "
                  f"{plain_ms:.4f} ms, library {lib}, bound {wb['bound_ms']:.5f} ms by "
                  f"{wb['bound_by']}", flush=True)
            res[f"write_{kind}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **wb)

            # prefill attention at T = 5 queries a slot, after the write (layer 0)
            scales = dict(k_scale=a.k_scale, v_scale=a.v_scale) if int8 else {}
            got = prefill_attention(q, a.k, a.v, pos, slots, layer_idx=0, page_table=table,
                                    **scales)
            sc0 = (a.k_scale[0], a.v_scale[0]) if int8 else (None, None)
            ref = prefill_attention_reference(q, a.k[0], a.v[0], pos, slots, *sc0,
                                              page_table=table)
            e = (got.float() - ref.float()).abs().max().item()
            check(e <= 2e-2, f"prefill attention T={T} ({kind}): abs err {e:.3e} > 2e-2")
            ms = timer(lambda: prefill_attention(q, a.k, a.v, pos, slots, layer_idx=0,
                                                 page_table=table, **scales))
            plain_ms = timer(lambda: prefill_attention_reference(
                q, a.k[0], a.v[0], pos, slots, *sc0, page_table=table), iters=3)
            kc, vc = a.k[0], a.v[0]
            if paged:
                kc, vc = gather_pages(kc, table), gather_pages(vc, table)
                if int8:
                    kd = _unpack_kv_words(kc, gather_pages(a.k_scale[0], table, scales=True))
                    vd = _unpack_kv_words(vc, gather_pages(a.v_scale[0], table, scales=True))
            elif int8:
                kd, vd = _unpack_kv_words(kc, a.k_scale[0]), _unpack_kv_words(vc, a.v_scale[0])
            if not int8:
                kd, vd = kc, vc
            kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
            mask = (s_idx[None, None] <= pos[:, :, None])[:, None] & valid[:, None, :, None]
            qh = q.transpose(1, 2)
            lib = sdpa(qh, kd, vd, mask).transpose(1, 2)
            check((lib[valid].float() - ref[valid].float()).abs().max().item() <= 2e-2,
                  "the SDPA yardstick differs from the plain prefill attention")
            library_ms = timer(lambda: sdpa(qh, kd, vd, mask))
            del kd, vd, mask, lib
            seen = int(((pos + 1) * valid).sum())  # keys each valid query attends
            span = int(torch.where(valid, pos + 1, 0).amax(dim=1).sum())  # rows read a head
            cache_bytes = 2 * span * Hkv * D * (1 if int8 else 2) + (4 * span * Hkv if int8 else 0)
            pb = bound(cache_bytes + nbytes(q, got), 4 * H * D * seen)
            print(f"prefill_attention ({kind}) N={B} T={T} H={H} Hkv={Hkv} S={S}, live ~1000: "
                  f"max abs err {e:.2e}, op {ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA, "
                  f"boolean mask, rows as bf16) {library_ms:.4f} ms, bound {pb['bound_ms']:.4f} "
                  f"ms by {pb['bound_by']}", flush=True)
            res[f"prefill_T5_{kind}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **pb)
            del got, ref

            # the verify forward of the cut, kernels against the plain path
            a, b = make(), make()
            la, _ = cut(tokens, a, pos, kv_unaligned=True)
            lb, _ = cut(tokens, b, pos, kv_unaligned=True, use_kernel=False)
            check(torch.isfinite(la.float()).all().item(), "non-finite verify logits")
            # a query at S (an inactive slot, a chain's tail past S) is padding: the
            # kernel returns zeros for it, the eager path attends every row
            e = rel_err(la[valid], lb[valid])
            print(f"verify forward, 2 layers, {kind} cache, T={T}: logits rel err {e:.2e} "
                  f"(kernels vs plain)", flush=True)
            check(e <= 2e-2, f"verify forward ({kind}) logits rel err {e:.3e} > 2e-2")
            check(a.lengths.tolist() == b.lengths.tolist(), f"verify forward ({kind}): lengths")
            del a, b, la, lb
        del linear, parts
        torch.cuda.empty_cache()
    del timer

    # (c) the engine at full depth, 8 slots: the copy-model (its greedy stream is
    # the cycle 0..7, so speculative and plain tokens must be equal), then the
    # random model of the phases before, then pipelined bursts
    launches = dict.fromkeys(common.launches, 0)

    def run(eng, reqs, label):
        """One run of the phase's main path: the counts set to 0 just before
        and read just after."""
        common.reset_counts()
        out = eng.generate(reqs)
        for k, n in common.launches.items():
            launches[k] += n
        got = {k: n for k, n in common.launches.items() if n}
        check(not any(common.plain_on_cuda.values()),
              f"{label}: plain versions ran on the card: {common.plain_on_cuda}")
        return out, got, graph_rates(eng, label)

    def spec_line(eng, rates, label, plain_rates):
        st = eng.spec_stats
        prog = eng._programs["spec"].launches
        gain = rates["tok_s"] / plain_rates["tok_s"]
        print(f"{label}: acceptance {st['accepted']}/{st['drafted']} = "
              f"{st['accepted'] / st['drafted']:.3f}; {rates['tok_s']:.1f} tokens/s, "
              f"{rates['ms_step']:.2f} ms a verify step, device {rates['device_ms_step']:.3f} ms a "
              f"replayed step ({rates['replays']:.0f} replays, capture "
              f"{rates['capture_s']:.2f} s); plain graph decode (bursts of 8) "
              f"{plain_rates['tok_s']:.1f} tokens/s, {plain_rates['ms_step']:.2f} ms/step "
              f"({gain:.2f}x); a replay launches {sum(prog.values())}: {prog}", flush=True)

    cp = synth.copy_llama_params(torch.Generator(device=dev).manual_seed(SEED), cfg, 4, 128,
                                 period=8)
    lengths = np.linspace(16, 500, 8).astype(int)
    creqs = [Request(prompt=[(j + i) % 8 for i in range(n)], max_new_tokens=64)
             for j, n in enumerate(lengths)]
    copies = {}
    for kv_quant in (False, True):
        cache = "int8" if kv_quant else "bf16"
        plain, _, plain_rates = run(Engine(cp, cfg, slots=8, decode_burst=8, kv_quant=kv_quant),
                                    creqs, f"copy-model, {cache} cache, plain")
        check(all(follows_cycle(c, r.prompt, 8) and len(c.tokens) == 64
                  for c, r in zip(plain, creqs)), f"copy-model ({cache}): not the cycle")
        eng = Engine(cp, cfg, slots=8, spec_tokens=4, kv_quant=kv_quant)
        out, got, rates = run(eng, creqs, f"copy-model, {cache} cache, spec γ=4")
        check([c.tokens for c in out] == [c.tokens for c in plain],
              f"copy-model ({cache}): speculative tokens differ from plain greedy")
        rate = eng.spec_stats["accepted"] / eng.spec_stats["drafted"]
        check(rate >= 0.9, f"copy-model ({cache}): acceptance {rate:.3f} < 0.9")
        path = ["qgemv_mma", "prefill_attention", "kv_append_packed" if kv_quant else "kv_append"]
        check(all(got.get(k, 0) > 0 for k in path), f"spec ({cache}): launches {got}")
        spec_line(eng, rates, f"copy-model, {cache} cache, n-gram spec γ=4", plain_rates)
        prog = eng._programs["spec"].launches
        copies[cache] = dict(rates=rates, plain=plain_rates, rate=rate, launches=prog,
                             tokens=[c.tokens for c in plain])
        # the same requests with each verify step eager: equal tokens, and one
        # eager step launches what a replay counts
        eng._eager = True
        try:
            eager = eng.generate(creqs)
            eager_rates = dict(eng.loop_stats)
            eng._act_in.zero_()
            common.reset_counts()
            eng._spec()
            torch.cuda.synchronize()
        finally:
            eng._eager = False
        per_step = {k: n for k, n in common.launches.items() if n}
        check([c.tokens for c in eager] == [c.tokens for c in out],
              f"copy-model ({cache}): graph and eager speculative tokens differ")
        check(per_step == prog, f"spec ({cache}): a replay counts {prog}, an eager step "
              f"launches {per_step}")
        print(f"copy-model, {cache} cache: eager verify steps "
              f"{1e3 * eager_rates['decode'] / eager_rates['decode_steps']:.2f} ms/step, tokens "
              f"equal to the graph's", flush=True)
        del eng
    # the verify step at γ = 1 and 3 (M = 16 and 32) beside γ = 4 (M = 40)
    verify = {4: copies["bf16"]["rates"]}
    for g in (1, 3):
        eng = Engine(cp, cfg, slots=8, spec_tokens=g, kv_quant=False)
        out, _, verify[g] = run(eng, creqs, f"copy-model, spec γ={g}")
        check([c.tokens for c in out] == copies["bf16"]["tokens"],
              f"copy-model, γ={g}: speculative tokens differ from plain greedy")
        spec_line(eng, verify[g], f"copy-model, bf16 cache, n-gram spec γ={g}",
                  copies["bf16"]["plain"])
        del eng
    # the draft model: a 2-layer cut of the copy-model, its chain in the graph
    eng = Engine(cp, cfg, slots=8, spec_tokens=4, kv_quant=False, draft_params=two_layer_cut(cp))
    out, got, rates = run(eng, creqs, "copy-model, draft model")
    check([c.tokens for c in out] == copies["bf16"]["tokens"],
          "copy-model with the draft model: tokens differ from plain greedy")
    check(got.get("decode_attention", 0) > 0 and got.get("kv_append_fused", 0) > 0,
          f"the draft chain launched {got}")
    spec_line(eng, rates, "copy-model, bf16 cache, draft-model spec γ=4 (2-layer cut)",
              copies["bf16"]["plain"])
    copies["draft"] = dict(rates=rates, rate=eng.spec_stats["accepted"] / eng.spec_stats["drafted"])
    del eng
    # pipelined bursts with sampled requests admitted while other slots decode:
    # the sampled graph is captured with bursts in flight, and the continuing
    # slots must still chain from their newest burst (top_k=1: on the
    # copy-model a sampled row is the greedy one, so every stream is the cycle)
    mreqs = [Request(prompt=[(j + i) % 8 for i in range(n)], max_new_tokens=16 + 8 * j)
             for j, n in enumerate(lengths)]
    mreqs += [Request(prompt=[(j + i) % 8 for i in range(40)], max_new_tokens=24,
                      temperature=0.8) for j in range(4)]
    for depth in (0, 1, 2):
        eng = Engine(cp, cfg, slots=8, decode_burst=8, kv_quant=False, top_k=1, pipeline=depth)
        out, _, _ = run(eng, mreqs, f"copy-model, greedy and sampled, pipeline={depth}")
        check(eng.loop_stats["graph_captures"] == 2,
              f"pipeline={depth}, greedy and sampled: {eng.loop_stats['graph_captures']:.0f} "
              f"captures, not 2")
        check(all(follows_cycle(c, r.prompt, 8) and len(c.tokens) == r.max_new_tokens
                  for c, r in zip(out, mreqs)),
              f"pipeline={depth}, greedy and sampled: a stream left the cycle")
        if depth == 0:
            mixed = out
        check([c.tokens for c in out] == [c.tokens for c in mixed],
              f"pipeline={depth}, greedy and sampled: tokens differ from pipeline=0")
        del eng
    print("copy-model, 8 greedy requests then 4 sampled (top_k=1) admitted mid-flight: "
          "pipeline=0, 1 and 2 each capture both graphs, every stream the cycle, tokens "
          "equal", flush=True)
    del cp
    torch.cuda.empty_cache()

    # random weights: acceptance near 0, and pipelined bursts on the same requests
    rng = np.random.default_rng(SEED + 9)
    rreqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=32)
             for n in lengths]
    pipe = {}
    for depth in (0, 1, 2):
        eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=False, pipeline=depth)
        pout, _, pipe[depth] = run(eng, rreqs, f"pipeline={depth}")
        if depth == 0:
            sync = pout
        check([c.tokens for c in pout] == [c.tokens for c in sync],
              f"pipeline={depth}: tokens differ from the synchronous engine's")
        del eng
    print(f"pipelined bursts, random 7B, bf16 cache, bursts of 8: tokens/s "
          f"{ {d: round(r['tok_s'], 1) for d, r in pipe.items()} }, ms/step "
          f"{ {d: round(r['ms_step'], 3) for d, r in pipe.items()} }, device ms a replayed step "
          f"{ {d: round(r['device_ms_step'], 3) for d, r in pipe.items()} }; tokens equal to "
          f"pipeline=0", flush=True)
    eng = Engine(model, cfg, slots=8, spec_tokens=4, kv_quant=False)
    out, _, rates = run(eng, rreqs, "random weights, spec γ=4")
    equal = sum(a == b for c, d in zip(out, sync) for a, b in zip(c.tokens, d.tokens))
    spec_line(eng, rates, "random 7B, bf16 cache, n-gram spec γ=4", pipe[0])
    print(f"random 7B, spec against plain greedy: {equal} of {sum(len(c.tokens) for c in sync)} "
          f"tokens equal (the verify rounds otherwise than one-row decode: near-ties may part)",
          flush=True)
    res.update(copies=copies, verify=verify, pipe=pipe, random=dict(
        rates=rates, rate=eng.spec_stats["accepted"] / eng.spec_stats["drafted"]))
    del eng
    torch.cuda.empty_cache()
    return launches, res


def phase_dense_caches(dev, model):
    """Phase 13: Llama-2-7B at full width and depth over the fp16 and f32 KV
    caches (8 slots, S=2048, bursts of 8 replayed as graphs): the copy-model's
    requests on bf16, f32 and fp16 caches (tokens the cycle and equal across
    the three), eager against graph bursts, a paged pool, γ=4 speculation
    linear and paged; the random model's 2-layer cut block by block against
    the plain path; and each cache's replayed step at 8 x 1000 live positions
    beside ``decode_roofline``'s bound."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.utils import synth
    from xbitops_tpu_torch.utils.profiling import decode_roofline, replayed

    t_phase = time.perf_counter()
    cfg = model.cfg
    launches = dict.fromkeys(common.launches, 0)
    caches = (("bf16", torch.bfloat16), ("f32", torch.float32), ("f16", torch.float16))

    def run(eng, reqs, label):
        """One run of the phase's main path: the counts set to 0 just before
        and read just after."""
        common.reset_counts()
        out = eng.generate(reqs)
        for k, n in common.launches.items():
            launches[k] += n
        check(not any(common.plain_on_cuda.values()),
              f"{label}: plain versions ran on the card: {common.plain_on_cuda}")
        check(all(len(c.tokens) == r.max_new_tokens for c, r in zip(out, reqs)),
              f"{label}: a request stopped short")
        return out, {k: n for k, n in common.launches.items() if n}

    # (a), (c), (d), (e): the copy-model (its greedy stream is the cycle 0..7)
    cp = synth.copy_llama_params(torch.Generator(device=dev).manual_seed(SEED + 13), cfg, 4, 128,
                                 period=8)
    lengths = [int(n) for n in np.linspace(16, 500, 8)] + [1500]  # the last in 3 chunks
    reqs = [Request(prompt=[(j + i) % 8 for i in range(n)], max_new_tokens=32)
            for j, n in enumerate(lengths)]
    kw = dict(slots=8, kv_quant=False, prefill_chunk=512)
    pool = dict(paged=True, page_size=256, pool_pages=24)
    res, tokens = {}, None
    for kind, dtype in caches:
        label = f"phase 13, copy-model, {kind} cache"
        sfx = "" if dtype == torch.bfloat16 else "_" + kind
        eng = Engine(cp, cfg, decode_burst=8, cache_dtype=dtype, **kw)
        check(eng.cache.k.dtype == dtype, f"{label}: the cache is {eng.cache.k.dtype}")
        out, got = run(eng, reqs, label)
        check(all(follows_cycle(c, r.prompt, 8) for c, r in zip(out, reqs)),
              f"{label}: not the cycle")
        tokens = tokens or [c.tokens for c in out]
        check([c.tokens for c in out] == tokens, f"{label}: tokens differ from the bf16 cache's")
        check(eng.loop_stats["chunks"] == 3, f"{label}: {eng.loop_stats['chunks']} chunks, want 3")
        path = ("qgemv", "qgemv_mma", "decode_attention" + sfx, f"kv_append{sfx}_fused",
                "prefill_attention" + sfx)
        check(all(got.get(k, 0) > 0 for k in path), f"{label}: launches {got}")
        if dtype == torch.bfloat16:  # phase 2 holds the bf16 graphs to eager bursts
            rates = graph_rates(eng, label)
            del eng
            res[kind] = dict(rates=rates)
            continue
        rates = against_eager(eng, reqs, out, label)  # (c): the graph run's rates
        check(rates["captures"] > 0, f"{label}: no graph captured")
        del eng
        torch.cuda.empty_cache()
        # (d) a pool of 24 pages of 256 for 8 slots
        eng = Engine(cp, cfg, decode_burst=8, cache_dtype=dtype, **kw, **pool)
        pout, got = run(eng, reqs, label + ", paged")
        check([c.tokens for c in pout] == tokens, f"{label}, paged: tokens differ from linear")
        check(sorted(eng._free_pages) == list(range(24)), f"{label}, paged: pages not back")
        path = (f"decode_attention{sfx}_paged", f"kv_append{sfx}_paged_fused",
                f"prefill_attention{sfx}_paged")
        check(all(got.get(k, 0) > 0 for k in path), f"{label}, paged: launches {got}")
        prates = graph_rates(eng, label + ", paged")
        waits = eng.loop_stats["admission_waits"]
        del eng
        torch.cuda.empty_cache()
        # (e) n-gram speculation, γ = 4: the verify's rows through #4, attention through #9
        spec = {}
        for paged in (False, True):
            slabel = f"{label}, spec γ=4" + (", paged" if paged else "")
            eng = Engine(cp, cfg, spec_tokens=4, cache_dtype=dtype, **kw, **(pool if paged else {}))
            sout, got = run(eng, reqs, slabel)
            check([c.tokens for c in sout] == tokens, f"{slabel}: tokens differ from plain")
            rate = eng.spec_stats["accepted"] / eng.spec_stats["drafted"]
            check(rate >= 0.9, f"{slabel}: acceptance {rate:.3f} < 0.9")
            p = "_paged" if paged else ""
            check(got.get(f"kv_append{sfx}{p}", 0) > 0 and got.get(f"prefill_attention{sfx}{p}", 0)
                  > 0, f"{slabel}: launches {got}")
            spec["paged" if paged else "linear"] = dict(rates=graph_rates(eng, slabel), rate=rate)
            del eng
            torch.cuda.empty_cache()
        print(f"{label}: tokens the cycle and equal to the bf16 cache's, linear, paged ({waits:.0f} "
              f"admission waits) and under γ=4 (acceptance {spec['linear']['rate']:.3f} / "
              f"{spec['paged']['rate']:.3f} paged); replayed device {rates['device_ms_step']:.3f} "
              f"ms/step (paged {prates['device_ms_step']:.3f}), {rates['tok_s']:.1f} tokens/s; "
              f"verify {spec['linear']['rates']['device_ms_step']:.3f} ms a replayed step",
              flush=True)
        res[kind] = dict(rates=rates, paged=prates, spec=spec, waits=waits)
    del cp
    torch.cuda.empty_cache()

    # (b) the random model's 2-layer cut, block by block against the plain path on
    # the same cache: a chunk forward of 5 rows of 512 at positions 512-1023, then
    # one decode step of 8 slots
    cut = two_layer_cut(model)
    rng = np.random.default_rng(SEED + 13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (5, 1024))).to(dev)
    slots = torch.arange(5, device=dev)
    positions = 512 + torch.arange(512, device=dev)[None].expand(5, 512)
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    vis = torch.arange(cfg.max_seq_len, device=dev)[None, None] <= positions[:, :, None]
    for kind, dtype in caches[1:]:
        a = llama.KVCache.init(cut.cfg, 8, dev, dtype=dtype)
        llama.prefill_slots_chunk(cut, toks[:, :512], torch.zeros(5, device=dev),
                                  torch.full((5,), 1024, device=dev), slots, a,
                                  resets=torch.ones(5, dtype=torch.bool, device=dev))
        b = clone_cache(a)
        x = cut.embed[toks[:, 512:]].to(torch.bfloat16)
        chunk_errs = []
        for li, block in enumerate(cut.blocks):
            got = block(x, positions, rope, a, li, None, slots, flash_prefill=True)
            want = block(x, positions, rope, b, li, vis, slots, use_kernel=False)
            check(torch.isfinite(got.float()).all().item(), f"block {li}: non-finite output")
            chunk_errs.append(rel_err(got, want))
            x = got
        a.lengths[:5] = 1024
        step_errs = block_errs(cut, torch.cat([toks[:, -1], toks[:3, 0]]), a)
        worst = max(chunk_errs + step_errs)
        print(f"phase 13, 2-layer cut, {kind} cache, kernels vs plain on the same cache: chunk "
              f"forward 5 x 512 blocks rel err {[f'{e:.2e}' for e in chunk_errs]}, decode step "
              f"blocks {[f'{e:.2e}' for e in step_errs]}", flush=True)
        check(worst <= 2e-2, f"{kind} cache, 2-layer cut: a block's rel err {worst:.3e} > 2e-2")
        res[kind]["block_err"] = worst
        del a, b

    # each cache's decode step at 8 slots of 1000 live positions, replayed
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 8)).to(dev)
    for kind, dtype in caches:
        cache = llama.KVCache.init(cfg, 8, dev, dtype=dtype)

        def step():
            cache.lengths.fill_(1000)
            llama.decode_step(model, tok, cache)

        rep = replayed(step)  # a graph of 8 steps, as the engine replays a burst
        ms = rep["event_ms"]
        r = decode_roofline(model, cfg, 8, 1000, measured_ms=ms,
                            dtype_bytes=torch.finfo(dtype).bits // 8)
        print(f"phase 13, random 7B decode step, {kind} cache, 8 slots x 1000 live, replayed: "
              f"{ms:.3f} ms ({r}); device {rep['device_ms']:.3f} ms busy {rep['busy']:.2f}, "
              f"largest kernels {rep['top']}", flush=True)
        res[kind]["live1000"] = dict(ms=ms, bound_ms=r.bound_ms, cache_gb=r.cache_bytes / 1e9,
                                     device_ms=rep["device_ms"], busy=rep["busy"])
        del cache
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {res['phase_s']:.1f} s", flush=True)
    return launches, res


def model_bytes(model) -> int:
    """Device bytes of a model's buffers (its resident weights)."""
    return sum(t.numel() * t.element_size() for t in model.buffers())


def moe_block_errs(model, tokens, cache=None):
    """Each MoE block through the kernels and through the plain versions on
    the same input (the kernel path's output of the block before), with the
    routes each path's router gives the same block input: one decode step
    (``tokens`` [B], on clones of ``cache``) or a chunk forward (``tokens``
    [N, T]: N fresh prompts from position 0 into slots 0..N-1 of new caches;
    the kernel path attends through the prefill-attention kernel, the plain
    one eagerly over the slots' rows), as :func:`block_errs`.  A token whose
    top-k experts differ between the paths is excluded from its block's rel
    err, and allowed only at a near-tie: the plain path's k-th and (k+1)-th
    router logits within 2e-2 of the token's largest logit, which is as far
    as the router's input may move between the paths (the blocks' bf16
    gate).  Returns each block's rel err and the counts of tokens routed
    alike and of tokens in all."""
    from xbitops_tpu_torch.models import llama, moe

    cfg = model.cfg
    k = cfg.experts_per_token
    dev = tokens.device
    if tokens.dim() == 1:
        a, b = clone_cache(cache, cfg.num_layers), clone_cache(cache, cfg.num_layers)
        positions = cache.lengths[:, None].long()
        x = model.embed[tokens.long()][:, None].to(torch.bfloat16)
        kernel_kw, plain_kw = {}, {}
    else:
        N, T = tokens.shape
        a, b = (llama.KVCache.init(cfg, N, dev) for _ in range(2))
        positions = torch.arange(T, device=dev)[None].expand(N, T)
        x = model.embed[tokens.long()].to(torch.bfloat16)
        slots = torch.arange(N, device=dev)
        mask = torch.arange(a.S, device=dev)[None, None] <= positions[:, :, None]
        kernel_kw = dict(slot_ids=slots, flash_prefill=True)
        plain_kw = dict(slot_ids=slots, mask=mask)
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    errs, alike, total = [], 0, 0
    for li, block in enumerate(model.blocks):
        seen = []
        hook = block.moe.register_forward_hook(lambda mod, inp, out: seen.append(inp[0]))
        try:
            got = block(x, positions, rope, a, li, **{"mask": None, **kernel_kw})
            want = block(x, positions, rope, b, li, **{"mask": None, **plain_kw},
                         use_kernel=False)
        finally:
            hook.remove()
        check(torch.isfinite(got.float()).all().item(), f"block {li}: non-finite output")
        router = block.moe.router
        routes = [moe.route(h.reshape(-1, h.shape[-1]), router, k)[0].sort(dim=1).values
                  for h in seen]
        same = (routes[0] == routes[1]).all(dim=1)
        logits = seen[1].reshape(-1, seen[1].shape[-1]).float() @ router.float()
        top = logits.topk(k + 1, dim=1).values
        gap = (top[:, k - 1] - top[:, k]) / logits.abs().amax(dim=1)
        flips = (~same).nonzero()[:, 0].tolist()
        check(all(gap[n].item() <= 2e-2 for n in flips),
              f"block {li}: a route flipped away from a near-tie (gaps {gap[~same].tolist()})")
        g, w = got.reshape(-1, got.shape[-1])[same], want.reshape(-1, want.shape[-1])[same]
        errs.append(rel_err(g, w))
        alike += int(same.sum())
        total += same.numel()
        x = got
    return errs, alike, total


def phase_mixtral(dev):
    """Phase 10a: Mixtral-8x7B (``MoeConfig.mixtral_like``, no-drop) at full
    width and depth, random packed 4-bit g=128 weights: serving on 8 slots in
    bursts of 8 on the bf16 and the int8 cache (graph tokens equal eager),
    n-gram speculation (γ=4) on its copy-model form (tokens equal plain
    greedy), each MoE block of a 2-layer cut against the plain path."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models.moe import MoeConfig
    from xbitops_tpu_torch.utils import synth

    cfg = MoeConfig.mixtral_like(capacity_factor=None)
    t0 = time.perf_counter()
    model = synth.random_moe_params(cfg, bits=4, group_size=128, device=dev, seed=SEED)
    torch.cuda.synchronize()
    resident = model_bytes(model)
    experts = sum(model_bytes(b.moe) for b in model.blocks)
    print(f"Mixtral-8x7B (32 layers, 8 experts top-2 of ffn 14336, 32/8 heads of 128, vocab "
          f"32000, no-drop) built in {time.perf_counter() - t0:.1f} s: {resident / 1e9:.2f} GB "
          f"resident ({experts / 1e9:.2f} GB of experts)", flush=True)
    check(20e9 < resident < 30e9, f"Mixtral resident bytes {resident}")
    launches = dict.fromkeys(common.launches, 0)
    rng = np.random.default_rng(SEED)
    lengths = np.linspace(16, 500, 8).astype(int)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=32)
            for n in lengths]

    def run(eng, reqs, label):
        common.reset_counts()
        out = eng.generate(reqs)
        for k, n in common.launches.items():
            launches[k] += n
        check(not any(common.plain_on_cuda.values()),
              f"{label}: plain versions ran on the card: {common.plain_on_cuda}")
        check(all(len(c.tokens) == r.max_new_tokens for c, r in zip(out, reqs)),
              f"{label}: a request was cut short")
        return out, {k: n for k, n in common.launches.items() if n}

    res = {}
    for kv_quant in (False, True):
        label = f"Mixtral, {'int8' if kv_quant else 'bf16'} cache"
        eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=kv_quant, seed=SEED)
        out, got = run(eng, reqs, label)
        for name in (INT8_PATH if kv_quant else BF16_PATH):
            if name != "prefill_attention":  # bucketed admission attends eagerly here
                check(got.get(name, 0) > 0, f"{label}: kernel {name} was not launched")
        st = dict(eng.loop_stats)
        rates = against_eager(eng, reqs, out, label)
        per_step = {k: n / eng.decode_burst for k, n in eng._programs[True].launches.items()}
        # the step's bound: every packed weight (all experts run at no-drop) and
        # the live k/v rows of the last step read once
        kv = sum(len(r.prompt) + 31 for r in reqs) * cfg.num_layers * cfg.num_kv_heads \
            * cfg.head_dim * 2 * (1 + 2 / cfg.head_dim if kv_quant else 2)
        b = bound(resident - model.embed.numel() * 2 + kv, 0)
        print(f"{label}: admission {st['admit_prefill']:.2f} s ({st['admit_rows']:.0f} padded "
              f"rows); decode {rates['ms_step']:.2f} ms/step, {rates['tok_s']:.1f} tokens/s, "
              f"device {rates['device_ms_step']:.3f} ms a replayed step against a bound of "
              f"{b['bound_ms']:.3f} ms (weights and live k/v once); launches a step "
              f"{per_step}", flush=True)
        res["int8" if kv_quant else "bf16"] = dict(rates=rates, bound_ms=b["bound_ms"],
                                                   per_step=per_step,
                                                   admit_s=st["admit_prefill"])
        if not kv_quant:  # the 2-layer cut, each MoE block against the plain path
            tokens = torch.tensor([c.tokens[-1] for c in out], device=dev)
            cut = two_layer_cut(model)
            errs, alike, total = moe_block_errs(cut, tokens, eng.cache)
            print(f"Mixtral decode step, 2-layer cut, each block on the same input, kernels vs "
                  f"plain: rel err {[f'{x:.2e}' for x in errs]} over the tokens routed alike; "
                  f"routes agree for {alike} of {total} tokens ({alike / total:.3f})", flush=True)
            check(max(errs) <= 2e-2, f"Mixtral block rel err {max(errs):.3e} > 2e-2")
            res["routes"] = (alike, total)
            res["block_err"] = max(errs)
            # a chunk forward of 5 x 512: every expert at C = 2560 rows (the tile)
            chunk = torch.randint(0, cfg.vocab_size, (5, 512), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(SEED))
            common.reset_counts()
            errs, alike, total = moe_block_errs(cut, chunk)
            # the kernel path: q|k|v, wo and every expert's two on the tile, and
            # the prefill-attention kernel, in each of the 2 blocks
            check(common.launches["qgemv_mma"] == 2 * (2 + 2 * cfg.n_experts)
                  and common.launches["prefill_attention"] == 2,
                  f"Mixtral chunk forward: launches {dict(common.launches)}")
            print(f"Mixtral chunk forward of 5 x 512, 2-layer cut, each block on the same input, "
                  f"kernels vs plain: rel err {[f'{x:.2e}' for x in errs]} over the tokens routed "
                  f"alike; routes agree for {alike} of {total} tokens ({alike / total:.4f})",
                  flush=True)
            check(max(errs) <= 2e-2, f"Mixtral chunk block rel err {max(errs):.3e} > 2e-2")
            res["chunk_routes"] = (alike, total)
            res["chunk_block_err"] = max(errs)
            del cut
        del eng
        torch.cuda.empty_cache()

    # speculative decoding on the copy-model form of the same model (its greedy
    # stream is the cycle 0..7, so the verify's other rounding cannot part it)
    synth.make_copy_model(model, torch.Generator(device=dev).manual_seed(SEED), period=8)
    creqs = [Request(prompt=[(j + i) % 8 for i in range(n)], max_new_tokens=32)
             for j, n in enumerate(lengths)]
    plain_eng = Engine(model, cfg, slots=8, decode_burst=8, kv_quant=False)
    plain, _ = run(plain_eng, creqs, "Mixtral copy-model, plain")
    plain_rates = graph_rates(plain_eng, "Mixtral copy-model, plain")
    check(all(follows_cycle(c, r.prompt, 8) for c, r in zip(plain, creqs)),
          "Mixtral copy-model: not the cycle")
    del plain_eng
    eng = Engine(model, cfg, slots=8, spec_tokens=4, kv_quant=False)
    out, got = run(eng, creqs, "Mixtral copy-model, spec γ=4")
    check([c.tokens for c in out] == [c.tokens for c in plain],
          "Mixtral: speculative tokens differ from plain greedy")
    rates = graph_rates(eng, "Mixtral copy-model, spec γ=4")
    st = eng.spec_stats
    rate = st["accepted"] / st["drafted"]
    prog = eng._programs["spec"].launches
    print(f"Mixtral copy-model, n-gram spec γ=4: tokens equal plain greedy; acceptance "
          f"{st['accepted']}/{st['drafted']} = {rate:.3f}; {rates['tok_s']:.1f} tokens/s, "
          f"{rates['ms_step']:.2f} ms a verify step, device {rates['device_ms_step']:.3f} ms a "
          f"replayed step; plain graph decode {plain_rates['tok_s']:.1f} tokens/s, "
          f"{plain_rates['ms_step']:.2f} ms/step, device {plain_rates['device_ms_step']:.3f} ms; "
          f"a verify replay launches {prog}", flush=True)
    check(rate >= 0.5, f"Mixtral copy-model: acceptance {rate:.3f}")
    res["spec"] = dict(rates=rates, plain=plain_rates, rate=rate, launches=prog)
    # phase 11b holds expert parallelism to these one-rank tokens
    res["copy"] = dict(prompts=[r.prompt for r in creqs], tokens=[c.tokens for c in plain])
    del eng
    want = cfg.num_layers * (2 + 2 * cfg.n_experts) + 1  # no-drop: every expert, 16 rows
    res["step16"] = step16(model, cfg, dev, "Mixtral", want)
    del model
    torch.cuda.empty_cache()
    return launches, res


def phase_gptq(dev):
    """Phase 10b: a structured dense model at Llama-2-7B widths cut to 2
    layers (cycle 8) through ``write_hf_dense_checkpoint``, CLI ``quantize``
    (4-bit g=128, 16 structured rows of 512) and ``generate``; the identity
    Hessian against round-to-nearest at 4096x12288; dense against quantized
    NLL on held-out structured text; n-gram speculation on the quantized
    model."""
    import contextlib
    import io
    import re
    import tempfile
    from pathlib import Path

    from xbitops_tpu_torch import cli
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops import gptq
    from xbitops_tpu_torch.ops.quantize import quantize_array
    from xbitops_tpu_torch.utils import structured
    from xbitops_tpu_torch.utils.evaluate import sequence_nll

    res = {}
    # identity Hessian == round-to-nearest, bit for bit, on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = torch.randn((4096, 12288), generator=gen, device=dev) * 0.02
    t0 = time.perf_counter()
    qt = gptq.gptq_quantize_array(w, torch.eye(4096, device=dev), 4, 128)
    torch.cuda.synchronize()
    t_eye = time.perf_counter() - t0
    rtn = quantize_array(w, 4, 128)
    exact = (all(torch.equal(a, b) for a, b in zip(qt.planes, rtn.planes))
             and torch.equal(qt.scales, rtn.scales) and torch.equal(qt.scale_zeros, rtn.scale_zeros))
    print(f"GPTQ with an identity Hessian at 4096x12288 on the card: equal to round-to-nearest "
          f"bit for bit: {exact} (solver {t_eye:.2f} s)", flush=True)
    check(exact, "GPTQ with an identity Hessian differs from round-to-nearest")
    del w, qt, rtn

    cycle = 8
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=2)
    root = Path(__file__).resolve().parent
    launches = dict.fromkeys(common.launches, 0)
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        dense_dir, packed = Path(tmp) / "dense", Path(tmp) / "packed"
        t0 = time.perf_counter()
        dense = structured.structured_dense_params(cfg, cycle=cycle, seed=SEED, device=dev)
        structured.write_hf_dense_checkpoint(dense, cfg, str(dense_dir))
        t_write = time.perf_counter() - t0
        calib = structured.structured_calib_tokens(cfg, cycle, n_rows=16, seq_len=512)
        np.save(Path(tmp) / "calib.npy", calib)
        held = torch.from_numpy(structured.structured_calib_tokens(cfg, cycle, 4, 64,
                                                                   seed=7)).to(dev)
        nll_d = float(sequence_nll(dense, held).mean())
        del dense
        torch.cuda.empty_cache()
        buf, err = io.StringIO(), io.StringIO()
        common.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            check(cli.main(["quantize", "--ckpt", str(dense_dir), "--out", str(packed),
                            "--bits", "4", "--group-size", "128", "--seq-len", "512",
                            "--calib-npy", str(Path(tmp) / "calib.npy"),
                            "--device", dev.type]) == 0, "cli quantize failed")
        t_quant = time.perf_counter() - t0
        for k, n in common.launches.items():
            launches[k] += n
        check(common.launches["qgemv_mma"] > 0, "quantize: the calibration forward ran no tile")
        solver = [x for x in err.getvalue().splitlines() if x.startswith("gptq solver")]
        print(f"structured dense model at Llama-2-7B widths cut to 2 layers (cycle {cycle}): "
              f"built on the card and written (f32 safetensors) in {t_write:.1f} s; `quantize` "
              f"(4-bit g=128, 16x512 structured calibration rows) {t_quant:.1f} s; "
              f"{'; '.join(solver)}", flush=True)
        start = 21
        args = ["generate", "--ckpt", str(packed), "--prompt", str(start), "--max-tokens", "16",
                "--slots", "1", "--device", dev.type]
        buf = io.StringIO()
        common.reset_counts()
        with contextlib.redirect_stdout(buf):
            check(cli.main(args) == 0, "cli generate failed")
        for k, n in common.launches.items():
            launches[k] += n
        m = re.search(r"\[0\] \[(.*)\]", buf.getvalue())
        printed = [int(t) for t in m.group(1).split(", ")] if m else []
        want = [int(t) for t in structured.successor_stream(start, 16, cycle)]
        print(f"`generate` on the quantized model from {start}: {printed} (the walk: "
              f"{printed == want})", flush=True)
        check(printed == want, f"the quantized model does not walk its cycle: {printed}")
        qmodel = load_llama(str(packed), cfg, device=dev)
        nll_q = float(sequence_nll(qmodel, held).mean())
        print(f"held-out structured text (4x64): dense NLL {nll_d:.4f}, quantized NLL "
              f"{nll_q:.4f} (gate: dense < 0.1, quantized < dense + 0.05)", flush=True)
        check(nll_d < 0.1, f"the dense structured model at 4096 wide does not walk: {nll_d:.4f}")
        check(nll_q < nll_d + 0.05, f"quantized NLL {nll_q:.4f} vs dense {nll_d:.4f}")
        prompts = [list(range(16 + 8 * j, 24 + 8 * j)) * 2 + list(range(16 + 8 * j, 19 + 8 * j))
                   for j in range(8)]
        reqs = [Request(prompt=p, max_new_tokens=32, id=i) for i, p in enumerate(prompts)]
        plain = Engine(qmodel, cfg, slots=8, kv_quant=False).generate(reqs)
        eng = Engine(qmodel, cfg, slots=8, spec_tokens=4, kv_quant=False)
        common.reset_counts()
        out = eng.generate(reqs)
        for k, n in common.launches.items():
            launches[k] += n
        check([c.tokens for c in out] == [c.tokens for c in plain],
              "quantized structured model: speculative tokens differ from plain greedy")
        st = eng.spec_stats
        rate = st["accepted"] / st["drafted"]
        walks = all(c.tokens == list(structured.successor_stream(p[-1], 32, cycle))
                    for c, p in zip(out, prompts))
        print(f"quantized structured model, n-gram spec γ=4 on 8 slots: tokens equal plain "
              f"greedy, the walk {walks}; acceptance {st['accepted']}/{st['drafted']} = "
              f"{rate:.3f}", flush=True)
        check(rate > 0.5, f"structured model acceptance {rate:.3f}")
        # prompts of one token: the n-gram draft finds nothing to look up until
        # the walk has come round once, so part of the drafts miss
        reqs1 = [Request(prompt=[16 + 8 * j + j % 8], max_new_tokens=32, id=j) for j in range(8)]
        plain1 = Engine(qmodel, cfg, slots=8, kv_quant=False).generate(reqs1)
        eng1 = Engine(qmodel, cfg, slots=8, spec_tokens=4, kv_quant=False)
        out1 = eng1.generate(reqs1)
        check([c.tokens for c in out1] == [c.tokens for c in plain1],
              "quantized structured model (1-token prompts): speculative tokens differ")
        st1 = eng1.spec_stats
        rate1 = st1["accepted"] / st1["drafted"]
        print(f"the same with prompts of one token (the draft has no history for the first "
              f"cycle): tokens equal plain greedy; acceptance {st1['accepted']}/{st1['drafted']} "
              f"= {rate1:.3f}", flush=True)
        res.update(nll_d=nll_d, nll_q=nll_q, rate=rate, rate1=rate1, t_quant=t_quant,
                   solver=solver, t_write=t_write)
        del eng1
        del qmodel, eng
        torch.cuda.empty_cache()
    return launches, res


def write_autogptq_mixtral(path, cfg, layers: int, rng) -> None:
    """:func:`write_autogptq`'s Mixtral twin: a random AutoGPTQ Mixtral
    checkpoint (4-bit, g=128, "gptq" format) at ``cfg``'s widths with
    ``layers`` layers: attention and each expert's w1/w2/w3 packed, the router
    (``block_sparse_moe.gate``) and the lm_head dense fp16."""
    import json as _json
    from pathlib import Path

    from safetensors import numpy as st_np

    h, ffn, g = cfg.hidden_size, cfg.intermediate_size, 128
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    tensors = {}

    def packed(name, k, n):
        scale = k ** -0.5 / 4.6
        tensors[f"{name}.qweight"] = rng.integers(0, 2**32, (k // 8, n),
                                                  dtype=np.uint32).view(np.int32)
        tensors[f"{name}.qzeros"] = np.full((k // g, n // 8), 0x77777777, np.int32)
        tensors[f"{name}.scales"] = rng.uniform(0.8 * scale, 1.2 * scale,
                                                (k // g, n)).astype(np.float16)
        tensors[f"{name}.g_idx"] = (np.arange(k) // g).astype(np.int32)

    for i in range(layers):
        pre = f"model.layers.{i}"
        for name, k, n in (("q_proj", h, qdim), ("k_proj", h, kvdim), ("v_proj", h, kvdim),
                           ("o_proj", qdim, h)):
            packed(f"{pre}.self_attn.{name}", k, n)
        tensors[f"{pre}.block_sparse_moe.gate.weight"] = (
            rng.standard_normal((cfg.n_experts, h), dtype=np.float32) * h ** -0.5
        ).astype(np.float16)
        for e in range(cfg.n_experts):
            ep = f"{pre}.block_sparse_moe.experts.{e}"
            packed(f"{ep}.w1", h, ffn)
            packed(f"{ep}.w3", h, ffn)
            packed(f"{ep}.w2", ffn, h)
        tensors[f"{pre}.input_layernorm.weight"] = np.ones(h, np.float16)
        tensors[f"{pre}.post_attention_layernorm.weight"] = np.ones(h, np.float16)
    tensors["model.embed_tokens.weight"] = (
        rng.standard_normal((cfg.vocab_size, h), dtype=np.float32) * 0.02).astype(np.float16)
    tensors["model.norm.weight"] = np.ones(h, np.float16)
    tensors["lm_head.weight"] = (
        rng.standard_normal((cfg.vocab_size, h), dtype=np.float32) * h ** -0.5).astype(np.float16)
    p = Path(path)
    st_np.save_file(tensors, str(p / "model.safetensors"))
    (p / "config.json").write_text(_json.dumps(dict(
        model_type="mixtral", vocab_size=cfg.vocab_size, hidden_size=h, intermediate_size=ffn,
        num_hidden_layers=layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, max_position_embeddings=2048,
        num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.experts_per_token)))
    (p / "quantize_config.json").write_text(_json.dumps(dict(bits=4, group_size=g,
                                                              desc_act=False)))


def phase_mixtral_loader(dev):
    """Phase 10c: a random AutoGPTQ Mixtral checkpoint at full widths cut to
    1 layer through CLI ``convert`` and ``generate``; the logits of the loaded
    model equal, bit for bit, those of the same weights built directly
    (``formats.from_gptq`` per tensor, ``moe.stack_experts``), and
    ``generate``'s tokens equal an ``Engine`` on that model."""
    import contextlib
    import io
    import re
    import tempfile
    from pathlib import Path

    from safetensors import numpy as st_np

    from xbitops_tpu_torch import cli, formats
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.io.gptq_loader import llama_config_from_hf
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.models.moe import MoeConfig, stack_experts

    cfg = MoeConfig.mixtral_like(capacity_factor=None, num_layers=1)
    rng = np.random.default_rng(SEED)
    root = Path(__file__).resolve().parent
    launches = dict.fromkeys(common.launches, 0)
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        src, packed = Path(tmp) / "autogptq", Path(tmp) / "packed"
        src.mkdir()
        t0 = time.perf_counter()
        write_autogptq_mixtral(src, cfg, 1, rng)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["convert", "--ckpt", str(src), "--out", str(packed), "--device",
                            dev.type]) == 0, "cli convert (Mixtral) failed")
        t_convert = time.perf_counter() - t0
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (16, 90, 300)]
        args = ["generate", "--ckpt", str(packed), "--max-tokens", "8", "--slots", "4",
                "--device", dev.type]
        for p in prompts:
            args += ["--prompt", " ".join(map(str, p))]
        buf = io.StringIO()
        common.reset_counts()
        with contextlib.redirect_stdout(buf):
            check(cli.main(args) == 0, "cli generate (Mixtral) failed")
        for k, n in common.launches.items():
            launches[k] += n
        lines = [re.fullmatch(r"\[(\d+)\] \[(.*)\] \((\w+)\)", x)
                 for x in buf.getvalue().splitlines()]
        check(len(lines) == len(prompts) and all(lines), f"generate printed {buf.getvalue()}")
        printed = [[int(t) for t in m.group(2).split(", ")] for m in lines]

        # the same weights built directly, tensor by tensor
        t = st_np.load_file(str(src / "model.safetensors"))
        hf = json.loads((src / "config.json").read_text())
        lcfg = llama_config_from_hf(hf)

        def g(name):
            return torch.from_numpy(t[name]).to(dev)

        def qt(prefix, k):
            return formats.from_gptq(g(f"{prefix}.qweight"), g(f"{prefix}.scales"),
                                     g(f"{prefix}.qzeros"), 4, 128, k, add_zero_bias=1)

        h, ffn = cfg.hidden_size, cfg.intermediate_size
        pre = "model.layers.0"
        wqkv = formats.concat_qtensors([qt(f"{pre}.self_attn.{n}_proj", h) for n in "qkv"])
        gus = [formats.concat_qtensors([qt(f"{pre}.block_sparse_moe.experts.{e}.w1", h),
                                        qt(f"{pre}.block_sparse_moe.experts.{e}.w3", h)])
               for e in range(cfg.n_experts)]
        downs = [qt(f"{pre}.block_sparse_moe.experts.{e}.w2", ffn) for e in range(cfg.n_experts)]
        proj = dict(wqkv=wqkv, wo=qt(f"{pre}.self_attn.o_proj", cfg.num_heads * cfg.head_dim),
                    router=g(f"{pre}.block_sparse_moe.gate.weight").T.float().contiguous(),
                    w_experts_gateup=stack_experts(gus), w_experts_down=stack_experts(downs))
        block = llama.LlamaBlock(lcfg, proj, g(f"{pre}.input_layernorm.weight").float(),
                                 g(f"{pre}.post_attention_layernorm.weight").float())
        direct = llama.Llama(lcfg, g("model.embed_tokens.weight").to(torch.bfloat16), [block],
                             g("model.norm.weight").float(),
                             g("lm_head.weight").T.to(torch.bfloat16).contiguous())
        loaded = load_llama(str(packed), lcfg, device=dev)
        toks = torch.tensor([p[:16] for p in prompts], device=dev)
        la, _ = llama.prefill(loaded, toks, llama.KVCache.init(lcfg, 3, dev))
        lb, _ = llama.prefill(direct, toks, llama.KVCache.init(lcfg, 3, dev))
        check(torch.equal(la, lb), "the converted Mixtral's logits differ from the direct build's")
        eng_out = Engine(direct, lcfg, slots=4).generate(
            [Request(prompt=p, max_new_tokens=8, id=i) for i, p in enumerate(prompts)])
        check(printed == [c.tokens for c in eng_out],
              "generate's tokens differ from an Engine on the direct build")
        print(f"AutoGPTQ Mixtral checkpoint at full widths cut to 1 layer (8 experts, random "
              f"4-bit g=128, dense fp16 router and lm_head): written in {t_write:.1f} s, "
              f"`convert` {t_convert:.1f} s; logits of the converted model equal the direct "
              f"build's bit for bit; `generate`'s tokens equal an Engine on it", flush=True)
        del loaded, direct, block, proj, gus, downs, t
        torch.cuda.empty_cache()
    return launches, dict(t_write=t_write, t_convert=t_convert)


# --- phase 11: tensor and expert parallelism, two ranks on the one card ---
#
# Each rank is a process of its own (``parallel.multihost.spawn``, start method
# "spawn": the children import this file as a module, so ``main`` does not run
# in them) on cuda:0.  Two ranks on one card are a gloo world: NCCL refuses two
# ranks on one GPU, and gloo takes CUDA tensors for ``all_reduce``, the only
# collective the port uses.  So every collective goes through the host, and no
# time below is a tensor-parallel speed.  Rank 0 writes what it measured, and
# each rank its launch counts of the main path's run, to files the parent
# reads.

TP_LABEL = "two ranks sharing one H100, collectives through the host by gloo: not a TP speed"


def _rank_json(path, rank: int, name: str, obj) -> None:
    from pathlib import Path

    (Path(path) / f"{name}_rank{rank}.json").write_text(json.dumps(obj))


def _rank_device() -> torch.device:
    """The device ``multihost.initialize`` gave this rank."""
    return torch.device("cuda", torch.cuda.current_device())


def _read_ranks(path, name: str, n: int = 2) -> list:
    from pathlib import Path

    return [json.loads((Path(path) / f"{name}_rank{r}.json").read_text()) for r in range(n)]


def _tp_requests():
    """8 greedy requests for the copy-model: prompts of 16-500 tokens on the
    cycle (the period-8 copy-model continues any prompt by its successor)."""
    from xbitops_tpu_torch.engine import Request

    lengths = np.linspace(16, 500, 8).astype(int)
    return [Request(prompt=[(j + i) % 8 for i in range(n)], max_new_tokens=32, id=j)
            for j, n in enumerate(lengths)]


def _tp_block_errs(full, shard, prompts, dev):
    """The tp=1 model and this rank's tp=2 shard prefill the same prompts into
    caches of their own (8 slots), then one decode step block by block: each
    block of both on the same input (the tp=1 block's output of the block
    before) and its own cache.  Returns each block's rel err, on every rank
    (the shard's blocks run their collectives)."""
    from xbitops_tpu_torch.models import llama

    cfg = full.cfg
    n, T = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros((n, T), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p, device=dev)
    lens, slots = torch.tensor([len(p) for p in prompts], device=dev), torch.arange(n, device=dev)
    caches, logits = [], []
    for m in (full, shard):
        cache = llama.KVCache.init(m.cfg, n, dev)
        logits.append(llama.prefill_slots(m, tokens, lens, slots, cache)[0])
        caches.append(cache)
    nxt = logits[0].argmax(-1)
    positions = caches[0].lengths[:, None].long()
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    x = full.embed[nxt][:, None].to(torch.bfloat16)
    errs = []
    for li in range(cfg.num_layers):
        want = full.blocks[li](x, positions, rope, caches[0], li, None)
        got = shard.blocks[li](x, positions, rope, caches[1], li, None)
        check(torch.isfinite(got.float()).all().item(), f"tp block {li}: non-finite output")
        errs.append(rel_err(got, want))
        x = want
    return errs


def _tp_rank(rank: int, out_dir: str) -> None:
    """One rank of phase 11a (see :func:`phase_tp`)."""
    from xbitops_tpu_torch.engine import Engine
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import model_tp
    from xbitops_tpu_torch.parallel.mesh import make_mesh
    from xbitops_tpu_torch.utils import synth

    dev = _rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 2))
    cfg = llama.LlamaConfig.llama2_7b()
    res = {}
    # (1) the copy-model at full width and depth: tp=2 against tp=1, tokens equal
    t0 = time.perf_counter()
    copy = synth.copy_llama_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    packed = model_tp.pack_for_tp(copy, 2)
    eng = Engine(packed, cfg, slots=8, decode_burst=8, mesh=mesh, kv_quant=False)
    del packed
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    reqs = _tp_requests()
    common.reset_counts()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = dict(common.launches)
    st = dict(eng.loop_stats)
    check(not any(common.plain_on_cuda.values()), f"tp=2: plain versions ran on the card")
    check(st.get("graph_captures", 0) == 0, "tp=2: a mesh engine captured a graph")
    check(eng.cache.k.shape[2] == cfg.num_kv_heads // 2, "tp=2: the cache holds all kv heads")
    check(all(len(c.tokens) == 32 and follows_cycle(c, r.prompt, 8) for c, r in zip(out, reqs)),
          "tp=2 copy-model: not the cycle")
    # a rank's launches in one decode step (every slot inactive: it writes nothing)
    common.reset_counts()
    llama.decode_step(eng.model, torch.zeros(8, dtype=torch.int32, device=dev), eng.cache,
                      active=torch.zeros(8, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    res.update(tokens=[c.tokens for c in out], ms_step=1e3 * st["decode"] / st["decode_steps"],
               tok_s=st["decode_tokens"] / st["decode"], admit_s=st["admit_prefill"],
               per_step={k: n for k, n in common.launches.items() if n})
    del eng
    torch.cuda.empty_cache()
    if rank == 0:  # the tp=1 engine on the same weights (graphs, as it serves)
        one = Engine(copy, cfg, slots=8, decode_burst=8, kv_quant=False).generate(reqs)
        res["one_tokens"] = [c.tokens for c in one]
        torch.cuda.synchronize()
    del copy
    torch.cuda.empty_cache()
    # (2) the random model: a 2-layer cut's decode logits and each of the 32
    # blocks at tp=2 against tp=1
    full = synth.random_llama_params(cfg, bits=4, group_size=128, device=dev, seed=SEED)
    shard = model_tp.shard_params(model_tp.pack_for_tp(full, 2), mesh)
    gen = np.random.default_rng(SEED)
    prompts = [gen.integers(0, cfg.vocab_size, n).tolist()
               for n in np.linspace(40, 300, 8, dtype=int)]
    res["block_errs"] = _tp_block_errs(full, shard, prompts, dev)
    cut1, cut2 = two_layer_cut(full), two_layer_cut(shard)
    lg = []
    for m in (cut1, cut2):
        cache = llama.KVCache.init(m.cfg, 8, dev)
        tokens = torch.tensor([p[:40] for p in prompts], device=dev)
        llama.prefill(m, tokens, cache)
        lg.append(llama.decode_step(m, tokens[:, -1], cache)[0])
    res["cut_err"] = rel_err(lg[1], lg[0])
    del full, shard, cut1, cut2
    torch.cuda.empty_cache()
    _rank_json(out_dir, rank, "tp_launches", launches)
    if rank == 0:
        _rank_json(out_dir, rank, "tp", res)


def _ep_rank(rank: int, out_dir: str, prompts, want_tokens) -> None:
    """One rank of phase 11b (see :func:`phase_ep`)."""
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama, moe
    from xbitops_tpu_torch.parallel.mesh import make_mesh
    from xbitops_tpu_torch.utils import synth

    dev = _rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("expert",))
    cfg = moe.MoeConfig.mixtral_like(capacity_factor=None)
    El = cfg.n_experts // 2
    mine = range(rank * El, (rank + 1) * El)
    res = {}
    # (1) the copy-model form of phase 10a's Mixtral, this rank's 4 experts only
    t0 = time.perf_counter()
    model = synth.random_moe_params(cfg, bits=4, group_size=128, device=dev, seed=SEED,
                                    experts=mine)
    synth.make_copy_model(model, torch.Generator(device=dev).manual_seed(SEED), period=8,
                          experts=mine)
    ep = moe.shard_experts(model, mesh)
    torch.cuda.synchronize()
    res.update(build_s=time.perf_counter() - t0, resident=model_bytes(model))
    n, T = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros((n, -(-T // 16) * 16), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p, device=dev)
    cache = llama.KVCache.init(cfg, n, dev)
    common.reset_counts()
    t0 = time.perf_counter()
    logits, _ = moe.ep_prefill_slots(ep, cfg, mesh, tokens, torch.tensor([len(p) for p in prompts],
                                     device=dev), torch.arange(n, device=dev), cache)
    torch.cuda.synchronize()
    res["prefill_s"] = time.perf_counter() - t0
    got = [[t] for t in logits.argmax(-1).tolist()]
    t0 = time.perf_counter()
    for _ in range(len(want_tokens[0]) - 1):
        tok = torch.tensor([g[-1] for g in got], device=dev)
        logits, _ = moe.ep_decode_step(ep, cfg, mesh, tok, cache)
        for g, t in zip(got, logits.argmax(-1).tolist()):
            g.append(t)
    torch.cuda.synchronize()
    res["decode_ms_step"] = 1e3 * (time.perf_counter() - t0) / (len(want_tokens[0]) - 1)
    launches = dict(common.launches)
    check(not any(common.plain_on_cuda.values()), "ep=2: plain versions ran on the card")
    res["tokens_equal"] = got == want_tokens
    check(got == want_tokens, "ep=2: the copy-model's tokens differ from one rank's")
    del model, ep, cache
    torch.cuda.empty_cache()
    # (2) a 2-layer cut with all 8 experts on each rank: the ep=2 blocks against
    # one rank's, block by block on the same input
    cut_cfg = dataclasses.replace(cfg, num_layers=2)
    full = synth.random_moe_params(cut_cfg, bits=4, group_size=128, device=dev, seed=SEED + 1)
    ep = moe.shard_experts(full, mesh)
    res["block_errs"], res["routes"] = _ep_block_errs(full, ep, dev)
    _rank_json(out_dir, rank, "ep_launches", launches)
    if rank == 0:
        _rank_json(out_dir, rank, "ep", res)


def _ep_block_errs(full, ep, dev):
    """One decode step after an admission of 8 prompts of 64 tokens, block by
    block: the ep=2 block and the one-rank block on the same input (the
    one-rank output of the block before), each on its own cache.  A token's
    routes are the same on both (the router reads the same input); the rel err
    is over all tokens.  Returns the errs and (tokens routed alike, tokens)."""
    from xbitops_tpu_torch.models import llama, moe

    cfg = full.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), device=dev, generator=gen)
    caches, logits = [], []
    for m in (full, ep):
        cache = llama.KVCache.init(cfg, 8, dev)
        logits.append(llama.prefill(m, tokens, cache)[0])
        caches.append(cache)
    positions = caches[0].lengths[:, None].long()
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    x = full.embed[logits[0][:, -1].argmax(-1)][:, None].to(torch.bfloat16)
    errs, alike, total = [], 0, 0
    for li in range(cfg.num_layers):
        seen = []
        hooks = [m.blocks[li].moe.register_forward_hook(lambda mod, i, o: seen.append(i[0]))
                 for m in (full, ep)]
        try:
            want = full.blocks[li](x, positions, rope, caches[0], li, None)
            got = ep.blocks[li](x, positions, rope, caches[1], li, None)
        finally:
            for h in hooks:
                h.remove()
        routes = [moe.route(h.reshape(-1, h.shape[-1]), full.blocks[li].moe.router,
                            cfg.experts_per_token)[0].sort(dim=1).values for h in seen]
        same = (routes[0] == routes[1]).all(dim=1)
        check(torch.isfinite(got.float()).all().item(), f"ep block {li}: non-finite output")
        errs.append(rel_err(got.reshape(-1, got.shape[-1])[same],
                            want.reshape(-1, want.shape[-1])[same]))
        alike, total = alike + int(same.sum()), total + same.numel()
        x = want
    return errs, (alike, total)


def phase_tp(dev, rng):
    """Phase 11a: Llama-2-7B (full width and depth) at tensor parallelism 2,
    two gloo ranks on the one card (:func:`_tp_rank`): (a) the copy-model
    packed for tp=2 (``model_tp.pack_for_tp``), each rank ``Engine(mesh=)``
    with its shard (eager bursts, half the kv heads) serving 8 greedy
    requests, tokens equal to the tp=1 engine's; (b) the random 4-bit model:
    a 2-layer cut's decode logits and each of the 32 blocks within rel 2e-2 of
    tp=1; (c) an AutoGPTQ checkpoint at 7B widths cut to 2 layers through
    ``python -m xbitops_tpu_torch convert --tp 2`` and ``generate --tp 2`` (two
    ranks the command starts), tokens equal to ``generate`` at tp=1."""
    import re
    import tempfile
    from pathlib import Path

    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import multihost

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        multihost.spawn(_tp_rank, 2, args=(tmp,))
        res = _read_ranks(tmp, "tp", 1)[0]
        launches = _read_ranks(tmp, "tp_launches")
    check(res["tokens"] == res["one_tokens"], "tp=2: the copy-model's tokens differ from tp=1")
    errs = res["block_errs"]
    print(f"7B tp=2 ({TP_LABEL}): copy-model, 8 requests of 16-500 prompt tokens, 32 new each, "
          f"Engine(mesh=) bursts of 8 (eager): tokens equal the tp=1 engine's; decode "
          f"{res['ms_step']:.2f} ms/step, {res['tok_s']:.1f} tokens/s, admission "
          f"{res['admit_s']:.2f} s; a rank's launches a step {res['per_step']}; random model: "
          f"2-layer cut decode logits rel {res['cut_err']:.2e}, blocks rel max {max(errs):.2e} "
          f"(first {errs[0]:.2e}, last {errs[-1]:.2e})", flush=True)
    check(res["cut_err"] <= 2e-2, f"tp=2 2-layer cut rel err {res['cut_err']:.3e} > 2e-2")
    check(max(errs) <= 2e-2, f"tp=2 block rel err {max(errs):.3e} > 2e-2")

    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_layers=2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (16, 90, 300, 700)]
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        src = Path(tmp) / "autogptq"
        src.mkdir()
        write_autogptq(src, cfg, 2, rng)

        def cli(*args):
            proc = subprocess.run([sys.executable, "-m", "xbitops_tpu_torch", *args],
                                  capture_output=True, text=True, timeout=600, cwd=root)
            check(proc.returncode == 0, f"cli {args[0]} failed: {proc.stderr[-2000:]}")
            return proc.stdout

        t0 = time.perf_counter()
        cli("convert", "--ckpt", str(src), "--out", f"{tmp}/packed_tp2", "--tp", "2")
        t_convert = time.perf_counter() - t0
        # S = 960 keeps tp=1 on the bf16 cache, which a mesh engine always takes
        gen = ["--max-tokens", "16", "--slots", "8", "--max-seq-len", "960"]
        for p in prompts:
            gen += ["--prompt", " ".join(map(str, p))]
        t0 = time.perf_counter()
        two = cli("generate", "--ckpt", f"{tmp}/packed_tp2", "--tp", "2", *gen)
        t_generate = time.perf_counter() - t0
        one = cli("generate", "--ckpt", str(src), *gen)
    lines = [[re.fullmatch(r"\[(\d+)\] \[(.*)\] \((\w+)\)", x) for x in out.splitlines()]
             for out in (two, one)]
    check(all(len(ls) == len(prompts) and all(ls) for ls in lines),
          f"cli generate printed {two!r} and {one!r}")
    toks = [[[int(t) for t in m.group(2).split(", ")] for m in ls] for ls in lines]
    same = sum(a == b for x, y in zip(*toks) for a, b in zip(x, y))
    print(f"AutoGPTQ 7B widths cut to 2 layers: `convert --tp 2` {t_convert:.1f} s, `generate "
          f"--tp 2` (2 ranks it starts) of 4 prompts of 16-700 tokens {t_generate:.1f} s; tokens "
          f"equal to `generate` at tp=1: {same} of {sum(map(len, toks[1]))}", flush=True)
    check(toks[0] == toks[1], "generate --tp 2 printed other tokens than tp=1")
    res.update(t_convert=t_convert, t_generate=t_generate, phase_s=time.perf_counter() - t_phase)
    return launches, res


def phase_ep(dev, copy):
    """Phase 11b: Mixtral-8x7B at expert parallelism 2 (4 experts a rank, each
    rank builds only its own: ``random_moe_params(experts=)``), two gloo ranks
    on the one card (:func:`_ep_rank`): (a) phase 10a's copy-model form through
    ``ep_prefill_slots`` and ``ep_decode_step``, 8 prompts of 16-500 tokens and
    31 decode steps, tokens equal to the one-rank engine's of phase 10a; (b) a
    2-layer cut: each MoE block at ep=2 within rel 2e-2 of one rank's over the
    tokens routed alike."""
    import tempfile
    from pathlib import Path

    from xbitops_tpu_torch.parallel import multihost

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        multihost.spawn(_ep_rank, 2, args=(tmp, copy["prompts"], copy["tokens"]))
        res = _read_ranks(tmp, "ep", 1)[0]
        launches = _read_ranks(tmp, "ep_launches")
    errs, (alike, total) = res["block_errs"], res["routes"]
    print(f"Mixtral-8x7B ep=2 ({TP_LABEL}): a rank holds 4 of 8 experts, "
          f"{res['resident'] / 1e9:.2f} GB, built in {res['build_s']:.1f} s; copy-model, 8 "
          f"prompts of 16-500 tokens, 32 tokens each through ep_prefill_slots "
          f"({res['prefill_s']:.2f} s) and ep_decode_step ({res['decode_ms_step']:.1f} ms a "
          f"step, eager): tokens equal one rank's; 2-layer cut, ep=2 against one rank block by "
          f"block: rel {[f'{x:.2e}' for x in errs]}, routes alike {alike}/{total}", flush=True)
    check(max(errs) <= 2e-2, f"ep=2 block rel err {max(errs):.3e} > 2e-2")
    res["phase_s"] = time.perf_counter() - t_phase
    return launches, res


# --- phase 12: pipeline and sequence parallelism, two ranks on the one card ---
#
# As phase 11: two spawned gloo ranks on cuda:0.  The ring permute that moves
# a PP stage's hidden state or an SP chunk's keys (``parallel.mesh.ppermute``)
# is an ``all_to_all_single`` through the host, so no time below is a PP or
# SP speed.

PPSP_LABEL = ("two ranks sharing one H100, permutes and sums through the host by gloo: not a "
              "PP/SP speed")


def _padded(prompts, dev):
    """Prompts zero-padded into one batch [n, T], T the next multiple of 16,
    and their lengths."""
    T = -(-max(map(len, prompts)) // 16) * 16
    tokens = torch.zeros((len(prompts), T), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p, device=dev)
    return tokens, torch.tensor([len(p) for p in prompts], device=dev)


def _permute_ms(x, mesh, axis: str) -> float:
    """Mean ms of ``parallel.mesh.ppermute`` of ``x`` over 20 calls."""
    from xbitops_tpu_torch.parallel.mesh import ppermute

    for _ in range(3):
        ppermute(x, mesh, axis)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        x = ppermute(x, mesh, axis)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 20


def _ppsp_rank(rank: int, out_dir: str, want_tokens) -> None:
    """One rank of phase 12 (see :func:`phase_pp_sp`)."""
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import pp, seqpar
    from xbitops_tpu_torch.parallel.mesh import make_mesh
    from xbitops_tpu_torch.utils import synth

    dev = _rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe, seq = make_mesh((2,), ("pipe",)), make_mesh((2,), ("seq",))
    cfg = llama.LlamaConfig.llama2_7b()
    cut_cfg = dataclasses.replace(cfg, num_layers=2)
    res, launches = {}, {}

    def counted(key, fn):
        """A main-path run: the counts set to 0 just before ``fn``, read just after."""
        common.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        check(not any(common.plain_on_cuda.values()),
              f"phase 12 {key}: plain versions ran on the card: {dict(common.plain_on_cuda)}")
        launches[key] = dict(common.launches)
        return out

    # (a) PP: the copy-model at full width and depth, 16 layers a rank: 8
    # prompts admitted in one bucket, then a burst of 32 greedy steps
    t0 = time.perf_counter()
    copy = synth.copy_llama_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    stage = pp.stage_model(copy, pipe)
    del copy
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res.update(pp_build_s=time.perf_counter() - t0, pp_resident=model_bytes(stage))
    prompts = [r.prompt for r in _tp_requests()]
    tokens, lens = _padded(prompts, dev)
    cache = llama.KVCache.init(stage.cfg, len(prompts), dev)
    times = []

    def pp_run():
        t0 = time.perf_counter()
        logits, _ = pp.pp_prefill_slots(stage, cfg, pipe, tokens, lens, cache)
        first = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, _ = pp.pp_decode_burst(stage, cfg, pipe, first, cache, 32)
        torch.cuda.synchronize()
        times.extend((t1 - t0, time.perf_counter() - t1))
        return first, out

    first, out = counted("pp", pp_run)
    res.update(pp_prefill_s=times[0], pp_burst_s=times[1], pp_bucket=tokens.shape[1])
    streams = [[f] + col for f, col in zip(first.tolist(), out.t().tolist())]
    check(all(t == (p + 1) % 8 for s, pr in zip(streams, prompts)
              for p, t in zip([pr[-1]] + s[:-1], s)), "pp=2 copy-model: not the cycle")
    check([s[:32] for s in streams] == want_tokens,
          "pp=2: the copy-model's tokens differ from the one-rank engine's (phase 11a)")
    ln = launches["pp"]
    check(ln.get("decode_attention") == ln.get("kv_append_fused") == 16 * 32 * 2,
          f"pp=2: a stage's burst launched {ln}, want decode attention with the append inside "
          f"once a layer, microbatch and step (1024)")
    res["pp_permute_ms"] = _permute_ms(torch.randn(4, 1, 4096, device=dev).to(torch.bfloat16),
                                       pipe, "pipe")
    del stage, cache
    torch.cuda.empty_cache()

    # a 2-layer cut of the random model, one layer a rank: pp_decode_step
    # against one rank's decode_step on the bf16 and the int8 cache
    cut = synth.random_llama_params(cut_cfg, bits=4, group_size=128, device=dev, seed=SEED)
    cstage = pp.stage_model(cut, pipe)
    rng = np.random.default_rng(SEED)
    ptoks, plens = _padded([rng.integers(0, cfg.vocab_size, n).tolist()
                            for n in np.linspace(40, 300, 8, dtype=int)], dev)
    for quantized in (False, True):
        whole = llama.KVCache.init(cut_cfg, 8, dev, quantized=quantized)
        logits, _ = llama.prefill_slots(cut, ptoks, plens, torch.arange(8, device=dev), whole)
        nxt = logits.argmax(-1).to(torch.int32)
        part = pp.stage_cache(whole, pipe)
        key = "pp_cut_int8" if quantized else "pp_cut"
        got = counted(key, lambda: pp.pp_decode_step(cstage, cut_cfg, pipe, nxt, part)[0])
        want = llama.decode_step(cut, nxt, whole)[0]
        res[key + "_err"] = rel_err(got, want)
        name = "decode_attention_int8" if quantized else "decode_attention"
        check(launches[key].get(name) == 2, f"pp=2 cut: {launches[key]}, want {name} twice")
    del cut, cstage, whole, part
    torch.cuda.empty_cache()

    # (b) SP: the copy-model, 2 prompts of 2048 tokens on the cycle, then 3
    # decode steps on one rank's cache, against one rank's prefill + decode
    copy = synth.copy_llama_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    T = 2048
    stoks = torch.tensor([[(j + i) % 8 for i in range(T)] for j in range(2)], device=dev)
    scfg = dataclasses.replace(cfg, max_seq_len=2 * T)  # room for the decode after

    def decode_after(logits, cache):
        toks = [logits.argmax(-1)]
        for _ in range(3):
            toks.append(llama.decode_step(copy, toks[-1], cache)[0].argmax(-1))
        return torch.stack(toks, 1).tolist()

    def sp_run():
        cache = llama.KVCache.init(scfg, 2, dev)
        t0 = time.perf_counter()
        logits, _ = seqpar.sp_prefill(copy, cfg, seq, stoks, cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return decode_after(logits, cache)

    res["sp_tokens"] = counted("sp", sp_run)
    res["sp_prefill_s"] = times[-1]
    one = llama.KVCache.init(scfg, 2, dev)
    res["sp_one_tokens"] = decode_after(llama.prefill(copy, stoks, one)[0][:, -1], one)
    del copy, one
    torch.cuda.empty_cache()
    res["sp_permute_ms"] = _permute_ms(
        torch.randn(1, 1024, 32, 128, device=dev).to(torch.bfloat16), seq, "seq")

    # 2-layer cuts at T=2048: the random model, and Mistral-7B's widths (32 q
    # heads, 8 kv heads: GQA rep 4) with a window of 512, against one rank
    mistral = dataclasses.replace(llama.LlamaConfig.mistral_7b(), num_layers=2,
                                  max_seq_len=T, sliding_window=512)
    for label, ccfg in (("random", cut_cfg), ("mistral", mistral)):
        m = synth.random_llama_params(ccfg, bits=4, group_size=128, device=dev, seed=SEED)
        toks = torch.randint(0, ccfg.vocab_size, (2, T), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(SEED))
        c1, c2 = (llama.KVCache.init(ccfg, 2, dev) for _ in range(2))
        got = counted(f"sp_{label}", lambda: seqpar.sp_prefill(m, ccfg, seq, toks, c1)[0])
        want = llama.prefill(m, toks, c2)[0][:, -1]
        res[f"sp_{label}_err"] = rel_err(got, want)
        # layer 0's rows come from the same projections: the CPU tests' rtol 5e-2 /
        # atol 3e-2.  Layer 1's carry layer 0's attention, the ring's (f32) against
        # the prefill kernel's (bf16 probabilities), at the 7B widths' magnitudes:
        # they are held, as the logits are, by rel 2e-2 of their largest
        pairs = [(a[li, :2, :, :T], b[li, :2, :, :T]) for a, b in ((c1.k, c2.k), (c1.v, c2.v))
                 for li in range(ccfg.num_layers)]
        res[f"sp_{label}_rows0"] = all(torch.allclose(a.float(), b.float(), rtol=5e-2, atol=3e-2)
                                       for a, b in pairs[::ccfg.num_layers])
        res[f"sp_{label}_rows_rel"] = max(rel_err(a, b) for a, b in pairs)
        res[f"sp_{label}_rows_abs"] = max((a.float() - b.float()).abs().max().item()
                                          for a, b in pairs)
        del m, c1, c2
        torch.cuda.empty_cache()
    _rank_json(out_dir, rank, "ppsp_launches",
               {k: sum(ln[k] for ln in launches.values()) for k in common.launches})
    _rank_json(out_dir, rank, "ppsp_runs", launches)
    if rank == 0:
        _rank_json(out_dir, rank, "ppsp", res)


def phase_pp_sp(dev, want_tokens):
    """Phase 12: Llama-2-7B at pipeline parallelism 2 and at sequence
    parallelism 2, two gloo ranks on the one card (:func:`_ppsp_rank`): (a)
    the copy-model at full width and depth, 16 layers a rank
    (``pp.stage_model``): 8 prompts of 16-500 tokens admitted by
    ``pp_prefill_slots`` in one bucket of 512, then ``pp_decode_burst`` of 32
    greedy steps, tokens equal to phase 11a's one-rank engine's, each stage's
    decode through the decode-attention kernel with the append inside; on a
    2-layer cut of the random model, ``pp_decode_step`` on the bf16 and the
    int8 cache within rel 2e-2 of one rank's ``decode_step``; (b)
    ``sp_prefill`` of 2 prompts of 2048 tokens on the copy-model, then 3
    ``decode_step`` on a rank's cache, tokens equal to one rank's ``prefill``
    and ``decode_step``; on 2-layer cuts of the random model and of a random
    model at Mistral-7B's widths with a window of 512, the logits within rel
    2e-2 of one rank's ``prefill``, layer 0's cache rows within rtol 5e-2 /
    atol 3e-2 and every layer's within rel 2e-2."""
    import tempfile
    from pathlib import Path

    from xbitops_tpu_torch.parallel import multihost

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root, prefix="smoke_ckpt_") as tmp:
        multihost.spawn(_ppsp_rank, 2, args=(tmp, want_tokens))
        res = _read_ranks(tmp, "ppsp", 1)[0]
        launches = _read_ranks(tmp, "ppsp_launches")
        runs = _read_ranks(tmp, "ppsp_runs")[0]
    rounds = 32 * 2 + 1
    res.update(pp_ms_round=1e3 * res["pp_burst_s"] / rounds,
               pp_ms_step=1e3 * res["pp_burst_s"] / 32,
               pp_tok_s=8 * 32 / res["pp_burst_s"])
    print(f"7B pp=2 ({PPSP_LABEL}): a rank holds 16 layers, {res['pp_resident'] / 1e9:.2f} GB, "
          f"built in {res['pp_build_s']:.1f} s; copy-model, 8 prompts of 16-500 tokens in one "
          f"bucket of {res['pp_bucket']} through pp_prefill_slots ({res['pp_prefill_s']:.2f} s), "
          f"pp_decode_burst of 32 steps ({rounds} rounds): {res['pp_ms_round']:.2f} ms a round, "
          f"{res['pp_ms_step']:.2f} ms/step, {res['pp_tok_s']:.1f} tokens/s; tokens equal the "
          f"one-rank engine's; the permute of [4, 1, 4096] bf16 {res['pp_permute_ms']:.3f} ms; "
          f"2-layer cut pp_decode_step against one rank: bf16 rel {res['pp_cut_err']:.2e}, int8 "
          f"rel {res['pp_cut_int8_err']:.2e}; rank 0's launches of the admission and burst "
          f"{ {k: n for k, n in runs['pp'].items() if n} }",
          flush=True)
    print(f"7B sp=2 ({PPSP_LABEL}): copy-model, 2 prompts of 2048 tokens, sp_prefill "
          f"{res['sp_prefill_s']:.2f} s, then 3 decode steps on a rank's cache: tokens "
          f"{[t[:4] for t in res['sp_tokens']]} equal one rank's prefill + decode; the permute of "
          f"[1, 1024, 32, 128] bf16 {res['sp_permute_ms']:.3f} ms; 2-layer cuts against one "
          f"rank's prefill at T=2048: random rel {res['sp_random_err']:.2e} (cache rows rel "
          f"{res['sp_random_rows_rel']:.2e}, max abs {res['sp_random_rows_abs']:.2e}), Mistral-7B "
          f"widths with window 512 rel {res['sp_mistral_err']:.2e} (rows rel "
          f"{res['sp_mistral_rows_rel']:.2e}, max abs {res['sp_mistral_rows_abs']:.2e}); rank 0's "
          f"launches of sp_prefill and the decode after { {k: n for k, n in runs['sp'].items() if n} }",
          flush=True)
    check(res["sp_tokens"] == res["sp_one_tokens"],
          f"sp=2: tokens {res['sp_tokens']} differ from one rank's {res['sp_one_tokens']}")
    for key in ("pp_cut_err", "pp_cut_int8_err", "sp_random_err", "sp_mistral_err",
                "sp_random_rows_rel", "sp_mistral_rows_rel"):
        check(res[key] <= 2e-2, f"phase 12 {key} {res[key]:.3e} > 2e-2")
    check(res["sp_random_rows0"] and res["sp_mistral_rows0"],
          "sp=2: layer 0's cache rows outside rtol 5e-2 / atol 3e-2 of one rank's")
    for key in ("pp", "sp"):
        ln = runs[key]
        check(ln.get("qgemv", 0) > 0 and ln.get("qgemv_mma", 0) > 0
              and ln.get("qgemv_cuda_core", 0) == 0, f"phase 12 {key}: matmul forms {ln}")
    res["phase_s"] = time.perf_counter() - t_phase
    return launches, res


def clone_cache(cache, n_layers=None):
    """A copy of ``cache`` (of its first ``n_layers`` layers), its scales and
    page table included."""
    layered = ("k", "v", "k_scale", "v_scale")
    return dataclasses.replace(cache, **{
        f.name: (t[:n_layers] if f.name in layered else t).clone()
        for f in dataclasses.fields(cache) if (t := getattr(cache, f.name)) is not None})


def block_errs(model, tokens, cache):
    """One decode step, block by block: each block runs through the kernels
    and through the plain versions on the same input (the kernel path's
    output of the block before) and on its own clone of the cache.  Returns
    each block's rel err."""
    from xbitops_tpu_torch.models import llama

    cfg = model.cfg
    a, b = clone_cache(cache, cfg.num_layers), clone_cache(cache, cfg.num_layers)
    positions = cache.lengths[:, None].long()
    rope = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_type,
                             cfg.rope_scaling_factor)
    x = model.embed[tokens.long()][:, None].to(torch.bfloat16)
    errs = []
    for li, block in enumerate(model.blocks):
        got = block(x, positions, rope, a, li, None)
        want = block(x, positions, rope, b, li, None, use_kernel=False)
        check(torch.isfinite(got.float()).all().item(), f"block {li}: non-finite output")
        errs.append(rel_err(got, want))
        x = got
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from xbitops_tpu_torch.kernels import common

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t_start = t0 = time.perf_counter()
    lib_path = common.build()
    common.lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.name}", flush=True)

    timer = Timer(dev)
    res = phase_kernels(dev, timer)
    del timer
    torch.cuda.empty_cache()

    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.utils import synth

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = synth.random_llama_params(cfg, bits=4, group_size=128, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"7B model built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches2, serving = phase_serving(dev, model)
    torch.cuda.empty_cache()
    launches3, long_ctx = phase_long_context(dev, model)
    torch.cuda.empty_cache()
    launches4, w4a8 = phase_w4a8(dev, model)
    torch.cuda.empty_cache()
    launches5, paged = phase_paged(dev, model)
    torch.cuda.empty_cache()
    launches6 = phase_eager_decode(dev, model)
    torch.cuda.empty_cache()
    launches8, entry = phase_entry_points(dev, model)
    torch.cuda.empty_cache()
    launches9, spec = phase_spec(dev, model)
    torch.cuda.empty_cache()
    launches13, dense = phase_dense_caches(dev, model)
    del model
    torch.cuda.empty_cache()
    launches7, three_bit = phase_three_bit(dev, cfg)
    torch.cuda.empty_cache()
    launches10a, mixtral = phase_mixtral(dev)
    launches10b, gptq_res = phase_gptq(dev)
    launches10c, _ = phase_mixtral_loader(dev)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks of phase 11 share the card with this process
    launches11a, tp_res = phase_tp(dev, np.random.default_rng(SEED))
    launches11b, ep_res = phase_ep(dev, mixtral["copy"])
    launches12, ppsp_res = phase_pp_sp(dev, tp_res["one_tokens"])
    print(f"card: {card}; 7B 4-bit decode at B=8: bf16 cache, prompts to 500: "
          f"{serving['ms_step']:.2f} ms/step, {serving['tok_s']:.1f} tokens/s; int8 cache, "
          f"prompts to 1500: {long_ctx['ms_step']:.2f} ms/step, {long_ctx['tok_s']:.1f} tokens/s; "
          f"7B 3-bit decode at B=8, bf16 cache: {three_bit['ms_step']:.2f} ms/step, "
          f"{three_bit['tok_s']:.1f} tokens/s", flush=True)
    rate = {k: w4a8[k]["rows"] / w4a8[k]["admit_s"] for k in ("a", "b", "bf16")}
    print(f"card: {card}; 7B admission, padded prompt rows/s: W4A8 4-bit g=128 {rate['a']:.0f} "
          f"({w4a8['a']['admit_s']:.3f} s), W4A8 8-bit per-channel {rate['b']:.0f} "
          f"({w4a8['b']['admit_s']:.3f} s), bf16 activations on the same requests "
          f"{rate['bf16']:.0f} ({w4a8['bf16']['admit_s']:.3f} s), bf16 activations in phase 2 "
          f"{serving['admit_rows'] / serving['admit_s']:.0f} ({serving['admit_s']:.3f} s); "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    for label, g in (("bf16 cache, prompts to 500 (phase 2)", serving["graphs"]),
                     ("int8 cache, prompts to 1500 (phase 3)", long_ctx["graphs"]),
                     ("paged bf16 pool (phase 5)", paged["bf16"]["graphs"]),
                     ("paged int8 pool (phase 5)", paged["int8"]["graphs"]),
                     ("3-bit, bf16 cache (phase 7)", three_bit["graphs"])):
        print(f"card: {card}; 7B decode at B=8, {label}: graph {g['ms_step']:.2f} ms/step, "
              f"{g['tok_s']:.1f} tokens/s, device {g['device_ms_step']:.3f} ms a replayed step, "
              f"{g['launches_per_replay']} launches a replay of {8} steps, capture "
              f"{g['capture_s']:.2f} s ({g['captures']:.0f}); eager {g['eager_ms_step']:.2f} "
              f"ms/step, {g['eager_tok_s']:.1f} tokens/s", flush=True)
    for kind, st in paged.items():
        pg, ln = st["paged"], st["linear"]
        print(f"card: {card}; 7B paged serving, {kind} pool (24 pages of 256 for 8 slots) against "
              f"the linear cache on the same requests: {pg['ms_step']:.2f} vs {ln['ms_step']:.2f} "
              f"ms/step, {pg['tok_s']:.1f} vs {ln['tok_s']:.1f} tokens/s, admission "
              f"{pg['rows_s']:.0f} vs {ln['rows_s']:.0f} padded rows/s; equal tokens "
              f"{st['equal_tokens']} of {st['tokens']} ({st['equal_tokens_full_pool']} with a pool "
              f"that makes no request wait)", flush=True)

    v, cp = spec["verify"], spec["copies"]
    print(f"card: {card}; 7B verify step, 8 slots, bf16 cache (copy-model), device ms a replayed "
          f"step: γ=1 (M=16) {v[1]['device_ms_step']:.3f}, γ=3 (M=32) {v[3]['device_ms_step']:.3f}"
          f", γ=4 (M=40) {v[4]['device_ms_step']:.3f}, against a plain decode step "
          f"{cp['bf16']['plain']['device_ms_step']:.3f}; the 129 projections of a forward, op ms: "
          f"M=16 {spec['matmul_ms_M16']:.3f}, M=32 {spec['matmul_ms_M32']:.3f}, M=40 "
          f"{spec['matmul_ms_M40']:.3f}; a γ=4 replay launches {cp['bf16']['launches']}",
          flush=True)
    print(f"card: {card}; 7B speculative decoding γ=4, 8 slots, tokens/s against plain graph "
          f"decode in bursts of 8: copy-model bf16 cache {cp['bf16']['rates']['tok_s']:.1f} vs "
          f"{cp['bf16']['plain']['tok_s']:.1f} (acceptance {cp['bf16']['rate']:.3f}), int8 cache "
          f"{cp['int8']['rates']['tok_s']:.1f} vs {cp['int8']['plain']['tok_s']:.1f} (acceptance "
          f"{cp['int8']['rate']:.3f}), draft model (2-layer cut) "
          f"{cp['draft']['rates']['tok_s']:.1f} (acceptance {cp['draft']['rate']:.3f}); random "
          f"weights {spec['random']['rates']['tok_s']:.1f} vs {spec['pipe'][0]['tok_s']:.1f} "
          f"(acceptance {spec['random']['rate']:.3f}); pipeline=0/1/2 on the random model "
          f"{spec['pipe'][0]['tok_s']:.1f} / {spec['pipe'][1]['tok_s']:.1f} / "
          f"{spec['pipe'][2]['tok_s']:.1f} tokens/s; total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    mk = res["mixtral"]
    print(f"card: {card}; Mixtral-8x7B 4-bit g=128, no-drop, decode at B=8 (8 requests, prompts "
          f"16-500, 32 new tokens): bf16 cache {mixtral['bf16']['rates']['ms_step']:.2f} ms/step, "
          f"{mixtral['bf16']['rates']['tok_s']:.1f} tokens/s, device "
          f"{mixtral['bf16']['rates']['device_ms_step']:.3f} ms a replayed step (bound "
          f"{mixtral['bf16']['bound_ms']:.3f}); int8 cache "
          f"{mixtral['int8']['rates']['ms_step']:.2f} ms/step, "
          f"{mixtral['int8']['rates']['tok_s']:.1f} tokens/s, device "
          f"{mixtral['int8']['rates']['device_ms_step']:.3f} ms; eager bf16 "
          f"{mixtral['bf16']['rates']['eager_ms_step']:.2f} ms/step; copy-model spec γ=4 "
          f"{mixtral['spec']['rates']['tok_s']:.1f} tokens/s against "
          f"{mixtral['spec']['plain']['tok_s']:.1f} (acceptance {mixtral['spec']['rate']:.3f}, "
          f"device {mixtral['spec']['rates']['device_ms_step']:.3f} ms a verify step); routes "
          f"alike {mixtral['routes'][0]}/{mixtral['routes'][1]} a decode step, "
          f"{mixtral['chunk_routes'][0]}/{mixtral['chunk_routes'][1]} a chunk forward (blocks "
          f"within rel {mixtral['block_err']:.1e} / {mixtral['chunk_block_err']:.1e}); kernels at "
          f"its shapes, op ms: "
          + ", ".join(f"{n} {v['ms']:.4f} (bound {v['bound_ms']:.4f})" for n, v in mk.items()),
          flush=True)
    print(f"card: {card}; GPTQ at Llama-2-7B widths, 2 layers: `quantize` "
          f"{gptq_res['t_quant']:.1f} s; NLL dense {gptq_res['nll_d']:.4f}, quantized "
          f"{gptq_res['nll_q']:.4f}; spec γ=4 acceptance {gptq_res['rate']:.3f} (prompts of "
          f"one token: {gptq_res['rate1']:.3f}); "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    tk = res["tp"]
    print(f"card: {card}; phase 11 ({TP_LABEL}): 7B tp=2 copy-model decode at B=8 "
          f"{tp_res['ms_step']:.2f} ms/step, {tp_res['tok_s']:.1f} tokens/s (eager bursts); "
          f"Mixtral ep=2 decode {ep_res['decode_ms_step']:.1f} ms a step (eager); phases 11a + "
          f"11b {tp_res['phase_s'] + ep_res['phase_s']:.1f} s; a 7B tp=2 rank's kernels, op ms: "
          + ", ".join(f"{n} {v['ms']:.4f} (bound {v['bound_ms']:.4f}, library "
                      f"{'none exists' if v['library_ms'] is None else round(v['library_ms'], 4)})"
                      for n, v in tk.items())
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)

    mm, pv = res["pp_sp_matmul"], res["pp_view"]
    print(f"card: {card}; phase 12 ({PPSP_LABEL}): 7B pp=2 burst {ppsp_res['pp_ms_round']:.2f} "
          f"ms a round, {ppsp_res['pp_ms_step']:.2f} ms/step, {ppsp_res['pp_tok_s']:.1f} tokens/s; "
          f"sp=2 prefill of 2 x 2048 {ppsp_res['sp_prefill_s']:.2f} s; permutes "
          f"{ppsp_res['pp_permute_ms']:.3f} / {ppsp_res['sp_permute_ms']:.3f} ms; phase 12 "
          f"{ppsp_res['phase_s']:.1f} s; kernels at its shapes, op ms (bound, plain): qmatmul M=4 "
          + ", ".join(f"{n} {v['ms']:.4f} ({v['bound_ms']:.4f}, {v['plain_ms']:.4f})"
                      for (n, m), v in mm.items() if m == 4)
          + "; M=1024 "
          + ", ".join(f"{n} {v['ms']:.4f} ({v['bound_ms']:.4f}, {v['plain_ms']:.4f})"
                      for (n, m), v in mm.items() if m == 1024)
          + "; decode attention on a microbatch's view (B=4) "
          + ", ".join(f"{n} {v['ms']:.4f} ({v['bound_ms']:.4f}, {v['plain_ms']:.4f}; SDPA "
                      f"{v['library_ms']:.4f})" for n, v in pv.items())
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)

    live = {k: dense[k]["live1000"] for k in ("bf16", "f16", "f32")}
    print(f"card: {card}; phase 13 (Llama-2-7B 4-bit, 8 slots, S=2048): decode step at 8 x 1000 "
          f"live, replayed, ms (bound by decode_roofline): "
          + ", ".join(f"{k} {v['ms']:.3f} ({v['bound_ms']:.3f})" for k, v in live.items())
          + "; copy-model serving, replayed device ms/step / tokens/s: "
          + ", ".join(f"{k} {dense[k]['rates']['device_ms_step']:.3f} / "
                      f"{dense[k]['rates']['tok_s']:.1f}" for k in ("bf16", "f16", "f32"))
          + "; dense forms at the bf16 rows' shapes, op / bound / plain / library ms: "
          + ", ".join(f"{n} {res[n]['ms']:.4f} / {res[n]['bound_ms']:.4f} / "
                      f"{res[n]['plain_ms']:.4f} / {res[n]['library_ms']:.4f}"
                      for n in sorted(res) if any(n.startswith(p + "_f") for p in (
                          "decode_attention", "prefill_attention", "kv_append")))
          + "; f32 gate controls (beyond the rounding, gate 1e-4): "
          + ", ".join(f"{n} {b:.2e}" for n, b in res["f32_control"].items())
          + f"; phase 13 {dense['phase_s']:.1f} s; total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    csrc, jk = "xbitops_tpu_torch/csrc/", "xbitops_tpu/kernels/"
    src = {
        "qgemv": (csrc + "qgemv_word.cu", jk + "qgemv_kernel.py:51"),
        "qgemv_mma": (csrc + "qgemv_mma.cu", jk + "qgemv_kernel.py:51"),
        "qgemv_planes": (csrc + "qgemv_word_planes.cu", jk + "qgemv_kernel.py:51"),
        "decode_attention": (csrc + "decode_attention.cu", jk + "decode_attention.py:176"),
        "kv_append": (csrc + "kv_append.cu", jk + "kv_append.py:92"),
        "prefill_attention": (csrc + "prefill_attention.cu", jk + "prefill_attention.py:188"),
        "kv_append_packed": (csrc + "kv_append.cu", jk + "kv_append.py:43"),
        "decode_attention_int8": (csrc + "decode_attention.cu", jk + "decode_attention.py:176"),
        "dequant": (csrc + "dequant.cu", jk + "dequant_kernel.py:32"),
        "qgemv_a8": (csrc + "qgemv_a8.cu", jk + "qgemv_kernel.py:146"),
        "qgemv_a8_perchannel": (csrc + "qgemv_a8.cu", jk + "qgemv_kernel.py:260"),
        "decode_attention_paged": (csrc + "decode_attention.cu", jk + "decode_attention.py:176"),
        "decode_attention_int8_paged": (csrc + "decode_attention.cu",
                                        jk + "decode_attention.py:176"),
        "prefill_attention_paged": (csrc + "prefill_attention.cu",
                                    jk + "prefill_attention.py:188"),
        "kv_append_paged": (csrc + "kv_append.cu", jk + "kv_append.py:92"),
        "kv_append_packed_paged": (csrc + "kv_append.cu", jk + "kv_append.py:43"),
    }
    for kind in DENSE:  # the fp16 and f32 caches' forms (phase 1, phase 13)
        for p in ("", "_paged"):
            src[f"decode_attention_{kind}{p}"] = (csrc + "decode_attention.cu",
                                                 jk + "decode_attention.py:176")
            src[f"prefill_attention_{kind}{p}"] = (csrc + "prefill_attention.cu",
                                                  jk + "prefill_attention.py:188")
            src[f"kv_append_{kind}{p}"] = (csrc + "kv_append.cu", jk + "kv_append.py:92")
    # launches: each kernel's count over the runs of phases 2 to 13 (the counts
    # were set to 0 just before each run and read just after it; phases 11
    # and 12's are each rank's of its main-path runs, summed over the ranks).  An append
    # row counts its own kernel's launches (phase 6: the eager decode), and
    # apart, as fused_launches, the decode-attention launches (csrc/
    # decode_attention.cu) that appended in its form on the serving paths
    runs = (launches2, launches3, launches4, launches5, launches6, launches7, launches8,
            launches9, launches10a, launches10b, launches10c, *launches11a, *launches11b,
            *launches12, launches13)
    count = lambda n: sum(ln[n] for ln in runs)
    kernels = [dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1], launches=count(n),
                    **({"fused_launches": count(n + "_fused")} if n in common.APPENDS else {}),
                    **{key: res[n][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms")},
                    **({"max_abs_err_beyond_rounding": res[n]["max_abs_err_beyond_rounding"]}
                       if "max_abs_err_beyond_rounding" in res[n] else {})) for n in src]
    for kern in kernels:
        check(kern["launches"] > 0, f"kernel {kern['name']} was launched on no serving path")
        check(kern.get("fused_launches", 1) > 0,
              f"decode attention appended in form {kern['name']} on no serving path")
    # the serving paths route every matmul to the few-rows form or the tile
    core = sum(ln["qgemv_cuda_core"] for ln in runs)
    check(core == 0, f"the CUDA-core qgemv form was launched {core} times on the serving paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
