"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``xbitops_tpu_torch/csrc`` (nvcc).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and times both with CUDA events (the L2
   cache is flushed before every timed launch, as the serving path finds it).
   A time is the op's: the kernel's wrapper, with the small device passes it
   adds around its kernel (K padding, index casts, the split-K sum).
3. Drives the serving path: a random 4-bit (g=128) Llama-2-7B at full width
   through ``Engine.generate`` with 12 requests on 8 slots, then checks the
   outputs, that every kernel launched during that run and that no plain
   version ran on the card, and one decode step against the plain path
   (the logits of a 2-layer cut, and each of the 32 blocks on one input).

Any failed check raises, so the exit code is not 0.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Needs one CUDA device; without one it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref| (the repo's bf16 gate is 2e-2)."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


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
    from xbitops_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from xbitops_tpu_torch.kernels.kv_append import (
        kv_append_dense,
        kv_append_dense_reference,
    )
    from xbitops_tpu_torch.ops.qmatmul import qmatmul
    from xbitops_tpu_torch.utils import synth

    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    # --- fused dequant-matmul at the 7B projection shapes ---
    shapes = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gateup": (4096, 22016),
              "w_down": (11008, 4096), "lm_head": (4096, 32000)}
    worst = worst_abs = 0.0
    for name, (K, N) in shapes.items():
        qt = synth.random_qtensor(gen, K, N, 4, 128)
        for M in (8, 256):
            a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            got = qmatmul(a, qt)
            ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
            e = rel_err(got, ref)
            worst = max(worst, e)
            worst_abs = max(worst_abs, (got.float() - ref).abs().max().item())
            check(e <= 2e-2, f"qmatmul {name} M={M}: rel err {e:.3e} > 2e-2")
            ms = timer(lambda: qmatmul(a, qt))
            plain_ms = timer(lambda: qmatmul(a, qt, use_kernel=False), iters=3)
            gbs = qt.bytes_packed() / ms / 1e6
            print(f"qmatmul 4-bit {name} K={K} N={N} M={M}: op {ms:.4f} ms "
                  f"({gbs:.1f} GB/s packed stream at op time), plain {plain_ms:.4f} ms, rel err {e:.2e}",
                  flush=True)
            if name == "w_gateup" and M == 8:
                res["qgemv"] = dict(ms=ms, plain_ms=plain_ms)
        if name == "w_down":
            check(qt.K == 11264 and qt.K_logical == 11008, "w_down K padding")
    qt = synth.random_qtensor(gen, 4096, 4096, 4, 128)
    a = torch.randn(8, 4096, device=dev, generator=gen)
    got = qmatmul(a, qt, precise=True)
    ref = qmatmul(a, qt, use_kernel=False)
    ok = torch.allclose(got, ref, rtol=1e-5, atol=3e-4)
    e = (got - ref).abs().max().item()
    worst_abs = max(worst_abs, e)
    print(f"qmatmul precise 4096x4096 M=8: max abs err {e:.3e}", flush=True)
    check(ok, "qmatmul precise outside rel 1e-5 / abs 3e-4")
    for bits in (3, 8):
        qt = synth.random_qtensor(gen, 4096, 4096, bits, 128)
        a = torch.randn(8, 4096, device=dev, generator=gen).to(torch.bfloat16)
        got = qmatmul(a, qt)
        ref = qmatmul(a, qt, out_dtype=torch.float32, use_kernel=False)
        e = rel_err(got, ref)
        worst = max(worst, e)
        worst_abs = max(worst_abs, (got.float() - ref).abs().max().item())
        print(f"qmatmul {bits}-bit 4096x4096 M=8: rel err {e:.2e}", flush=True)
        check(e <= 2e-2, f"qmatmul {bits}-bit rel err {e:.3e}")
    print(f"qmatmul: worst rel err {worst:.2e} (gate 2e-2), worst abs err {worst_abs:.3e}",
          flush=True)
    res["qgemv"]["max_abs_err"] = worst_abs

    # --- decode attention with the fused append, and the append alone ---
    S, D = 2048, 128
    lens_live = [1, 7, 128, 1000, 2047, 2048, 513]  # + one inactive slot
    B = len(lens_live) + 1
    pos = torch.tensor([n - 1 for n in lens_live] + [S], device=dev)  # inactive: S
    lens = torch.clamp(pos + 1, max=S)
    att_err, app_ok = 0.0, True
    for H, Hkv, window in ((32, 32, None), (32, 8, None), (32, 32, 512)):
        k = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
        v = torch.randn(2, B, Hkv, S, D, device=dev, generator=gen).to(torch.bfloat16)
        q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
        kn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
        vn = torch.randn(B, Hkv, D, device=dev, generator=gen).to(torch.bfloat16)
        k_ref, v_ref = k.clone(), v.clone()
        out, _, _ = decode_attention(q, k, v, lens, layer_idx=1, kv_new=(kn, vn, pos),
                                     window=window)
        kv_append_dense_reference(k_ref, v_ref, kn, vn, pos, 1)
        ref = decode_attention_reference(q, k_ref[1], v_ref[1], lens, window)
        same = torch.equal(k, k_ref) and torch.equal(v, v_ref)
        e = (out.float() - ref.float()).abs().max().item()
        print(f"decode_attention+append B={B} H={H} Hkv={Hkv} S={S} window={window}: "
              f"rows exact {same}, max abs err {e:.2e}", flush=True)
        check(same, "appended cache rows differ from the plain append")
        check(e <= 2e-2, f"decode attention abs err {e:.3e} > 2e-2")
        att_err = max(att_err, e)
        if H == Hkv and window is None:
            ms = timer(lambda: decode_attention(q, k, v, lens, layer_idx=1,
                                                kv_new=(kn, vn, pos)))
            plain_ms = timer(lambda: (
                kv_append_dense_reference(k, v, kn, vn, pos, 1),
                decode_attention_reference(q, k[1], v[1], lens)), iters=3)
            print(f"decode_attention+append MHA: op {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            res["decode_attention"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=att_err)
            k2, v2 = k.clone(), v.clone()
            kn2, vn2 = kn + 1, vn - 1
            kv_append_dense(k, v, kn2, vn2, pos, 0)
            kv_append_dense_reference(k2, v2, kn2, vn2, pos, 0)
            app_ok = torch.equal(k, k2) and torch.equal(v, v2)
            ms = timer(lambda: kv_append_dense(k, v, kn2, vn2, pos, 0))
            plain_ms = timer(lambda: kv_append_dense_reference(k, v, kn2, vn2, pos, 0))
            print(f"kv_append B={B} Hkv={Hkv} S={S}: exact {app_ok}, op {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms", flush=True)
            check(app_ok, "kv_append differs from its plain version")
            res["kv_append"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0)
    res["decode_attention"]["max_abs_err"] = att_err
    return res


def phase_serving(dev):
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.utils import synth

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = synth.random_llama_params(cfg, bits=4, group_size=128, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"7B model built in {time.perf_counter() - t0:.1f} s", flush=True)
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")
    check(not any(plain.values()), f"plain versions ran on the card: {plain}")
    st = eng.loop_stats
    ms_step = 1e3 * st["decode"] / st["decode_steps"]
    tok_s = st["decode_tokens"] / st["decode"]
    print(f"serving: 12 requests, 8 slots, burst 8, {wall:.2f} s wall; prefill "
          f"{st['admit_prefill']:.2f} s; decode {st['decode_steps']:.0f} steps "
          f"{ms_step:.2f} ms/step, {tok_s:.1f} tokens/s; launches {launches}", flush=True)

    # One decode step through the kernels against the plain path, on clones
    # of the engine's cache.  Each op agrees to f32 rounding (~5e-7) before
    # its bf16 output rounding; the rare 1-ulp output flips that leaves grow
    # through this untrained random model's layers (H100 80GB HBM3, 700 W:
    # max rel 7e-3 after 1 layer, 2e-2 after 8, 5e-2 after 32).  So the gates
    # are: decode_step logits of a 2-layer cut of the same full-width model
    # within rel 2e-2, and every one of the 32 blocks, fed the same input,
    # within rel 2e-2; the full-depth logits are reported.
    tokens = torch.tensor([c.tokens[-1] for c in out[:8]], device=dev)
    cut = llama.Llama(dataclasses.replace(cfg, num_layers=2), model.embed,
                      list(model.blocks)[:2], model.ln_final, model.lm_head.qtensor)
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
    return launches, dict(ms_step=ms_step, tok_s=tok_s)


def clone_cache(cache, n_layers):
    from xbitops_tpu_torch.models import llama

    return llama.KVCache(cache.k[:n_layers].clone(), cache.v[:n_layers].clone(),
                         cache.lengths.clone())


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
    t0 = time.perf_counter()
    lib_path = common.build()
    common.lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.name}", flush=True)

    timer = Timer(dev)
    res = phase_kernels(dev, timer)
    torch.cuda.empty_cache()
    launches, serving = phase_serving(dev)
    print(f"card: {card}; 7B 4-bit decode at B=8: {serving['ms_step']:.2f} ms/step, "
          f"{serving['tok_s']:.1f} tokens/s", flush=True)

    src = {
        "qgemv": ("xbitops_tpu_torch/csrc/qgemv.cu", "xbitops_tpu/kernels/qgemv_kernel.py:51"),
        "decode_attention": ("xbitops_tpu_torch/csrc/decode_attention.cu",
                             "xbitops_tpu/kernels/decode_attention.py:176"),
        "kv_append": ("xbitops_tpu_torch/csrc/kv_append.cu",
                      "xbitops_tpu/kernels/kv_append.py:92"),
    }
    kernels = [dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
                    launches=launches[n], max_abs_err=res[n]["max_abs_err"],
                    ms=res[n]["ms"], plain_ms=res[n]["plain_ms"]) for n in src]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
