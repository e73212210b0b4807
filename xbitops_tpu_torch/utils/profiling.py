"""Where a forward's time goes on the card: kernel time by name, launches,
host ops and the device's busy share, from ``torch.profiler``.

    python3 -m xbitops_tpu_torch.utils.profiling [--bits B | --moe]

profiles, on a random 4-bit Llama-2-7B at full width and depth with 8 slots
(S=2048): one decode step over the bf16 cache, one over the paged bf16 cache
(pages of 256 positions, shuffled through the pool) and one over the int8
cache, all slots at 1000 live positions, on each cache a speculative verify
step of 5 rows a slot (``spec_verify_step``, γ = 4), and one chunk forward of chunked admission
(5 rows of 512 tokens at positions 512-1023, int8 cache) with bf16
activations, with int8 activations (``prefill_a8``) and with int8 activations
on the 8-bit per-channel requantization of the blocks.  With ``--bits B``
(another width, default packed storage, g=128) it profiles the decode step
over the bf16 cache alone.  With ``--moe`` the model is a random 4-bit
Mixtral-8x7B (``MoeConfig.mixtral_like``, no-drop): the decode and verify
steps on the bf16 and the int8 cache and one chunk forward with bf16
activations (every expert on all 2,560 rows of the chunk).  Each decode step is profiled twice: called from
Python as an eager step, and as a CUDA graph of 8 such steps replayed (the
engine's burst), whose numbers are given a step (``replayed``, with
``event_ms``: CUDA events around each replay); a verify step is replayed as a
graph of one step, as the engine replays it.  It needs one CUDA device and
prints one JSON object per case.

It also holds the decode step's roofline accounting (port of
``xbitops_tpu/utils/profiling.py``): :func:`model_weight_bytes` (the packed
and dense weights a step streams), :func:`kv_step_bytes` (the cache rows it
reads and writes, at 2 or 4 bytes an element) and :func:`decode_roofline`,
their sum over the H100's memory rate.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

# NVIDIA H100 SXM, published: 3.35 TB/s of HBM3 at the 700 W limit
H100_HBM_GBPS = 3350.0


@dataclasses.dataclass
class DecodeRoofline:
    """A decode step's device-memory traffic and the least time it takes."""

    weight_bytes: int  # packed + dense weights a step reads
    cache_bytes: int  # k/v rows read and written a step at the current lengths
    total_bytes: int
    hbm_gbps_peak: float
    bound_ms: float  # total_bytes / peak
    measured_ms: Optional[float] = None

    @property
    def efficiency(self) -> Optional[float]:
        if self.measured_ms is None:
            return None
        return self.bound_ms / self.measured_ms

    def __str__(self) -> str:
        s = (f"weights {self.weight_bytes / 1e9:.2f} GB + cache {self.cache_bytes / 1e9:.3f} GB "
             f"per step -> bound {self.bound_ms:.2f} ms @ {self.hbm_gbps_peak:.0f} GB/s")
        if self.measured_ms is not None:
            s += f"; measured {self.measured_ms:.2f} ms ({self.efficiency:.0%} of roofline)"
        return s


def model_weight_bytes(model) -> int:
    """The weight bytes a decode step reads: each projection's packed planes
    and scales (``QTensor.bytes_packed``, the act-order ``perm`` left out as
    the JAX package leaves it), every dense weight, norm and router, and not
    the embedding (a step gathers B of its rows)."""
    from xbitops_tpu_torch.models.llama import QLinear

    total = 0
    for mod in model.modules():
        if isinstance(mod, QLinear):
            total += mod.qtensor.bytes_packed()
            continue
        for name, buf in mod.named_buffers(recurse=False):
            if not (mod is model and name == "embed"):
                total += buf.numel() * buf.element_size()
    return total


def kv_step_bytes(cfg, batch: int, mean_len: int, dtype_bytes: int = 2) -> int:
    """Cache bytes a decode step touches: every cached position read and one
    written, k and v, at ``dtype_bytes`` an element (2: bf16 or fp16, 4: f32)."""
    per_pos = cfg.num_kv_heads * cfg.head_dim * dtype_bytes * 2  # k and v
    return cfg.num_layers * batch * (mean_len + 1) * per_pos


def decode_roofline(model, cfg, batch: int, mean_len: int = 0,
                    hbm_gbps_peak: float = H100_HBM_GBPS, measured_ms: Optional[float] = None,
                    dtype_bytes: int = 2) -> DecodeRoofline:
    """The least time of a decode step of ``batch`` slots at ``mean_len``
    cached positions over a cache of ``dtype_bytes`` an element: its weight
    and cache bytes over the memory rate."""
    wb = model_weight_bytes(model)
    cb = kv_step_bytes(cfg, batch, mean_len, dtype_bytes)
    total = wb + cb
    return DecodeRoofline(weight_bytes=wb, cache_bytes=cb, total_bytes=total,
                          hbm_gbps_peak=hbm_gbps_peak, bound_ms=total / hbm_gbps_peak / 1e6,
                          measured_ms=measured_ms)


def profile(fn: Callable[[], object], steps: int = 4, warmup: int = 3, top: int = 8) -> Dict:
    """Run ``fn`` ``warmup`` times, then ``steps`` times without the profiler
    (host clock, synchronised: ``wall_ms``) and ``steps`` times under it.
    Returns per call: ``device_ms`` (sum of kernel and device-copy times, each
    counted once, from the trace's device events), ``busy`` (device_ms over
    wall_ms), ``launches``, ``host_ops`` (ATen ops) and the ``top`` kernels
    by time as ``{name: [ms, launches]}``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0.0, 0])
    host_ops = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:  # a kernel or a device copy
            by_name[ev.name][0] += ev.device_time / 1e3  # us -> ms
            by_name[ev.name][1] += 1
        elif ev.name.startswith("aten::"):
            host_ops += 1
    device_ms = sum(t for t, _ in by_name.values()) / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, busy=device_ms / wall_ms,
        launches=sum(n for _, n in by_name.values()) / steps, host_ops=host_ops / steps,
        top={name[:60]: [t / steps, n / steps] for name, (t, n) in ranked},
    )


def replayed(step: Callable[[], object], burst: int = 8, top: int = 8) -> Dict:
    """``burst`` calls of ``step`` captured as one CUDA graph, as the engine
    captures a decode burst, and profiled a replay at a time: the numbers of
    :func:`profile`, and ``event_ms`` (CUDA events around each replay), given
    a step."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(burst):
            step()
    res = profile(graph.replay, top=top)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = 0.0
    for _ in range(4):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
    del graph
    out = {k: res[k] / burst for k in ("wall_ms", "device_ms", "launches", "host_ops")}
    out.update(busy=res["busy"], event_ms=ms / 4 / burst,
               top={name: [t / burst, n / burst] for name, (t, n) in res["top"].items()})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profiling: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops.quantize import requantize_a8
    from xbitops_tpu_torch.utils import synth

    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    bits = int(sys.argv[sys.argv.index("--bits") + 1]) if "--bits" in sys.argv else 4
    moe = "--moe" in sys.argv
    if moe:
        from xbitops_tpu_torch.models.moe import MoeConfig

        cfg = MoeConfig.mixtral_like(capacity_factor=None)
        model = synth.random_moe_params(cfg, bits=bits, group_size=128, device=dev, seed=0)
        name = "Mixtral-8x7B"
    else:
        cfg = llama.LlamaConfig.llama2_7b()
        model = synth.random_llama_params(cfg, bits=bits, group_size=128, device=dev, seed=0)
        name = "Llama-2-7B"
    gen = torch.Generator(device=dev).manual_seed(0)
    slots, live = 8, 1000
    tok = torch.randint(0, cfg.vocab_size, (slots,), generator=gen, device=dev)
    top = 12 if moe else 8
    with torch.no_grad():
        if moe:
            cases = ((False, False), (True, False))
        else:
            cases = ((False, False), (False, True), (True, False)) if bits == 4 else ((False, False),)
        for quantized, paged in cases:
            if paged:
                pages = cfg.max_seq_len // 256
                cache = llama.KVCache.init_paged(cfg, slots, slots * pages, 256, device=dev)
                order = torch.randperm(slots * pages, generator=gen, device=dev)
                cache.page_table.copy_(order.reshape(slots, pages))
            else:
                cache = llama.KVCache.init(cfg, slots, dev, quantized=quantized)

            def step():
                cache.lengths.fill_(live)  # every call decodes at the same position
                llama.decode_step(model, tok, cache)

            res = profile(step, top=top)
            res["replayed"] = replayed(step, top=top)
            kind = ("paged " if paged else "") + ("int8" if quantized else "bf16")
            print(json.dumps(dict(case=f"{name} decode step, {bits}-bit, {kind} cache, B={slots}, "
                                       f"live={live}", **res)), flush=True)
            drafts = torch.randint(0, cfg.vocab_size, (slots, 5), generator=gen, device=dev)

            def verify():
                cache.lengths.fill_(live)
                llama.spec_verify_step(model, drafts, cache)

            res = profile(verify, top=top)
            res["replayed"] = replayed(verify, burst=1, top=top)
            print(json.dumps(dict(case=f"{name} verify step, 5 rows a slot, {bits}-bit, {kind} "
                                       f"cache, B={slots}, live={live}", **res)), flush=True)
            if moe and not quantized:  # every expert runs all 2,560 rows of the chunk
                n, chunk = 5, 512
                tokens = torch.randint(0, cfg.vocab_size, (n, chunk), generator=gen, device=dev)
                res = profile(lambda: llama.prefill_slots_chunk(
                    model, tokens, torch.full((n,), chunk, device=dev),
                    torch.full((n,), 2 * chunk, device=dev), torch.arange(n, device=dev), cache),
                    steps=1, warmup=1, top=top)
                print(json.dumps(dict(case=f"{name} chunk forward, bf16 activations, bf16 cache, "
                                           f"{n} rows of {chunk} at positions {chunk}-"
                                           f"{2 * chunk - 1}", **res)), flush=True)
            if quantized and not moe:
                n, chunk = 5, 512
                tokens = torch.randint(0, cfg.vocab_size, (n, chunk), generator=gen, device=dev)
                args = (tokens, torch.full((n,), chunk, device=dev),
                        torch.full((n,), 2 * chunk, device=dev), torch.arange(n, device=dev))
                cfg8 = dataclasses.replace(cfg, prefill_a8=True)
                blocks8 = [llama.LlamaBlock(
                    cfg8, {k: requantize_a8(c.qtensor) for k, c in b.named_children()},
                    b.ln_attn, b.ln_mlp) for b in model.blocks]
                models = {
                    "bf16 activations": model,
                    "int8 activations, 4-bit g=128": model.with_config(cfg8),
                    "int8 activations, 8-bit per channel": llama.Llama(
                        cfg8, model.embed, blocks8, model.ln_final, model.lm_head.qtensor),
                }
                for label, m in models.items():
                    res = profile(lambda: llama.prefill_slots_chunk(m, *args, cache),
                                  steps=1, warmup=1)
                    print(json.dumps(dict(case=f"chunk forward, {label}, int8 cache, {n} rows of "
                                               f"{chunk} at positions {chunk}-{2 * chunk - 1}",
                                          **res)), flush=True)
                del models, blocks8
            del cache
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
