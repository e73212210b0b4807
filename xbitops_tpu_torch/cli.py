"""Command-line interface of the port (port of ``xbitops_tpu/cli.py``):

    python -m xbitops_tpu_torch convert  --ckpt <autogptq_dir> --out <packed_dir> [--tp N]
    python -m xbitops_tpu_torch generate --ckpt <dir> --prompt "1 2 3" [--max-tokens N] [--tp N]
    python -m xbitops_tpu_torch serve    --ckpt <dir> [--slots 8] [--burst 8] [--port 8000]
    python -m xbitops_tpu_torch bench    [--bits 4] [--batch 4]
    python -m xbitops_tpu_torch quantize --ckpt <dense_hf_dir> --out <packed_dir> [--bits 4]

``convert`` packs an AutoGPTQ safetensors checkpoint once, offline, with its
``config.json`` carried along; ``generate`` runs the engine on a packed or an
AutoGPTQ directory; ``serve`` puts the HTTP endpoint in front of it; ``bench``
times the fused matmul on the model's four projection shapes with CUDA events.
The engine and the model run on ``cuda`` unless ``--device cpu`` is given.
Prompts are token ids separated by spaces unless a tokenizer loads from the
checkpoint directory (``transformers``).  ``quantize`` GPTQ-quantizes a dense
HF-layout Llama, Mistral or Mixtral checkpoint layer by layer on calibration
tokens (``--calib-npy``, else random ids from a seeded generator) and writes a
packed directory that ``generate`` and ``serve`` read.

``--tp N`` (``convert``, ``generate``): tensor parallelism over N ranks.
``convert --tp N`` packs for N ranks (row-sharded wo and w_down, fused columns
interleaved; the directory records N); ``generate --tp N`` starts N processes
(``torch.multiprocessing``, start method "spawn", a gloo or NCCL world as
``parallel.multihost.initialize`` picks), each serving its shard of the same
requests, and rank 0 prints.  A rank loads the model on the CPU and puts only
its shard on its device.  ``serve`` has no ``--tp``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path


def _load_any(path: str, device: str, max_seq_len=None, tp: int = 1):
    """A packed directory (``manifest.json``) or an AutoGPTQ one (``config.json``)
    as ``(model, cfg)`` on ``device``, packed for ``tp`` ranks."""
    from xbitops_tpu_torch.io import llama_config_from_hf, load_autogptq
    from xbitops_tpu_torch.io.checkpoint import load_llama

    p = Path(path)
    if (p / "manifest.json").exists():
        cfg = llama_config_from_hf(json.loads((p / "config.json").read_text()), max_seq_len)
        return load_llama(str(p), cfg, device, tp=tp), cfg
    return load_autogptq(str(p), tp=tp, max_seq_len=max_seq_len, device=device)


def _tokenizer(path: str):
    """The checkpoint's tokenizer, or None (prompts are then token ids)."""
    p = Path(path)
    if not ((p / "tokenizer.json").exists() or (p / "tokenizer.model").exists()):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(str(p))
    except Exception as e:  # no tokenizer package: token ids only
        print(f"(tokenizer unavailable: {e}; using raw token ids)", file=sys.stderr)
        return None


def cmd_convert(args) -> int:
    from xbitops_tpu_torch.io import load_autogptq, save_packed

    t0 = time.time()
    model, cfg = load_autogptq(args.ckpt, tp=args.tp, storage_bits=args.storage,
                               device=args.device)
    save_packed(model, args.out, tp=args.tp)
    # carry the model's config and tokenizer beside the packed arrays
    src = Path(args.ckpt)
    for name in ("config.json", "quantize_config.json", "tokenizer.json",
                 "tokenizer.model", "tokenizer_config.json"):
        if (src / name).exists():
            shutil.copy(src / name, Path(args.out) / name)
    print(f"packed {cfg.num_layers}-layer model -> {args.out} in {time.time() - t0:.1f}s")
    return 0


def _generate_rank(rank: int, args) -> None:
    """One rank of ``generate --tp N``: its shard of the same requests."""
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    _generate(args, make_mesh((1, args.tp)), quiet=rank != 0)


def cmd_generate(args) -> int:
    if args.tp > 1:
        from xbitops_tpu_torch.parallel import multihost

        multihost.spawn(_generate_rank, args.tp, args=(args,), device=args.device)
        return 0
    _generate(args)
    return 0


def _generate(args, mesh=None, quiet: bool = False) -> None:
    from xbitops_tpu_torch.engine import Engine, Request

    # a rank loads the model on the CPU and puts only its shard on the device
    model, cfg = _load_any(args.ckpt, args.device if mesh is None else "cpu", args.max_seq_len,
                           args.tp)
    tokenizer = _tokenizer(args.ckpt)
    reqs = []
    for i, p in enumerate(args.prompt or ["1 2 3 4"]):
        if tokenizer is not None:
            ids, eos = tokenizer(p)["input_ids"], tokenizer.eos_token_id
        else:
            ids, eos = [int(t) for t in p.split()], None
        reqs.append(Request(prompt=ids, max_new_tokens=args.max_tokens,
                            temperature=args.temperature, eos_id=eos, id=i))
    eng = Engine(model, cfg, slots=args.slots, top_k=args.top_k, top_p=args.top_p,
                 seed=args.seed, mesh=mesh, device=None if mesh is None else args.device)
    del model
    t0 = time.time()
    outs = eng.generate(reqs)
    dt = time.time() - t0
    if quiet:
        return
    n_tok = sum(len(c.tokens) for c in outs)
    for c in outs:
        if tokenizer is not None:
            print(f"[{c.id}] {tokenizer.decode(c.tokens)!r} ({c.finish_reason})", flush=True)
        else:
            print(f"[{c.id}] {c.tokens} ({c.finish_reason})", flush=True)
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, graph capture included)",
          file=sys.stderr, flush=True)


def cmd_serve(args) -> int:
    from xbitops_tpu_torch.engine import Engine
    from xbitops_tpu_torch.engine.server import ServingEndpoint

    model, cfg = _load_any(args.ckpt, args.device, args.max_seq_len)
    eng = Engine(model, cfg, slots=args.slots, decode_burst=args.burst)
    ep = ServingEndpoint(eng, host=args.host, port=args.port, tokenizer=_tokenizer(args.ckpt))
    print(f"serving on http://{args.host}:{ep.port} "
          f"(slots={args.slots}, burst={args.burst}, kv_quant={eng.kv_quant})", file=sys.stderr)
    try:
        ep.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_quantize(args) -> int:
    import numpy as np
    import torch

    from xbitops_tpu_torch.io import load_autogptq, save_packed
    from xbitops_tpu_torch.ops.gptq import quantize_model_gptq

    t0 = time.time()
    # a dense checkpoint loads with every projection dense
    model, cfg = load_autogptq(args.ckpt, max_seq_len=args.seq_len, device=args.device)
    if args.calib_npy:
        calib = torch.from_numpy(np.load(args.calib_npy)[:, : args.seq_len].astype(np.int64))
        print(f"calibrating on {calib.shape[0]}x{calib.shape[1]} tokens from {args.calib_npy}",
              file=sys.stderr)
    else:
        rows = max(1, args.calib_tokens // args.seq_len)
        gen = torch.Generator().manual_seed(0)
        calib = torch.randint(0, cfg.vocab_size, (rows, args.seq_len), generator=gen)
        print(f"calibrating on {rows}x{args.seq_len} random tokens "
              "(pass real text with --calib-npy for production use)", file=sys.stderr)
    timings: dict = {}
    qmodel = quantize_model_gptq(model, cfg, calib, bits=args.bits, group_size=args.group_size,
                                 act_order=args.act_order, verbose=True, timings=timings)
    del model
    print("gptq solver s by weight shape (K, N): " + ", ".join(
        f"{k[0]}x{k[1]} {sum(v) / len(v):.2f} x{len(v)}" for k, v in timings.items()),
        file=sys.stderr)
    save_packed(qmodel, args.out)
    src = Path(args.ckpt)
    for name in ("config.json", "tokenizer.json", "tokenizer.model", "tokenizer_config.json"):
        if (src / name).exists():
            shutil.copy(src / name, Path(args.out) / name)
    print(f"gptq {args.bits}-bit packed -> {args.out} in {time.time() - t0:.1f}s")
    return 0


def cmd_bench(args) -> int:
    """The fused matmul at ``--batch`` rows on the model's four block
    projections (fused q|k|v, o, fused gate|up, down): one JSON line each,
    with the mean op time of 10 calls that each find the L2 cache flushed."""
    import torch

    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.ops.qmatmul import qmatmul
    from xbitops_tpu_torch.utils import synth

    if not torch.cuda.is_available():
        raise RuntimeError("bench measures the card: it needs a CUDA device")
    cfg = {"llama2-7b": llama.LlamaConfig.llama2_7b(),
           "llama2-13b": llama.LlamaConfig.llama2_13b(),
           "llama3-8b": llama.LlamaConfig.llama3_8b(),
           "mistral-7b": llama.LlamaConfig.mistral_7b()}[args.model]
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = [(h, qdim + 2 * kvdim), (qdim, h), (h, 2 * ffn), (ffn, h)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB: 5x the L2
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rows = []
    for K, N in shapes:
        qt = synth.random_qtensor(gen, K, N, args.bits, args.group_size)
        a = (torch.randn(args.batch, K, generator=gen, device=dev) * 0.2).to(torch.bfloat16)
        for _ in range(2):  # builds the kernels; warms up
            qmatmul(a, qt)
        ms = 0.0
        for _ in range(10):
            flush.zero_()
            torch.cuda._sleep(2_000_000)  # the host queues the call before the start event fires
            start.record()
            qmatmul(a, qt)
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end)
        dt = 1e-3 * ms / 10
        rows.append(dict(K=K, N=N, bits=args.bits, batch=args.batch, us=round(dt * 1e6, 2),
                         gbps=round(qt.bytes_packed() / dt / 1e9, 1)))
        print(json.dumps(rows[-1]))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xbitops_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="AutoGPTQ checkpoint -> packed layout")
    c.add_argument("--ckpt", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--tp", type=int, default=1)
    c.add_argument("--storage", choices=["auto", "packed"], default="auto",
                   help="plane storage width: 'auto' pads 3- and 7-bit values to the next "
                        "power of two (more bytes); 'packed' keeps exact b-bit storage")
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    c.set_defaults(fn=cmd_convert)

    g = sub.add_parser("generate", help="run the decode engine")
    g.add_argument("--ckpt", required=True)
    g.add_argument("--prompt", action="append", help="repeatable; token ids if no tokenizer")
    g.add_argument("--max-tokens", type=int, default=64)
    g.add_argument("--max-seq-len", type=int, default=None)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--slots", type=int, default=4)
    g.add_argument("--tp", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("bench", help="the fused matmul on the model's projection shapes")
    b.add_argument("--model", default="llama2-7b",
                   choices=["llama2-7b", "llama2-13b", "llama3-8b", "mistral-7b"])
    b.add_argument("--bits", type=int, default=4)
    b.add_argument("--group-size", type=int, default=128)
    b.add_argument("--batch", type=int, default=4)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("serve", help="HTTP serving endpoint (/v1/completions)")
    s.add_argument("--ckpt", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--burst", type=int, default=8)
    s.add_argument("--max-seq-len", type=int, default=None)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize", help="GPTQ-quantize a dense HF Llama/Mixtral checkpoint")
    q.add_argument("--ckpt", required=True, help="dense safetensors dir (HF layout)")
    q.add_argument("--out", required=True)
    q.add_argument("--bits", type=int, default=4)
    q.add_argument("--group-size", type=int, default=128)
    q.add_argument("--act-order", action="store_true")
    q.add_argument("--calib-tokens", type=int, default=2048,
                   help="total calibration tokens (random ids if no --calib-npy)")
    q.add_argument("--calib-npy", default=None,
                   help=".npy of int token ids [rows, seq] to calibrate on")
    q.add_argument("--seq-len", type=int, default=512)
    q.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    q.set_defaults(fn=cmd_quantize)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
