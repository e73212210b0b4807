"""Time the fused decode-attention op (``kernels/decode_attention.py``, the new
row appended in the same call) on the card, at B=8, H=Hkv=32, D=128, S=2048,
over the bf16 and the int8 cache, linear and in pages of 256, for two sets of
lengths: the ragged 7,792 rows a head of ``chip_smoke.py`` phase 1, and 8
slots of 1000.

    python3 -m xbitops_tpu_torch.utils.decode_sweep --splits  # split lengths
    python3 xbitops_tpu_torch/utils/decode_sweep.py --ops     # the op alone

With ``--splits`` it times the op at split lengths (positions a block takes,
``kernels/decode_attention.SPLIT_LEN``) of 64, 128, 256 and 512, in turns.
With ``--ops`` (or no argument) it times the op of whichever
``xbitops_tpu_torch`` the import finds: run by path with another tree first
on ``PYTHONPATH``, it times that tree's op, so two trees compare on one card
in turns.  One JSON line per case; timing as in ``utils/qgemv_sweep.py``: CUDA
events around the wrapper, the L2 cache flushed and a device sleep queued
before each call.  It needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from xbitops_tpu_torch.utils.qgemv_sweep import timed


def _cases(dev, gen):
    """(description, call) of each case: the fused op on fresh random caches."""
    from xbitops_tpu_torch.kernels.decode_attention import decode_attention
    from xbitops_tpu_torch.utils.synth import cut_pages

    B, H, D, S = 8, 32, 128, 2048
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    lengths = {"ragged 7792": [1, 7, 128, 1000, 2047, 2048, 513, S], "live 1000": [1000] * B}
    for label, lens_list in lengths.items():
        lens = torch.tensor(lens_list, device=dev)
        pos = lens - 1
        for int8 in (False, True):
            if int8:
                linear = [torch.randint(-(2**31), 2**31, (1, B, H, S // 4, D), generator=gen,
                                        device=dev, dtype=torch.int64).to(torch.int32)
                          for _ in range(2)]
                linear += [torch.empty((1, B, 4, H, S // 4), device=dev)
                           .uniform_(0.005, 0.02, generator=gen).to(torch.bfloat16)
                           for _ in range(2)]
                new = [torch.randint(1, 256, (B, H, D), generator=gen, device=dev,
                                     dtype=torch.int32) for _ in range(2)]
                new += [torch.empty((B, H), device=dev).uniform_(0.005, 0.02, generator=gen)
                        for _ in range(2)]
            else:
                linear = [torch.randn(1, B, H, S, D, device=dev, generator=gen)
                          .to(torch.bfloat16) for _ in range(2)]
                new = [torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
                       for _ in range(2)]
            table, pools = cut_pages(gen, linear, S // 256, lens)
            for paged in (False, True):
                cache, tbl = (pools, table) if paged else (linear, None)
                kw = dict(k_scale=cache[2], v_scale=cache[3]) if int8 else {}

                def call(cache=cache, tbl=tbl, kw=kw, new=new):
                    return decode_attention(q, cache[0], cache[1], lens, layer_idx=0,
                                            kv_new=(*new, pos), page_table=tbl, **kw)[0]

                yield dict(case=label, cache="int8" if int8 else "bf16", paged=paged,
                           rows_a_head=int(lens.sum())), call
            del linear, pools, new


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import xbitops_tpu_torch
    from xbitops_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    splits = "--splits" in sys.argv[1:]
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for desc, call in _cases(dev, gen):
        if not splits:
            print(json.dumps(dict(desc, tree=xbitops_tpu_torch.__file__,
                                  ms=round(timed(call, flush), 5))), flush=True)
            continue
        ms, default = {n: [] for n in (64, 128, 256, 512)}, da.SPLIT_LEN
        for n in (*ms, *reversed(ms)):  # in turns
            da.SPLIT_LEN = n
            ms[n].append(timed(call, flush))
        da.SPLIT_LEN = default
        print(json.dumps(dict(desc, ms_by_split_len={n: round(sum(t) / len(t), 5)
                                                     for n, t in ms.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
