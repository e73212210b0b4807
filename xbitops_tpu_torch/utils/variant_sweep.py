"""Time builds of one kernel source with extra ``nvcc`` flags against each
other in one process: the way to find what a kernel waits for on a card
whose profilers do not see inside a kernel (build it with a part left out
behind a macro, and compare).

    python3 -m xbitops_tpu_torch.utils.variant_sweep TAG=FLAG[,FLAG...] ... \\
        [--bits 3,1] [--M 8]

Each TAG builds ``csrc/qgemv_word_planes.cu`` alone (the few-rows form's
planes kernel; ``base`` with no flag is always built), or with a first
"flag" ``@path`` another copy of it (an earlier version, kept outside the
package), into its own library under ``_build/``,
prints its registers, stack frame and spills, and takes the place of the
main library's ``xb_qgemv_word_planes`` in turns (all builds in order, then
in reverse) while ``qmatmul_kernel`` runs at the five Llama-2-7B projection
shapes at default storage, g=128: one JSON line a (width, shape, M) with
each build's two readings in ms (CUDA events, L2 flushed, device sleep
queued before each call).  It needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

SOURCE = "qgemv_word_planes.cu"
ENTRY = "xb_qgemv_word_planes"


def main() -> int:
    if not torch.cuda.is_available():
        print("variant_sweep: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from xbitops_tpu_torch.kernels import common
    from xbitops_tpu_torch.kernels import qgemv_kernel as qk
    from xbitops_tpu_torch.utils import synth
    from xbitops_tpu_torch.utils.build_report import report
    from xbitops_tpu_torch.utils.qgemv_sweep import timed

    args, opts = [], {"--bits": "3", "--M": "8"}
    it = iter(sys.argv[1:])
    for arg in it:
        if arg in opts:
            opts[arg] = next(it)
        else:
            args.append(arg)
    builds = {"base": []}
    for arg in args:
        tag, _, flags = arg.partition("=")
        builds[tag] = [f for f in flags.split(",") if f]
    main_lib = common.lib()
    nvcc = common._nvcc()
    tmp = tempfile.mkdtemp(dir=common.BUILD_ROOT)
    procs = {}
    for tag, flags in builds.items():
        src = str(common.CSRC / SOURCE)
        if flags and flags[0].startswith("@"):
            src, flags = flags[0][1:], flags[1:]
        procs[tag] = subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-I", str(common.CSRC), *flags, "-shared", "-o",
             os.path.join(tmp, tag + ".so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        print(tag, *report(log), sep="\n  ", flush=True)
        fn = getattr(ctypes.CDLL(os.path.join(tmp, tag + ".so")), ENTRY)
        fn.argtypes, fn.restype = common._SIGNATURES[ENTRY], ctypes.c_int
        fns[tag] = fn

    class Swapped:
        def __init__(self, fn):
            self.fn = fn

        def __getattr__(self, name):
            return self.fn if name == ENTRY else getattr(main_lib, name)

    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    shapes = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gateup": (4096, 22016),
              "w_down": (11008, 4096), "lm_head": (4096, 32000)}
    try:
        for bits in map(int, opts["--bits"].split(",")):
            for name, (K, N) in shapes.items():
                qt = synth.random_qtensor(gen, K, N, bits, 128)
                for M in map(int, opts["--M"].split(",")):
                    a = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
                    row = dict(bits=bits, case=name, M=M)
                    for order in (list(fns), list(fns)[::-1]):
                        for tag in order:
                            common._lib = Swapped(fns[tag])
                            row.setdefault(tag, []).append(
                                round(timed(lambda: qk.qmatmul_kernel(a, qt), flush), 5))
                    print(json.dumps(row), flush=True)
    finally:
        common._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
