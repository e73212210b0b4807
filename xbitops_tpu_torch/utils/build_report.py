"""Print what ``nvcc -Xptxas -v`` said of each kernel at the last build:
registers, shared memory, stack frame (local memory: arrays the compiler
could not keep in registers) and spills.

    python3 -m xbitops_tpu_torch.utils.build_report [substring ...]

Builds the kernel library if it is not built yet (needs nvcc); the report
is kept beside the library.  With
arguments, only kernels whose demangled name holds one of them."""

from __future__ import annotations

import re
import subprocess
import sys

from xbitops_tpu_torch.kernels import common


def report(log: str, wanted=()) -> list[str]:
    """One line per kernel: name, registers, shared memory, stack frame and
    spill bytes."""
    names = re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'", log)
    try:
        plain = subprocess.run(["c++filt", *names], capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    blocks = re.split(r"Compiling entry function '\S+' for 'sm_90a'", log)[1:]
    lines = []
    for name, block in zip(plain, blocks):
        if wanted and not any(w in name for w in wanted):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        short = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", ""))
        short = short.removeprefix("void ")
        lines.append(f"{short}: {regs.group(1) if regs else '?'} registers, "
                     f"{smem.group(1) if smem else 0} bytes static smem, "
                     f"{stack.group(1) if stack else '?'} bytes stack frame, spills "
                     f"{spill.group(1) if spill else '?'} / {spill.group(2) if spill else '?'} bytes")
    return lines


if __name__ == "__main__":
    common.lib()
    print("\n".join(report(common.build_log, sys.argv[1:])))
