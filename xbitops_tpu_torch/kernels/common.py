"""Build, load and count the port's CUDA kernels.

Every kernel source under ``xbitops_tpu_torch/csrc/*.cu`` has a plain C
interface.  At first use they compile with ``nvcc`` for ``sm_90a`` into one
shared library, cached under ``xbitops_tpu_torch/_build/<hash of the sources>/``,
and load with ``ctypes``.  Pointers and the stream pass as ``c_void_p`` (a
pointer passed as a plain int would be cut to 32 bits), ints as ``c_int``.
Each C entry returns ``cudaGetLastError()`` after its launch and the wrapper
raises if it is not 0.  A failed build raises with nvcc's output: there is no
fallback.

Nothing here runs at import: the CPU test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts per kernel, and calls of a plain version on CUDA tensors.
# A wrapper adds one where it launches its kernel and nowhere else, so a run
# can show that the main path went through the kernels.
launches = {"qgemv": 0, "kv_append": 0, "decode_attention": 0}
plain_on_cuda = {"qgemv": 0, "kv_append": 0, "decode_attention": 0}


def reset_counts() -> None:
    for d in (launches, plain_on_cuda):
        for k in d:
            d[k] = 0


def count_plain(name: str, t: torch.Tensor) -> None:
    """Record a plain-version call when it runs on a CUDA tensor."""
    if t.is_cuda:
        plain_on_cuda[name] += 1


_VP, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every entry returns the launch's cudaError_t as an int.
_SIGNATURES = {
    "xb_qgemv": [_VP, _I, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I,
                 _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _I, _VP],
    "xb_kv_append": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "xb_decode_attention": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                            _I, _I, _I, _I, _I, ctypes.c_float, _VP],
}

_lib = None
_lock = threading.Lock()
build_log = ""  # ptxas resource report of the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernel library if this source hash has none; return its path."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libxbitops_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Reject an input the kernel does not take."""
    if not cond:
        raise ValueError(msg)
