"""Build, load and count the port's CUDA kernels.

Every kernel source under ``xbitops_tpu_torch/csrc/*.cu`` has a plain C
interface (``*.cuh`` are headers they share).  At first use they compile with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) into one shared library, cached
under ``xbitops_tpu_torch/_build/<hash of the sources>/``, and load with
``ctypes``.  Pointers and the stream pass as ``c_void_p`` (a
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts per kernel, and calls of a plain version on CUDA tensors.
# A wrapper adds one where it launches its kernel and nowhere else, so a run
# can show that the main path went through the kernels.
# The few-rows matmul's 9-16-row instance counts once more under
# ``qgemv_word16`` (``qgemv_kernel.word16``).
# The decode-attention kernel appends the new rows itself: its launches with
# ``kv_new`` count once more under the append form's name + "_fused".  The
# fp16 and f32 caches' forms of the attention kernels and the append count
# under their own names (``dense_suffix``).
APPENDS = ("kv_append", "kv_append_packed", "kv_append_paged", "kv_append_packed_paged",
           "kv_append_f16", "kv_append_f32", "kv_append_f16_paged", "kv_append_f32_paged")
KERNELS = ("qgemv", "decode_attention", "prefill_attention", "decode_attention_int8", "dequant",
           "qgemv_a8", "qgemv_a8_perchannel", "decode_attention_paged",
           "decode_attention_int8_paged", "prefill_attention_paged", "qgemv_mma",
           "qgemv_cuda_core", "qgemv_planes", "decode_attention_f16", "decode_attention_f32",
           "decode_attention_f16_paged", "decode_attention_f32_paged", "prefill_attention_f16",
           "prefill_attention_f32", "prefill_attention_f16_paged",
           "prefill_attention_f32_paged", "qgemv_word16") + APPENDS + tuple(
               n + "_fused" for n in APPENDS)
launches = dict.fromkeys(KERNELS, 0)
plain_on_cuda = dict.fromkeys(KERNELS, 0)


# The dense KV cache's element types and their codes in the C entries (csrc/kvtype.cuh).
DENSE_KV = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def check_kv_dtype(dtype) -> None:
    """Reject a dense KV cache type the kernels do not take."""
    if dtype not in DENSE_KV:
        raise ValueError(f"KV cache dtype {dtype}: the dense cache is torch.bfloat16, "
                         "torch.float16 or torch.float32")


def dense_suffix(dtype) -> str:
    """A dense cache form's part of a counter name: "" (bf16), "_f16", "_f32"."""
    check_kv_dtype(dtype)
    return {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}[dtype]


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
    "xb_qgemv_mma": [_VP, _I, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _I, _I, _I, _I,
                     _I, _I, _VP, _VP, _I, _VP],
    "xb_qgemv_word": [_VP, _I, _I, _I, _I, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP,
                      _I, _VP],
    "xb_qgemv_word_planes": [_VP, _I, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _I,
                             _I, _I, _I, _I, _I, _VP, _VP, _VP, _I, _VP],
    "xb_kv_append": [_VP] * 4 + [_I, _VP] + [_I] * 5 + [_VP],
    "xb_kv_append_packed": [_VP] * 8 + [_I, _VP] + [_I] * 5 + [_VP],
    "xb_decode_attention": [_VP] * 15 + [_I] * 12 + [ctypes.c_float, _VP],
    "xb_prefill_attention": [_VP] * 8 + [_I] * 9 + [ctypes.c_float, _VP],
    "xb_kv_append_paged": [_VP] * 4 + [_I, _VP, _I, _VP] + [_I] * 6 + [_VP],
    "xb_kv_append_packed_paged": [_VP] * 8 + [_I, _VP, _I, _VP] + [_I] * 6 + [_VP],
    "xb_prefill_attention_paged": [_VP] * 9 + [_I] * 11 + [ctypes.c_float, _VP],
    "xb_dequant": [_I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _I, _I, _I, _I, _VP, _I, _VP],
    "xb_qgemv_a8": [_VP, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _VP, _VP, _VP],
}

_lib = None
_lock = threading.Lock()
build_log = ""  # ptxas resource report of the library in use (kept beside it)


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
    for src in sorted(CSRC.glob("*.cu*")):  # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libxbitops_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        # one nvcc per source, all at once, then one link
        objs = [os.path.join(tmp_dir, src.stem + ".o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        tmp = os.path.join(tmp_dir, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        logs = []
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            logs.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}")
        build_log = "".join(logs) + proc.stdout
        log_path.write_text(build_log)
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


def kernel_input(t: torch.Tensor, dtypes, device) -> torch.Tensor:
    """``t`` as a kernel reads it: on ``device``, contiguous and starting on 16
    bytes, in its own dtype where that is one of ``dtypes`` (then nothing at
    all runs on the card), else cast to the first."""
    t = t.to(device=device, dtype=t.dtype if t.dtype in dtypes else dtypes[0]).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require(cond: bool, msg: str) -> None:
    """Reject an input the kernel does not take."""
    if not cond:
        raise ValueError(msg)


def qtensor_args(qt, device) -> list:
    """Check a 2-D packed QTensor for the kernels that read one, and return
    its C arguments: three plane pointers, three plane widths, paired, scales,
    scale_zeros, scales-are-fp16, tile_k, scale rows used a tile, scale rows
    stored a tile."""
    N = qt.N
    require(1 <= len(qt.planes) <= 3, "1-3 planes")
    require(qt.scales.dtype in (torch.float16, torch.float32), f"scales {qt.scales.dtype}")
    require(qt.scale_zeros.dtype == qt.scales.dtype, "scale_zeros dtype != scales dtype")
    for p in qt.planes:
        require(p.is_cuda and p.device == device, "planes must be on the activations' device")
        require(p.dtype == torch.int32 and p.dim() == 2 and p.is_contiguous(),
                "planes must be contiguous int32 [K/(32/pb), N]")
    for s in (qt.scales, qt.scale_zeros):
        require(s.device == device and s.is_contiguous() and s.dim() == 3
                and s.shape[0] == qt.K // qt.tile_k and s.shape[2] == N,
                "scales must be contiguous [K/tile_k, gt_pad, N] on the planes' device")
    require(qt.K % qt.tile_k == 0 and qt.tile_k % 32 == 0, f"tile_k={qt.tile_k}")
    pad = 3 - len(qt.planes)
    return [
        *[p.data_ptr() for p in qt.planes], *[None] * pad, *qt.plane_bits, *[0] * pad,
        int(qt.paired), qt.scales.data_ptr(), qt.scale_zeros.data_ptr(),
        int(qt.scales.dtype == torch.float16), qt.tile_k, qt.groups_per_tile,
        qt.scales.shape[1],
    ]
