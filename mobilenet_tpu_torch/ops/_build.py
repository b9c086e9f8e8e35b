"""Build and load the package's CUDA kernels.

At first use, every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`)
into one shared library with a plain C interface, under `build/kernels/`
at the root of the checkout. The file name carries a hash of the sources
and the flags, so an edited source builds anew and a stale library is never
loaded. The library is loaded with `ctypes`; every pointer and the stream
are passed as `c_void_p`, every size as `c_int`, and every entry point
returns the `cudaError_t` of its launch, which `check` turns into an
exception.

Nothing here runs at import: the CPU-only test environment has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (pointer args, int args); each also takes the stream last.
_SIGNATURES = {
    # x, dw_w, dw_b, pw_w, pw_b, out | N, H, W, Cin, Cout, stride, relu6
    "separable_block": (6, 7),
    # x, fc_w, fc_b, out | N, HW, C, classes
    "fused_head": (4, 4),
    # x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out | N, H, W, C, K, relu6
    "chain": (8, 6),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of mobilenet_tpu_torch cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Raises on a failed
    build or load."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        cu, cuh = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in cu + cuh:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out = BUILD_DIR / f"libmobilenet_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
            os.replace(tmp, out)
        else:
            build_seconds = 0.0
        lib = ctypes.CDLL(str(out))
        for dt in ("bf16", "f32"):
            for name, (n_ptr, n_int) in _SIGNATURES.items():
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
                fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
