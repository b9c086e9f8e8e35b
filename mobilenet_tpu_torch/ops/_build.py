"""Build and load the package's CUDA kernels.

At first use, each `csrc/*.cu` is compiled by its own `nvcc` for Hopper
(`sm_90a`), all at once, and the objects are linked into one shared library
with a plain C interface under `build/kernels/` at the root of the checkout.
The file name carries a hash of the sources and the flags, so an edited
source builds anew and a stale library is never loaded. The library is
loaded with `ctypes`; every entry point has its argument types declared in
`_SIGNATURES` (pointers and the stream as `c_void_p`, sizes as `c_int`,
float32 scalars as `c_float`) and returns the `cudaError_t` of its launch,
which `check` turns into an exception.

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
# No --use_fast_math: the int8 kernels' requant must round as numpy does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# x, dw_w, dw_b, pw_w, pw_b, out | N, H, W, Cin, Cout, stride, relu6, pw_act
_BLOCK = [_P] * 6 + [_I] * 8
# x, conv_w, conv_b, w0, b0, w1, b1, pooled, out | N, HW, C, E, conv_act,
# n_post, n0, act0, n1, act1 (acts: -1 none, 0 linear, 1 relu, 2 relu6, 3 hswish)
_HEAD = [_P] * 9 + [_I] * 10
# x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, out | N, H, W, Cin, E, Cout,
# stride, residual, TH, TW
_IR = [_P] * 8 + [_I] * 10
# x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se_w1, se_b1, se_w2, se_b2,
# partial, out | N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
# identity, TH, TW
_V3 = [_P] * 13 + [_I] * 15
_CHAIN = [_P] * 8 + [_I] * 6  # x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out | N, H, W, C, K, relu6
# the bf16 separable plan: nwg, th, tw, kp, split, cw, ws, bs
_PLAN = [_I] * 8
_STEM_B0 = [_P] * 8 + [_I] * 5 + [_F] * 2
# C entry points -> argument types; each also takes the stream last.
_SIGNATURES = {
    "separable_block_bf16": _BLOCK + _PLAN, "separable_block_f32": _BLOCK,
    "chain_bf16": _CHAIN + _PLAN, "chain_f32": _CHAIN,
    # x, dw_w, dw_b, dw_m, pw_w, pw_b, pw_m, out | N, H, W, Cin, Cout, stride,
    # relu6 | dw_six_q, pw_six_q
    "separable_block_i8": [_P] * 8 + [_I] * 7 + [_F] * 2,
    "separable_block_i8_linear": [_P] * 8 + [_I] * 7 + [_F] * 2,
    # x, exp_w, exp_b, exp_m, dw_w, dw_b, dw_m, prj_w, prj_b, prj_m, out | N, H,
    # W, Cin, E, Cout, stride, residual, TH, TW | exp_six_q, dw_six_q
    "inverted_residual_i8": [_P] * 11 + [_I] * 10 + [_F] * 2,
    # x, exp_w, exp_b, exp_mult, dw_w, dw_b, dw_mult, prj_w, prj_b, prj_m,
    # se1_w, se1_b, se1_m, se2_w, se2_b, se2_a, pooled, out | N, H, W, Cin, E,
    # Cout, Se, K, stride, act_exp, act, residual, identity, TH, TW | exp_m6,
    # dw_m6, hw_inv, sixth
    "v3_block_i8": [_P] * 18 + [_I] * 15 + [_F] * 4,
    # x, dw_w, dw_b, dw_m, out | N, H, W, C, stride, relu6 | six_q
    "depthwise_i8": [_P] * 5 + [_I] * 6 + [_F],
    # x, w, b (or 0), out | N, H, W, C, stride, relu6
    "depthwise_f32": [_P] * 4 + [_I] * 6, "depthwise_bf16": [_P] * 4 + [_I] * 6,
    "inverted_residual_bf16": _IR, "inverted_residual_f32": _IR,
    "v3_block_bf16": _V3, "v3_block_f32": _V3,
    # x, out, scratch0, scratch1, partial | N, H, W, stages | ptrs (stages x
    # 10 weight pointers), dims (stages x 12 ints): host arrays; grid: one
    # host int the launch's block count is written to
    "v3_chain_bf16": [_P] * 5 + [_I] * 4 + [_P] * 3,
    "v3_chain_f32": [_P] * 5 + [_I] * 4 + [_P] * 3,
    "fused_head_bf16": _HEAD, "fused_head_f32": _HEAD,
    # images, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out | N, H, W, Cout,
    # relu6 | normalize scale, offset
    "stem_block0_f32": _STEM_B0, "stem_block0_bf16": _STEM_B0,
    # x, w, b, out | N, H, W, Cout, relu6
    "stem_conv_f32": [_P] * 4 + [_I] * 5, "stem_conv_bf16": [_P] * 4 + [_I] * 5,
    # the floor probes: x, out | N, bytes per image; x, out | bytes;
    # x, w, out | elements, C, reps, variant
    "hbm_copy": [_P] * 2 + [_I, _L], "hbm_copy_flat": [_P] * 2 + [_L],
    "stencil": [_P] * 3 + [_L] + [_I] * 3,
}
# C functions that launch nothing: (argument types, no stream; result type).
_HOST_SIGNATURES = {
    # nwg, th, tw, kp, ws, bs, stride -> bytes of dynamic shared memory
    "separable_bf16_smem_bytes": ([_I] * 7, ctypes.c_int),
    # Cin, Cout, stride, TH, TW, itemsize -> bytes of dynamic shared memory
    "inverted_residual_smem_bytes": ([_I] * 6, ctypes.c_int),
    # Cin, Cout, stride, TH, TW -> bytes of dynamic shared memory
    "inverted_residual_i8_smem_bytes": ([_I] * 5, ctypes.c_int),
    # Cin, E, Cout, Se, K, stride, TH, TW, itemsize -> bytes of dynamic shared memory
    "v3_block_smem_bytes": ([_I] * 9, ctypes.c_int),
    # Cin, E, Cout, Se, K, stride, identity, TH, TW -> bytes of dynamic shared memory
    "v3_block_i8_smem_bytes": ([_I] * 9, ctypes.c_int),
    "cuda_error_string": ([_I], ctypes.c_char_p),
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


def _compile(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    nvcc = _nvcc()
    cu, _ = _sources()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(cu, objs))]
    logs, failed = [], []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
    if not failed:
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(link)}\n{logs[-1]}")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Raises on a failed
    build or load."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        cu, cuh = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in cu + cuh:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out = BUILD_DIR / f"libmobilenet_kernels_{h.hexdigest()[:16]}.so"
        if out.exists():
            build_seconds = 0.0
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*argtypes, _P]
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
