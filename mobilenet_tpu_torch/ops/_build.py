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
# x, conv_w, conv_b, w0, b0, w1, b1, pooled, mid, out | N, HW, C, E, conv_act,
# n_post, m0, act0, m1, act1, m_out (acts: -1 none, 0 linear, 1 relu, 2 relu6,
# 3 hswish), then bf16: conv_nwg, conv_groups, conv_stages, kparts0, kparts1,
# stages0, stages1 (ops/head.head_plan); float32: conv_bm, conv_groups,
# kparts0, kparts1 (ops/head.f32_head_plan)
_HEAD_BF16 = [_P] * 10 + [_I] * 18
_HEAD_F32 = [_P] * 10 + [_I] * 15
# x, exp_w, exp_b, dw_w, dw_b, prj_w, prj_b, se_w1, se_b1, se_w2, se_b2,
# partial, out | N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual,
# identity, then float32 th, tw, ws, bs (ops/v3_block.v3_plan)
_V3 = [_P] * 13 + [_I] * 17
# ... then th, tw, split, cw, ws, bs (ops/v3_block.v3_wgmma_plan) for bf16;
# partial: N x tiles x E f32 sums then N x E f32 gates (SE blocks)
_V3_BF16 = [_P] * 13 + [_I] * 19
_CHAIN = [_P] * 8 + [_I] * 6  # x, dw_ws, dw_bs, pw_ws, pw_bs, scratch0, scratch1, out | N, H, W, C, K, relu6
# the bf16 and int8 separable plans: nwg, th, tw, kp, split, cw, ws, bs
_PLAN = [_I] * 8
# the float32 separable plan: mg, th, tw, kp, split, cw, ns, ws, bs
_F32_PLAN = [_I] * 9
_STEM_CONV = [_P] * 4 + [_I] * 8
_STEM_B0 = [_P] * 8 + [_I] * 5 + [_F] * 2 + [_I] * 2
# C entry points -> argument types; each also takes the stream last.
_SIGNATURES = {
    "separable_block_bf16": _BLOCK + _PLAN, "separable_block_f32": _BLOCK + _F32_PLAN,
    "chain_bf16": _CHAIN + _PLAN, "chain_f32": _CHAIN + _F32_PLAN,
    # x, dw_w, dw_b, dw_m, pw_wt (K-major), pw_b, pw_m, out | N, H, W, Cin,
    # Cout, stride, relu6 | dw_six_q, pw_six_q | the int8 plan (as _PLAN)
    "separable_block_i8": [_P] * 8 + [_I] * 7 + [_F] * 2 + _PLAN,
    "separable_block_i8_linear": [_P] * 8 + [_I] * 7 + [_F] * 2 + _PLAN,
    # x, exp_wt, exp_b, exp_mult, dw_table, dw_b, dw_mult, prj_wt, prj_b,
    # prj_m, se1_w, se1_b, se1_m, se2_w, se2_b, se2_a, pooled, gate, z, out |
    # N, H, W, Cin, E, Cout, Se, K, stride, act_exp, act, residual, identity |
    # th, tw, split, cw, ws, bs (ops/v3_block_i8.v3_i8_wgmma_plan) | exp_m6,
    # dw_m6 (hswish's m6, or the relu/relu6 upper bound), hw_inv, sixth
    "v3_block_i8": [_P] * 20 + [_I] * 19 + [_F] * 4,
    # a launch prepared by v3_block_i8_prepare (below) in buf: buf, x, pooled,
    # gate, z, out
    "v3_block_i8_run": [_P] * 6,
    # x, dw_w, dw_b, dw_m, out | N, H, W, C, stride, relu6 | six_q | th, tw,
    # seg, nv, ws (ops/depthwise.dw_plan)
    "depthwise_i8": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 5,
    # x, w, b (or 0), out | N, H, W, C, stride, relu6 | th, tw, seg, nv, ws
    "depthwise_f32": [_P] * 4 + [_I] * 11, "depthwise_bf16": [_P] * 4 + [_I] * 11,
    "v3_block_bf16": _V3_BF16, "v3_block_f32": _V3,
    # x, out, scratch0, scratch1, partial | N, H, W, stages | ptrs (stages x
    # 10 weight pointers), dims (stages x 14 ints): host arrays; grid: one
    # host int the launch's block count is written to
    "v3_chain_f32": [_P] * 5 + [_I] * 4 + [_P] * 3,
    # the same with gate (N x E f32) and maps (the device copy of
    # v3_chain_bf16_maps' output) after partial; dims: stages x 16 ints
    "v3_chain_bf16": [_P] * 7 + [_I] * 4 + [_P] * 3,
    "fused_head_bf16": _HEAD_BF16, "fused_head_f32": _HEAD_F32,
    # images, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b, out | N, H, W, Cout,
    # relu6 | normalize scale, offset | th, grid (ops/stem.stem_plan); float32:
    # th, cpu, grid (ops/stem.f32_stem_plan)
    "stem_block0_f32": _STEM_B0 + [_I], "stem_block0_bf16": _STEM_B0,
    # x, w, b, out | N, H, W, Cout, relu6 | th, tw, grid
    "stem_conv_f32": _STEM_CONV, "stem_conv_bf16": _STEM_CONV,
    # the floor probes: x, out | bytes; x, w, out | elements, C, reps,
    # variant, then the plan's chains, passes, stride, grid
    # (floors.stencil_plan)
    "hbm_copy_flat": [_P] * 2 + [_L], "stencil": [_P] * 3 + [_L] + [_I] * 7,
}
# C functions that launch nothing: (argument types, no stream; result type).
_HOST_SIGNATURES = {
    # nwg, th, tw, kp, ws, bs, stride -> bytes of dynamic shared memory
    "separable_bf16_smem_bytes": ([_I] * 7, ctypes.c_int),
    # mg, th, tw, kp, ns, ws, bs, stride -> bytes of dynamic shared memory
    # (ops/separable_block.f32_sep_smem_bytes)
    "separable_f32_smem_bytes": ([_I] * 8, ctypes.c_int),
    # nwg, th, tw, kp, ws, bs, stride, cin -> bytes of dynamic shared memory
    "separable_i8_smem_bytes": ([_I] * 8, ctypes.c_int),
    # th, tw, H, W, Cin, E, Cout, Se, K, stride, ws, bs, identity -> bytes of
    # dynamic shared memory (ops/v3_block.v3_smem_bytes)
    "v3_f32_smem_bytes": ([_I] * 13, ctypes.c_int),
    # th, tw, Cin, E, Cout, K, stride, cw, ws, bs, identity, pass (0 full, 1
    # pool, 2 gated) -> bytes of dynamic shared memory
    "v3_i8_wgmma_smem_bytes": ([_I] * 12, ctypes.c_int),
    # th, tw, Cin, E, Cout, K, stride, cw, ws, bs, identity -> bytes of dynamic shared memory
    "v3_wgmma_smem_bytes": ([_I] * 11, ctypes.c_int),
    # elem, stride, th, tw, nv, ws -> bytes of dynamic shared memory
    # (ops/depthwise.dw_smem_bytes)
    "depthwise_smem_bytes": ([_I] * 6, ctypes.c_int),
    # block0, th, tw, cout -> bytes of dynamic shared memory (ops/stem.stem_smem_bytes)
    "stem_smem_bytes": ([_I] * 4, ctypes.c_int),
    # block0, th, tw, cout -> bytes of dynamic shared memory of the float32
    # kernels (ops/stem.f32_stem_smem_bytes)
    "stem_f32_smem_bytes": ([_I] * 4, ctypes.c_int),
    # kind (0 conv_walk, 1 post), C, nwg, stages -> bytes of dynamic shared
    # memory (ops/head.head_smem_bytes)
    "head_smem_bytes": ([_I] * 4, ctypes.c_int),
    # kind (0 conv_walk, 1 post, 2 narrow), pool, nc -> bytes of dynamic
    # shared memory of the float32 kernels (ops/head.f32_head_smem_bytes)
    "head_f32_smem_bytes": ([_I] * 3, ctypes.c_int),
    # the bytes of v3_block_i8_prepare's buffer
    "v3_block_i8_prepared_bytes": ([], ctypes.c_int),
    # buf, then v3_block_i8's arguments but x, the SE scratch, out and the
    # stream: its checks, geometry and weight maps into buf -> cudaError_t
    "v3_block_i8_prepare": ([_P] * 16 + [_I] * 19 + [_F] * 4, ctypes.c_int),
    # host (stages x 1152 bytes), x, scratch0, scratch1, gate | N, H, W, stages |
    # ptrs, dims (as v3_chain_bf16): the bf16 chain's TMA tensor maps -> cudaError_t
    "v3_chain_bf16_maps": ([_P] * 5 + [_I] * 4 + [_P] * 2, ctypes.c_int),
    # variant, chains -> blocks of the stencil kernel an SM holds
    # (floors.stencil_plan's blocks_per_sm)
    "stencil_blocks_per_sm": ([_I] * 2, ctypes.c_int),
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
