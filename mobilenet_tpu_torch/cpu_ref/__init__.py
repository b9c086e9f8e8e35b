"""ctypes binding of the native C++ golden oracle (`cpu_ref.cpp`, the port's
copy of the JAX package's `cpu_ref/cpu_ref.cpp`, unchanged).

At first use the source is compiled with `g++ -O2 -shared -fPIC -std=c++17
-ffp-contract=off` into `build/cpu_ref/` at the root of the checkout,
under a file name that carries a hash of the source and the flags, so an
edited source builds anew and a stale library is never loaded. No FMA
contraction: the float32 results are bit-identical to the NumPy twin
(`oracle/numpy_ref.py`). It is the second oracle of the float verify gates
(`runtime/eval.py`, `oracle="cpp"`) and of the V1 int8 gate
(`quant/verify.verify_int8(oracle="cpp")`). Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "cpu_ref.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cpu_ref"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17",
             "-ffp-contract=off")  # no FMA: bit-match the NumPy twin

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_P = ctypes.c_void_p
_c = ctypes.c_int
_c64 = ctypes.c_int64
_cf = ctypes.c_float

# C entry point -> argument types (bias pointers may be NULL)
_SIGNATURES = {
    "conv3x3_f32": [_F32, _F32, _P, _F32] + [_c] * 8,
    "dw3x3_f32": [_F32, _F32, _P, _F32] + [_c] * 7,
    "pw_f32": [_F32, _F32, _P, _F32, _c64] + [_c] * 4,
    "avgpool_f32": [_F32, _F32] + [_c] * 4,
    "fc_f32": [_F32, _F32, _P, _F32] + [_c] * 3,
    "dwka_f32": [_F32, _F32, _P, _F32] + [_c] * 7,
    "pwa_f32": [_F32, _F32, _P, _F32, _c64] + [_c] * 3,
    "conv3x3a_f32": [_F32, _F32, _P, _F32] + [_c] * 7,
    "dw3x3_i8": [_I8, _I8, _P, _F32, _cf, _I8] + [_c] * 6,
    "pw_i8": [_I8, _I8, _P, _F32, _cf, _I8, _c64] + [_c] * 3,
    "conv3x3_i8": [_I8, _I8, _P, _F32, _cf, _I8] + [_c] * 7,
}


def library_path() -> Path:
    """The library's path for this source and these flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libcpuref_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile cpu_ref.cpp unless this source and these flags already are.
    Raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def _bias_ptr(bias, dtype):
    """(pointer, array) of a bias, or (None, None): the caller keeps the
    array alive across the call."""
    if bias is None:
        return None, None
    arr = np.ascontiguousarray(bias, dtype)
    return arr.ctypes.data_as(ctypes.c_void_p), arr


def _out_hw(size: int, stride: int) -> int:
    return -(-size // stride)


def conv3x3(x, w, bias=None, stride=1, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().conv3x3_f32(x, w, bp, out, n, h, wd, cin, cout, stride, int(relu6),
                        int(apply_act))
    return out


def dw3x3(x, w, bias=None, stride=1, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (3,3,1,C)
    n, h, wd, c = x.shape
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().dw3x3_f32(x, w, bp, out, n, h, wd, c, stride, int(relu6), int(apply_act))
    return out


def pw(x, w, bias=None, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (Cin, Cout)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().pw_f32(x.reshape(pixels, cin), w, bp, out.reshape(pixels, cout), pixels, cin,
                   cout, int(relu6), int(apply_act))
    return out


_ACT_KINDS = {None: 0, "relu": 1, "relu6": 2, "hswish": 3, "hsigmoid": 4}


def conv3x3a(x, w, bias=None, stride=1, act=None):
    """Stem conv with a named activation (V3: hswish)."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().conv3x3a_f32(x, w, bp, out, n, h, wd, cin, cout, stride, _ACT_KINDS[act])
    return out


def dwk(x, w, bias=None, stride=1, act=None):
    """Depthwise k x k (k from w.shape; V3 uses 3 and 5), named activation."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (k,k,1,C)
    n, h, wd, c = x.shape
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().dwka_f32(x, w, bp, out, n, h, wd, c, int(w.shape[0]), stride, _ACT_KINDS[act])
    return out


def pwa(x, w, bias=None, act=None):
    """Pointwise matmul with a named activation (V3 expand/project/head)."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().pwa_f32(x.reshape(pixels, cin), w, bp, out.reshape(pixels, cout), pixels, cin,
                    cout, _ACT_KINDS[act])
    return out


def avgpool(x):
    x = np.ascontiguousarray(x, np.float32)
    n, h, wd, c = x.shape
    out = np.empty((n, c), np.float32)
    _load().avgpool_f32(x, out, n, h, wd, c)
    return out


def fc(x, w, bias=None):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, c = x.shape
    out = np.empty((n, w.shape[1]), np.float32)
    bp, _keep = _bias_ptr(bias, np.float32)
    _load().fc_f32(x, w, bp, out, n, c, w.shape[1])
    return out


def dw3x3_i8(x, w, bias_i32, m, s_out, stride=1, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    n, h, wd, c = x.shape
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.int8)
    bp, _keep = _bias_ptr(bias_i32, np.int32)
    _load().dw3x3_i8(x, w, bp, np.ascontiguousarray(m, np.float32), float(s_out), out,
                     n, h, wd, c, stride, int(relu6))
    return out


def pw_i8(x, w, bias_i32, m, s_out, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.int8)
    bp, _keep = _bias_ptr(bias_i32, np.int32)
    _load().pw_i8(x.reshape(pixels, cin), w, bp, np.ascontiguousarray(m, np.float32),
                  float(s_out), out.reshape(pixels, cout), pixels, cin, cout, int(relu6))
    return out


def conv3x3_i8(x, w, bias_i32, m, s_out, stride=1, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout), np.int8)
    bp, _keep = _bias_ptr(bias_i32, np.int32)
    _load().conv3x3_i8(x, w, bp, np.ascontiguousarray(m, np.float32), float(s_out), out,
                       n, h, wd, cin, cout, stride, int(relu6))
    return out


def forward_all(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle MobileNet-V1 forward, tap names matching
    models.mobilenet_v1.forward(collect=True); the twin of
    oracle/numpy_ref.forward_all."""
    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    y = conv3x3(x, params["conv1"]["w"], params["conv1"]["b"], 2, relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(params["blocks"], config.block_strides)):
        y = dw3x3(y, blk["dw"]["w"], blk["dw"]["b"], stride, relu6)
        acts[f"block{i:02d}_dw"] = y
        y = pw(y, blk["pw"]["w"], blk["pw"]["b"], relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    logits = fc(pooled, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def forward_all_v2(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle MobileNet-V2 forward (config a V2Config), tap names
    matching models.mobilenet_v2.forward_v2(collect=True); the twin of
    oracle/numpy_ref.forward_all_v2. The residual adds are NumPy float32."""
    acts: Dict[str, np.ndarray] = {}
    y = conv3x3(x, params["conv1"]["w"], params["conv1"]["b"], 2, True)
    acts["conv1"] = y
    for i, ((_, cin, cout, stride), blk) in enumerate(zip(config.block_defs, params["blocks"])):
        z = y
        if "exp" in blk:
            z = pw(z, blk["exp"]["w"], blk["exp"]["b"], relu6=True)
            acts[f"block{i:02d}_exp"] = z
        z = dw3x3(z, blk["dw"]["w"], blk["dw"]["b"], stride, True)
        acts[f"block{i:02d}_dw"] = z
        out = pw(z, blk["prj"]["w"], blk["prj"]["b"], apply_act=False)
        acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            out = (out + y).astype(np.float32)
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pw(y, params["conv_last"]["w"], params["conv_last"]["b"], relu6=True)
    acts["conv_last"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    logits = fc(pooled, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def forward_all_v3(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle MobileNet-V3 forward (config a V3Config), tap names
    matching models.mobilenet_v3.forward_v3(collect=True); the twin of
    oracle/numpy_ref.forward_all_v3. The SE gate's scale multiply and the
    residual adds are NumPy float32."""
    acts: Dict[str, np.ndarray] = {}
    head_act = config.head_act
    y = conv3x3a(x, params["conv1"]["w"], params["conv1"]["b"], 2, head_act)
    acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, params["blocks"])):
        z = y
        if bd.has_expand:
            z = pwa(z, blk["exp"]["w"], blk["exp"]["b"], bd.act)
            acts[f"block{i:02d}_exp"] = z
        z = dwk(z, blk["dw"]["w"], blk["dw"]["b"], bd.stride, bd.act)
        acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            se = blk["se"]
            g = pwa(avgpool(z), se["w1"], se["b1"], "relu")
            g = pwa(g, se["w2"], se["b2"], "hsigmoid")
            z = (z * g[:, None, None, :]).astype(np.float32)
            acts[f"block{i:02d}_se"] = z
        out = pwa(z, blk["prj"]["w"], blk["prj"]["b"], None)
        acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = (out + y).astype(np.float32)
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pwa(y, params["conv_last"]["w"], params["conv_last"]["b"], head_act)
    acts["conv_last"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    h = pwa(pooled, params["head"]["w"], params["head"]["b"], head_act)
    acts["head"] = h
    logits = fc(h, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts
