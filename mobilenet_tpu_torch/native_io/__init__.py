"""Native C++ image decode on the host: `decode.cpp` (the JAX package's
`native_io/decode.cpp`, copied unchanged) against the system libjpeg and
libpng, bound with ctypes.

At first use the source is compiled with `g++ -O2 -shared -fPIC -std=c++17
-pthread ... -ljpeg -lpng` into `build/native_io/` at the root of the
checkout, under a file name that carries a hash of the source and the
flags (as `cpu_ref` builds), so an edited source builds anew and no library
is written beside the source. Nothing builds at import.

`decode_image(path)` returns an (H, W, 3) uint8 RGB array, `decode_batch`
decodes many files on a native thread pool. Resize and normalization stay
on the device (`ops/preprocess.py`). Where the library does not build (no
g++, no libjpeg or libpng headers), `available()` is False and
`build_error()` says why; `ops.preprocess.decode_image_host` then decodes
with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_io"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_ERRORS = {
    1: "cannot open file or unrecognized format (not JPEG/PNG)",
    2: "corrupt image data",
    3: "out of memory",
    4: "unexpected decoded layout",
}


def library_path() -> Path:
    """The library's path for this source and these flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libnativeio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile decode.cpp unless this source and these flags already are.
    Raises RuntimeError on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ on this machine
        raise RuntimeError(f"native_io build failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native_io build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        cint = ctypes.c_int
        lib.mnv1_decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(u8p),
                                          ctypes.POINTER(cint), ctypes.POINTER(cint)]
        lib.mnv1_decode_image.restype = cint
        lib.mnv1_free.argtypes = [u8p]
        lib.mnv1_free.restype = None
        lib.mnv1_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), cint, cint, ctypes.POINTER(u8p),
            ctypes.POINTER(cint), ctypes.POINTER(cint), ctypes.POINTER(cint)]
        lib.mnv1_decode_batch.restype = cint
        _lib = lib
        return lib


def available() -> bool:
    """True when the native decoder builds and loads on this machine; the
    first failure is kept (`build_error`) and not retried."""
    global _error
    if _error is not None:
        return False
    try:
        _load()
        return True
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return False


def build_error() -> Optional[str]:
    """Why `available()` returned False, or None."""
    return _error


def decode_image(path: str) -> np.ndarray:
    """Decode a JPEG/PNG file to an (H, W, 3) uint8 RGB array."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_ubyte)()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.mnv1_decode_image(os.fspath(path).encode(), ctypes.byref(out),
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"native decode failed for {path!r}: {_ERRORS.get(rc, rc)}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(h.value * w.value * 3,)).copy()
    finally:
        lib.mnv1_free(out)
    return arr.reshape(h.value, w.value, 3)


def decode_batch(paths, threads: int = 0, strict: bool = True):
    """Decode many JPEG/PNG files concurrently on decode.cpp's thread pool
    (off the interpreter lock); `threads` 0 lets the pool choose.

    Returns a list of (H, W, 3) uint8 arrays aligned with `paths`. With
    strict=True any failure raises with each failing file named; with
    strict=False a failed entry is None."""
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fspath(p).encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    hs, ws, rcs = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    failures = lib.mnv1_decode_batch(c_paths, n, threads, outs, hs, ws, rcs)
    images, errors = [], []
    try:
        for i in range(n):
            if rcs[i] != 0:
                images.append(None)
                errors.append(f"{paths[i]!r}: {_ERRORS.get(rcs[i], rcs[i])}")
                continue
            size = hs[i] * ws[i] * 3
            images.append(np.ctypeslib.as_array(outs[i], shape=(size,))
                          .copy().reshape(hs[i], ws[i], 3))
    finally:
        for i in range(n):
            if outs[i]:
                lib.mnv1_free(outs[i])
    if len(errors) != failures:
        raise RuntimeError(f"native batch decode: {failures} failures reported, "
                           f"{len(errors)} found")
    if strict and errors:
        raise ValueError(f"native batch decode: {len(errors)}/{n} failed: "
                         + "; ".join(errors[:5]))
    return images
