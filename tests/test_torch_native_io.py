"""The port's native decoder (`mobilenet_tpu_torch/native_io`, the JAX
package's decode.cpp built into build/native_io/) against the JAX
package's: PNG (RGB, RGBA, gray, palette, 16-bit gray, 16-bit RGB) and JPEG
(baseline, progressive, gray) files written with PIL decode bit for bit the
same through both; a corrupt, a truncated and a missing file fail the same
way, in `decode_batch` with strict on (raises, naming the file) and off
(None in place); `decode_batch` equals decoding file by file;
`decode_image_host` equals the JAX function on every backend; and the
library is built where the port says, under a name that carries the
source's hash."""

import shutil

import numpy as np
import pytest
from PIL import Image

from mobilenet_tpu import native_io as jax_native_io
from mobilenet_tpu.ops.preprocess import decode_image_host as jax_decode_host
from mobilenet_tpu_torch import native_io
from mobilenet_tpu_torch.ops.preprocess import decode_image_host


@pytest.fixture(scope="module", autouse=True)
def _built():
    if shutil.which("g++") is None or not native_io.available():
        pytest.skip(f"the native decoder does not build here: {native_io.build_error()}")
    if not jax_native_io.available():
        pytest.skip("the JAX package's native decoder does not build here")


def _write(path, kind, rng):
    """One image file of `kind` at `path`."""
    if kind == "rgb.png":
        Image.fromarray(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)).save(path)
    elif kind == "rgba.png":
        Image.fromarray(rng.integers(0, 256, (20, 30, 4), dtype=np.uint8), "RGBA").save(path)
    elif kind == "gray.png":
        Image.fromarray(rng.integers(0, 256, (25, 31), dtype=np.uint8), "L").save(path)
    elif kind == "palette.png":
        im = Image.fromarray(rng.integers(0, 16, (19, 23), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 16 * 3, dtype=np.uint8).tolist())
        im.save(path)
    elif kind == "gray16.png":
        Image.fromarray(rng.integers(0, 65536, (17, 29), dtype=np.uint16)).save(path)
    elif kind == "rgb16.png":
        _png_rgb16(path, rng.integers(0, 65536, (9, 13, 3), dtype=np.uint16))
    elif kind == "baseline.jpg":
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(path, quality=90)
    elif kind == "progressive.jpg":
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            path, quality=85, progressive=True)
    elif kind == "gray.jpg":
        Image.fromarray(rng.integers(0, 256, (33, 44), dtype=np.uint8), "L").save(path, quality=90)
    else:
        raise KeyError(kind)


def _png_rgb16(path, arr):
    """A 16-bit RGB PNG by hand (PIL writes no 16-bit RGB)."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(h))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


KINDS = ["rgb.png", "rgba.png", "gray.png", "palette.png", "gray16.png", "rgb16.png",
         "baseline.jpg", "progressive.jpg", "gray.jpg"]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_equals_jax(tmp_path, kind):
    path = tmp_path / f"t_{kind}"
    _write(path, kind, np.random.default_rng(len(kind)))
    ours, theirs = native_io.decode_image(str(path)), jax_native_io.decode_image(str(path))
    assert ours.dtype == np.uint8 and ours.ndim == 3 and ours.shape[2] == 3
    np.testing.assert_array_equal(ours, theirs)
    for backend in ("native", "pil", "auto"):
        np.testing.assert_array_equal(decode_image_host(str(path), backend),
                                      jax_decode_host(str(path), backend))


def _bad_files(tmp_path):
    good = tmp_path / "good.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (10, 10, 3),
                                                       dtype=np.uint8)).save(good)
    trunc = tmp_path / "trunc.png"
    trunc.write_bytes(good.read_bytes()[:40])
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"notanimage" * 10)
    return good, trunc, garbage, tmp_path / "missing.png"


def test_errors_equal_jax(tmp_path):
    _, trunc, garbage, missing = _bad_files(tmp_path)
    for path in (trunc, garbage, missing):
        with pytest.raises(ValueError) as ours:
            native_io.decode_image(str(path))
        with pytest.raises(ValueError) as theirs:
            jax_native_io.decode_image(str(path))
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown decode backend"):
        decode_image_host(str(garbage), backend="opencv")


@pytest.mark.parametrize("strict", [True, False])
def test_decode_batch_corrupt_file(tmp_path, strict):
    good, trunc, garbage, missing = _bad_files(tmp_path)
    paths = [str(good), str(trunc), str(good), str(garbage), str(missing)]
    if strict:
        with pytest.raises(ValueError) as ours:
            native_io.decode_batch(paths)
        with pytest.raises(ValueError) as theirs:
            jax_native_io.decode_batch(paths)
        assert str(ours.value) == str(theirs.value) and "trunc.png" in str(ours.value)
        return
    ours = native_io.decode_batch(paths, strict=False)
    theirs = jax_native_io.decode_batch(paths, strict=False)
    assert [o is None for o in ours] == [t is None for t in theirs] == [
        False, True, False, True, True]
    for o, t in zip(ours, theirs):
        if o is not None:
            np.testing.assert_array_equal(o, t)


def test_decode_batch_equals_per_file(tmp_path):
    """17 files of mixed kinds (more than a pool's threads, an odd count):
    the batch in input order equals decoding each file alone, in both
    packages."""
    rng = np.random.default_rng(11)
    paths = []
    for i in range(17):
        path = tmp_path / f"img_{i:02d}_{KINDS[i % len(KINDS)]}"
        _write(path, KINDS[i % len(KINDS)], rng)
        paths.append(str(path))
    for threads in (0, 1, 4):
        batch = native_io.decode_batch(paths, threads=threads)
        assert len(batch) == len(paths)
        for p, got in zip(paths, batch):
            np.testing.assert_array_equal(got, native_io.decode_image(p))
            np.testing.assert_array_equal(got, jax_native_io.decode_image(p))
    assert native_io.decode_batch([]) == []


def test_library_lives_under_build():
    lib = native_io.library_path()
    assert lib.parent == native_io.BUILD_DIR and lib.parent.parts[-2:] == ("build", "native_io")
    assert lib.name.startswith("libnativeio_") and lib.exists()
    assert not list(native_io._SRC.parent.glob("*.so"))
