"""The port and its chip smoke test import neither JAX nor the JAX package,
and importing the port builds no kernel."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mobilenet_tpu")
FILES = sorted((ROOT / "mobilenet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_builds_nothing():
    import mobilenet_tpu_torch.models.mobilenet_v1  # noqa: F401
    import mobilenet_tpu_torch.models.mobilenet_v2  # noqa: F401
    import mobilenet_tpu_torch.models.mobilenet_v3  # noqa: F401
    import mobilenet_tpu_torch.ops.inverted_residual  # noqa: F401
    import mobilenet_tpu_torch.ops.inverted_residual_i8  # noqa: F401
    import mobilenet_tpu_torch.ops.v3_block  # noqa: F401
    import mobilenet_tpu_torch.ops.v3_block_i8  # noqa: F401
    import mobilenet_tpu_torch.ops.v3_chain  # noqa: F401
    import mobilenet_tpu_torch.floors  # noqa: F401
    import mobilenet_tpu_torch.roofline  # noqa: F401
    import mobilenet_tpu_torch.quant.v2  # noqa: F401
    import mobilenet_tpu_torch.quant.v3  # noqa: F401
    import mobilenet_tpu_torch.native_io  # noqa: F401
    from mobilenet_tpu_torch.ops import _build

    # the native decoder's library may have been loaded by another test in
    # this process; test_import_writes_nothing_under_build checks it in a
    # fresh interpreter
    assert _build._lib is None


def test_accuracy_path_modules_are_checked():
    """The accuracy path's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/native_io/__init__.py",
            "mobilenet_tpu_torch/runtime/metrics.py",
            "mobilenet_tpu_torch/utils/flops.py",
            "mobilenet_tpu_torch/ops/preprocess.py",
            "mobilenet_tpu_torch/checkpoints/io.py"} <= names


def test_import_writes_nothing_under_build():
    """A fresh interpreter importing the port and its entry points (the CLI,
    eval, metrics, the native decoder) loads no library and writes nothing
    under build/native_io/ or build/kernels/."""
    import subprocess
    import sys

    def snapshot():
        return {str(p): p.stat().st_mtime_ns for sub in ("native_io", "kernels")
                for p in (ROOT / "build" / sub).glob("**/*")}

    before = snapshot()
    code = ("import mobilenet_tpu_torch, mobilenet_tpu_torch.cli, "
            "mobilenet_tpu_torch.runtime.eval, mobilenet_tpu_torch.runtime.metrics, "
            "mobilenet_tpu_torch.ops.preprocess\n"
            "from mobilenet_tpu_torch import native_io\n"
            "from mobilenet_tpu_torch.ops import _build\n"
            "assert native_io._lib is None and _build._lib is None\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    assert snapshot() == before


def test_v2_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/models/mobilenet_v2.py",
            "mobilenet_tpu_torch/checkpoints/v2.py",
            "mobilenet_tpu_torch/ops/inverted_residual.py",
            "mobilenet_tpu_torch/ops/inverted_residual_i8.py",
            "mobilenet_tpu_torch/quant/v2.py",
            "mobilenet_tpu_torch/oracle/numpy_ref.py",
            "mobilenet_tpu_torch/runtime/eval.py"} <= names


def test_v3_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/models/mobilenet_v3.py",
            "mobilenet_tpu_torch/checkpoints/v3.py",
            "mobilenet_tpu_torch/checkpoints/convert.py",
            "mobilenet_tpu_torch/ops/v3_block.py",
            "mobilenet_tpu_torch/ops/conv.py",
            "mobilenet_tpu_torch/oracle/numpy_ref.py",
            "mobilenet_tpu_torch/runtime/eval.py",
            "mobilenet_tpu_torch/runtime/pipeline.py",
            "mobilenet_tpu_torch/runtime/serving.py"} <= names


def test_v3_int8_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/quant/v3.py",
            "mobilenet_tpu_torch/quant/verify.py",
            "mobilenet_tpu_torch/ops/v3_block_i8.py"} <= names


def test_verify_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/cli.py",
            "mobilenet_tpu_torch/cpu_ref/__init__.py",
            "mobilenet_tpu_torch/ops/depthwise.py",
            "mobilenet_tpu_torch/utils/golden.py",
            "mobilenet_tpu_torch/runtime/eval.py",
            "mobilenet_tpu_torch/quant/verify.py"} <= names


def test_verify_imports_build_nothing():
    """Importing the verify entry point, the depthwise wrapper and the C++
    oracle's loader builds neither the kernels nor the oracle library's
    binding (the oracle builds at its first call)."""
    import mobilenet_tpu_torch.cli  # noqa: F401
    import mobilenet_tpu_torch.ops.depthwise  # noqa: F401
    import mobilenet_tpu_torch.runtime.eval  # noqa: F401
    from mobilenet_tpu_torch import cpu_ref
    from mobilenet_tpu_torch.ops import _build

    assert _build._lib is None
    assert cpu_ref.library_path().name.startswith("libcpuref_")


def test_stem_modules_are_checked():
    """The stem kernels' wrapper and the fused-stem route are among the
    files checked above, and importing them builds nothing."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"mobilenet_tpu_torch/ops/stem.py",
            "mobilenet_tpu_torch/models/mobilenet_v1.py",
            "mobilenet_tpu_torch/profile.py"} <= names
    import mobilenet_tpu_torch.ops.stem  # noqa: F401
    import mobilenet_tpu_torch.profile  # noqa: F401
    from mobilenet_tpu_torch.ops import _build

    assert _build._lib is None
