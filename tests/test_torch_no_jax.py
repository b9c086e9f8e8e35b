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
    from mobilenet_tpu_torch.ops import _build

    assert _build._lib is None
