"""The port's `cli classify` and `cli export` against the JAX package's
commands, on the CPU (`--device cpu`, `--backend cpu`):

  - classify: the same top-k classes, probabilities within `PROB_ATOL` in
    float32 on an image that both resize on their device; with --int8
    (MobileNet-V1, -V2, -V3-Small) the same printed lines, on an image at the
    model's size (no resize: the int8 input is then the same bytes in both);
  - export: the three .npz files with the JAX command's names, keys and
    arrays: raw and folded bit for bit, the int8 tree exactly, from the
    seeded set, a keras .h5 and a raw .npz; two weight sources, or a TF-slim
    checkpoint for V2, refused;
  - a round trip: `eval --ckpt <folded.npz>` prints the report of `eval` on
    the seeded weights that were exported, float32 and int8."""

import json

import numpy as np
import pytest
from PIL import Image

from mobilenet_tpu import cli as jax_cli
from mobilenet_tpu_torch.cli import main as cli_main

# float32 softmax probabilities of two float32 forwards that differ by
# reassociation (~1e-6 relative on the logits)
PROB_ATOL = 1e-4

SIZES = {"v1": ["--alpha", "0.25", "--res", "64"], "v2": ["--alpha", "0.35", "--res", "64"],
         "v3small": ["--alpha", "1.0", "--res", "64"]}
VARIANTS = {"v1": "mobilenet_v1_0.25_64", "v2": "mobilenet_v2_0.35_64",
            "v3small": "mobilenet_v3_small_1_64"}


def _top(out):
    """[(class, prob)] of classify's printed lines."""
    rows = [ln.split() for ln in out.strip().splitlines() if ln.startswith("top-")]
    return [(int(r[2]), float(r[3][2:])) for r in rows]


def _png(path, shape, seed):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)).save(path)
    return str(path)


def test_classify_float32_equals_jax(tmp_path, capsys):
    img = _png(tmp_path / "t.png", (70, 90, 3), 0)
    args = ["classify", img, "--dtype", "float32", "--top-k", "5"] + SIZES["v1"]
    cli_main(args + ["--device", "cpu"])
    ours = _top(capsys.readouterr().out)
    jax_cli.main(["--backend", "cpu"] + args)
    theirs = _top(capsys.readouterr().out)
    assert len(ours) == 5 and [c for c, _ in ours] == [c for c, _ in theirs]
    np.testing.assert_allclose([p for _, p in ours], [p for _, p in theirs], atol=PROB_ATOL)


@pytest.mark.parametrize("model", ["v1", "v2", "v3small"])
def test_classify_int8_equals_jax(tmp_path, capsys, model):
    img = _png(tmp_path / "t.png", (64, 64, 3), 1)
    args = ["classify", img, "--int8", "--model", model] + SIZES[model]
    cli_main(args + ["--device", "cpu"])
    ours = capsys.readouterr().out
    jax_cli.main(["--backend", "cpu"] + args)
    assert ours == capsys.readouterr().out
    assert len(_top(ours)) == 5


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_npz_equal(ours, theirs):
    a, b = _npz(ours), _npz(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _source(tmp_path, model, source):
    """Extra export arguments for a weight source."""
    if source == "seeded":
        return ["--seed", "3"]
    if source == "keras":
        from test_keras_import import _write_keras_h5

        from mobilenet_tpu import ModelConfig as JaxModelConfig
        from mobilenet_tpu.checkpoints import init_params as jax_init

        cfg = JaxModelConfig(alpha=0.25, resolution=64)
        h5 = str(tmp_path / "k.h5")
        _write_keras_h5(h5, jax_init(cfg, seed=5), cfg)
        return ["--from-keras", h5]
    from mobilenet_tpu_torch.checkpoints import init_params_v2, save_npz
    from mobilenet_tpu_torch.models.mobilenet_v2 import V2Config

    raw = str(tmp_path / "raw.npz")
    save_npz(raw, init_params_v2(V2Config(alpha=0.35, resolution=64), seed=7))
    return ["--ckpt", raw]


@pytest.mark.parametrize("model,source", [("v1", "seeded"), ("v2", "seeded"),
                                          ("v3small", "seeded"), ("v1", "keras"),
                                          ("v2", "ckpt")])
def test_export_equals_jax(tmp_path, capsys, model, source):
    extra = _source(tmp_path, model, source)
    base = ["export", "--model", model] + SIZES[model] + extra
    cli_main(base + ["--out", str(tmp_path / "ours")])
    jax_cli.main(["--backend", "cpu"] + base + ["--out", str(tmp_path / "jax")])
    capsys.readouterr()
    for kind in ("raw", "folded", "int8"):
        name = f"{VARIANTS[model]}_{kind}.npz"
        _assert_npz_equal(tmp_path / "ours" / name, tmp_path / "jax" / name)


def test_export_refuses_two_sources_and_slim_for_v2(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli_main(["export", "--from-keras", "a.h5", "--ckpt", "b.npz",
                  "--out", str(tmp_path)] + SIZES["v1"])
    with pytest.raises(SystemExit, match="V1 TF-slim layout only"):
        cli_main(["export", "--model", "v2", "--from-tf-slim", "p",
                  "--out", str(tmp_path)] + SIZES["v2"])


@pytest.mark.parametrize("int8", [False, True])
def test_eval_ckpt_round_trip(tmp_path, capsys, int8):
    cli_main(["export", "--out", str(tmp_path)] + SIZES["v1"])
    common = ["eval", "--n", "4", "--batch", "2", "--device", "cpu"] + SIZES["v1"]
    common += ["--int8"] if int8 else []
    cli_main(common)
    seeded = capsys.readouterr().out.strip().splitlines()[-1]
    cli_main(common + ["--ckpt", str(tmp_path / f"{VARIANTS['v1']}_folded.npz")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == seeded
    assert json.loads(seeded)["top1_agreement_tie_aware"] == 1.0
