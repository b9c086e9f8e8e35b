"""The port's end-to-end accuracy gate against the JAX package's, on the
CPU: `evaluate_agreement` on the same images, folded weights and oracle
gives the JAX function's report (int8: every key exactly; float32: every
key but top5_overlap, which may differ by `TOP5_TOL`, since float32 logits
that agree to rounding may swap neighbouring ranks), `load_dir_images`
decodes a mixed directory to the JAX function's arrays, the host's
reference of the device's preprocessing (the oracle's input) agrees with
the JAX package's and the port's, a planted fault (a pipeline that flips
one image's class) drops the agreement and makes `cli eval` exit 1, and a
fault in the device's resize makes it refuse its report; the constants that the gate and the reports read
(`flops_per_image`, `BF16_TIE_MARGIN`) equal the JAX package's; and
`runtime/metrics.build_report` fills `mfu` from the card's peaks only for a
pipeline on a CUDA device."""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from mobilenet_tpu import ModelConfig as JaxModelConfig
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu.runtime import eval as jax_eval
from mobilenet_tpu.utils import golden as jax_golden
from mobilenet_tpu.utils.profiling import flops_per_image as jax_flops
from mobilenet_tpu_torch import InferencePipeline, ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import default_folded
from mobilenet_tpu_torch.cli import main as cli_main
from mobilenet_tpu_torch.runtime import eval as teval
from mobilenet_tpu_torch.runtime import metrics
from mobilenet_tpu_torch.utils import flops, golden

# top5_overlap is a mean over images of |top5(device) & top5(oracle)| / 5:
# one swap of rank 5 with rank 6 in one image of N moves it by 1 / (5 N).
TOP5_TOL = 0.05

# (port config, JAX config) of each family at the tests' size
CASES = {
    "v1": (ModelConfig(0.25, 64, compute_dtype="float32"),
           JaxModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")),
    "v2": (V2Config(alpha=0.35, resolution=64, compute_dtype="float32"),
           JaxV2Config(alpha=0.35, resolution=64, compute_dtype="float32")),
    "v3small": (V3Config(variant="small", alpha=1.0, resolution=64, compute_dtype="float32"),
                JaxV3Config(variant="small", alpha=1.0, resolution=64,
                            compute_dtype="float32")),
}


def _reports(family, images, **kw):
    cfg, jcfg = CASES[family]
    folded = default_folded(cfg, seed=0)
    ours = teval.evaluate_agreement(cfg, images, params=folded, device="cpu", **kw)
    theirs = jax_eval.evaluate_agreement(jcfg, images, params=folded, **kw)
    return ours, theirs


@pytest.mark.parametrize("family,oracle", [("v1", "numpy"), ("v1", "cpp"), ("v2", "numpy"),
                                           ("v3small", "numpy")])
def test_int8_report_equals_jax(family, oracle):
    """Ten images in batches of 4: the trailing chunk of 2 is padded."""
    if oracle == "cpp" and shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the C++ oracle cannot be built")
    images = teval.synth_images(CASES[family][0], 10, seed=9)
    ours, theirs = _reports(family, images, int8=True, oracle=oracle, batch_size=4)
    assert ours == theirs
    assert ours["top1_agreement"] == 1.0 and ours["dtype"] == "int8"


def _float_equal(ours, theirs):
    assert abs(ours.pop("top5_overlap") - theirs.pop("top5_overlap")) <= TOP5_TOL
    assert ours == theirs


@pytest.mark.parametrize("family", ["v1", "v2", "v3small"])
def test_float32_report_equals_jax(family):
    images = teval.synth_images(CASES[family][0], 8, seed=5)
    ours, theirs = _reports(family, images, batch_size=4, tie_margin=1e-3)
    assert ours["dtype"] == "float32"
    _float_equal(ours, theirs)


def _mixed_dir(path):
    """Three PNG shapes (one repeated), a JPEG, a grey PNG and a text file."""
    rng = np.random.default_rng(2)
    for i, shape in enumerate([(80, 64), (64, 80), (80, 64), (64, 64)]):
        Image.fromarray(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).save(
            path / f"img{i}.png")
    Image.fromarray(rng.integers(0, 256, (70, 66, 3), dtype=np.uint8)).save(
        path / "img4.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (64, 64), dtype=np.uint8), mode="L").save(
        path / "img5.png")
    (path / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("native", [True, False])
def test_load_dir_images_equals_jax(tmp_path, monkeypatch, native):
    """With the native decoder and, where it is absent, with PIL alone."""
    from mobilenet_tpu_torch import native_io

    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
    _mixed_dir(tmp_path)
    ours, theirs = teval.load_dir_images(str(tmp_path)), jax_eval.load_dir_images(str(tmp_path))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "notes.txt").write_text("not an image")
    with pytest.raises(ValueError, match="no decodable images"):
        teval.load_dir_images(str(tmp_path / "empty"))


def test_float32_dir_report_equals_jax(tmp_path):
    """Mixed shapes: grouped by shape, resized on the device; the oracle
    reads the host's preprocessing."""
    _mixed_dir(tmp_path)
    images = teval.load_dir_images(str(tmp_path))
    ours, theirs = _reports("v1", images, batch_size=2, tie_margin=1e-3)
    _float_equal(ours, theirs)


@pytest.mark.parametrize("shape,res", [((80, 64), 64), ((64, 80), 64), ((70, 66), 64),
                                       ((37, 50), 64), ((150, 97), 64), ((64, 64), 64),
                                       ((300, 400), 224)])
def test_preprocess_ref_equals_jax_and_the_port(shape, res):
    """The host's reference of the device's preprocessing (NumPy, float64
    resize) against the JAX package's `preprocess` and the port's, within
    eval.preprocess_tol, downsampling, upsampling and at model size (bit
    for bit there)."""
    import jax.numpy as jnp
    import torch

    from mobilenet_tpu.ops import preprocess as jax_prep
    from mobilenet_tpu_torch.oracle import numpy_ref
    from mobilenet_tpu_torch.ops.preprocess import preprocess

    batch = np.random.default_rng(sum(shape)).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    ref = numpy_ref.preprocess_batch_ref(batch, res)
    assert ref.dtype == np.float32 and ref.shape == (2, res, res, 3)
    theirs = np.asarray(jax_prep.preprocess(jnp.asarray(batch), res, jnp.float32))
    ours = preprocess(torch.from_numpy(batch), res, torch.float32).numpy()
    tol = teval.preprocess_tol(*shape) if shape != (res, res) else 0.0
    assert np.abs(ref - theirs).max() <= tol
    assert np.abs(ref - ours).max() <= tol


def test_planted_preprocess_fault_fails_the_eval(tmp_path, monkeypatch):
    """A resize with the wrong pixel centres (align_corners=True) on the
    device path, which the pipeline and the device-side check share: the
    eval refuses its report, and `cli eval --dir` exits with the reason."""
    import torch.nn.functional as F

    from mobilenet_tpu_torch.ops import preprocess as tprep

    def corners(images, resolution):
        y = F.interpolate(images.permute(0, 3, 1, 2), size=(resolution, resolution),
                          mode="bilinear", align_corners=True)
        return y.permute(0, 2, 3, 1)

    _mixed_dir(tmp_path)
    monkeypatch.setattr(tprep, "resize_bilinear", corners)
    images = teval.load_dir_images(str(tmp_path))
    with pytest.raises(ValueError, match="differs from the host reference"):
        teval.evaluate_agreement(CASES["v1"][0], images, batch_size=2, device="cpu")
    with pytest.raises(SystemExit) as e:
        cli_main(["eval", "--alpha", "0.25", "--res", "64", "--dir", str(tmp_path),
                  "--batch", "2", "--device", "cpu"])
    assert "differs from the host reference" in str(e.value.code)


def test_planted_fault_fails_the_gate(monkeypatch, capsys):
    """A pipeline that moves image 0's top-1 to its least likely class: the
    report counts one mismatch, and `cli eval` prints it and exits 1."""
    run_batch = InferencePipeline.run_batch

    def flipped(self, images_u8):
        probs = run_batch(self, images_u8)
        low = int(np.argmin(probs[0]))
        probs[0] = 0.0
        probs[0, low] = 1.0
        return probs

    cfg = CASES["v1"][0]
    monkeypatch.setattr(InferencePipeline, "run_batch", flipped)
    report = teval.evaluate_agreement(cfg, teval.synth_images(cfg, 4, seed=3), batch_size=4,
                                      device="cpu", tie_margin=1e-3)
    assert report["top1_agreement"] == report["top1_agreement_tie_aware"] == 0.75
    assert [m["index"] for m in report["mismatches"]] == [0]
    assert not report["mismatches"][0]["near_tie"]
    with pytest.raises(SystemExit) as e:
        cli_main(["eval", "--alpha", "0.25", "--res", "64", "--n", "4", "--batch", "4",
                  "--device", "cpu"])
    assert e.value.code == 1
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["top1_agreement"] < 1.0 and printed["mismatches"]


def test_cli_eval_passes_and_prints_the_jax_report(capsys):
    """`cli eval` on the CPU at the JAX defaults but size (float32, numpy
    oracle, structured images from seed + 1): exit 0, and the line the JAX
    command prints, top5_overlap aside."""
    args = ["eval", "--alpha", "0.25", "--res", "64", "--n", "6", "--batch", "4"]
    cli_main(args + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from mobilenet_tpu import cli as jax_cli

    with pytest.raises(SystemExit) as e:
        jax_cli.main(["--backend", "cpu"] + args)
    assert e.value.code == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _float_equal(ours, theirs)


@pytest.mark.parametrize("family,sizes", [("v1", ((0.25, 64), (1.0, 224))),
                                          ("v2", ((0.35, 96), (1.0, 224))),
                                          ("v3", ((1.0, 64), (0.75, 224))),
                                          ("v3small", ((1.0, 96), (1.0, 224)))])
def test_flops_per_image_equals_jax(family, sizes):
    for alpha, res in sizes:
        if family == "v1":
            pair = ModelConfig(alpha, res), JaxModelConfig(alpha=alpha, resolution=res)
        elif family == "v2":
            pair = V2Config(alpha=alpha, resolution=res), JaxV2Config(alpha=alpha, resolution=res)
        else:
            variant = "large" if family == "v3" else "small"
            pair = (V3Config(variant=variant, alpha=alpha, resolution=res),
                    JaxV3Config(variant=variant, alpha=alpha, resolution=res))
        assert flops.flops_per_image(pair[0]) == jax_flops(pair[1])


def test_bf16_tie_margin_equals_jax():
    assert golden.BF16_TIE_MARGIN == jax_golden.BF16_TIE_MARGIN


def test_build_report_on_the_cpu():
    """A CPU pipeline's report names the CPU and leaves mfu empty (a CPU
    rate is not the card's); the mfu formula divides by the card's peak."""
    cfg = ModelConfig(0.25, 64, compute_dtype="float32")
    pipe = InferencePipeline(cfg, device="cpu")
    stats = {"images_per_sec": 1000.0, "p50_latency_ms": 1.0, "p99_latency_ms": 2.0,
             "batch_size": 8, "wall_s": 1.0}
    doc = json.loads(metrics.build_report(pipe, stats).to_json())
    assert doc["variant"] == "mobilenet_v1_0.25_64" and doc["dtype"] == "float32"
    assert doc["device"] == "cpu" and doc["mfu"] is None
    assert doc["model_macs_per_image"] == flops.flops_per_image(cfg)
    assert doc["extra"] == {"wall_s": 1.0}
    macs = flops.flops_per_image(ModelConfig(1.0, 224))
    assert metrics.mfu(1e4, macs, "bf16") == pytest.approx(1e4 * macs * 2 / 989e12)
    assert metrics.peak_kind(pipe) == "f32"
