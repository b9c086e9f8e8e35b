"""The port's checkpoint importers against the JAX package's, on the
synthetic files that the JAX package's own importer tests write (no
published checkpoint is in the repository): keras .h5 in the legacy named
layout for MobileNet-V1, -V2, -V3-Large, -V3-Small and V3-Small
-minimalistic, the keras-3 `.weights.h5` layout (class-default layer names
in creation order) for each family, and a TF-slim MobileNet-V1 checkpoint
with and without the background class. Each port importer returns the JAX
importer's raw tree exactly (same keys, shapes, dtypes and bits); a keras-3
store of the wrong family raises the JAX importer's ValueError."""

import numpy as np
import pytest

from mobilenet_tpu import ModelConfig as JaxModelConfig
from mobilenet_tpu.checkpoints import io as jax_io
from mobilenet_tpu.checkpoints import v2 as jax_v2
from mobilenet_tpu.checkpoints import v3 as jax_v3
from mobilenet_tpu.models.mobilenet_v2 import V2Config as JaxV2Config
from mobilenet_tpu.models.mobilenet_v3 import V3Config as JaxV3Config
from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
from mobilenet_tpu_torch.checkpoints import (
    import_keras_h5, import_keras_h5_v2, import_keras_h5_v3, import_tf_slim, init_params,
    init_params_v2, init_params_v3,
)
from mobilenet_tpu_torch.checkpoints import io as tio
from mobilenet_tpu_torch.checkpoints import v2 as tv2
from mobilenet_tpu_torch.checkpoints import v3 as tv3

h5py = pytest.importorskip("h5py")


def assert_tree_equal(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


# family -> (port config, JAX config, init, port importer, JAX importer)
FAMILIES = {
    "v1": (ModelConfig(0.25, 128), JaxModelConfig(alpha=0.25, resolution=128), init_params,
           import_keras_h5, jax_io.import_keras_h5),
    "v2": (V2Config(alpha=1.0, resolution=96), JaxV2Config(alpha=1.0, resolution=96),
           init_params_v2, import_keras_h5_v2, jax_v2.import_keras_h5_v2),
    "v3": (V3Config(variant="large", alpha=1.0, resolution=96),
           JaxV3Config(variant="large", alpha=1.0, resolution=96),
           init_params_v3, import_keras_h5_v3, jax_v3.import_keras_h5_v3),
    "v3small": (V3Config(variant="small", alpha=1.0, resolution=96),
                JaxV3Config(variant="small", alpha=1.0, resolution=96),
                init_params_v3, import_keras_h5_v3, jax_v3.import_keras_h5_v3),
    "v3small-min": (V3Config(variant="small", alpha=1.0, resolution=96, minimalistic=True),
                    JaxV3Config(variant="small", alpha=1.0, resolution=96, minimalistic=True),
                    init_params_v3, import_keras_h5_v3, jax_v3.import_keras_h5_v3),
}


def _legacy_writer(family):
    """The JAX package's test writer of the family's legacy named .h5."""
    if family == "v1":
        from test_keras_import import _write_keras_h5

        return _write_keras_h5
    from test_keras_import_families import _write_keras_h5_v2, _write_keras_h5_v3

    return _write_keras_h5_v2 if family == "v2" else _write_keras_h5_v3


def _keras3_layers(family, params, cfg):
    """(class base, [vars]) of every weighted layer in keras creation order."""
    def bn(b):
        return [b["gamma"], b["beta"], b["mean"], b["var"]]

    out = [("conv2d", [params["conv1"]["w"]]), ("batch_normalization", bn(params["conv1"]["bn"])),
           ("re_lu", [])]
    if family == "v1":
        for blk in params["blocks"]:
            out += [("depthwise_conv2d", [blk["dw"]["w"].transpose(0, 1, 3, 2)]),
                    ("batch_normalization", bn(blk["dw"]["bn"])),
                    ("conv2d", [blk["pw"]["w"][None, None]]),
                    ("batch_normalization", bn(blk["pw"]["bn"]))]
        return out + [("conv2d", [params["fc"]["w"][None, None], params["fc"]["b"]])]
    for blk in params["blocks"]:
        if "exp" in blk:
            out += [("conv2d", [blk["exp"]["w"][None, None]]),
                    ("batch_normalization", bn(blk["exp"]["bn"]))]
        out += [("depthwise_conv2d", [blk["dw"]["w"].transpose(0, 1, 3, 2)]),
                ("batch_normalization", bn(blk["dw"]["bn"]))]
        if "se" in blk:
            se = blk["se"]
            out += [("conv2d", [se["w1"][None, None], se["b1"]]),
                    ("conv2d", [se["w2"][None, None], se["b2"]])]
        out += [("conv2d", [blk["prj"]["w"][None, None]]),
                ("batch_normalization", bn(blk["prj"]["bn"]))]
    out += [("conv2d", [params["conv_last"]["w"][None, None]]),
            ("batch_normalization", bn(params["conv_last"]["bn"]))]
    if family == "v2":
        return out + [("dense", [params["fc"]["w"], params["fc"]["b"]])]
    return out + [("conv2d", [params["head"]["w"][None, None], params["head"]["b"]]),
                  ("conv2d", [params["fc"]["w"][None, None], params["fc"]["b"]])]


def _write_keras3(path, layers):
    """A keras-3 `.weights.h5`: layers/<class>[_<n>]/vars/<i>, the n-th
    layer of a class named with suffix n (none for the first)."""
    seen = {}
    with h5py.File(path, "w") as f:
        root = f.create_group("layers")
        for base, arrs in layers:
            k = seen.get(base, 0)
            seen[base] = k + 1
            g = root.create_group(base if k == 0 else f"{base}_{k}").create_group("vars")
            for i, a in enumerate(arrs):
                g[str(i)] = a


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("layout", ["legacy", "keras3"])
def test_keras_importer_equals_jax(tmp_path, family, layout):
    cfg, jcfg, init, ours, theirs = FAMILIES[family]
    params = init(cfg, seed=11)
    path = str(tmp_path / f"{family}.h5")
    if layout == "legacy":
        _legacy_writer(family)(path, params, jcfg)
    else:
        _write_keras3(path, _keras3_layers(family, params, cfg))
        assert tio._keras3_store(path) is not None
    got = ours(path, cfg)
    assert_tree_equal(got, theirs(path, jcfg))
    assert_tree_equal(got["blocks"][1]["dw"]["w"], params["blocks"][1]["dw"]["w"])


@pytest.mark.parametrize("mapper,jax_mapper,cfg,store", [
    (tv2._import_keras3_v2, jax_v2._import_keras3_v2, V2Config(alpha=1.0, resolution=224),
     {"conv2d": [], "depthwise_conv2d": [], "batch_normalization": []}),
    (tio._import_keras3_v1, jax_io._import_keras3_v1, ModelConfig(1.0, 224),
     {"my_custom_conv": [[np.zeros((3, 3, 3, 32))]]}),
    (tv3._import_keras3_v3, jax_v3._import_keras3_v3,
     V3Config(variant="large", alpha=1.0, resolution=224), {"dense": []}),
    (tio._import_keras3_v1, jax_io._import_keras3_v1, ModelConfig(1.0, 224),
     {"conv2d": [[np.zeros(1)]], "depthwise_conv2d": [], "batch_normalization": []}),
])
def test_keras3_wrong_store_raises_as_jax(mapper, jax_mapper, cfg, store):
    with pytest.raises(ValueError) as ours:
        mapper(store, cfg)
    with pytest.raises(ValueError) as theirs:
        jax_mapper(store, cfg)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("background_class", [True, False])
def test_tf_slim_importer_equals_jax(tmp_path, background_class):
    pytest.importorskip("tensorflow")
    from test_tf_slim_import import _write_slim_ckpt

    cfg = ModelConfig(0.25, 128)
    params = init_params(cfg, seed=17)
    prefix = str(tmp_path / "mobilenet_v1_0.25_128.ckpt")
    _write_slim_ckpt(prefix, params, cfg, background_class=background_class)
    got = import_tf_slim(prefix, cfg)
    assert_tree_equal(got, jax_io.import_tf_slim(prefix, JaxModelConfig(alpha=0.25,
                                                                        resolution=128)))
    assert_tree_equal(got["fc"], params["fc"])
