from .io import (  # noqa: F401
    Params,
    fold_bn,
    import_keras_h5,
    import_tf_slim,
    init_params,
    load_npz,
    save_npz,
    to_device,
)
from .convert import from_jax_params, from_jax_params_v2, from_jax_params_v3  # noqa: F401
from .v2 import fold_bn_v2, import_keras_h5_v2, init_params_v2  # noqa: F401
from .v3 import fold_bn_v3, import_keras_h5_v3, init_params_v3  # noqa: F401


def family_fns(config):
    """(init, fold) of a config's family: MobileNet-V1 (ModelConfig), -V2
    (V2Config) or -V3 (V3Config)."""
    from ..models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from ..models.mobilenet_v3 import V3Config  # noqa: PLC0415

    if isinstance(config, V3Config):
        return init_params_v3, fold_bn_v3
    if isinstance(config, V2Config):
        return init_params_v2, fold_bn_v2
    return init_params, fold_bn


def default_folded(config, seed: int = 0) -> Params:
    """The seeded weight set of any family's config, folded."""
    init, fold = family_fns(config)
    return fold(init(config, seed=seed), eps=config.bn_eps)
