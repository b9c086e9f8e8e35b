from .io import (  # noqa: F401
    Params,
    fold_bn,
    init_params,
    load_npz,
    save_npz,
    to_device,
)
from .convert import from_jax_params, from_jax_params_v2, from_jax_params_v3  # noqa: F401
from .v2 import fold_bn_v2, init_params_v2  # noqa: F401
from .v3 import fold_bn_v3, init_params_v3  # noqa: F401
