from .io import (  # noqa: F401
    Params,
    fold_bn,
    init_params,
    load_npz,
    save_npz,
    to_device,
)
from .convert import from_jax_params  # noqa: F401
