"""Fused pool + fc head: the CUDA kernel `csrc/fused_head.cu` and its plain
PyTorch version.

Replaces the pool+fc form of the TPU kernel `mobilenet_tpu/ops/pallas_head.py`
`fused_head`, the only form V1 uses. The conv_last and multi-matmul forms
belong to V2/V3 and are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .separable_block import check_kernel_args

# fused_head.cu: the pooled rows in shared memory, and 512 threads x 2 classes
MAX_CHANNELS = 1024
MAX_CLASSES = 1024


def head_fits(c: int, classes: int) -> bool:
    """True when the kernel takes c feature channels and `classes` outputs."""
    return 0 < c <= MAX_CHANNELS and 0 < classes <= MAX_CLASSES


def fused_head_plain(x, fc_w, fc_b) -> torch.Tensor:
    """f32 mean over H*W cast to x's dtype, then an f32 product, + bias in
    f32, cast to x's dtype."""
    pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
    return (pooled.float() @ fc_w.float() + fc_b.float()).to(x.dtype)


def fused_head(x, conv: Optional[Tuple], post: Sequence[Tuple]) -> torch.Tensor:
    """[conv_last] -> pool -> post-matmul chain, the JAX entry point's
    signature. Only V1's form runs: conv=None and one linear post matmul
    (the fc). x (N,H,W,C) -> (N, classes). On CPU tensors this is the plain
    version; on CUDA tensors it launches the kernel or raises."""
    name = "fused_head"
    if conv is not None or len(post) != 1 or post[0][2] != "linear":
        raise NotImplementedError(
            f"{name}: only the V1 pool+fc form is ported (conv=None, one "
            "linear fc); the conv_last and multi-matmul forms wait for V2/V3")
    fc_w, fc_b, _ = post[0]
    sfx = check_kernel_args(name, x, fc_w, fc_b)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    classes = int(fc_w.shape[-1])
    if tuple(fc_w.shape) != (c, classes) or tuple(fc_b.shape) != (classes,):
        raise ValueError(f"{name}: fc shapes {tuple(fc_w.shape)} "
                         f"{tuple(fc_b.shape)} do not fit C={c}")
    if not head_fits(c, classes):
        raise ValueError(f"{name}: C={c} or classes={classes} exceeds "
                         f"{MAX_CHANNELS}/{MAX_CLASSES}")
    if x.device.type == "cpu":
        return fused_head_plain(x, fc_w, fc_b)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, classes), dtype=x.dtype, device=x.device)
    code = getattr(lib, f"fused_head_{sfx}")(
        x.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(), out.data_ptr(),
        n, h * w, c, classes, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    fused_head.launches += 1
    return out


fused_head.launches = 0
