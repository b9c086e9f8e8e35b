"""Fused classifier head, [conv_last 1x1 + act] -> pool -> 0-2 matmuls
each + act: the CUDA kernel `csrc/fused_head.cu` and its plain PyTorch
version.

Replaces every form of the TPU kernel `mobilenet_tpu/ops/pallas_head.py`
`fused_head`: V1's pool+fc, V2's conv_last + ReLU6 -> pool -> fc, and
V3-Large's conv_last + hswish -> pool -> head matmul + hswish -> fc. With a
conv_last the C entry point launches two kernels: conv_last + pool over an
(N / images-per-block) x (E / 128) grid, which writes only the pooled (N, E)
rows, then the post stage; the conv_last output never reaches device
memory.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .conv import ieee_f32
from .separable_block import check_aligned, check_channels, check_kernel_args

# The kernels' activation codes (numerics.cuh enum Act): fused_head, v3_block.
ACTS = {"linear": 0, "relu": 1, "relu6": 2, "hswish": 3}
MAX_POST = 2
HB = 2                  # images per thread block
SMEM_MAX = 232448       # the per-block shared-memory opt-in limit (227 KB)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def head_smem_bytes(c: int, conv: Optional[Tuple], post: Sequence[Tuple]) -> int:
    """Dynamic shared memory of the post stage (fused_head.cu
    head_post_kernel): two f32 rows of the widest pooled/post width per
    image. The conv_last stage uses a fixed static tile."""
    e = int(conv[0].shape[1]) if conv is not None else c
    maxw = max([e] + [int(w.shape[1]) for w, _, _ in post])
    return _rup(2 * HB * maxw * 4, 128)


def head_fits(c: int, conv: Optional[Tuple], post: Sequence[Tuple]) -> bool:
    """True when the kernel takes this form: 0-2 post matmuls, known
    activations, and its rows within the shared-memory limit."""
    acts = ([conv[2]] if conv is not None else []) + [a for _, _, a in post]
    return (len(post) <= MAX_POST and all(a in ACTS for a in acts)
            and head_smem_bytes(c, conv, post) <= SMEM_MAX)


def head_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """pallas_head.py `_kact`, in float32."""
    if act == "linear":
        return y
    if act == "relu":
        return y.clamp_min(0)
    if act == "relu6":
        return y.clamp(0, 6)
    if act == "hswish":
        return y * ((y + 3.0).clamp(0, 6) * (1.0 / 6.0))
    raise ValueError(f"unknown activation {act!r}")


@ieee_f32
def fused_head_plain(x, conv: Optional[Tuple], post: Sequence[Tuple]) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: [f32 conv_last + bias, act,
    cast], f32 mean over H*W cast to x's dtype, then each post: f32 product
    + bias, act, cast."""
    n, h, w, c = x.shape
    y = x
    if conv is not None:
        cw, cb, act = conv
        y = head_act(x.float().reshape(n * h * w, c) @ cw.float() + cb.float(), act)
        y = y.to(x.dtype).reshape(n, h, w, -1)
    y = y.float().mean(dim=(1, 2)).to(x.dtype)
    for pw, pb, act in post:
        y = head_act(y.float() @ pw.float() + pb.float(), act).to(x.dtype)
    return y


def fused_head(x, conv: Optional[Tuple], post: Sequence[Tuple]) -> torch.Tensor:
    """[conv_last] -> pool -> post-matmul chain, the JAX entry point's
    signature. x (N,H,W,C); conv: (w (C,E), b (E,), act) or None; post:
    [(w (K,M), b (M,), act), ...] with 0-2 entries -> (N, last width).
    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel or raises."""
    name = "fused_head"
    if len(post) > MAX_POST:
        raise NotImplementedError(f"{name}: {len(post)} post matmuls; the kernel "
                                  f"takes 0-{MAX_POST}")
    weights = [t for layer in ([conv] if conv is not None else []) + list(post)
               for t in layer[:2]]
    sfx = check_kernel_args(name, x, *weights)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    k = c
    for cw, cb, act in ([conv] if conv is not None else []) + list(post):
        m = int(cw.shape[-1])
        if tuple(cw.shape) != (k, m) or tuple(cb.shape) != (m,):
            raise ValueError(f"{name}: weight {tuple(cw.shape)} / bias {tuple(cb.shape)} "
                             f"do not follow width {k}")
        if act not in ACTS:
            raise ValueError(f"{name}: unknown activation {act!r}")
        k = m
    if conv is not None:  # the conv_last stage moves rows as 16-byte vectors
        check_channels(name, c, int(conv[0].shape[1]))
        check_aligned(name, x, conv[0], conv[1])
    if not head_fits(c, conv, post):
        raise ValueError(f"{name}: rows of width {k} exceed the kernel's shared memory")
    if x.device.type == "cpu":
        return fused_head_plain(x, conv, post)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, k), dtype=x.dtype, device=x.device)
    e = int(conv[0].shape[1]) if conv is not None else c
    # the conv_last stage's pooled (N, E) rows, read by the post stage
    pooled = None if conv is None else torch.empty((n, e), dtype=x.dtype, device=x.device)
    ptrs = [0, 0] if conv is None else [conv[0].data_ptr(), conv[1].data_ptr()]
    dims = []
    for j in range(MAX_POST):
        if j < len(post):
            ptrs += [post[j][0].data_ptr(), post[j][1].data_ptr()]
            dims += [int(post[j][0].shape[1]), ACTS[post[j][2]]]
        else:
            ptrs += [0, 0]
            dims += [0, 0]
    code = getattr(lib, f"fused_head_{sfx}")(
        x.data_ptr(), *ptrs, 0 if pooled is None else pooled.data_ptr(), out.data_ptr(),
        n, h * w, c, e,
        -1 if conv is None else ACTS[conv[2]], len(post), *dims,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    fused_head.launches += 1
    return out


fused_head.launches = 0
