"""K stride-1 C->C separable blocks in one launch: the CUDA kernel
`csrc/chain.cu` and its plain PyTorch version.

Replaces the TPU kernel `mobilenet_tpu/ops/pallas_chain_systolic.py`
`chain_systolic`. The output equals K `separable_block` calls in sequence.
"""

from __future__ import annotations

import torch

from . import _build
from .separable_block import (
    check_aligned, check_channels, check_kernel_args, plan_for, separable_block_plain,
)

# The two inter-stage buffers are meant to stay in the H100's 50 MB L2; a
# chain whose buffers exceed this budget runs as per-block kernels instead.
L2_BUDGET_BYTES = 24 * 2**20


def stride1_runs(pw_shapes, strides, eligible, min_run: int = 3):
    """{start: length} of the maximal runs of >= min_run consecutive
    eligible, stride-1, C->C blocks of one width (V1's blocks 6-10 at every
    alpha). pw_shapes: each block's (Cin, Cout)."""
    runs, i, n = {}, 0, len(strides)
    while i < n:
        cin, cout = pw_shapes[i]
        if not (eligible[i] and strides[i] == 1 and cin == cout):
            i += 1
            continue
        j = i + 1
        while (j < n and eligible[j] and strides[j] == 1
               and tuple(pw_shapes[j]) == (cin, cout)):
            j += 1
        if j - i >= min_run:
            runs[i] = j - i
        i = j
    return runs


def chain_fits(n: int, hh: int, ww: int, c: int, k_blocks: int,
               itemsize: int) -> bool:
    """True when a K-block chain at (n, hh, ww, c) runs as one launch: a
    kernel-supported width, and inter-stage buffers within the L2 budget.
    The grid itself always fits co-resident: the kernel caps it at what the
    occupancy query allows and loops over the remaining tiles."""
    scratch = 2 * n * hh * ww * c * itemsize
    return k_blocks >= 1 and c > 0 and c % 8 == 0 and scratch <= L2_BUDGET_BYTES


def chain_plain(x, dw_ws, dw_bs, pw_ws, pw_bs, relu6: bool = True):
    """K plain separable blocks in sequence."""
    c = x.shape[-1]
    for k in range(dw_ws.shape[0]):
        x = separable_block_plain(x, dw_ws[k].reshape(3, 3, 1, c), dw_bs[k],
                                  pw_ws[k], pw_bs[k], 1, relu6)
    return x


def chain(x, dw_ws, dw_bs, pw_ws, pw_bs, relu6: bool = True) -> torch.Tensor:
    """x (N,H,W,C), dw_ws (K,3,3,C), dw_bs (K,C), pw_ws (K,C,C), pw_bs (K,C)
    -> (N,H,W,C). On CPU tensors this is the plain version; on CUDA tensors
    it launches the kernel or raises."""
    name = "chain"
    sfx = check_kernel_args(name, x, dw_ws, dw_bs, pw_ws, pw_bs)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    n, hh, ww, c = x.shape
    k = int(dw_ws.shape[0])
    if (tuple(dw_ws.shape) != (k, 3, 3, c) or tuple(dw_bs.shape) != (k, c)
            or tuple(pw_ws.shape) != (k, c, c) or tuple(pw_bs.shape) != (k, c)):
        raise ValueError(f"{name}: stacked weight shapes do not fit C={c}, K={k}")
    check_channels(name, c)
    if not chain_fits(n, hh, ww, c, k, x.element_size()):
        raise ValueError(f"{name}: ({n},{hh},{ww},{c}) x {k} blocks does not "
                         "fit one launch (chain_fits); route per-block kernels")
    if x.device.type == "cpu":
        return chain_plain(x, dw_ws, dw_bs, pw_ws, pw_bs, relu6)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty_like(x)
    scratch = torch.empty((2,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), dw_ws.data_ptr(), dw_bs.data_ptr(), pw_ws.data_ptr(),
            pw_bs.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            out.data_ptr(), n, hh, ww, c, k, int(relu6)]
    if sfx == "bf16":  # the per-block kernel's plan: bit-equal stages
        check_aligned(name, x, dw_ws, dw_bs, pw_ws, pw_bs)
        args += plan_for(x, c, c, 1)
    code = getattr(lib, f"chain_{sfx}")(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    chain.launches += 1
    return out


chain.launches = 0
