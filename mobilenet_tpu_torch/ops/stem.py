"""The stem kernels: the CUDA kernel `csrc/stem.cu` (two entry points; bf16
on the Hopper tiles of `csrc/stem_wgmma.cuh`, planned by `stem_plan`;
float32 on those of `csrc/stem_f32.cuh`, planned by `f32_stem_plan`) and
their plain PyTorch versions.

Replaces the TPU kernels `mobilenet_tpu/ops/pallas_stem_b0.py`
`stem_block0_fused` (uint8 normalize + the 3x3 s2 stem + block 0's
depthwise and pointwise in one launch: `stem_block0`) and
`mobilenet_tpu/ops/pallas_stem.py` `stem_conv_packed` (the stem alone on a
preprocessed input: `stem_conv`, which is also the stem of every forward
whose block 0 is routed "fused"). No lane packing: both read and write dense
NHWC. The stem's TF-SAME padding at stride 2 is (0, 1) per axis on an even
input and (1, 1) on an odd one (`ops/conv.same_pads`), zero in the
normalized domain; PyTorch's `padding=1` would be wrong on the even sizes
the model runs. What bounds the kernels on the card and what the
design does about it is in the CUDA source's header.

The plain versions do every product as elementwise multiply-then-add in a
fixed order (stem taps in (dy, dx, c) order, depthwise taps in (dy, dx)
order, pointwise inputs in k order), never through a convolution or matmul
library call, so they hold on the card whatever its TF32 flags say.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import PREPROCESS_OFFSET, PREPROCESS_SCALE
from . import _build
from .conv import apply_activation, dw_taps_f32, same_pads
from .preprocess import normalize
from .separable_block import (
    H100_SMS, SMEM_LIMIT, _sms, check_aligned, check_channels, check_kernel_args,
)

C1 = 32  # block 0's width: the fused kernel's stem output channels (alpha 1.0)
MAX_STEM_COUT = 256  # stem_conv: bf16 stages 27 x Cout weights; float32, a thread a channel

# -- the bf16 kernels' plan (csrc/stem_wgmma.cuh) ------------------------------
K = 32           # the product's K: 27 taps + 5 zero columns, or block 0's 32 channels
A_ROW = 128      # bytes an A panel row takes (128-byte swizzle)
B_BLOCK = K * 16  # an 8-column block of the resident weight: 32 K rows x 16 bytes
STEP = 128       # stem_conv: pixels a step, a thread a row
HALO_W = 18      # stem_block0: the halo tile's width (16 + 2)
SMEM_SM = 233472  # shared memory an SM holds (228 KB); a block also takes 1 KB
MAX_CONV_TW = 128
CONV_BLOCKS_SM = 4  # stem_conv: 128 threads, __launch_bounds__(128, 4)
B0_BLOCKS_SM = 2    # stem_block0: 256 threads, __launch_bounds__(256, 2)


class StemPlan(NamedTuple):
    th: int      # tile rows (of the stem grid; stem_block0: of block 0's output)
    tw: int      # tile columns (stem_block0: 16)
    nwg: int     # warpgroups a block (stem_conv 1, stem_block0 2)
    tiles: int
    per_sm: int  # blocks an SM holds (shared memory, and the launch bounds)
    grid: int    # persistent blocks: min(tiles, SMs x per_sm)
    smem: int    # dynamic shared memory a block


def _pitch(nbytes: int) -> int:
    """A window row's bytes in shared memory: the 16-byte granules that hold
    `nbytes` bytes at any offset."""
    return 16 * (-(-nbytes // 16) + 1)


def stem_smem_bytes(block0: bool, th: int, tw: int, cout: int) -> int:
    """Dynamic shared memory of a plan (`conv_geo` / `b0_geo`): 1 KB of
    alignment; stem_conv: an A ring of two 128-row slots, the resident
    weight (32 rows), the bias, two window buffers of 2th+1 rows of 2tw+1
    bf16 pixels and their row offsets; stem_block0: the pointwise's A panel
    (th x 16 rows in 64-row blocks), weight and bias, the stem's f32 weight
    and bias, the f32 stem tile (128 bytes a halo pixel), two uint8 windows
    of 2(th+2)+1 rows of 37 pixels and their row offsets."""
    if block0:
        hp, wr = (th + 2) * HALO_W, 2 * (th + 2) + 1
        a = -(-th * 16 // 64) * 64 * A_ROW
        weights = cout // 8 * B_BLOCK + 28 * K * 4 + -(-2 * cout // 16) * 16
        return 1024 + a + weights + hp * K * 4 + 2 * wr * _pitch((2 * HALO_W + 1) * 3) + 2 * wr * 4
    wr = 2 * th + 1
    return (1024 + 2 * STEP * A_ROW + cout // 8 * B_BLOCK + -(-2 * cout // 16) * 16
            + 2 * wr * _pitch((2 * tw + 1) * 6) + 2 * wr * 4)


@functools.lru_cache(maxsize=None)
def stem_plan(n: int, h: int, w: int, cout: int, block0: bool,
              sms: int = H100_SMS) -> StemPlan:
    """The bf16 kernel's plan on a card of `sms` SMs. stem_conv: whole stem
    rows (tw = Ws up to 128 columns), th the largest of 4, 2, 1 rows whose
    tiles still number at least one an SM (4 x 112 = 448 pixels, 3.5 steps,
    at 1.0-224); stem_block0: 12 x 16 outputs, whose 14 x 18 halo tile (1.31x
    the stem's work) gives each of the block's 256 threads one stem pixel,
    or 6 x 16 (8 x 18, 1.5x) where 12 x 16 leaves SMs without a tile. Raises
    where a block's shared memory would pass the limit (stem_block0's
    resident 32 x Cout weight at a large Cout)."""
    if block0:
        hs, ws, tw, nwg, cap = h // 2, w // 2, 16, 2, B0_BLOCKS_SM
        ths = (12, 6)
    else:
        hs, ws, nwg, cap = -(-h // 2), -(-w // 2), 1, CONV_BLOCKS_SM
        tw = min(ws, MAX_CONV_TW)
        ths = (4, 2, 1)
    th = next((t for t in ths if n * -(-hs // t) * -(-ws // tw) >= sms), ths[-1])
    tiles = n * -(-hs // th) * -(-ws // tw)
    smem = stem_smem_bytes(block0, th, tw, cout)
    if smem > SMEM_LIMIT:
        raise ValueError(f"stem_plan: Cout {cout} needs {smem} bytes of shared memory, "
                         f"above {SMEM_LIMIT}")
    per_sm = min(cap, SMEM_SM // (smem + 1024))
    return StemPlan(th, tw, nwg, tiles, per_sm, max(1, min(tiles, sms * per_sm)), smem)


# -- the float32 kernels' plan (csrc/stem_f32.cuh) ----------------------------
F32_BARS = 64         # bytes kept for the mbarriers
F32_CONV_TH = (4, 2, 1)
F32_CONV_P = 8        # stem_conv: pixels a strip; its tile width is a multiple
F32_B0_TH = (16, 8, 4, 2)
F32_B0_TW = 16
MAX_F32_CONV_TW = 128
F32_CONV_BLOCKS_SM = 2  # 288 threads, __launch_bounds__(288, 2)
F32_B0_BLOCKS_SM = 2    # 256 threads, __launch_bounds__(256, 2)


class F32StemPlan(NamedTuple):
    th: int      # tile rows (of the stem grid; stem_block0: of block 0's output)
    tw: int      # tile columns (stem_conv: a multiple of 8; stem_block0: 16)
    cpu: int     # tiles a unit walks down its column band (stem_conv: 1)
    units: int   # the persistent blocks' work items
    per_sm: int  # blocks an SM holds (shared memory, and the launch bounds)
    grid: int    # persistent blocks: min(units, SMs x per_sm)
    smem: int    # dynamic shared memory a block


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def f32_stem_smem_bytes(block0: bool, th: int, tw: int, cout: int) -> int:
    """Dynamic shared memory of a float32 plan (`stf::conv_geo` / `b0_geo`):
    the mbarriers; stem_conv: a ring of two float32 windows of 2th+1 rows of
    3(2tw+1)+1 floats; stem_block0: the weights (stem 27 x 32 + bias,
    depthwise 9 x 32 + bias, pointwise 32 x Cout in blocks of 4 columns, 4
    floats apart, + bias), two uint8 windows of 2(th+2)+1 rows of 16-byte
    granules and their row offsets, the float32 window (111 + 1 floats a
    row), the (th+2) x 18 x 32 stem tile and the K-major depthwise tile (32
    rows of 16 x 16 + 4 floats, whatever th)."""
    if not block0:
        wr, wc = 2 * th + 1, 2 * tw + 1
        return F32_BARS + 2 * wr * (3 * wc + 1) * 4
    hh, hw = th + 2, F32_B0_TW + 2
    wr, wc = 2 * hh + 1, 2 * hw + 1
    u8pitch = 16 * (-(-wc * 3 // 16) + 1)
    roff = F32_BARS + (28 * C1 + 10 * C1 + cout // 4 * (4 * C1 + 4) + cout) * 4
    win = _up(roff + 2 * wr * 4, 16) + 2 * wr * u8pitch
    stem = win + wr * (3 * wc + 1) * 4
    return stem + hh * hw * C1 * 4 + C1 * (16 * F32_B0_TW + 4) * 4


@functools.lru_cache(maxsize=None)
def f32_stem_plan(n: int, h: int, w: int, cout: int, block0: bool,
                  sms: int = H100_SMS) -> F32StemPlan:
    """The float32 kernels' plan on a card of `sms` SMs: the largest tile
    whose tiles still number at least one an SM, else the smallest.
    stem_conv: th of 4, 2, 1 stem rows x tw columns, tw the stem grid's
    width in the fewest parts of at most 128 (a multiple of 8), or that
    halved (4 x 112 at 1.0-224, batch 256). stem_block0: th of 16, 8, 4, 2
    rows x 16 among the th whose shared memory fits (raises where none
    does: a resident 32 x Cout weight at a large Cout); a unit walks `cpu`
    tiles down its column band, reusing the stem rows the tile above
    computed, as many as still leave every block of the grid a unit (the
    16 x 16 tile's stem work is then 18/16 of the stem's, not 1.27x)."""
    if block0:
        hs, ws = h // 2, w // 2
        cands = [(th, F32_B0_TW) for th in F32_B0_TH
                 if f32_stem_smem_bytes(True, th, F32_B0_TW, cout) <= SMEM_LIMIT]
        if not cands:
            raise ValueError(f"f32_stem_plan: Cout {cout} needs "
                             f"{f32_stem_smem_bytes(True, 2, F32_B0_TW, cout)} bytes of shared "
                             f"memory, above {SMEM_LIMIT}")
        cap = F32_B0_BLOCKS_SM
    else:
        hs, ws = -(-h // 2), -(-w // 2)
        parts = max(1, -(-ws // MAX_F32_CONV_TW))
        tws = [_up(max(1, -(-ws // parts)), F32_CONV_P)]
        while tws[-1] > F32_CONV_P:
            tws.append(_up(tws[-1] // 2, F32_CONV_P))
        cands = sorted(((th, tw) for tw in tws for th in F32_CONV_TH),
                       key=lambda c: (-c[0] * c[1], -c[1]))
        cap = F32_CONV_BLOCKS_SM

    def tiles(c):
        return n * -(-hs // c[0]) * -(-ws // c[1])

    th, tw = next((c for c in cands if tiles(c) >= sms), cands[-1])
    smem = f32_stem_smem_bytes(block0, th, tw, cout)
    per_sm = min(cap, SMEM_SM // (smem + 1024))
    cpu, units = 1, tiles((th, tw))
    if block0:
        tiles_h, bands = -(-hs // th), n * -(-ws // tw)
        cpu = max((c for c in range(1, max(1, tiles_h) + 1)
                   if bands * -(-tiles_h // c) >= sms * per_sm), default=1)
        units = bands * -(-tiles_h // cpu)
    return F32StemPlan(th, tw, cpu, units, per_sm, max(1, min(units, sms * per_sm)), smem)


def _stem_taps_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3x3 s2 stem's sums in float32: TF-SAME pad with zeros, the 27
    taps in (dy, dx, c) order, each a float32 multiply then add.
    x (N,H,W,3) float, w (3,3,3,Cout) -> (N,ceil(H/2),ceil(W/2),Cout) float32."""
    n, h, wd, _ = x.shape
    (ph0, ph1), (pw0, pw1) = same_pads(h, 2), same_pads(wd, 2)
    xp = torch.nn.functional.pad(x.float(), (0, 0, pw0, pw1, ph0, ph1))
    ho, wo = -(-h // 2), -(-wd // 2)
    wf = w.float()
    acc = torch.zeros((n, ho, wo, w.shape[3]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2, :]
            for c in range(3):
                acc = acc + tap[..., c:c + 1] * wf[dy, dx, c]
    return acc


def _pointwise_f32(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum over k of y[..., k] * w[k] in float32, k in order: the pointwise
    product without a matmul. y (N,H,W,K) float32, w (K,Cout)."""
    wf = w.float()
    acc = torch.zeros(y.shape[:-1] + (w.shape[1],), dtype=torch.float32, device=y.device)
    for k in range(w.shape[0]):
        acc = acc + y[..., k:k + 1] * wf[k]
    return acc


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    relu6: bool = True) -> torch.Tensor:
    """The stem kernel's arithmetic in plain ops, as `stem_conv_packed`
    computes it: taps and weights in x's dtype (the wrapper's dtype check),
    float32 sums, + bias in float32, ReLU or ReLU6, one rounding to x's
    dtype."""
    y = _stem_taps_f32(x, w) + b.float()
    return apply_activation(y, relu6).to(x.dtype)


def stem_block0_plain(images_u8: torch.Tensor, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b,
                      relu6: bool = True) -> torch.Tensor:
    """The fused kernel's stages in plain ops, in `stem_block0_fused`'s
    order: normalize in float32 and round to the weights' dtype; the stem
    (zero pad in the normalized domain), + bias, activation, round; block
    0's depthwise (zero SAME pad in the stem-activation domain), + bias,
    activation, round; the pointwise, + bias, activation, round."""
    dtype = pw_w.dtype
    y = _stem_taps_f32(normalize(images_u8, dtype), stem_w) + stem_b.float()
    y = apply_activation(y, relu6).to(dtype)
    y = dw_taps_f32(y, dw_w, 1) + dw_b.float()
    y = apply_activation(y, relu6).to(dtype).float()
    y = _pointwise_f32(y, pw_w) + pw_b.float()
    return apply_activation(y, relu6).to(dtype)


def _check_input(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"{name}: input must be (N,H,W,3), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def stem_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              relu6: bool = True) -> torch.Tensor:
    """The 3x3 s2 stem + bias + ReLU(6), TF-SAME, NHWC: the function of
    `stem_conv_packed`.

    x (N,H,W,3) float32 or bf16 (preprocessed); w (3,3,3,Cout) and b (Cout,)
    in x's dtype, Cout a multiple of 8 up to 256 -> (N,ceil(H/2),ceil(W/2),
    Cout) in x's dtype. On CPU tensors this is the plain version;
    on CUDA tensors it launches the kernel or raises."""
    name = "stem_conv"
    sfx = check_kernel_args(name, x, w, b)
    _check_input(name, x)
    n, h, wd, _ = x.shape
    cout = int(w.shape[-1])
    if tuple(w.shape) != (3, 3, 3, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"{name}: weight {tuple(w.shape)} or bias {tuple(b.shape)} "
                         "is not a 3x3x3 stem")
    check_channels(name, cout)
    if cout > MAX_STEM_COUT:
        raise ValueError(f"{name}: Cout {cout} above {MAX_STEM_COUT}")
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, b, relu6)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((n, -(-h // 2), -(-wd // 2), cout), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, wd, cout,
            int(relu6)]
    plan = (stem_plan if sfx == "bf16" else f32_stem_plan)(
        n, h, wd, cout, False, _sms(x.device.index or 0))
    args += [plan.th, plan.tw, plan.grid]
    code = getattr(lib, f"stem_conv_{sfx}")(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    stem_conv.launches += 1
    return out


stem_conv.launches = 0


def stem_block0(images_u8: torch.Tensor, stem_w, stem_b, dw_w, dw_b, pw_w, pw_b,
                relu6: bool = True) -> torch.Tensor:
    """uint8 normalize + the 3x3 s2 stem + block 0's depthwise 3x3 s1 and
    pointwise, each with bias and ReLU(6), in one launch: the function of
    `stem_block0_fused`, with a dense output.

    images_u8 (N,H,W,3) uint8 at model resolution, H and W even; stem_w
    (3,3,3,32), stem_b (32,), dw_w (3,3,1,32), dw_b (32,), pw_w (32,Cout),
    pw_b (Cout,), all in one dtype (float32 or bf16), Cout a multiple of 8
    -> (N,H/2,W/2,Cout) in that dtype. On CPU tensors this is the plain
    version; on CUDA tensors it launches the kernel or raises."""
    name = "stem_block0"
    weights = (stem_w, stem_b, dw_w, dw_b, pw_w, pw_b)
    sfx = check_kernel_args(name, *weights)
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"{name}: images must be uint8, got {images_u8.dtype}")
    if images_u8.device != stem_w.device:
        raise ValueError(f"{name}: tensors on {images_u8.device} and {stem_w.device}")
    _check_input(name, images_u8)
    if images_u8.shape[1] % 2 or images_u8.shape[2] % 2:
        raise ValueError(f"{name}: H and W must be even, got {tuple(images_u8.shape[1:3])}")
    cout = int(pw_w.shape[-1])
    if (tuple(stem_w.shape) != (3, 3, 3, C1) or tuple(stem_b.shape) != (C1,)
            or tuple(dw_w.shape) != (3, 3, 1, C1) or tuple(dw_b.shape) != (C1,)
            or tuple(pw_w.shape) != (C1, cout) or tuple(pw_b.shape) != (cout,)):
        raise ValueError(f"{name}: weight shapes {[tuple(t.shape) for t in weights]} "
                         f"are not a {C1}-channel stem and block 0")
    check_channels(name, cout)
    if images_u8.device.type == "cpu":
        return stem_block0_plain(images_u8, *weights, relu6)
    if images_u8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {images_u8.device}")
    check_aligned(name, *weights)
    n, h, w, _ = images_u8.shape
    lib = _build.library()
    out = torch.empty((n, h // 2, w // 2, cout), dtype=pw_w.dtype, device=pw_w.device)
    args = [images_u8.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(), n, h, w,
            cout, int(relu6), float(PREPROCESS_SCALE), float(PREPROCESS_OFFSET)]
    sms = _sms(images_u8.device.index or 0)
    if sfx == "bf16":
        plan = stem_plan(n, h, w, cout, True, sms)
        args += [plan.th, plan.grid]
    else:
        plan = f32_stem_plan(n, h, w, cout, True, sms)
        args += [plan.th, plan.cpu, plan.grid]
    code = getattr(lib, f"stem_block0_{sfx}")(
        *args, torch.cuda.current_stream(images_u8.device).cuda_stream)
    _build.check(lib, code, name)
    stem_block0.launches += 1
    return out


stem_block0.launches = 0
