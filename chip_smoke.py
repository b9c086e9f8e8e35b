#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mobilenet_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repo's `mobilenet_tpu_torch/` beside this
file; imports nothing of JAX. Phases, one JSON line each:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the kernels from `mobilenet_tpu_torch/csrc/`;
  2. each float kernel against its plain PyTorch version at the main-path
     shapes of MobileNet-V1 1.0-224: float32 at a tight tolerance (TF32
     off), then bfloat16 at the working tolerance; max-abs error,
     CUDA-event times and the bound (below), and for float32 also
     torch.profiler's device ms of the kernel and of the library sequence
     (taken after phase 46, so that the profiler runs after every other
     phase's events; summed over a forward into the row's f32_* fields;
     phases 10, 18 and 22 likewise); a row whose float32 form runs its own
     design names it (`float32_design`: `csrc/separable_f32.cuh`,
     `csrc/v3_f32.cuh`, `csrc/head_f32.cuh`); the float32 separable tile also
     at batch 2 and 1 at every V1 block shape and V2 b00 (its rows'
     f32_b2 / f32_b1 sums over a forward), its plan's shared memory against
     the kernel's at batch 256, 2 and 1, and the float32 chain equal to five
     per-block launches bit for bit at batch 1 and 2; for the separable block also
     the time of its unfused library sequence
     (`block_times.separable_library`: cuDNN's grouped conv + bias, clamp,
     matmul + bias, clamp; phase 10 the same for the linear block 0), for
     the head that of `block_times.head_library` (mean, addmm), yardsticks
     the port never calls; the head at batch 256 and 1, its bf16 kernels'
     shared memory against `ops/head.head_smem_bytes`, and its bf16
     conv_last walk on the eager ring (C 576 batch 64, C 1024 batch 1)
     against the plain version;
  3. the bf16 1.0-224 pipeline, kernel route against the plain route, at
     batch 256 and batch 1 (logits tolerance, top-1), and a float32
     full-network check at batch 2;
  4. benchmark(): batch-256 img/s and batch-1 latency, both routes;
  5. the float main path: launch counters set to 0, a 64-stream
     MicroBatchServer built (it warm-runs buckets 1, 8 and 64), a selftest
     of every stream, one lone request (bucket 1); counters read; 0 errors
     and every float kernel of the path launched (the stem kernel, the
     block kernel, the head kernel, the chain at batch 1) are required;
  6. the int8 kernels against their plain versions, exactly (torch.equal):
     the fused block at every 1.0-224 block shape at batch 256 and 1, given
     the stored K-major weight copy as the int8 route gives it, the
     depthwise at every depthwise shape at batch 256 and 2 and at its edge
     shapes (C = 8, 24, 40 and 264: the cp.async window of C % 16 == 8; odd
     sides at stride 2; batch 1 and 2; ReLU without 6; six_q 100; a
     16-channel group's biases beyond 2^21); and the input quantization over
     all 256 uint8 values against the host twin;
  7. the int8 pipeline: kernel route against plain route, logits equal bit
     for bit at batch 256 and batch 1; the per-layer gate verify_int8 at
     batch 2 through the depthwise kernel (counters set to 0 before, read
     after: the depthwise kernel's path), exact on every layer;
  8. the int8 benchmark(): batch-256 img/s and batch-1 latency;
  9. the int8 main path: counters set to 0, a 64-stream int8 server and one
     lone request; 0 errors and the int8 block kernel launched;
 10. each MobileNet-V2 kernel against its plain version at the 12 distinct
     block shapes of V2 1.0-224 at batch 256 (the inverted-residual block on
     the V3 bottleneck's tiles with ReLU6: bf16 the Hopper tile, float32
     the CUDA-core tile of `csrc/v3_f32.cuh`, with the time of the unfused library sequence
     `block_times.v3_library`; the block-0 linear-projection mode of the
     separable block) and the conv_last head, V2's, V3-Large's and
     V3-Small's forms (two hswish stages), each at batch 256 and 1, with the
     time of the library sequence `block_times.head_library`: float32 then
     bfloat16, no TF32 flag set; the inverted-residual block in
     bf16 also at batch 1; its plans (bf16 `v3_wgmma_plan` and float32
     `v3_plan`, each at batch 256 and 1) and both shared-memory mirrors;
 11. the V2 bf16 pipeline, kernel route against plain route, at batch 256
     and 1 (the routing gate with the JAX package's V2 extreme-value term
     and float32 anchor, below), and a float32 full-network check at batch 2;
 12. V2 benchmark(): "auto" and "plain" at batch 256, and the batch-1
     latency of "mixed" against "auto" (alternating, in one process);
 13. the V2 float main path: counters set to 0, a 64-stream V2 server and
     one lone request; 0 errors, and the inverted-residual kernel, the
     conv_last head and the block-0 kernel launched;
 14. the V2 int8 kernels against their plain versions, exactly: the int8
     inverted-residual block (the int8 V3 bottleneck's Hopper tile with the
     ReLU6 requant) at the 11 distinct expanded block shapes of V2 1.0-224
     at batch 256 and 1, with its plans (`v3_i8_wgmma_plan`) and the
     shared-memory mirror, a saturation case and a ReLU6 bound below 127
     (six_q 100.37, reached); the int8 separable block's linear mode at
     block 0's shape at batch 256;
 15. the V2 int8 pipeline on one calibrated tree (calibration seconds
     printed): kernel route against plain route, logits equal bit for bit at
     batch 256 and 1; the per-layer gate verify_int8_v2 at batch 2, exact;
 16. the V2 int8 benchmark(): batch-256 img/s and batch-1 latency;
 17. the V2 int8 main path: counters set to 0, a 64-stream V2 int8 server
     and one lone request; 0 errors and both V2 int8 kernels launched;
 18. the MobileNet-V3 bottleneck kernel against its plain version at the 12
     distinct block shapes of V3-Large 1.0-224 at batch 256, with non-zero
     SE biases: float32 then bfloat16, no TF32 flag set, and the time of the
     unfused library sequence (`block_times.v3_library`: matmul + act,
     cuDNN's grouped k x k conv TF-SAME + act, the SE in torch ops, matmul
     + bias + residual), a yardstick the port never calls; bfloat16 also
     at batch 1; the plans (bf16 `v3_wgmma_plan` and float32 `v3_plan`,
     each at batch 256 and 1) and both shared-memory mirrors;
 19. the V3-Large bf16 pipeline (seeded weights with non-zero SE, head and
     fc biases), kernel route against plain route at batch 256 and 1 (the
     anchored routing gate, as V2), a float32 full-network check at batch 2
     at the JAX package's V3 gate, and the per-layer gate verify_layers at
     batch 2 on every tap;
 20. V3 benchmark(): "auto" and "plain" at batch 256, and the batch-1
     latency of "mixed" against "auto" (alternating, in one process);
 21. the V3 float main path: counters set to 0, a 64-stream V3-Large server
     and one lone request; 0 errors, and the V3 bottleneck kernel and the
     fused head launched;
 22-25. phases 18-21 for MobileNet-V3-Small 1.0-224: the V3 kernel at its
     nine distinct block shapes (block 0 with the identity expansion at
     stride 2 and SE), the routes, verify_layers, benchmark() and batch-1
     "mixed" (four plain blocks) against "auto", the 64-stream V3-Small
     server;
 26. V3-Large int8 calibration (32 images, seconds printed);
 27. the int8 V3 kernel against its plain version, exactly, at the 12
     distinct block shapes of V3-Large 1.0-224 at batch 256 and 1 (non-zero
     SE biases, the identity block 0, block 1's expansion at stride 2) and a
     saturating residual; its plans (`v3_i8_wgmma_plan`, printed) and the
     shared-memory mirror of every pass;
 28. the V3-Large int8 pipeline on the calibrated tree: kernel route
     against plain route, logits equal bit for bit at batch 256 and 1; the
     per-layer gate verify_int8_v3 at batch 2, every int8 tap exact;
 29. V3-Large int8 benchmark(): kernel and plain routes at batch 256, and
     their batch-1 latency (alternating);
 30. the V3-Large int8 main path: counters set to 0, a 64-stream int8
     server and one lone request, then `cli serve --model v3 --int8` in
     this process (it calibrates anew); 0 errors and the int8 V3 kernel
     launched in each.
 31. the standalone depthwise kernel against its plain version at the 13
     depthwise layers of V1 1.0-224 (their distinct shapes), at batch 256
     and 2, float32 then bfloat16: max-abs error, CUDA-event ms, the bound,
     the launches, and the time of the nearest library call at the same
     shape (cuDNN's grouped conv in channels-last, then clamp_: "two
     calls", a yardstick the port never calls); then at its edge shapes (C
     = 8, 24, 40; odd sides at stride 2; bias None; ReLU; batch 1 and 2; a
     window wider than a TMA box) within the same gates;
 32. the V1 "dw" route (the depthwise kernel, then the plain pointwise)
     against the plain route: bf16 at batch 256 and 1 with the anchored
     gate, float32 at batch 2 within MM_TOL; then a "fused" pipeline's
     per-layer taps (activations) at batch 8, counters set to 0: the
     depthwise kernel launched once per layer, 13 times;
 33. `cli verify` in this process at 1.0-224, batch 2 (counters set to 0
     before, read after; every run must pass): V1 with the C++ and the
     NumPy oracle, V1 --int8 with both, V1 --routing dw, fused and auto
     (bfloat16), V2, V3, V3-Small, V3-Large --int8 and V3-Small --int8;
     seconds of each;
 34. V3-Small int8 calibration (seconds); the int8 V3 kernel against its
     plain version, exactly, at the nine distinct block shapes of V3-Small
     1.0-224 at batch 256 and 1 (non-zero SE biases; block 0 with the
     identity expansion at stride 2 and SE 8, the JAX package's
     packed_block_i8_named_s2_se) and a block 0 driven into saturation;
     its tile plans and the shared-memory mirror;
 35. the V3-Small int8 pipeline on the calibrated tree: kernel route
     against plain route, logits equal bit for bit at batch 256 and 1;
     verify_int8_v3 at batch 2, every int8 tap exact;
 36. V3-Small int8 benchmark(): kernel and plain routes at batch 256, and
     their batch-1 latency (alternating);
 37. the V3-Small int8 main path: counters set to 0, a 64-stream int8
     server and one lone request, then `cli serve --model v3small --int8`
     in this process; 0 errors and the int8 V3 kernel launched in each.
 38. the stem kernels against their plain versions at V1 1.0-224, batch
     256 and 2, float32 then bf16 (the fused normalize + stem + block-0
     kernel in float32 at 1.0-160, where the routing gate lets it run):
     max-abs error, CUDA-event ms, the bound, and the yardsticks: the
     unfused sequence it replaces (preprocess, the plain route's stem,
     block 0's separable_block) and, for the stem alone, the plain route's
     cuDNN stem (`ops/conv.conv2d_same`: conv, bias, clamp); the stem
     kernel also on odd sides (1.0-225x223, batch 2);
 39. the fused-stem pipeline against the default pipeline: bf16 1.0-224 at
     batch 256 and 1 (the routing gate; the fused kernel launched once a
     forward, separable_block 12 times at batch 256, 7 and the chain once
     at batch 1), float32 1.0-160 at batch 2 within 1e-4/1e-3, and the
     float32 1.0-224 pipeline (counters set to 0 before, read after): the
     gate refuses the fused kernel there, and the default route runs, its
     stem on the stem kernel;
 40. benchmark() of the fused-stem and the default pipeline, alternating
     in one process at batch 256, and their batch-1 p50/p99;
 41. the fused-stem main path: counters set to 0, a 64-stream server on
     the fused-stem pipeline and one lone request; 0 errors, and the fused
     stem kernel launched.
 42. the V3 chain kernel on every run that the greedy chain knob forms at
     V3-Large and V3-Small 1.0-224 (blocks 1 to the last), bf16 at batch
     256 and 1 and float32 at batch 8, random weights with non-zero SE
     biases: bit-equal to v3_block called per block in sequence, within
     BF16/F32_ATOL/RTOL of v3_chain_plain; its ms beside the same blocks'
     per-block ms, plain ms, its bound (input and output once, the blocks'
     operations) and the sum of the per-block bounds, and its grid (the
     launch's block count); the wrapper's host ms a call, its tables made
     anew and kept;
 43. the chained V3-Large and V3-Small bf16 pipelines: logits equal to the
     per-block "auto" route's bit for bit at batch 256 and 1 (one chain
     launch a forward), the anchored routing gate against the plain route
     with the knob on (and the float32 check at batch 2); benchmark() at
     batch 256 with the knob off and on (V3-Large also with the run split
     before block 12, whose tile halves residency), alternating in one
     process; batch-1 p50/p99 of each, and of the chain with its wrapper's
     checks and tables made anew at every call;
 44. the chained V3-Small main path: counters set to 0, a 64-stream server
     with the knob on and one lone request; 0 errors and v3_chain launched;
 45. the floor probes (`python -m mobilenet_tpu_torch.floors`'s run,
     counters set to 0 before and read after; the JSON written to
     build/achievable_h100.json): the copies bit-equal to their input at
     the five audit shapes and at 65,537 images of 16 bytes, their A/B
     against `Tensor.copy_` (`floors --copy-ab 7`: medians and spreads of
     alternating runs), the stencil's variants against their plain
     versions (bf16 bit-equal; float32 within one bf16 step, relative, for
     FMA contraction) at the timed 56^2 x 128 shape after 2, 8 and 256
     rounds and at the plan's edge shapes (STENCIL_EDGES) after 0, 1 and
     19, the short runs required to depend on x (`check_stencil`), each
     stencil run's time on the card against its bound, the
     library copy's time; the roofline floors of V1, V2,
     V3-Large and V3-Small 1.0-224 at batch 256 at the published and the
     measured rates.
 46. the accuracy path, each step through the CLI in this process with the
     counters set to 0 before and read after: `cli export` of the seeded
     V1 1.0-224 weights, `cli eval` on its folded file at the JAX package's
     defaults (float32, 32 structured images, the NumPy oracle, batch 16,
     --min-agreement 1.0; stem_conv, separable_block and fused_head
     launched), with --int8 (separable_block_i8) and with --dtype bfloat16
     (its family's tie margin; the float kernels), V2, V3-Large and
     V3-Small float32 on 8 images, and V1 float32 with --dir on 8 PNG files
     of 4 shapes other than 224 squared (the device resizes them, and the
     host's resize, the oracle's input, holds it); each exits 0, its report
     printed (the
     agreements, near ties, the largest oracle margin among mismatches,
     seconds); then `cli classify` (bf16, batch 1: stem_conv, the chain,
     fused_head) of a PNG written with zlib and struct, and whether the
     native decoder builds there (else PIL decodes).
 47. training, QAT, several variants served and warmup (`training_phases`):
     one V1 1.0-224 float32 train step at batch 4 on the card (the
     trainer's) against the same step on the CPU with the card's ReLU6 clip
     decisions replayed (every gradient leaf within GRAD_REL of its
     absmax), again with cuDNN's TF32 allowed and a float32 matmul
     precision of "high" set beforehand (the step's own guard must hold),
     and an unguarded TF32 control, which must miss it;
     `cli train --steps 5 --batch 32` (the loss descends; ms a step and
     img/s) and the float32 and QAT trainers at batch 32 timed; the QAT
     taps of V1 (batch 4), V2, V3-Large and V3-Small (batch 2) 1.0-224 equal
     to the NumPy int8 oracles bit for bit; `cli train --qat --steps 3
     --batch 16 --out` at V1 1.0-224, its tree through `quantize` into the
     int8 path on the card: verify_int8 exact, the fused route's logits
     (separable_block_i8 launched) equal to the QAT forward's, top-1 too;
     `cli serve --variants 1.0:224,0.25:128,v2:1.0:224` (bf16) and `--int8
     --variants 1.0:224,v3:1.0:224` (0 errors, the route kernels launched),
     then each deployment's variants alone (counters set to 0 before each,
     its own route's kernels launched), selftest_multi, and one TCP round
     trip naming a variant; `cli warmup` of V1 1.0-224 (buckets 1, 8, 64)
     in two fresh processes from a copy of the package not built yet: the
     first builds the kernels, the second finds every bucket "cached".
 48. data, tensor and pipeline parallelism (`parallel_phases`), every mesh
     on ranks that share the one card (`devices=["cuda:0"] * n`; its
     img/s are no scaling figure): (a) the separable block's raw-partial
     mode (`pw_epilogue=False`, the tensor-parallel partial) against its
     plain version at the V1 1.0-224 shard shapes of tp 2 (blocks 4-12) and
     tp 4 (blocks 6-12), batch 256 and 1, bf16 (`partial_bf16_atol`, no
     relative term; the plain output rounded to bf16, a planted control,
     must miss it) and float32 (MM_TOL), with its ms, the bound (a 4-byte output) and the library
     sequence's ms (the `separable_block[partial]` row of the kernels line);
     (b) `forward_tp_fused` at V1 1.0-224 bf16 batch 256, tp 2, tp 4 and
     dp 2 x tp 2, against the single-device forward within V1's route gate
     (a top-1 flip only between near-tied classes), the partial launches
     equal to kernel blocks x tp x dp; again in float32 at batch 8 within
     atol 2e-4 / rtol 1e-3; (c) `forward_i8_tp` at batch 64, tp 2 and 4,
     equal to `forward_i8` (torch.equal); (d) the data-parallel pipelines
     on two ranks (V1 bf16 and int8, V2 bf16, V3-Large int8 at batch 64)
     against one device (int8 equal; bf16 within ROUTE_ATOL, top-1), a
     2-rank `benchmark()`, a 64-stream selftest through `build_server(...,
     mesh=)` (buckets [2, 8, 64], 0 errors, the route's kernels launched),
     `cli serve --dp 2` refused with make_mesh's error on a one-card
     machine, `cli warmup --dp 1`; (e) `forward_pp` of V1, V2, V3-Large and
     V3-Small 1.0-224 (bf16, batch 64, S 4, M 8, "auto"): stage bounds,
     against the single-device forward on each microbatch (within the route
     gate; bit-equality reported), the families' kernels launched; (f)
     `pp_train_step` of V1 1.0-224 (float32, batch 8, S 4, M 4, lr 1)
     against one single-device SGD step on the whole batch with the
     pipelined forward's ReLU6 clip decisions replayed (phase 47's caveat):
     the loss, and every updated leaf within GRAD_REL of its update's
     absmax plus the float32 rounding of w - lr * g; the clip decisions
     that differ between the two forwards counted, and the step without
     the replay reported beside;
     (g) the img/s of (b), (d) and (e).
Phases 18-25 also hold the default V3 routes to no v3_chain launch.
Phase 28 also holds V3-Large-minimalistic int8's kernel route to its plain
route at batch 256, bit for bit.
Then one JSON line of per-kernel results and, last, the result line.
Any failure raises and the script exits non-zero without the result line.

bound_ms is the least time the card could take for a kernel's work: the
larger of the bytes it must move (each input read once, each output written
once) over 3.35 TB/s, and its operations (multiply-adds count 2) over the
peak rate of their type (989 TFLOP/s bf16, 67 TFLOP/s float32 outside the
tensor cores, 1,979 TOP/s int8): NVIDIA's H100 SXM data sheet, read from
`mobilenet_tpu_torch/utils/flops.py` (HBM_BYTES_PER_S, PEAK_OPS_PER_S). Depthwise
and stem multiply-adds (one or three input channels: no matrix unit shape)
count at the 67 TFLOP/s of the CUDA cores. No TF32
flag is set, except around phase 47's one guarded train step (restored
after it): float32 products run in IEEE float32 by default, and the float32
stem turns cuDNN's TF32 off around its own call.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

from mobilenet_tpu_torch.block_times import separable_library
from mobilenet_tpu_torch.floors import cuda_ms
from mobilenet_tpu_torch.utils.flops import HBM_BYTES_PER_S, PEAK_OPS_PER_S

# bf16 kernel vs plain: the depthwise result is rounded to bf16 before the
# product and the output to bf16 after it; a last-bit difference in the f32
# sums (FMA contraction, summation order) can move either rounding by one
# bf16 step (2^-8 relative), so two steps at the value plus a floor.
BF16_ATOL, BF16_RTOL = 6e-2, 1.6e-2
# fp32 kernel vs plain: reassociation of f32 sums only (K <= 1024); the
# per-layer gate of the JAX package's golden harness (MM_TOL).
F32_ATOL, F32_RTOL = 1e-4, 3e-4
# Whole-network bf16 kernel route vs plain route (logits): the JAX package's
# routing gate, max(6e-2, 4.5e-2 x logits absmax).
ROUTE_ATOL, ROUTE_REL = 6e-2, 4.5e-2
# V2 float32 network, kernel route vs plain route (logits): the JAX
# package's V2 gate (golden.V2_TOL): the linear bottlenecks carry f32
# reassociation noise unclipped through 17 blocks.
V2_F32_ATOL, V2_F32_RTOL = 1e-3, 1e-3
# V3 float32 network, kernel route vs plain route (logits): the JAX
# package's V3 gate (golden.V3_TOL): unbounded relu / hard-swish activations
# of O(30) and the SE gates carry f32 reassociation through 15 blocks.
V3_F32_ATOL, V3_F32_RTOL = 3e-3, 1e-3
# V2 bf16 routes: the JAX package's V2 routing verify (golden.
# routing_bf16_atol and cli._verify_routing). The linear bottlenecks carry
# the bf16 rounding noise of two valid routes unclipped, so the max-abs
# limit also takes ROUTE_EV_FACTOR x rms(kernel - plain) x sqrt(2 ln n),
# the extreme value of that noise over n logits; and the kernel route must
# stay within ROUTE_ANCHOR x the plain route's RMS distance (+ ROUTE_ATOL)
# of the float32 plain route on the same weights.
ROUTE_EV_FACTOR, ROUTE_ANCHOR = 1.5, 1.5

ALPHA, RES = 1.0, 224

# bytes per element of (activations, weights, biases, multipliers)
ELEM_BYTES = {"bf16": (2, 2, 2, 0), "f32": (4, 4, 4, 0), "int8": (1, 1, 4, 4)}
# No single PyTorch call computes the fused kernels' functions (fused dw+pw
# with requant, K chained blocks, int8 dw+requant, fused expand + dw +
# projection with or without requants). The standalone float depthwise has a
# nearest library form (phase 31), the float separable block an unfused
# library sequence (phase 2, `block_times.separable_library`), the fused head
# one too (phases 2 and 10, `block_times.head_library`).
LIBRARY_MS = None
# Where the int8 separable block's Hopper tile lives (its kernel line names it).
I8_BLOCK_DESIGN = ["mobilenet_tpu_torch/csrc/separable_i8_wgmma.cuh",
                   "mobilenet_tpu_torch/csrc/int8_tile.cuh",
                   "mobilenet_tpu_torch/csrc/hopper.cuh"]
# The standalone depthwise kernels' Hopper design (float; int8 with the
# depthwise stage it shares with the int8 block).
DW_DESIGN = ["mobilenet_tpu_torch/csrc/depthwise_ring.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
DW_I8_DESIGN = ["mobilenet_tpu_torch/csrc/depthwise_ring.cuh",
                "mobilenet_tpu_torch/csrc/int8_tile.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
# The depthwise kernels' edge shapes (phases 6 and 31): n, h, w, C, stride,
# and (int8) six_q, relu6, biases beyond 2^21 / (float) bias, relu6.
DW_I8_EDGES = ((1, 9, 9, 8, 2, 127.0, True, False), (2, 13, 13, 24, 1, 100.0, True, True),
               (2, 15, 11, 40, 2, 127.0, False, False), (1, 11, 11, 264, 2, 127.0, True, True),
               (2, 7, 7, 1024, 1, 100.0, True, True))
DW_EDGES = ((1, 9, 9, 8, 2, True, True), (2, 13, 13, 24, 1, False, True),
            (2, 15, 11, 40, 2, True, False), (1, 300, 300, 16, 1, True, True),
            (1, 7, 7, 1024, 2, False, False))
V3_DESIGN = ["mobilenet_tpu_torch/csrc/v3_wgmma.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
# The float32 kernels' Hopper designs (CUDA-core fmaf on cp.async rings).
SEP_F32_DESIGN = ["mobilenet_tpu_torch/csrc/separable_f32.cuh",
                  "mobilenet_tpu_torch/csrc/hopper.cuh"]
V3_F32_DESIGN = ["mobilenet_tpu_torch/csrc/v3_f32.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
HEAD_F32_DESIGN = ["mobilenet_tpu_torch/csrc/head_f32.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
V3_I8_DESIGN = ["mobilenet_tpu_torch/csrc/v3_i8_wgmma.cuh",
                "mobilenet_tpu_torch/csrc/hopper.cuh"]
HEAD_DESIGN = ["mobilenet_tpu_torch/csrc/head_wgmma.cuh", "mobilenet_tpu_torch/csrc/hopper.cuh"]
HEAD_LIBRARY = "[torch.addmm + act (conv_last)], mean over H*W, torch.addmm + act per post matmul"
V3_LIBRARY = ("torch.matmul + bias + act, F.conv2d(groups=E, channels-last, TF-SAME) + act, "
              "SE (mean, matmul, relu, matmul, hardsigmoid, mul), torch.matmul + bias "
              "(+ residual)")


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by, bytes_ms, ops_ms) of one call."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), t_b, t_o


def block_work(n, h, cin, cout, stride, kind, k=1):
    """(bytes, ops) of k depthwise-separable blocks on (n, h, h, cin): the
    input and output once, the weights once. The depthwise multiply-adds
    count at the CUDA cores' float32 rate (one input channel: no matrix unit
    shape, as dw_work), so they enter `ops` scaled to the pointwise's rate:
    bound(*block_work(..., kind), kind) takes pointwise / peak[kind] +
    depthwise / peak["f32"]."""
    act, w, b, m = ELEM_BYTES[kind]
    ho = -(-h // stride)
    pix_out = n * ho * ho
    weights = k * (9 * cin * w + cin * (b + m) + cin * cout * w + cout * (b + m))
    nbytes = n * h * h * cin * act + weights + pix_out * cout * act
    dw_ops = 2 * 9 * pix_out * cin * PEAK_OPS_PER_S[kind] / PEAK_OPS_PER_S["f32"]
    ops = k * (dw_ops + 2 * pix_out * cin * cout)
    return nbytes, ops


def ir_work(n, h, cin, e, cout, stride, kind, k=3, se=0, identity=False):
    """(bytes, ops) of one inverted-residual block on (n, h, h, cin): the
    input and output once, the weights once; the expansion of every input
    pixel (the stride-2 depthwise reads all of them; none for the identity
    expansion), the k*k taps and the projection of every output pixel, and
    the residual add where there is one; with an SE width `se`, its weights,
    its pool, two (n, e) x (e, se) products and the gate's multiply. The
    kernel's recompute (halo, SE blocks' second pass) is not counted."""
    act, w, b, _ = ELEM_BYTES[kind]
    ho = -(-h // stride)
    pix_in, pix_out = n * h * h, n * ho * ho
    exp = 0 if identity else cin * e
    weights = (exp + k * k * e + e * cout + 2 * e * se) * w
    weights += ((0 if identity else e) + e + cout + (se + e if se else 0)) * b
    nbytes = pix_in * cin * act + weights + pix_out * cout * act
    ops = (2 * pix_in * exp + 2 * k * k * pix_out * e + 2 * pix_out * e * cout
           + (pix_out * cout if stride == 1 and cin == cout else 0)
           + (2 * pix_out * e + 4 * n * e * se if se else 0))
    return nbytes, ops


def head_work(n, hw, c, e, widths, kind):
    """(bytes, ops) of a fused head: [conv_last c -> e] over n x hw pixels,
    the pool, and post matmuls of `widths`; e == c and no conv_last when e
    is None."""
    act = ELEM_BYTES[kind][0]
    pix = n * hw * hw
    k = c if e is None else e
    nbytes = pix * c + (0 if e is None else c * e + e)
    ops = (0 if e is None else 2 * pix * c * e) + pix * k
    for m in widths:
        nbytes += k * m + m
        ops += 2 * n * k * m
        k = m
    return (nbytes + n * k) * act, ops


def dw_work(n, h, c, stride, kind="int8"):
    act, w, b, m = ELEM_BYTES[kind]
    ho = -(-h // stride)
    return (n * h * h * c * act + c * (9 * w + b + m) + n * ho * ho * c * act,
            2 * 9 * n * ho * ho * c)


def ptxas_lines(log: str) -> list:
    """The build log's register and spill lines, each after the mangled name
    of the kernel ptxas was compiling ("<kernel>: ptxas info : Used ...")."""
    out, kernel = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            kernel = m.group(1)
        elif "registers" in ln or "spill" in ln:
            out.append(f"{kernel}: {ln.strip()}")
    return out


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def compare(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - ref).abs()
    excess = float((diff - (atol + rtol * ref.abs())).max())
    max_abs = float(diff.max())
    if excess > 0:
        raise AssertionError(f"{name}: max_abs {max_abs:.3e} exceeds atol {atol} "
                             f"+ rtol {rtol} x |ref| by {excess:.3e}")
    return max_abs


def block_shapes(cfg, batch):
    """(name, N, H, Cin, Cout, stride, count) of each distinct main-path
    block shape, `count` = how many blocks of one forward have it."""
    shapes, hw, cin = {}, cfg.resolution // 2, cfg.stem_channels
    for i, (stride, cout) in enumerate(zip(cfg.block_strides, cfg.block_channels)):
        key = (hw, cin, cout, stride)
        if key in shapes:
            shapes[key][1] += 1
        else:
            shapes[key] = [f"b{i:02d}", 1]
        hw //= stride
        cin = cout
    return [(nm, batch, h, ci, co, s, cnt)
            for (h, ci, co, s), (nm, cnt) in shapes.items()]


def rand_block(gen, n, h, cin, cout, dtype, k=None):
    dev = "cuda"

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype).contiguous()

    x = (torch.rand(n, h, h, cin, generator=gen, device=dev) * 2 - 1).to(dtype).contiguous()
    if k is None:
        return (x, r(3, 3, 1, cin, scale=0.5), r(cin, scale=0.2),
                r(cin, cout, scale=1.0 / cin ** 0.5), r(cout, scale=0.2))
    return (x, r(k, 3, 3, cin, scale=0.5), r(k, cin, scale=0.2),
            r(k, cin, cin, scale=1.0 / cin ** 0.5), r(k, cin, scale=0.2))


def serve_main_path(pipe, kernels, required, phase, smi):
    """Counters of every kernel set to 0, a 64-stream MicroBatchServer over
    `pipe` (its construction warm-runs buckets 1, 8 and 64), a selftest of
    every stream and one lone request (bucket 1), counters read. Raises
    unless 0 errors and every kernel in `required` launched. Returns the
    counts of the `required` kernels."""
    from mobilenet_tpu_torch.runtime.serving import MicroBatchServer, selftest

    for k in kernels.values():
        k.launches = 0

    async def serve():
        server = MicroBatchServer(pipe, max_batch=64)
        await server.start()
        try:
            stats = await selftest(server, streams=64, requests_per_stream=4)
            frame = np.random.default_rng(1).integers(0, 256, (RES, RES, 3), np.uint8)
            before = server.stats.bucket_counts.get(1, 0)
            top = await server.submit(frame)
            stats["lone_request_bucket1"] = server.stats.bucket_counts.get(1, 0) - before
            stats["lone_request_top1"] = top[0][0]
            stats["errors_final"] = server.stats.errors
            return stats
        finally:
            await server.close()

    stats = asyncio.run(serve())
    torch.cuda.synchronize()
    launches = {k: kernels[k].launches for k in required}
    emit(phase, nvidia_smi=smi, launches=launches, **stats)
    if stats["errors_final"] != 0:
        raise AssertionError(f"{phase}: {stats['errors_final']} errors")
    if stats["lone_request_bucket1"] != 1:
        raise AssertionError(f"{phase}: the lone request did not run in bucket 1")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{phase}: kernel {k} was not launched on the main path")
    return launches


def int8_block_args(rng, n, h, cin, cout):
    """Random int8 block operands on the card: x in [0, 127] (a ReLU6
    activation), int8 weights, int32 biases, float32 multipliers that spread
    the requantized values over (0, 127]."""
    def t(a):
        return torch.from_numpy(a).cuda()

    def layer(c, scale):
        return (t(rng.integers(-5000, 5000, (c,)).astype(np.int32)),
                t((rng.uniform(0.2, 1.5, (c,)) * scale).astype(np.float32)))

    return (t(rng.integers(0, 128, (n, h, h, cin)).astype(np.int8)),
            t(rng.integers(-127, 128, (3, 3, 1, cin)).astype(np.int8)), *layer(cin, 4e-3),
            t(rng.integers(-127, 128, (cin, cout)).astype(np.int8)),
            *layer(cout, 2 / 60 / cin ** 0.5))


def check_i8(summary, kname, shape_name, count, kfn, pfn, args, work, smi):
    """One int8 kernel at one shape against its plain version, exactly
    (torch.equal); CUDA-event times of both and the bound; the numbers,
    times `count` (the shape's blocks per forward), add to the kernel's row
    in `summary`. Returns the plain version's output."""
    got, ref = kfn(*args), pfn(*args)
    torch.cuda.synchronize()
    if got.dtype != torch.int8 or got.shape != ref.shape:
        raise AssertionError(f"{kname} {shape_name}: {got.dtype} {tuple(got.shape)} "
                             f"vs {tuple(ref.shape)}")
    err = float((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{kname} {shape_name}: "
                             f"{int((got != ref).sum())} elements differ (max {err})")
    kms, pms = cuda_ms(lambda: kfn(*args)), cuda_ms(lambda: pfn(*args))
    b_ms, b_by, t_b, t_o = bound(*work, "int8")
    emit("kernel", kernel=kname, shape=shape_name, count_per_forward=count,
         max_abs_err=err, tolerance=0, ms=kms, plain_ms=pms, bound_ms=b_ms,
         bound_by=b_by, library_ms=LIBRARY_MS, zero_share=float((ref == 0).float().mean()),
         saturated_share=float(((ref == 127) | (ref == -128)).float().mean()),
         nvidia_smi=smi)
    s = summary[kname]
    s["ms"] += count * kms
    s["plain_ms"] += count * pms
    s["bound_ms"] += count * b_ms
    s["bytes_ms"] += count * t_b
    s["ops_ms"] += count * t_o
    return ref


def int8_phases(smi, kernels, launches):
    """Phases 6-9. Fills launches["separable_block_i8"] (the int8 server)
    and launches["depthwise_i8"] (the verify gate); returns the two kernels'
    summaries."""
    from mobilenet_tpu_torch import Int8Pipeline, ModelConfig
    from mobilenet_tpu_torch.checkpoints import fold_bn, init_params
    from mobilenet_tpu_torch.ops.depthwise_i8 import depthwise_i8_plain
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.separable_block_i8 import separable_block_i8_plain
    from mobilenet_tpu_torch.quant import ACT_IN_SCALE, quantize_input
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant.model import forward_i8
    from mobilenet_tpu_torch.quant.verify import verify_int8

    cfg = ModelConfig(ALPHA, RES)
    block_i8, dw_i8 = kernels["separable_block_i8"], kernels["depthwise_i8"]
    summary = {
        "separable_block_i8": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/separable_block_i8.cu",
            "design": I8_BLOCK_DESIGN,
            "replaces": "mobilenet_tpu/quant/pallas_block_i8.py:201",
            "also_replaces": ["mobilenet_tpu/quant/pallas_block_packed_i8.py:222",
                              "mobilenet_tpu/ops/pallas_block_packed_mxu.py:391"]},
        "depthwise_i8": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/depthwise_i8.cu",
            "design": DW_I8_DESIGN, "replaces": "mobilenet_tpu/quant/pallas_dw_i8.py:74"},
    }
    for s in summary.values():
        s.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                 ops_ms=0.0, library_ms=LIBRARY_MS)

    # -- 6. int8 kernels vs plain, exact ----------------------------------------
    rng = np.random.default_rng(0)
    dw_shapes = {}
    for batch in (256, 1):
        for nm, n, h, cin, cout, stride, cnt in block_shapes(cfg, batch):
            args = int8_block_args(rng, n, h, cin, cout)
            wt = args[4].t().contiguous()  # the K-major copy, as Int8Pipeline stores it
            # the row sums one batch-256 forward; batch 1 is printed per shape
            check_i8(summary, "separable_block_i8",
                     f"{nm} ({n},{h},{h},{cin})->{cout} s{stride}", cnt if batch == 256 else 0,
                     lambda *a, wt=wt: block_i8(*a, pw_wt=wt), separable_block_i8_plain,
                     args + (stride, 127.0, 127.0, True),
                     block_work(n, h, cin, cout, stride, "int8"), smi)
            if batch == 256:
                key = (n, h, cin, stride)
                dw_shapes[key] = (nm, args[:4], dw_shapes.get(key, (nm, None, 0))[2] + cnt)
            del args, wt
            torch.cuda.empty_cache()
    for (n, h, c, stride), (nm, args, cnt) in dw_shapes.items():
        check_i8(summary, "depthwise_i8", f"{nm}_dw ({n},{h},{h},{c}) s{stride}", cnt, dw_i8,
                 depthwise_i8_plain, args + (127.0, stride, True), dw_work(n, h, c, stride), smi)
        # batch 2, as `cli verify --int8` runs it (printed per shape, not in the row)
        args = int8_block_args(rng, 2, h, c, 8)[:4]
        check_i8(summary, "depthwise_i8", f"{nm}_dw (2,{h},{h},{c}) s{stride}", 0, dw_i8,
                 depthwise_i8_plain, args + (127.0, stride, True), dw_work(2, h, c, stride), smi)
    del dw_shapes, args
    torch.cuda.empty_cache()
    for n, h, w, c, stride, six_q, relu6, big in DW_I8_EDGES:
        x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, c)).astype(np.int8)).cuda()
        _, dw, db, dm, *_ = int8_block_args(rng, 1, 1, c, 8)
        if big:  # the first 16 channels' sums convert by __int2float_rn
            db[:16] += torch.tensor(rng.choice([-1, 1], 16) * (3 << 21), dtype=torch.int32,
                                    device="cuda")
            dm[:16] *= 1e-3
        check_i8(summary, "depthwise_i8", f"edge ({n},{h},{w},{c}) s{stride} six_q {six_q} "
                 f"relu6 {relu6} big_bias {big}", 0, dw_i8, depthwise_i8_plain,
                 (x, dw, db, dm, six_q, stride, relu6), dw_work(n, h, c, stride), smi)
    imgs = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    x = preprocess(torch.from_numpy(imgs).cuda(), 16)
    if not np.array_equal(qops.quantize_input_dev(x, ACT_IN_SCALE).cpu().numpy(),
                          quantize_input(x.cpu().numpy())):
        raise AssertionError("quantize_input_dev differs from the host twin")
    emit("int8_input", uint8_values=256, equal_to_host_twin=True)

    # -- 7. int8 pipeline: kernel route vs plain route; verify ----------------------
    pipe = Int8Pipeline(cfg, device="cuda")
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x_q = qops.quantize_input_dev(preprocess(imgs, RES), ACT_IN_SCALE)
            got = forward_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            ref = forward_i8(pipe.dev, x_q, cfg, dw_backend="plain")
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 pipeline batch {batch}: kernel route logits "
                                     "differ from the plain route")
            if not torch.isfinite(got).all() or got.shape != (batch, cfg.num_classes):
                raise AssertionError(f"int8 pipeline batch {batch}: bad logits")
            emit("pipeline", dtype="int8", batch=batch, max_abs_err=0.0, tolerance=0,
                 top1_agree=batch, rows=batch, logits_absmax=float(ref.abs().max()))
    for k in kernels.values():
        k.launches = 0
    folded = fold_bn(init_params(cfg, seed=1), eps=cfg.bn_eps)
    x = rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ok = verify_int8(cfg, folded, x, device="cuda", use_dw_kernel=True)
    torch.cuda.synchronize()
    launches["depthwise_i8"] = dw_i8.launches
    emit("verify_int8", batch=2, exact=ok, launches={"depthwise_i8": dw_i8.launches})
    if not ok or dw_i8.launches <= 0:
        raise AssertionError("verify_int8 at 1.0-224: a layer differs from the oracle "
                             "or the depthwise kernel did not launch")

    # -- 8. int8 benchmark --------------------------------------------------------
    emit("benchmark", route="int8 auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = Int8Pipeline(cfg, device="cuda", dw_backend="plain")
    emit("benchmark", route="int8 plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=10))
    del plain
    torch.cuda.empty_cache()

    # -- 9. the int8 main path: 64-stream server ------------------------------------
    launches.update(serve_main_path(pipe, kernels, ("separable_block_i8",), "serving_int8",
                                    smi))
    return summary


FLOAT_ROW = dict(max_abs_err=0.0, max_abs_err_f32=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bytes_ms=0.0, ops_ms=0.0, library_ms=LIBRARY_MS)
# The float32 device-time measurements (torch.profiler), run after every
# other phase, so that the other rows' CUDA-event times are taken in a
# process that has not yet run the profiler.
DEFERRED_DEVICE = []


def check_float(summary, kname, shape_name, count, kfn, pfn, args_f32, args_bf16, work,
                lfn=None):
    """One float kernel at one shape: float32 then bfloat16 against its
    plain version (tolerances above), CUDA-event times of both, the bound,
    and the time of `lfn`, a library sequence of the same function, where
    given. The bf16 numbers, times `count` (the shape's blocks per forward),
    add to the kernel's row in `summary`."""
    from mobilenet_tpu_torch.ops.conv import no_tf32

    row = {}
    for tag, args, atol, rtol in (("f32", args_f32, F32_ATOL, F32_RTOL),
                                  ("bf16", args_bf16, BF16_ATOL, BF16_RTOL)):
        got = kfn(*args)
        ref = pfn(*args)
        torch.cuda.synchronize()
        err = compare(f"{kname} {shape_name} {tag}", got, ref, atol, rtol)
        kms, pms = cuda_ms(lambda: kfn(*args)), cuda_ms(lambda: pfn(*args))
        row[tag] = {"max_abs_err": err, "ms": kms, "plain_ms": pms,
                    "atol": atol, "rtol": rtol, "library_ms": LIBRARY_MS}
        if lfn is not None:
            with no_tf32(args[0]):
                row[tag]["library_ms"] = cuda_ms(lfn(*args))
        b_ms, b_by, t_b, t_o = bound(*work(tag), tag)
        row[tag].update(bound_ms=b_ms, bound_by=b_by)
        s = summary[kname]
        if tag == "bf16":
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += count * kms
            s["plain_ms"] += count * pms
            s["bound_ms"] += count * b_ms
            s["bytes_ms"] += count * t_b
            s["ops_ms"] += count * t_o
            if lfn is not None:
                s["library_ms"] += count * row[tag]["library_ms"]
        else:
            s["max_abs_err_f32"] = max(s["max_abs_err_f32"], err)
            # the float32 sums over one forward, beside the row's bf16 ones
            add = {"f32_ms": kms, "f32_bound_ms": b_ms}
            if lfn is not None:
                add["f32_library_ms"] = row[tag]["library_ms"]
            for k, v in add.items():
                s[k] = s.get(k, 0.0) + count * v
            DEFERRED_DEVICE.append((s, kname, shape_name, count, kfn, lfn, args))
    emit("kernel", kernel=kname, shape=shape_name, count_per_forward=count, **row)


def float32_device_times():
    """The float32 kernels' and library sequences' device ms (torch.profiler)
    at every shape `check_float` saw, after every other phase; each summed
    over one forward into its row (f32_device_ms, f32_library_device_ms)."""
    from mobilenet_tpu_torch.block_times import device_ms
    from mobilenet_tpu_torch.ops.conv import no_tf32

    for s, kname, shape_name, count, kfn, lfn, args in DEFERRED_DEVICE:
        got = {"device_ms": device_ms(lambda: kfn(*args), reps=10)}
        if lfn is not None:
            with no_tf32(args[0]):
                got["library_device_ms"] = device_ms(lfn(*args), reps=10)
        for k, v in got.items():
            s[f"f32_{k}"] = s.get(f"f32_{k}", 0.0) + count * v
        emit("kernel_f32_device", kernel=kname, shape=shape_name, count_per_forward=count, **got)
    DEFERRED_DEVICE.clear()
    torch.cuda.empty_cache()


def f32_separable_checks(summary, gen, cfg):
    """Phase 2's float32 separable tile (`csrc/separable_f32.cuh`) beyond the
    batch-256 rows: its plan's shared memory (`f32_sep_plan`,
    `f32_sep_smem_bytes`) against the kernel's own (`separable_f32_smem_bytes`)
    at every V1 1.0-224 block shape, V2 b00 and the chain's at batch 256, 2
    and 1; the tile against its plain version within F32_ATOL/RTOL at those
    shapes at batch 2 and 1 (its events and plain times per shape; its device
    ms deferred to `float32_device_times`, summed over a forward into the
    row's f32_b2 / f32_b1); the float32 chain equal to five per-block
    launches bit for bit at batch 1 and 2."""
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.chain import chain
    from mobilenet_tpu_torch.ops.separable_block import (
        f32_sep_plan, f32_sep_smem_bytes, separable_block, separable_block_plain,
    )

    lib = _build.library()
    shapes = [(nm, h, ci, co, s, cnt, True) for nm, _, h, ci, co, s, cnt in block_shapes(cfg, 1)]
    shapes.append(("v2b00", 112, 32, 16, 1, 0, False))
    for n in (256, 2, 1):
        for _, h, ci, co, s, _, _ in shapes + [("chain", 14, 512, 512, 1, 0, True)]:
            p = f32_sep_plan(n, h, h, ci, co, s)
            got = lib.separable_f32_smem_bytes(p.mg, p.th, p.tw, p.kp, p.ns, p.ws, p.bs, s)
            want = f32_sep_smem_bytes(p.mg, p.th, p.tw, p.kp, p.ns, p.ws, p.bs, s)
            if got != want:
                raise AssertionError(f"separable_f32_smem_bytes {(n, h, ci, co, s)} {p}: "
                                     f"kernel {got}, plan {want}")
    for n in (2, 1):
        row = summary["separable_block"].setdefault(f"f32_b{n}", {})
        for nm, h, ci, co, s, cnt, act in shapes:
            args = rand_block(gen, n, h, ci, co, torch.float32) + (s, True)
            fn = (lambda *a, act=act: separable_block(*a, pw_act=act))  # noqa: E731
            name = f"separable_block {nm} ({n},{h},{h},{ci})->{co} s{s} f32"
            err = compare(name, fn(*args), separable_block_plain(*args, pw_act=act),
                          F32_ATOL, F32_RTOL)
            kms = cuda_ms(lambda: fn(*args))
            pms = cuda_ms(lambda: separable_block_plain(*args, pw_act=act))
            b_ms = bound(*block_work(n, h, ci, co, s, "f32"), "f32")[0]
            emit("kernel_f32", kernel="separable_block", shape=name, batch=n,
                 plan=list(f32_sep_plan(n, h, h, ci, co, s)), max_abs_err=err, ms=kms,
                 plain_ms=pms, bound_ms=b_ms, atol=F32_ATOL, rtol=F32_RTOL)
            summary["separable_block"]["max_abs_err_f32"] = max(
                summary["separable_block"]["max_abs_err_f32"], err)
            if cnt:
                for k, v in (("ms", kms), ("bound_ms", b_ms)):
                    row[k] = row.get(k, 0.0) + cnt * v
                DEFERRED_DEVICE.append((row, "separable_block", name, cnt, fn, None, args))
    for n in (1, 2):
        args = rand_block(gen, n, 14, 512, 512, torch.float32, k=5) + (True,)
        got, y = chain(*args), args[0]
        for i in range(5):
            y = separable_block(y, args[1][i].reshape(3, 3, 1, 512).contiguous(), args[2][i],
                                args[3][i], args[4][i], 1, True)
        torch.cuda.synchronize()
        if not torch.equal(got, y):
            raise AssertionError(f"float32 chain at batch {n}: not equal to five per-block "
                                 f"launches (max-abs {float((got - y).abs().max()):.3e})")
        emit("chain_f32_bit_equal", batch=n, plan=list(f32_sep_plan(n, 14, 14, 512, 512, 1)),
             ms=cuda_ms(lambda: chain(*args)), bit_equal_to_separable_block=True)
        del args, got, y
    torch.cuda.empty_cache()


def check_head_smem(gen):
    """The bf16 head kernels' shared memory (the C entry head_smem_bytes)
    against ops/head.head_smem_bytes, at every form's conv_last width and
    the eager ring's (576, 1024, 1600); and the bf16 conv_last walk on the
    eager ring (fewer slots than C's 64-channel chunks: two warpgroups at C
    576 batch 64, one at C 1024 batch 1) against its plain version."""
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.head import (
        fused_head, fused_head_plain, head_plan, head_smem_bytes,
    )

    lib = _build.library()
    cases = ([(0, c, nwg, st) for c in (96, 160, 320, 448, 576, 1024, 1600) for nwg in (1, 2)
              for st in (2, 10)] + [(1, 0, 0, st) for st in (2, 8)])
    for case in cases:
        if lib.head_smem_bytes(*case) != head_smem_bytes(*case):
            raise AssertionError(f"head kernels {case}: the C side plans "
                                 f"{lib.head_smem_bytes(*case)} B of shared memory, "
                                 f"head_smem_bytes {head_smem_bytes(*case)}")
    eager = []
    for n, c in ((64, 576), (1, 1024)):
        cp = head_plan(n, c, 256, (128,)).conv
        if not cp.eager:
            raise AssertionError(f"head plan at C {c} batch {n}: {cp} is not eager")
        x, conv, post = rand_head(gen, n, 7, c, (256, "relu6"), [(128, "linear")], torch.bfloat16)
        got, ref = fused_head(x, conv, post), fused_head_plain(x, conv, post)
        torch.cuda.synchronize()
        err = compare(f"fused_head eager ring C {c} batch {n}", got, ref, BF16_ATOL, BF16_RTOL)
        eager.append({"n": n, "c": c, "nwg": cp.nwg, "stages": cp.stages, "max_abs_err": err})
    emit("head_smem", cases=[list(c) + [head_smem_bytes(*c)] for c in cases], eager=eager)


SEPARABLE_LIBRARY = ("F.conv2d(groups=C, channels-last, TF-SAME) + bias, clamp_, "
                     "torch.matmul, add_, clamp_")


def rand_head(gen, n, hw, c, conv, posts, dtype):
    """(x, conv, post) head operands on the card: x in [0, 6) (a ReLU6
    activation); conv = (e, act) or None; posts = [(width, act), ...]."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def layer(k, m, act):
        return (r(k, m, scale=k ** -0.5), r(m, scale=0.1), act)

    x = (torch.rand(n, hw, hw, c, generator=gen, device="cuda") * 6).to(dtype)
    k, post = c, []
    conv_layer = None
    if conv is not None:
        conv_layer = layer(c, conv[0], conv[1])
        k = conv[0]
    for m, act in posts:
        post.append(layer(k, m, act))
        k = m
    return x, conv_layer, post


def rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def check_routes(pipe, forward, cfg32, f32_atol, f32_rtol, anchored=False, params=None,
                 route="auto"):
    """The bf16 pipeline's kernel route (`route`) against its plain route at
    batch 256 and 1 (the routing gate, with anchored=True the V2 form above;
    a top-1 flip only between near-tied classes), then a float32 pipeline of
    `cfg32` (the same weights: `params`, the host tree `pipe` was built on,
    or the seeded set) at batch 2 within f32_atol/rtol."""
    from mobilenet_tpu_torch import InferencePipeline
    from mobilenet_tpu_torch.ops.preprocess import preprocess

    cfg = pipe.config
    pipe32 = InferencePipeline(cfg32, params, device="cuda")
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x = preprocess(imgs, RES, torch.bfloat16)
            got = forward(pipe.params, x, cfg, dw_backend=route).float()
            ref = forward(pipe.params, x, cfg, dw_backend="plain").float()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            atol = max(ROUTE_ATOL, ROUTE_REL * scale)
            anchor = {}
            if anchored:
                ev = ROUTE_EV_FACTOR * rms(got - ref) * float(np.sqrt(2 * np.log(got.numel())))
                atol = max(atol, ev)
                ora = forward(pipe32.params, preprocess(imgs, RES, torch.float32), cfg32,
                              dw_backend="plain")
                anchor = {"rms_kernel_vs_f32": rms(got - ora), "rms_plain_vs_f32": rms(ref - ora)}
                limit = ROUTE_ANCHOR * anchor["rms_plain_vs_f32"] + ROUTE_ATOL
                if anchor["rms_kernel_vs_f32"] > limit:
                    raise AssertionError(f"{cfg.variant_name()} bf16 batch {batch}: kernel "
                                         f"route {anchor['rms_kernel_vs_f32']:.4f} RMS from the "
                                         f"float32 route, above {limit:.4f}")
            err = compare(f"{cfg.variant_name()} bf16 batch {batch}", got, ref, atol, 0.0)
            top_k, top_p = got.argmax(-1), ref.argmax(-1)
            flips = (top_k != top_p).nonzero().flatten().tolist()
            for i in flips:  # a flip is allowed only between near-tied classes
                gap = float(ref[i, top_p[i]] - ref[i, top_k[i]])
                if gap > atol:
                    raise AssertionError(f"batch {batch} row {i}: top-1 {int(top_k[i])} "
                                         f"vs plain {int(top_p[i])}, gap {gap:.3e}")
            emit("pipeline", model=cfg.variant_name(), route=route, dtype="bfloat16",
                 batch=batch, max_abs_err=err, atol=atol, logits_absmax=scale,
                 top1_agree=batch - len(flips), rows=batch, **anchor)
        x32 = torch.from_numpy(
            rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)).cuda()
        got = forward(pipe32.params, x32, cfg32, dw_backend=route)
        ref = forward(pipe32.params, x32, cfg32, dw_backend="plain")
        err = compare(f"{cfg32.variant_name()} f32 batch 2", got, ref, f32_atol, f32_rtol)
        if not torch.equal(got.argmax(-1), ref.argmax(-1)):
            raise AssertionError("pipeline f32: top-1 differs from the plain route")
        emit("pipeline", model=cfg32.variant_name(), route=route, dtype="float32", batch=2,
             max_abs_err=err, atol=f32_atol, rtol=f32_rtol, top1_agree=2, rows=2)
        del pipe32
    torch.cuda.empty_cache()


def v2_block_shapes(cfg, batch):
    """(name, N, H, t, Cin, Cout, stride, count) of each distinct V2 block
    shape, `count` = how many blocks of one forward have it."""
    shapes, hw = {}, cfg.resolution // 2
    for i, (t, cin, cout, stride) in enumerate(cfg.block_defs):
        key = (hw, t, cin, cout, stride)
        if key in shapes:
            shapes[key][1] += 1
        else:
            shapes[key] = [f"b{i:02d}", 1]
        hw //= stride
    return [(nm, batch, h, t, ci, co, s, cnt)
            for (h, t, ci, co, s), (nm, cnt) in shapes.items()]


def rand_ir(gen, n, h, cin, e, cout, dtype):
    """Inverted-residual operands on the card: x in [-1, 1) (a block input
    after a linear projection), weights scaled so that part of each ReLU6
    clips."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()

    x = (torch.rand(n, h, h, cin, generator=gen, device="cuda") * 2 - 1).to(dtype).contiguous()
    return (x, r(cin, e, scale=2.0 / cin ** 0.5), r(e, scale=0.5), r(3, 3, 1, e, scale=0.5),
            r(e, scale=0.3), r(e, cout, scale=1.0 / e ** 0.5), r(cout, scale=0.2))


def batch1_latency(pipes, rounds=4, iters=15):
    """Batch-1 latency of each (name, pipeline), alternating in rounds
    (a, b, b, a, ...): host clock around run_batch of one uint8 image, host
    to host, and CUDA-event ms of the device-resident forward."""
    frame = np.random.default_rng(2).integers(0, 256, (1, RES, RES, 3), np.uint8)
    dev = torch.from_numpy(frame).cuda()
    host, device = {n: [] for n, _ in pipes}, {n: [] for n, _ in pipes}
    for _, p in pipes:
        p.run_batch(frame)
    for rnd in range(rounds):
        for name, p in (pipes if rnd % 2 == 0 else pipes[::-1]):
            for _ in range(iters):
                t = time.perf_counter()
                p.run_batch(frame)
                host[name].append(time.perf_counter() - t)
            entry = p._entry("probs_u8")
            with torch.inference_mode():
                device[name].append(cuda_ms(lambda: entry(dev), reps=iters))
    return {name: {"p50_ms": float(np.percentile(host[name], 50) * 1e3),
                   "p99_ms": float(np.percentile(host[name], 99) * 1e3),
                   "device_ms": float(np.median(device[name]))} for name, _ in pipes}


def v2_phases(smi, gen, kernels, launches):
    """Phases 10-13. Fills launches["inverted_residual"],
    launches["separable_block[linear]"] and launches["fused_head[conv_last]"]
    from the V2 server; returns the three rows' summaries."""
    from mobilenet_tpu_torch import InferencePipeline, V2Config
    from mobilenet_tpu_torch.models import mobilenet_v2
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.block_times import HEAD_FORMS, head_library, v3_library
    from mobilenet_tpu_torch.ops.head import fused_head, fused_head_plain
    from mobilenet_tpu_torch.ops.inverted_residual import (
        inverted_residual, inverted_residual_plain,
    )
    from mobilenet_tpu_torch.ops.separable_block import separable_block, separable_block_plain
    from mobilenet_tpu_torch.ops.v3_block import (
        v3_plan, v3_smem_bytes, v3_wgmma_plan, v3_wgmma_smem_bytes,
    )

    cfg = V2Config(ALPHA, RES, compute_dtype="bfloat16")
    summary = {
        "inverted_residual": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_wgmma.cuh",
            "design": V3_DESIGN + ["mobilenet_tpu_torch/csrc/v3_block.cu"],
            "float32_source": "mobilenet_tpu_torch/csrc/v3_block.cu",
            "float32_design": V3_F32_DESIGN,
            "replaces": "mobilenet_tpu/ops/pallas_ir_block.py:364",
            "also_replaces": ["mobilenet_tpu/ops/pallas_expand_s2.py:238"]},
        "separable_block[linear]": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/separable_block.cu",
            "float32_design": SEP_F32_DESIGN,
            "replaces": "mobilenet_tpu/ops/pallas_block_packed.py:132"},
        "fused_head[conv_last]": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/fused_head.cu",
            "design": HEAD_DESIGN, "float32_design": HEAD_F32_DESIGN,
            "replaces": "mobilenet_tpu/ops/pallas_head.py:168"},
    }
    for s in summary.values():
        s.update(FLOAT_ROW)
    summary["separable_block[linear]"].update(library_ms=0.0, library=SEPARABLE_LIBRARY)
    summary["fused_head[conv_last]"].update(library_ms=0.0, library=HEAD_LIBRARY)
    summary["inverted_residual"].update(library_ms=0.0, library=V3_LIBRARY)

    def ir_library(*a):  # the unfused sequence of one V2 block (relu6, k 3, no SE)
        return v3_library(*a[:7], k=3, stride=a[7], act="relu6", residual=a[8])

    # -- 10. V2 kernels vs plain ------------------------------------------------
    lib = _build.library()
    plans = {}
    for nm, n, h, t, cin, cout, stride, cnt in v2_block_shapes(cfg, 256):
        name = f"{nm} ({n},{h},{h},{cin})->{cout} t{t} s{stride}"
        if t == 1:
            mk = lambda dt: rand_block(gen, n, h, cin, cout, dt) + (stride, True)  # noqa: E731
            check_float(summary, "separable_block[linear]", name, cnt,
                        lambda *a: separable_block(*a, pw_act=False),
                        lambda *a: separable_block_plain(*a, pw_act=False),
                        mk(torch.float32), mk(torch.bfloat16),
                        lambda kind: block_work(n, h, cin, cout, stride, kind),
                        lambda *a: separable_library(*a, pw_act=False))
        else:
            e, res = t * cin, stride == 1 and cin == cout
            for b in (256, 1):
                p = plans[f"{nm} batch {b} bf16"] = v3_wgmma_plan(b, h, h, cin, e, cout, 3,
                                                                  stride, 0, False)
                args = (p.th, p.tw, cin, e, cout, 3, stride, p.cw, p.ws, p.bs, 0)
                if lib.v3_wgmma_smem_bytes(*args) != v3_wgmma_smem_bytes(*args):
                    raise AssertionError(f"{name}: the bf16 tile plans another shared memory "
                                         "than v3_wgmma_smem_bytes")
            for b in (256, 1):
                fp = plans[f"{nm} batch {b} f32"] = v3_plan(b, h, h, cin, e, cout, 3, stride, 0)
                args = (fp.th, fp.tw, h, h, cin, e, cout, 0, 3, stride, fp.ws, fp.bs, 0)
                if lib.v3_f32_smem_bytes(*args) != v3_smem_bytes(*args):
                    raise AssertionError(f"{name}: the float32 tile plans "
                                         f"{lib.v3_f32_smem_bytes(*args)} B of shared memory, "
                                         "v3_smem_bytes another")
            mk = lambda dt, b=256: rand_ir(gen, b, h, cin, e, cout, dt) + (stride, res)  # noqa: E731
            check_float(summary, "inverted_residual", name, cnt, inverted_residual,
                        inverted_residual_plain, mk(torch.float32), mk(torch.bfloat16),
                        lambda kind: ir_work(n, h, cin, e, cout, stride, kind), ir_library)
            a1 = mk(torch.bfloat16, 1)
            got, ref = inverted_residual(*a1), inverted_residual_plain(*a1)
            torch.cuda.synchronize()
            err = compare(f"inverted_residual {name} batch 1 bf16", got, ref, BF16_ATOL,
                          BF16_RTOL)
            summary["inverted_residual"]["max_abs_err"] = max(
                summary["inverted_residual"]["max_abs_err"], err)
            emit("kernel_b1", kernel="inverted_residual", shape=name.replace(f"({n},", "(1,"),
                 max_abs_err=err, atol=BF16_ATOL, rtol=BF16_RTOL)
            del a1, got, ref
        torch.cuda.empty_cache()
    emit("ir_plans", plans=plans)
    hw = cfg.final_spatial
    # V2's form (conv_last 320 -> 1280 relu6, fc), then V3-Large's (conv_last
    # 160 -> 960 hswish, head 960 -> 1280 hswish, fc) and V3-Small's (96 ->
    # 576 hswish, 576 -> 1024 hswish, fc), which the V3 float routes launch
    # (phases 18-25): each at batch 256 and 1; V2's batch-256 call is the
    # row's per-forward time
    for form in ("v2", "v3l", "v3s"):
        fc, conv, posts = HEAD_FORMS[form]
        per_forward = int(form == "v2")
        for n in (256, 1):
            mk = lambda dt: rand_head(gen, n, hw, fc, conv, posts, dt)  # noqa: E731
            check_float(summary, "fused_head[conv_last]",
                        f"({n},{hw},{hw},{fc}) conv_last {conv[0]} {conv[1]} -> "
                        + " -> ".join(f"{m} {a}" for m, a in posts),
                        per_forward * int(n == 256), fused_head, fused_head_plain,
                        mk(torch.float32), mk(torch.bfloat16),
                        lambda kind: head_work(n, hw, fc, conv[0], [m for m, _ in posts], kind),
                        head_library)

    # -- 11. V2 pipeline: kernel route vs plain route -----------------------------
    pipe = InferencePipeline(cfg, device="cuda")
    check_routes(pipe, mobilenet_v2.forward_v2, V2Config(ALPHA, RES, compute_dtype="float32"),
                 V2_F32_ATOL, V2_F32_RTOL, anchored=True)

    # -- 12. V2 benchmark; batch-1 "mixed" vs "auto" ------------------------------
    emit("benchmark", model=cfg.variant_name(), route="auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = InferencePipeline(cfg, device="cuda", dw_backend="plain")
    emit("benchmark", model=cfg.variant_name(), route="plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=5, latency_iters=10))
    del plain
    torch.cuda.empty_cache()
    mixed = InferencePipeline(cfg, device="cuda", dw_backend="mixed")
    emit("latency_b1", model=cfg.variant_name(), nvidia_smi=smi,
         **batch1_latency([("auto", pipe), ("mixed", mixed)]))
    del mixed

    # -- 13. the V2 float main path: 64-stream server -------------------------------
    got = serve_main_path(pipe, kernels, ("inverted_residual", "fused_head", "separable_block"),
                          "serving_v2", smi)
    launches["inverted_residual"] = got["inverted_residual"]
    launches["fused_head[conv_last]"] = got["fused_head"]
    launches["separable_block[linear]"] = got["separable_block"]
    del pipe
    torch.cuda.empty_cache()
    return summary


def int8_ir_args(rng, n, h, cin, e, cout, prj_gain=1.0):
    """Random int8 inverted-residual operands on the card: x over the whole
    int8 range (a bottleneck activation), int8 weights, int32 biases,
    float32 multipliers that spread each requant over its range (prj_gain >
    1 drives the projection into saturation); six_q 127 (the fixed 6/127
    hidden scale)."""
    def t(a):
        return torch.from_numpy(a).cuda()

    def layer(shape, c, m_scale):
        return (t(rng.integers(-127, 128, shape).astype(np.int8)),
                t(rng.integers(-5000, 5000, (c,)).astype(np.int32)),
                t((rng.uniform(0.2, 1.5, (c,)) * m_scale).astype(np.float32)))

    x = t(rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8))
    return (x, *layer((cin, e), e, 0.0113 / cin ** 0.5), 127.0,
            *layer((3, 3, 1, e), e, 0.0055), 127.0,
            *layer((e, cout), cout, prj_gain * 0.0137 / e ** 0.5))


def v2_int8_phases(smi, kernels, launches):
    """Phases 14-17. Fills launches["inverted_residual_i8"] and
    launches["separable_block_i8[linear]"] from the V2 int8 server; returns
    the two rows' summaries."""
    from mobilenet_tpu_torch import Int8PipelineV2, V2Config
    from mobilenet_tpu_torch.checkpoints import fold_bn_v2, init_params_v2
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.inverted_residual_i8 import (
        inverted_residual_i8, inverted_residual_i8_plain,
    )
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.separable_block_i8 import (
        separable_block_i8, separable_block_i8_plain,
    )
    from mobilenet_tpu_torch.ops.v3_block_i8 import (
        FULL, kernel_weights, v3_i8_wgmma_plan, v3_i8_wgmma_smem_bytes,
    )
    from mobilenet_tpu_torch.quant import ACT_IN_SCALE
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant.v2 import forward_v2_i8, quantize_v2
    from mobilenet_tpu_torch.quant.verify import verify_int8_v2

    cfg = V2Config(ALPHA, RES)
    summary = {
        "inverted_residual_i8": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_i8_wgmma.cuh",
            "design": V3_I8_DESIGN + ["mobilenet_tpu_torch/csrc/v3_block_i8.cu"],
            "replaces": "mobilenet_tpu/quant/pallas_ir_i8.py:237",
            "also_replaces": ["mobilenet_tpu/quant/pallas_expand_s2_i8.py:163",
                              "mobilenet_tpu/quant/pallas_ir_v3_i8.py:290 (V2 bridge form)"]},
        "separable_block_i8[linear]": {
            "route": "cuda", "source": "mobilenet_tpu_torch/csrc/separable_block_i8.cu",
            "design": I8_BLOCK_DESIGN,
            "replaces": "mobilenet_tpu/quant/pallas_block_packed_i8.py:222 (pw_linear=True)"},
    }
    for s in summary.values():
        s.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                 ops_ms=0.0, library_ms=LIBRARY_MS)
    linear = (lambda *a: separable_block_i8(*a, pw_linear=True),
              lambda *a: separable_block_i8_plain(*a, pw_linear=True))

    def ir_i8(*a):  # with the kernel's weight forms, as the V2 route passes them (made once)
        return inverted_residual_i8(*a, wt=forms)

    # -- 14. V2 int8 kernels vs plain, exact, at batch 256 and 1 -------------------
    lib = _build.library()
    rng = np.random.default_rng(4)
    plans = {}
    for nm, n, h, t, cin, cout, stride, cnt in v2_block_shapes(cfg, 256):
        if t == 1:
            name = f"{nm} ({n},{h},{h},{cin})->{cout} t{t} s{stride}"
            args = int8_block_args(rng, n, h, cin, cout) + (stride, 127.0, 0.0, True)
            ref = check_i8(summary, "separable_block_i8[linear]", name, cnt, *linear, args,
                           block_work(n, h, cin, cout, stride, "int8"), smi)
            if not (ref < 0).any():
                raise AssertionError(f"{name}: the linear mode gave no negative output")
            del args, ref
            continue
        e, res = t * cin, stride == 1 and cin == cout
        for b in (256, 1):
            name = f"{nm} ({b},{h},{h},{cin})->{cout} t{t} s{stride}"
            p = v3_i8_wgmma_plan(b, h, h, cin, e, cout, 3, stride, 0, False)
            plans[f"{nm} batch {b}"] = p._asdict()
            pargs = (p.th, p.tw, cin, e, cout, 3, stride, p.cw, p.ws, p.bs, False, FULL)
            c_bytes = lib.v3_i8_wgmma_smem_bytes(*pargs)
            if c_bytes != v3_i8_wgmma_smem_bytes(*pargs):
                raise AssertionError(f"{name}: the int8 tile plans {c_bytes} B of shared "
                                     "memory, v3_i8_wgmma_smem_bytes another")
            args = int8_ir_args(rng, b, h, cin, e, cout) + (stride, res)
            forms = kernel_weights({"w": args[1]}, {"w": args[5]}, {"w": args[9]})
            ref = check_i8(summary, "inverted_residual_i8", name, cnt if b == 256 else 0,
                           ir_i8, inverted_residual_i8_plain, args,
                           ir_work(b, h, cin, e, cout, stride, "int8"), smi)
            if not ((ref < 0).any() and (ref > 0).any()):
                raise AssertionError(f"{name}: a one-signed int8 output")
            del args, ref
        torch.cuda.empty_cache()
    emit("v2_i8_plans", plans=plans)
    # saturation: inputs at the rails, the projection driven past the int8 range
    args = list(int8_ir_args(rng, 256, 56, 24, 144, 24, prj_gain=8.0)) + [1, True]
    args[0] = torch.where(torch.rand(args[0].shape, device=args[0].device) < 0.5, 120,
                          -120).to(torch.int8)
    forms = kernel_weights({"w": args[1]}, {"w": args[5]}, {"w": args[9]})
    ref = check_i8(summary, "inverted_residual_i8", "saturation (256,56,56,24)->24 t6 s1 res",
                   0, ir_i8, inverted_residual_i8_plain, args,
                   ir_work(256, 56, 24, 144, 24, 1, "int8"), smi)
    if not ((ref == 127).any() and (ref == -128).any()):
        raise AssertionError("saturation case: the output did not reach both int8 rails")
    # the ReLU6 bound below 127 (a recalibrated six_q): the expansion's and the
    # depthwise's requants clip at 100 where 127 would not
    args = list(int8_ir_args(rng, 256, 28, 32, 192, 32)) + [1, True]
    args[4] = args[8] = 100.37
    forms = kernel_weights({"w": args[1]}, {"w": args[5]}, {"w": args[9]})
    ref = check_i8(summary, "inverted_residual_i8", "relu6 six_q 100.37 (256,28,28,32)->32 t6 "
                   "s1 res", 0, ir_i8, inverted_residual_i8_plain, args,
                   ir_work(256, 28, 32, 192, 32, 1, "int8"), smi)
    z = qops.pointwise_i8(args[0], *args[1:5])
    if int(z.max()) != 100:
        raise AssertionError(f"six_q 100.37: the expansion's maximum is {int(z.max())}, not 100")
    del args, ref, z, forms
    torch.cuda.empty_cache()

    # -- 15. V2 int8 routes on one calibrated tree; the per-layer gate -------------
    folded = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
    t0 = time.perf_counter()
    q = quantize_v2(folded, cfg)
    emit("calibration", model=cfg.variant_name(), n_images=32,
         seconds=time.perf_counter() - t0)
    pipe = Int8PipelineV2(cfg, device="cuda", quantized=q)
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x_q = qops.quantize_input_dev(preprocess(imgs, RES), ACT_IN_SCALE)
            got = forward_v2_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            ref = forward_v2_i8(pipe.dev, x_q, cfg, dw_backend="plain")
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"V2 int8 pipeline batch {batch}: kernel route logits "
                                     "differ from the plain route")
            if not torch.isfinite(got).all() or got.shape != (batch, cfg.num_classes):
                raise AssertionError(f"V2 int8 pipeline batch {batch}: bad logits")
            emit("pipeline", model=cfg.variant_name(), dtype="int8", batch=batch,
                 max_abs_err=0.0, tolerance=0, top1_agree=batch, rows=batch,
                 logits_absmax=float(ref.abs().max()))
    del imgs, x_q, got, ref
    x = rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ok = verify_int8_v2(cfg, fold_bn_v2(init_params_v2(cfg, seed=1), eps=cfg.bn_eps), x,
                        n_calib=8, device="cuda")
    emit("verify_int8_v2", model=cfg.variant_name(), batch=2, n_calib=8, exact=ok)
    if not ok:
        raise AssertionError("verify_int8_v2 at 1.0-224: a layer differs from the oracle")
    torch.cuda.empty_cache()

    # -- 16. V2 int8 benchmark ----------------------------------------------------
    emit("benchmark", model=cfg.variant_name(), route="int8 auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = Int8PipelineV2(cfg, device="cuda", quantized=q, dw_backend="plain")
    emit("benchmark", model=cfg.variant_name(), route="int8 plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=5, latency_iters=10))
    del plain
    torch.cuda.empty_cache()

    # -- 17. the V2 int8 main path: 64-stream server --------------------------------
    # (the MicroBatchServer that build_server(V2Config, int8=True) builds, over
    # the pipeline of the tree calibrated above)
    got = serve_main_path(pipe, kernels, ("inverted_residual_i8", "separable_block_i8"),
                          "serving_v2_int8", smi)
    launches["inverted_residual_i8"] = got["inverted_residual_i8"]
    launches["separable_block_i8[linear]"] = got["separable_block_i8"]
    del pipe
    torch.cuda.empty_cache()
    return summary


def v3_block_shapes(cfg, batch):
    """(name, N, H, block def, count) of each distinct V3 block shape,
    `count` = how many blocks of one forward have it."""
    shapes, hw = {}, cfg.resolution // 2
    for i, bd in enumerate(cfg.block_defs):
        key = (hw, bd)
        if key in shapes:
            shapes[key][1] += 1
        else:
            shapes[key] = [f"b{i:02d}", 1]
        hw //= bd.stride
    return [(nm, batch, h, bd, cnt) for (h, bd), (nm, cnt) in shapes.items()]


def rand_v3(gen, n, h, bd, dtype):
    """V3 bottleneck operands on the card, (x, exp_w, exp_b, dw_w, dw_b,
    prj_w, prj_b, se_w1, se_b1, se_w2, se_b2), None where the block has no
    such layer: x in [-2, 2) (a bottleneck activation), weights scaled so
    that the activations stay O(1), SE biases non-zero (the seeded set has
    none)."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()

    e, k, se = bd.cexp, bd.kernel, bd.se_mid
    x = ((torch.rand(n, h, h, bd.cin, generator=gen, device="cuda") * 4 - 2).to(dtype)
         .contiguous())
    exp = ((r(bd.cin, e, scale=1.5 / bd.cin ** 0.5), r(e, scale=0.3)) if bd.has_expand
           else (None, None))
    ses = ((r(e, se, scale=e ** -0.5), r(se, scale=0.3), r(se, e, scale=se ** -0.5),
            r(e, scale=0.3)) if se else (None,) * 4)
    return (x, *exp, r(k, k, 1, e, scale=0.3), r(e, scale=0.2),
            r(e, bd.cout, scale=e ** -0.5), r(bd.cout, scale=0.2), *ses)


def v3_folded(cfg, seed):
    """The seeded folded V3 tree with its zero biases (SE b1/b2, head, fc)
    drawn non-zero, so that the routes and the gate exercise them."""
    from mobilenet_tpu_torch.checkpoints import fold_bn_v3, init_params_v3

    tree = fold_bn_v3(init_params_v3(cfg, seed=seed), eps=cfg.bn_eps)
    rng = np.random.default_rng(seed + 100)

    def bias(a, scale):
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    for blk in tree["blocks"]:
        for name in ("b1", "b2") if "se" in blk else ():
            blk["se"][name] = bias(blk["se"][name], 0.3)
    tree["head"]["b"] = bias(tree["head"]["b"], 0.1)
    tree["fc"]["b"] = bias(tree["fc"]["b"], 0.1)
    return tree


def v3_kernel_checks(summary, row, cfg, gen):
    """The V3 kernel against its plain version at each distinct block shape
    of `cfg` at batch 256 (float32 then bfloat16, `check_float`, with the
    library sequence `v3_library` timed beside it; non-zero SE biases) and,
    bfloat16 only, at batch 1, adding to `summary[row]`; the plans (bf16
    `v3_wgmma_plan`, float32 `v3_plan`, each at batch 256 and 1) and each
    tile's shared memory against its Python mirror."""
    from mobilenet_tpu_torch.block_times import v3_library
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.v3_block import (
        v3_block, v3_block_plain, v3_plan, v3_smem_bytes, v3_wgmma_plan, v3_wgmma_smem_bytes,
    )

    lib = _build.library()
    plans = {}
    for nm, n, h, bd, cnt in v3_block_shapes(cfg, 256):
        name = (f"{nm} ({n},{h},{h},{bd.cin})->{bd.cout} E{bd.cexp} k{bd.kernel} "
                f"s{bd.stride} se{bd.se_mid} {bd.act}{' res' if bd.has_res else ''}"
                f"{'' if bd.has_expand else ' identity'}")
        identity = not bd.has_expand
        for b in (256, 1):
            p = plans[f"{nm} batch {b} bf16"] = v3_wgmma_plan(
                b, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid, identity)
            args = (p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, p.cw, p.ws, p.bs,
                    int(identity))
            if lib.v3_wgmma_smem_bytes(*args) != v3_wgmma_smem_bytes(*args):
                raise AssertionError(f"{name}: the bf16 tile plans another shared memory "
                                     "than v3_wgmma_smem_bytes")
        for b in (256, 1):
            fp = plans[f"{nm} batch {b} f32"] = v3_plan(
                b, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, bd.se_mid, identity)
            args = (fp.th, fp.tw, h, h, bd.cin, bd.cexp, bd.cout, bd.se_mid, bd.kernel,
                    bd.stride, fp.ws, fp.bs, int(identity))
            if lib.v3_f32_smem_bytes(*args) != v3_smem_bytes(*args):
                raise AssertionError(f"{name}: the float32 tile plans another shared memory "
                                     "than v3_smem_bytes")
        kw = dict(k=bd.kernel, stride=bd.stride, act=bd.act, residual=bd.has_res)

        def call(fn, kw=kw):
            return lambda *a: fn(*a[:7], se_w1=a[7], se_b1=a[8], se_w2=a[9], se_b2=a[10], **kw)

        check_float(summary, row, name, cnt, call(v3_block), call(v3_block_plain),
                    rand_v3(gen, n, h, bd, torch.float32), rand_v3(gen, n, h, bd, torch.bfloat16),
                    lambda kind: ir_work(n, h, bd.cin, bd.cexp, bd.cout, bd.stride, kind,
                                         k=bd.kernel, se=bd.se_mid, identity=identity),
                    call(v3_library))
        a1 = rand_v3(gen, 1, h, bd, torch.bfloat16)
        got, ref = call(v3_block)(*a1), call(v3_block_plain)(*a1)
        torch.cuda.synchronize()
        err = compare(f"{row} {name} batch 1 bf16", got, ref, BF16_ATOL, BF16_RTOL)
        summary[row]["max_abs_err"] = max(summary[row]["max_abs_err"], err)
        emit("kernel_b1", kernel=row, shape=name.replace(f"({n},", "(1,"), max_abs_err=err,
             atol=BF16_ATOL, rtol=BF16_RTOL)
        del a1, got, ref
        torch.cuda.empty_cache()
    emit("v3_plans", model=cfg.variant_name(), plans={k: list(v) for k, v in plans.items()})


V3_ROWS = {
    "large": ("v3_block", "mobilenet_tpu/ops/pallas_ir_v3.py:414",
              ["V3-L b00 (JAX: mobilenet_tpu/ops/pallas_block_packed.py:132)",
               "V3-L b01 (JAX: mobilenet_tpu/ops/pallas_expand_s2.py:238)"]),
    "small": ("v3_block[v3small]", "mobilenet_tpu/ops/pallas_se_packed.py:175",
              ["V3-S b02, b04-b07 (JAX: the row's TPU kernel)",
               "V3-S b01 (JAX: mobilenet_tpu/ops/pallas_expand_s2.py:238)",
               "V3-S b03, b08-b10 (JAX: mobilenet_tpu/ops/pallas_ir_v3.py:414)",
               "V3-S b00 (JAX: XLA ops)"]),
}


def v3_phases(smi, gen, kernels, launches, variant="large"):
    """Phases 18-21 (V3-Large) or 22-25 (V3-Small). Fills the row's
    launches from the V3 server; returns the kernel's summary row."""
    from mobilenet_tpu_torch import InferencePipeline, V3Config
    from mobilenet_tpu_torch.models import mobilenet_v3
    from mobilenet_tpu_torch.runtime.eval import verify_layers

    cfg = V3Config(variant, ALPHA, RES, compute_dtype="bfloat16")
    row, replaces, also = V3_ROWS[variant]
    kernels["v3_chain"].launches = 0  # the default routes must launch none (checked below)
    summary = {row: {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_block.cu",
                     "design": V3_DESIGN, "float32_design": V3_F32_DESIGN,
                     "replaces": replaces, "also_runs": also}}
    summary[row].update(FLOAT_ROW)
    summary[row].update(library_ms=0.0, library=V3_LIBRARY)

    # -- 18 / 22. the V3 kernel vs plain -------------------------------------------
    v3_kernel_checks(summary, row, cfg, gen)

    # -- 19 / 23. V3 pipeline: kernel route vs plain route; the per-layer gate ---------
    tree = v3_folded(cfg, 0)
    pipe = InferencePipeline(cfg, tree, device="cuda")
    check_routes(pipe, mobilenet_v3.forward_v3, V3Config(variant, ALPHA, RES), V3_F32_ATOL,
                 V3_F32_RTOL, anchored=True, params=tree)
    x = np.random.default_rng(5).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ok = verify_layers(cfg, v3_folded(cfg, 1), x, device="cuda")
    emit("verify_layers", model=cfg.variant_name(), batch=2, tolerance=[V3_F32_ATOL, V3_F32_RTOL],
         ok=ok)
    if not ok:
        raise AssertionError(f"verify_layers at {cfg.variant_name()}: a tap is outside the V3 gate")
    torch.cuda.empty_cache()

    # -- 20 / 24. V3 benchmark; batch-1 "mixed" vs "auto" --------------------------------
    emit("benchmark", model=cfg.variant_name(), route="auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = InferencePipeline(cfg, tree, device="cuda", dw_backend="plain")
    emit("benchmark", model=cfg.variant_name(), route="plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=5, latency_iters=10))
    del plain
    torch.cuda.empty_cache()
    mixed = InferencePipeline(cfg, tree, device="cuda", dw_backend="mixed")
    emit("latency_b1", model=cfg.variant_name(), nvidia_smi=smi,
         **batch1_latency([("auto", pipe), ("mixed", mixed)]))
    del mixed

    # -- 21 / 25. the V3 float main path: 64-stream server -------------------------------
    if kernels["v3_chain"].launches:
        raise AssertionError(f"{cfg.variant_name()}: the default routes launched v3_chain")
    got = serve_main_path(pipe, kernels, ("v3_block", "fused_head"),
                          "serving_v3" if variant == "large" else "serving_v3small", smi)
    if kernels["v3_chain"].launches:  # serve_main_path set every count to 0 first
        raise AssertionError(f"{cfg.variant_name()}: the default server launched v3_chain")
    launches[row] = got["v3_block"]
    del pipe
    torch.cuda.empty_cache()
    return summary


def v3_int8_layers(rng, cin, e, cout, k, se, identity, prj_gain=1.0):
    """(exp, dw, prj, se1, se2) of one int8 V3 block on the card, quantized
    from random float weights by quant/v3's _quant_named at fixed scales
    (input 0.05, expansion and depthwise 0.06, SE mid 0.03, the projection
    back at the input's scale / prj_gain): non-zero biases everywhere, the
    SE's included; exp None for the identity, the SE pair None without SE. The
    layers hold the kernel's weight forms, made once as at upload."""
    from mobilenet_tpu_torch.ops.v3_block_i8 import v3_i8_kernel_weights
    from mobilenet_tpu_torch.quant.v3 import _quant_named, device_layer_v3

    def lay(shape, axis, s_in, s_out, scale, b_scale, **kw):
        w = rng.normal(0, scale, shape).astype(np.float32)
        b = rng.normal(0, b_scale, (shape[axis],)).astype(np.float32)
        return device_layer_v3(_quant_named(w, b, axis, s_in, s_out, **kw), "cuda")

    s_x, s_e, s_d, s_g = 0.05, 0.06, 0.06, 0.03
    exp = None if identity else lay((cin, e), 1, s_x, s_e, 1.5 * cin ** -0.5, 0.3)
    dw = lay((k, k, 1, e), 3, s_x if identity else s_e, s_d, 0.3, 0.2, k_taps=k * k)
    se1 = lay((e, se), 1, s_d, s_g, e ** -0.5, 0.3) if se else None
    se2 = lay((se, e), 1, s_g, 1.0, se ** -0.5, 0.3) if se else None
    prj = lay((e, cout), 1, s_d, s_x / prj_gain, e ** -0.5, 0.2)
    v3_i8_kernel_weights({"dw": dw, "prj": prj, **({} if identity else {"exp": exp})})
    return exp, dw, prj, se1, se2


def v3_i8_kernel_checks(summary, row, cfg, rng, smi):
    """The int8 V3 kernel against its plain version, exactly, at each
    distinct block shape of `cfg` at batch 256 and 1 (random layers with
    non-zero SE biases), adding the batch-256 numbers to `summary[row]`; the
    plans (`v3_i8_wgmma_plan`) and the kernel's shared memory of each pass
    against its Python mirror."""
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.v3_block_i8 import (
        FULL, GATED, POOL, v3_block_i8, v3_block_i8_plain, v3_i8_wgmma_plan,
        v3_i8_wgmma_smem_bytes,
    )

    lib = _build.library()
    plans = {}
    for nm, _, h, bd, cnt in v3_block_shapes(cfg, 256):
        ident = not bd.has_expand
        name = (f"{nm} ({{n}},{h},{h},{bd.cin})->{bd.cout} E{bd.cexp} k{bd.kernel} "
                f"s{bd.stride} se{bd.se_mid} {bd.act}{' res' if bd.has_res else ''}"
                f"{' identity' if ident else ''}")
        layers = v3_int8_layers(rng, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.se_mid, ident)
        kw = dict(k=bd.kernel, stride=bd.stride, act=bd.act, se1=layers[3], se2=layers[4],
                  residual=bd.has_res)
        for n in (256, 1):
            p = v3_i8_wgmma_plan(n, h, h, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride,
                                 bd.se_mid, ident)
            plans[f"{nm} batch {n}"] = p._asdict()
            for mode in ((POOL, GATED) if bd.se_mid else (FULL,)):
                args = (p.th, p.tw, bd.cin, bd.cexp, bd.cout, bd.kernel, bd.stride, p.cw, p.ws,
                        p.bs, ident, mode)
                c_bytes = lib.v3_i8_wgmma_smem_bytes(*args)
                if c_bytes != v3_i8_wgmma_smem_bytes(*args):
                    raise AssertionError(f"{nm} pass {mode}: the int8 V3 kernel plans {c_bytes} "
                                         "B of shared memory, v3_i8_wgmma_smem_bytes another")
            x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, bd.cin)).astype(
                np.int8)).cuda()
            ref = check_i8(summary, row, name.format(n=n), cnt if n == 256 else 0,
                           lambda *a: v3_block_i8(*a, **kw),
                           lambda *a: v3_block_i8_plain(*a, **kw), (x, *layers[:3]),
                           ir_work(n, h, bd.cin, bd.cexp, bd.cout, bd.stride, "int8",
                                   k=bd.kernel, se=bd.se_mid, identity=ident), smi)
            if not ((ref < 0).any() and (ref > 0).any()):
                raise AssertionError(f"{nm} batch {n}: a one-signed int8 output")
            del x, ref
        del layers
        torch.cuda.empty_cache()
    emit("v3_i8_plans", model=cfg.variant_name(), plans=plans)


def v3_int8_phases(smi, kernels, launches):
    """Phases 26-30. Fills launches["v3_block_i8"] from the V3-Large int8
    server; returns the kernel's summary row."""
    from mobilenet_tpu_torch import Int8PipelineV3, V3Config, cli
    from mobilenet_tpu_torch.checkpoints import fold_bn_v3, init_params_v3
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.v3_block_i8 import v3_block_i8, v3_block_i8_plain
    from mobilenet_tpu_torch.quant import ACT_IN_SCALE
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant.v3 import forward_v3_i8, quantize_v3
    from mobilenet_tpu_torch.quant.verify import verify_int8_v3

    cfg = V3Config("large", ALPHA, RES)
    summary = {"v3_block_i8": {
        "route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_block_i8.cu",
        "design": V3_I8_DESIGN, "replaces": "mobilenet_tpu/quant/pallas_ir_v3_i8.py:290",
        "also_replaces": ["mobilenet_tpu/quant/pallas_block_packed_i8.py:436 (V3-L b00)",
                          "mobilenet_tpu/quant/pallas_block_packed_i8.py:632 (V3-L b01)",
                          "mobilenet_tpu/quant/pallas_block_packed_i8.py:821 (V3-S b00, "
                          "row v3_block_i8[v3small])"],
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
        "ops_ms": 0.0, "library_ms": LIBRARY_MS}}

    # -- 26. calibration ------------------------------------------------------------
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    t0 = time.perf_counter()
    q = quantize_v3(folded, cfg)
    emit("calibration", model=cfg.variant_name(), n_images=32,
         seconds=time.perf_counter() - t0)

    # -- 27. the int8 V3 kernel vs plain, exact, at batch 256 and 1 ----------------------
    rng = np.random.default_rng(6)
    v3_i8_kernel_checks(summary, "v3_block_i8", cfg, rng, smi)
    # saturation: inputs at the rails, the projection driven past the int8 range
    layers = v3_int8_layers(rng, 24, 72, 24, 3, 0, False, prj_gain=8.0)
    x = torch.from_numpy(np.where(rng.random((256, 56, 56, 24)) < 0.5, 120, -120).astype(
        np.int8)).cuda()
    kw = dict(k=3, stride=1, act="relu", residual=True)
    ref = check_i8(summary, "v3_block_i8", "saturation (256,56,56,24)->24 E72 k3 s1 res", 0,
                   lambda *a: v3_block_i8(*a, **kw), lambda *a: v3_block_i8_plain(*a, **kw),
                   (x, *layers[:3]), ir_work(256, 56, 24, 72, 24, 1, "int8"), smi)
    if not ((ref == 127).any() and (ref == -128).any()):
        raise AssertionError("saturation case: the output did not reach both int8 rails")
    del layers, x, ref
    torch.cuda.empty_cache()

    # -- 28. V3-L int8 routes on one calibrated tree; the per-layer gate -------------------
    pipe = Int8PipelineV3(cfg, device="cuda", quantized=q)
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x_q = qops.quantize_input_dev(preprocess(imgs, RES), ACT_IN_SCALE)
            got = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            ref = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="plain")
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"V3-L int8 pipeline batch {batch}: kernel route logits "
                                     "differ from the plain route")
            if not torch.isfinite(got).all() or got.shape != (batch, cfg.num_classes):
                raise AssertionError(f"V3-L int8 pipeline batch {batch}: bad logits")
            emit("pipeline", model=cfg.variant_name(), dtype="int8", batch=batch,
                 max_abs_err=0.0, tolerance=0, top1_agree=batch, rows=batch,
                 logits_absmax=float(ref.abs().max()))
    del imgs, x_q, got, ref
    # V3-Large-minimalistic (k 3, relu, no SE): its own calibrated tree
    mini = V3Config("large", ALPHA, RES, minimalistic=True)
    t0 = time.perf_counter()
    q_mini = quantize_v3(fold_bn_v3(init_params_v3(mini, seed=0), eps=mini.bn_eps), mini)
    mini_s = time.perf_counter() - t0
    dev_mini = Int8PipelineV3(mini, device="cuda", quantized=q_mini).dev
    with torch.inference_mode():
        imgs = torch.from_numpy(rng.integers(0, 256, (256, RES, RES, 3), dtype=np.uint8)).cuda()
        x_q = qops.quantize_input_dev(preprocess(imgs, RES), ACT_IN_SCALE)
        got = forward_v3_i8(dev_mini, x_q, mini, dw_backend="auto")
        ref = forward_v3_i8(dev_mini, x_q, mini, dw_backend="plain")
        torch.cuda.synchronize()
    if not torch.equal(got, ref) or got.shape != (256, mini.num_classes):
        raise AssertionError("V3-L-minimalistic int8 batch 256: kernel route logits differ "
                             "from the plain route")
    emit("pipeline", model=mini.variant_name(), dtype="int8", batch=256, max_abs_err=0.0,
         tolerance=0, top1_agree=256, rows=256, logits_absmax=float(ref.abs().max()),
         calibration_s=mini_s)
    del dev_mini, q_mini, imgs, x_q, got, ref
    x = rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ok = verify_int8_v3(cfg, fold_bn_v3(init_params_v3(cfg, seed=1), eps=cfg.bn_eps), x,
                        n_calib=8, device="cuda")
    emit("verify_int8_v3", model=cfg.variant_name(), batch=2, n_calib=8, exact=ok)
    if not ok:
        raise AssertionError("verify_int8_v3 at 1.0-224: a layer differs from the oracle")
    torch.cuda.empty_cache()

    # -- 29. V3-L int8 benchmark; batch-1 fused vs plain ------------------------------------
    emit("benchmark", model=cfg.variant_name(), route="int8 auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = Int8PipelineV3(cfg, device="cuda", quantized=q, dw_backend="plain")
    emit("benchmark", model=cfg.variant_name(), route="int8 plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=5, latency_iters=10))
    emit("latency_b1", model=cfg.variant_name(), dtype="int8", nvidia_smi=smi,
         **batch1_latency([("auto", pipe), ("plain", plain)]))
    del plain
    torch.cuda.empty_cache()

    # -- 30. the V3-L int8 main path: 64-stream server; cli serve --model v3 --int8 ----------
    got = serve_main_path(pipe, kernels, ("v3_block_i8",), "serving_v3_int8", smi)
    launches["v3_block_i8"] = got["v3_block_i8"]
    del pipe
    torch.cuda.empty_cache()
    for k in kernels.values():
        k.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["serve", "--model", "v3", "--int8", "--streams", "64", "--alpha", str(ALPHA),
                  "--res", str(RES)])
    torch.cuda.synchronize()
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    emit("cli_serve_v3_int8", nvidia_smi=smi, launches={"v3_block_i8": v3_block_i8.launches},
         **stats)
    if stats["errors"] != 0 or v3_block_i8.launches <= 0:
        raise AssertionError("cli serve --model v3 --int8: errors, or v3_block_i8 not launched")
    torch.cuda.empty_cache()
    return summary


def dw_shapes(cfg, batch):
    """(name, N, H, C, stride, count) of each distinct depthwise layer shape
    of a V1 config, `count` = how many of one forward's 13 layers have it."""
    shapes = {}
    for nm, n, h, cin, _, stride, cnt in block_shapes(cfg, batch):
        key = (h, cin, stride)
        if key in shapes:
            shapes[key][1] += cnt
        else:
            shapes[key] = [nm, cnt]
    return [(nm, batch, h, c, s, cnt) for (h, c, s), (nm, cnt) in shapes.items()]


VERIFY_RUNS = (
    ("v1 cpp", []), ("v1 numpy", ["--oracle", "numpy"]), ("v1 int8 cpp", ["--int8"]),
    ("v1 int8 numpy", ["--int8", "--oracle", "numpy"]), ("v1 routing dw", ["--routing", "dw"]),
    ("v1 routing fused", ["--routing", "fused"]),
    ("v1 routing auto bf16", ["--routing", "auto", "--dtype", "bfloat16"]),
    ("v2", ["--model", "v2"]), ("v3", ["--model", "v3"]), ("v3small", ["--model", "v3small"]),
    ("v3 int8", ["--model", "v3", "--int8"]), ("v3small int8", ["--model", "v3small", "--int8"]),
)


def dw_phases(smi, gen, kernels, launches):
    """Phases 31-33. Fills launches["depthwise"] from the `cli verify` runs;
    returns the depthwise kernel's summary row."""
    import torch.nn.functional as F

    from mobilenet_tpu_torch import InferencePipeline, ModelConfig, cli
    from mobilenet_tpu_torch.models import mobilenet_v1
    from mobilenet_tpu_torch.ops.conv import no_tf32
    from mobilenet_tpu_torch.ops.depthwise import depthwise, depthwise_plain
    from mobilenet_tpu_torch.utils import golden

    cfg = ModelConfig(ALPHA, RES, compute_dtype="bfloat16")
    row = {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/depthwise.cu",
           "design": DW_DESIGN, "replaces": "mobilenet_tpu/ops/pallas_dw.py:112", **FLOAT_ROW,
           "library_ms": 0.0, "library": "F.conv2d(groups=C, channels-last) + clamp_: two calls",
           "ms_f32": 0.0, "plain_ms_f32": 0.0, "library_ms_f32": 0.0, "bound_ms_f32": 0.0}

    # -- 31. the depthwise kernel vs plain at V1's 13 layers, batch 256 and 2 ----------------
    for batch in (256, 2):
        for nm, n, h, c, stride, cnt in dw_shapes(cfg, batch):
            entry = {}
            for tag, dt, atol, rtol in (("f32", torch.float32, 2e-6, 1e-6),
                                        ("bf16", torch.bfloat16, 0.0, 2 ** -8)):
                x = (torch.rand(n, h, h, c, generator=gen, device="cuda") * 4 - 2).to(dt)
                w = (torch.randn(3, 3, 1, c, generator=gen, device="cuda") * 0.5).to(dt)
                b = (torch.randn(c, generator=gen, device="cuda") * 0.2).to(dt)
                before = depthwise.launches
                got = depthwise(x, w, stride, b, True)
                ref = depthwise_plain(x, w, stride, b, True)
                torch.cuda.synchronize()
                err = compare(f"depthwise {nm} {tag}", got, ref, atol, rtol)
                kms = cuda_ms(lambda: depthwise(x, w, stride, b, True))
                pms = cuda_ms(lambda: depthwise_plain(x, w, stride, b, True))
                xn = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC data: channels-last
                wl = w.reshape(3, 3, c).permute(2, 0, 1).unsqueeze(1).contiguous()
                with no_tf32(x):
                    lms = cuda_ms(lambda: F.conv2d(xn, wl, b, stride, 1, 1, c).clamp_(0, 6))
                b_ms, b_by, t_b, t_o = bound(*dw_work(n, h, c, stride, tag), "f32")
                entry[tag] = {"max_abs_err": err, "atol": atol, "rtol": rtol, "ms": kms,
                              "plain_ms": pms, "library_ms": lms, "bound_ms": b_ms,
                              "bound_by": b_by, "launches": depthwise.launches - before}
                if batch == 256 and tag == "bf16":
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    row["ms"] += cnt * kms
                    row["plain_ms"] += cnt * pms
                    row["library_ms"] += cnt * lms
                    row["bound_ms"] += cnt * b_ms
                    row["bytes_ms"] += cnt * t_b
                    row["ops_ms"] += cnt * t_o
                elif batch == 256:
                    row["max_abs_err_f32"] = max(row["max_abs_err_f32"], err)
                    row["ms_f32"] += cnt * kms
                    row["plain_ms_f32"] += cnt * pms
                    row["library_ms_f32"] += cnt * lms
                    row["bound_ms_f32"] += cnt * b_ms
                del x, w, b, got, ref, xn, wl
            emit("kernel", kernel="depthwise", shape=f"{nm}_dw ({n},{h},{h},{c}) s{stride}",
                 count_per_forward=cnt, nvidia_smi=smi, **entry)
            torch.cuda.empty_cache()
    for n, h, w, c, stride, has_bias, relu6 in DW_EDGES:
        entry = {}
        for tag, dt, atol, rtol in (("f32", torch.float32, 2e-6, 1e-6),
                                    ("bf16", torch.bfloat16, 0.0, 2 ** -8)):
            x = (torch.rand(n, h, w, c, generator=gen, device="cuda") * 4 - 2).to(dt)
            wt = (torch.randn(3, 3, 1, c, generator=gen, device="cuda") * 0.5).to(dt)
            b = (torch.randn(c, generator=gen, device="cuda") * 0.2).to(dt) if has_bias else None
            before = depthwise.launches
            got = depthwise(x, wt, stride, b, relu6)
            ref = depthwise_plain(x, wt, stride, b, relu6)
            torch.cuda.synchronize()
            entry[tag] = {"max_abs_err": compare(f"depthwise edge {tag}", got, ref, atol, rtol),
                          "atol": atol, "rtol": rtol, "launches": depthwise.launches - before}
        emit("kernel", kernel="depthwise", shape=f"edge ({n},{h},{w},{c}) s{stride} bias "
             f"{has_bias} relu6 {relu6}", count_per_forward=0, nvidia_smi=smi, **entry)

    # -- 32. the V1 "dw" route vs plain; a fused pipeline's per-layer taps --------------------
    pipe = InferencePipeline(cfg, device="cuda")
    cfg32 = ModelConfig(ALPHA, RES, compute_dtype="float32")
    check_routes(pipe, mobilenet_v1.forward, cfg32, F32_ATOL, F32_RTOL, anchored=True,
                 route="dw")
    del pipe
    x = np.random.default_rng(8).uniform(-1, 1, (8, RES, RES, 3)).astype(np.float32)
    _, plain_taps = InferencePipeline(cfg32, device="cuda", dw_backend="plain").activations(x)
    fused32 = InferencePipeline(cfg32, device="cuda", dw_backend="fused")
    for k in kernels.values():
        k.launches = 0
    _, taps = fused32.activations(x)
    torch.cuda.synchronize()
    n_dw = depthwise.launches
    reports = golden.compare_activations(taps, plain_taps)
    bad = golden.first_divergence(reports)
    emit("collect_fused", model=cfg32.variant_name(), batch=8, taps=len(taps),
         launches={"depthwise": n_dw}, max_abs_err=max(r.max_abs for r in reports),
         first_divergence=None if bad is None else bad.name)
    if n_dw != 13 or bad is not None:
        raise AssertionError(f"fused collect: {n_dw} depthwise launches (13 wanted), "
                             f"first divergence from the plain taps {bad}")
    del fused32, taps, plain_taps
    torch.cuda.empty_cache()

    # -- 33. cli verify at 1.0-224, batch 2 ---------------------------------------------------
    for k in kernels.values():
        k.launches = 0
    for name, extra in VERIFY_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        code = 0
        try:
            with contextlib.redirect_stdout(out):
                cli.main(["verify", "--alpha", str(ALPHA), "--res", str(RES), "--batch", "2",
                          *extra])
        except SystemExit as e:
            code = e.code
        lines = out.getvalue().strip().splitlines()
        max_abs = [float(m.group(1)) for ln in lines
                   for m in [re.search(r"max_abs=([0-9.eE+-]+)", ln)] if m]
        emit("cli_verify", run=name, seconds=time.perf_counter() - t0, exit=code,
             last_line=lines[-1] if lines else "", worst_max_abs=max(max_abs, default=None),
             failed=[ln for ln in lines if "FAIL" in ln][:5])
        if code not in (0, None):
            raise AssertionError(f"cli verify {name}: exit {code}")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches["depthwise"] = depthwise.launches
    emit("cli_verify_launches", launches={k: v.launches for k, v in kernels.items()})
    if depthwise.launches <= 0:
        raise AssertionError("cli verify: the depthwise kernel was not launched")
    return {"depthwise": row}


def v3small_int8_phases(smi, kernels, launches):
    """Phases 34-37. Fills launches["v3_block_i8[v3small]"] from the
    V3-Small int8 server; returns the row's summary."""
    from mobilenet_tpu_torch import Int8PipelineV3, V3Config, cli
    from mobilenet_tpu_torch.checkpoints import fold_bn_v3, init_params_v3
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.v3_block_i8 import v3_block_i8, v3_block_i8_plain
    from mobilenet_tpu_torch.quant import ACT_IN_SCALE
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant.v3 import forward_v3_i8, quantize_v3
    from mobilenet_tpu_torch.quant.verify import verify_int8_v3

    cfg = V3Config("small", ALPHA, RES)
    row = "v3_block_i8[v3small]"
    summary = {row: {
        "route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_block_i8.cu",
        "design": V3_I8_DESIGN, "replaces": "mobilenet_tpu/quant/pallas_block_packed_i8.py:821",
        "also_runs": ["V3-S b01-b10 (JAX: mobilenet_tpu/quant/pallas_ir_v3_i8.py:290)"],
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
        "ops_ms": 0.0, "library_ms": LIBRARY_MS}}

    # -- 34. calibration; the int8 V3 kernel vs plain at V3-Small's shapes ----------------------
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    t0 = time.perf_counter()
    q = quantize_v3(folded, cfg)
    emit("calibration", model=cfg.variant_name(), n_images=32,
         seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(7)
    v3_i8_kernel_checks(summary, row, cfg, rng, smi)
    # block 0 saturated: inputs at the rails, the projection driven past the int8 range
    layers = v3_int8_layers(rng, 16, 16, 16, 3, 8, True, prj_gain=8.0)
    x = torch.from_numpy(np.where(rng.random((256, 112, 112, 16)) < 0.5, 120, -120).astype(
        np.int8)).cuda()
    kw = dict(k=3, stride=2, act="relu", se1=layers[3], se2=layers[4], residual=False)
    ref = check_i8(summary, row, "saturation b00 (256,112,112,16)->16 identity k3 s2 se8", 0,
                   lambda *a: v3_block_i8(*a, **kw), lambda *a: v3_block_i8_plain(*a, **kw),
                   (x, *layers[:3]), ir_work(256, 112, 16, 16, 16, 2, "int8", k=3, se=8,
                                             identity=True), smi)
    if not ((ref == 127).any() and (ref == -128).any()):
        raise AssertionError("block-0 saturation case: the output did not reach both rails")
    del layers, x, ref
    torch.cuda.empty_cache()

    # -- 35. V3-S int8 routes on the calibrated tree; the per-layer gate --------------------------
    pipe = Int8PipelineV3(cfg, device="cuda", quantized=q)
    with torch.inference_mode():
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            x_q = qops.quantize_input_dev(preprocess(imgs, RES), ACT_IN_SCALE)
            got = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="auto")
            ref = forward_v3_i8(pipe.dev, x_q, cfg, dw_backend="plain")
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"V3-S int8 pipeline batch {batch}: kernel route logits "
                                     "differ from the plain route")
            if not torch.isfinite(got).all() or got.shape != (batch, cfg.num_classes):
                raise AssertionError(f"V3-S int8 pipeline batch {batch}: bad logits")
            emit("pipeline", model=cfg.variant_name(), dtype="int8", batch=batch,
                 max_abs_err=0.0, tolerance=0, top1_agree=batch, rows=batch,
                 logits_absmax=float(ref.abs().max()))
    del imgs, x_q, got, ref
    x = rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ok = verify_int8_v3(cfg, fold_bn_v3(init_params_v3(cfg, seed=1), eps=cfg.bn_eps), x,
                        n_calib=8, device="cuda")
    emit("verify_int8_v3", model=cfg.variant_name(), batch=2, n_calib=8, exact=ok)
    if not ok:
        raise AssertionError("verify_int8_v3 at V3-S 1.0-224: a layer differs from the oracle")
    torch.cuda.empty_cache()

    # -- 36. V3-S int8 benchmark; batch-1 fused vs plain ----------------------------------------
    emit("benchmark", model=cfg.variant_name(), route="int8 auto", nvidia_smi=smi,
         **pipe.benchmark(batch_size=256, steps=40))
    plain = Int8PipelineV3(cfg, device="cuda", quantized=q, dw_backend="plain")
    emit("benchmark", model=cfg.variant_name(), route="int8 plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=5, latency_iters=10))
    emit("latency_b1", model=cfg.variant_name(), dtype="int8", nvidia_smi=smi,
         **batch1_latency([("auto", pipe), ("plain", plain)]))
    del plain
    torch.cuda.empty_cache()

    # -- 37. the V3-S int8 main path: 64-stream server; cli serve --model v3small --int8 ---------
    got = serve_main_path(pipe, kernels, ("v3_block_i8",), "serving_v3small_int8", smi)
    launches[row] = got["v3_block_i8"]
    del pipe
    torch.cuda.empty_cache()
    for k in kernels.values():
        k.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["serve", "--model", "v3small", "--int8", "--streams", "64", "--alpha",
                  str(ALPHA), "--res", str(RES)])
    torch.cuda.synchronize()
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    emit("cli_serve_v3small_int8", nvidia_smi=smi,
         launches={"v3_block_i8": v3_block_i8.launches}, **stats)
    if stats["errors"] != 0 or v3_block_i8.launches <= 0:
        raise AssertionError("cli serve --model v3small --int8: errors, or v3_block_i8 not "
                             "launched")
    torch.cuda.empty_cache()
    return summary


def stem_phases(smi, gen, kernels, launches):
    """Phases 38-41. Fills launches["stem_block0"] (the fused-stem server;
    launches["stem_conv"] comes from the float main path, phase 5, whose
    "fused" block 0 puts the stem on it); returns the two kernels' rows."""
    from mobilenet_tpu_torch import InferencePipeline, ModelConfig
    from mobilenet_tpu_torch.block_times import stem_work
    from mobilenet_tpu_torch.models import mobilenet_v1
    from mobilenet_tpu_torch.ops.conv import conv2d_same
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.separable_block import separable_block
    from mobilenet_tpu_torch.ops.stem import (
        stem_block0, stem_block0_plain, stem_conv, stem_conv_plain,
    )

    chain = kernels["chain"]
    extra = {"ms_f32": 0.0, "plain_ms_f32": 0.0, "bound_ms_f32": 0.0}
    # bf16 runs stem_wgmma.cuh ("source"), float32 stem_f32.cuh ("source_f32")
    sources = {"source": "mobilenet_tpu_torch/csrc/stem_wgmma.cuh",
               "source_f32": "mobilenet_tpu_torch/csrc/stem_f32.cuh"}
    rows = {
        "stem_block0": {"route": "cuda", **sources,
                        "replaces": "mobilenet_tpu/ops/pallas_stem_b0.py:124", **FLOAT_ROW,
                        **extra, "bound_by_f32": "", "unfused_ms": 0.0, "unfused_ms_f32": 0.0,
                        "unfused": "preprocess + conv2d_same (cuDNN) + separable_block b00",
                        "f32_shape": "(256,160,160,3) u8 -> 64"},
        "stem_conv": {"route": "cuda", **sources,
                      "replaces": "mobilenet_tpu/ops/pallas_stem.py:146", **FLOAT_ROW,
                      **extra, "bound_by_f32": "", "library_ms": 0.0, "library_ms_f32": 0.0,
                      "library": "ops/conv.conv2d_same: F.conv2d (cuDNN), bias, clamp"},
    }

    def r(*shape, scale, dt):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt).contiguous()

    def add(row, tag, batch, err, kms, pms, b_ms, t_b, t_o, yard_key, yard_ms):
        if batch != 256:
            return
        if tag == "bf16":
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bytes_ms=t_b, ops_ms=t_o)
            row[yard_key] = yard_ms
        else:
            row["max_abs_err_f32"] = max(row["max_abs_err_f32"], err)
            row.update(ms_f32=kms, plain_ms_f32=pms, bound_ms_f32=b_ms,
                       bound_by_f32="bytes" if t_b >= t_o else "operations")
            row[f"{yard_key}_f32"] = yard_ms

    # -- 38. the stem kernels vs plain at V1 1.0-224, batch 256 and 2 ---------------------
    cout = 64
    for batch in (256, 2):
        for tag, dt, atol, rtol in (("f32", torch.float32, F32_ATOL, F32_RTOL),
                                    ("bf16", torch.bfloat16, BF16_ATOL, BF16_RTOL)):
            # the fused kernel: float32 only up to 160 px (the routing gate)
            h = 160 if tag == "f32" else RES
            imgs = torch.randint(0, 256, (batch, h, h, 3), generator=gen, device="cuda",
                                 dtype=torch.uint8)
            imgs[:, -1] = 255  # beside the stem's pad
            imgs[:, :, -1] = 255
            w = (r(3, 3, 3, 32, scale=0.4, dt=dt), r(32, scale=0.2, dt=dt),
                 r(3, 3, 1, 32, scale=0.5, dt=dt), r(32, scale=0.2, dt=dt),
                 r(32, cout, scale=3 * 32 ** -0.5, dt=dt), r(cout, scale=0.2, dt=dt))
            got = stem_block0(imgs, *w, True)
            ref = stem_block0_plain(imgs, *w, True)
            torch.cuda.synchronize()
            err = compare(f"stem_block0 ({batch},{h},{h},3) {tag}", got, ref, atol, rtol)
            sat = float((ref.float() == 6).float().mean())
            del got, ref
            exact = None
            if tag == "f32":  # an identity pointwise: the output is the depthwise, exact
                eye = (torch.eye(32, device="cuda"), torch.zeros(32, device="cuda"))
                exact = bool(torch.equal(stem_block0(imgs, *w[:4], *eye, True),
                                         stem_block0_plain(imgs, *w[:4], *eye, True)))
                if not exact:
                    raise AssertionError(f"stem_block0 ({batch},{h},{h},3) f32: the stem and "
                                         "depthwise are not bit-equal to the plain version")
            kms = cuda_ms(lambda: stem_block0(imgs, *w, True))
            pms = cuda_ms(lambda: stem_block0_plain(imgs, *w, True), reps=3, warmup=1)

            def unfused():
                x = preprocess(imgs, h, dt)
                y = conv2d_same(x, w[0], 2, bias=w[1], relu6=True)
                return separable_block(y, w[2], w[3], w[4], w[5], 1, True)

            ums = cuda_ms(unfused)
            nbytes, t_o = stem_work(batch, h, cout, tag)
            t_b = nbytes / HBM_BYTES_PER_S * 1e3
            b_ms = max(t_b, t_o)
            emit("kernel", kernel="stem_block0", shape=f"({batch},{h},{h},3) u8 -> {cout}",
                 dtype=tag, nvidia_smi=smi, max_abs_err=err, atol=atol, rtol=rtol,
                 relu6_saturated=sat, stem_and_depthwise_bit_equal=exact, ms=kms, plain_ms=pms,
                 unfused_ms=ums, bound_ms=b_ms, bound_by="bytes" if t_b >= t_o else "operations")
            add(rows["stem_block0"], tag, batch, err, kms, pms, b_ms, t_b, t_o, "unfused_ms",
                ums)
            del imgs, w

            x = (torch.rand(batch, RES, RES, 3, generator=gen, device="cuda") * 2 - 1).to(dt)
            x[:, -1] = 1
            x[:, :, -1] = 1
            ws, bs = r(3, 3, 3, 32, scale=0.8, dt=dt), r(32, scale=0.2, dt=dt)
            got = stem_conv(x, ws, bs, True)
            ref = stem_conv_plain(x, ws, bs, True)
            torch.cuda.synchronize()
            err = compare(f"stem_conv ({batch},{RES},{RES},3) {tag}", got, ref, atol, rtol)
            sat = float((ref.float() == 6).float().mean())
            exact = bool(torch.equal(got, ref)) if tag == "f32" else None
            if exact is False:
                raise AssertionError(f"stem_conv ({batch},{RES},{RES},3) f32: not bit-equal to "
                                     "the plain version")
            del got, ref
            kms = cuda_ms(lambda: stem_conv(x, ws, bs, True))
            pms = cuda_ms(lambda: stem_conv_plain(x, ws, bs, True), reps=3, warmup=1)
            lms = cuda_ms(lambda: conv2d_same(x, ws, 2, bias=bs, relu6=True))
            nbytes, t_o = stem_work(batch, RES, 32, tag, block0=False)
            t_b = nbytes / HBM_BYTES_PER_S * 1e3
            b_ms = max(t_b, t_o)
            emit("kernel", kernel="stem_conv", shape=f"({batch},{RES},{RES},3) -> 32",
                 dtype=tag, nvidia_smi=smi, max_abs_err=err, atol=atol, rtol=rtol,
                 relu6_saturated=sat, bit_equal=exact, ms=kms, plain_ms=pms, library_ms=lms,
                 bound_ms=b_ms, bound_by="bytes" if t_b >= t_o else "operations")
            add(rows["stem_conv"], tag, batch, err, kms, pms, b_ms, t_b, t_o, "library_ms", lms)
            del x
            torch.cuda.empty_cache()
    # the stem kernel on odd sides, where TF-SAME pads (1, 1)
    for tag, dt, atol, rtol in (("f32", torch.float32, F32_ATOL, F32_RTOL),
                                ("bf16", torch.bfloat16, BF16_ATOL, BF16_RTOL)):
        x = (torch.rand(2, RES + 1, RES - 1, 3, generator=gen, device="cuda") * 2 - 1).to(dt)
        ws, bs = r(3, 3, 3, 32, scale=0.8, dt=dt), r(32, scale=0.2, dt=dt)
        got = stem_conv(x, ws, bs, True)
        ref = stem_conv_plain(x, ws, bs, True)
        err = compare(f"stem_conv (2,{RES + 1},{RES - 1},3) {tag}", got, ref, atol, rtol)
        exact = bool(torch.equal(got, ref)) if tag == "f32" else None
        if exact is False:
            raise AssertionError(f"stem_conv (2,{RES + 1},{RES - 1},3) f32: not bit-equal")
        emit("kernel", kernel="stem_conv", shape=f"(2,{RES + 1},{RES - 1},3) -> 32",
             dtype=tag, max_abs_err=err, atol=atol, rtol=rtol, bit_equal=exact,
             out=list(got.shape))

    # -- 39. the fused-stem pipeline vs the default pipeline ------------------------------
    cfg = ModelConfig(ALPHA, RES, compute_dtype="bfloat16")
    base = InferencePipeline(cfg, device="cuda")
    fused = InferencePipeline(cfg, device="cuda", fuse_stem=True)
    rng = np.random.default_rng(3)

    def logits(pipe, imgs, c, dt, fuse):
        return mobilenet_v1.forward_u8(pipe.params, imgs, c, dtype=dt, dw_backend="auto",
                                       fuse_stem=fuse).float()

    with torch.inference_mode():
        for batch, n_sep, n_chain in ((256, 12, 0), (1, 7, 1)):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            for k in kernels.values():
                k.launches = 0
            got = logits(fused, imgs, cfg, torch.bfloat16, True)
            torch.cuda.synchronize()
            counts = {k: kernels[k].launches for k in ("stem_block0", "stem_conv",
                                                       "separable_block", "chain")}
            ref = logits(base, imgs, cfg, torch.bfloat16, False)
            scale = float(ref.abs().max())
            atol = max(ROUTE_ATOL, ROUTE_REL * scale)
            err = compare(f"fused stem bf16 batch {batch}", got, ref, atol, 0.0)
            top_g, top_r = got.argmax(-1), ref.argmax(-1)
            flips = (top_g != top_r).nonzero().flatten().tolist()
            for i in flips:  # a flip only between near-tied classes, as check_routes
                gap = float(ref[i, top_r[i]] - ref[i, top_g[i]])
                if gap > atol:
                    raise AssertionError(f"fused stem batch {batch} row {i}: top-1 "
                                         f"{int(top_g[i])} vs {int(top_r[i])}, gap {gap:.3e}")
            emit("fused_stem_route", model=cfg.variant_name(), dtype="bfloat16", batch=batch,
                 max_abs_err=err, atol=atol, logits_absmax=scale,
                 top1_agree=batch - len(flips), rows=batch, launches=counts)
            want = {"stem_block0": 1, "stem_conv": 0, "separable_block": n_sep,
                    "chain": n_chain}
            if counts != want:
                raise AssertionError(f"fused stem batch {batch}: launches {counts}, "
                                     f"wanted {want}")
    del base, fused
    torch.cuda.empty_cache()

    for res, fuses in ((160, True), (RES, False)):
        cfg32 = ModelConfig(ALPHA, res, compute_dtype="float32")
        base32 = InferencePipeline(cfg32, device="cuda")
        fused32 = InferencePipeline(cfg32, device="cuda", fuse_stem=True)
        imgs = rng.integers(0, 256, (2, res, res, 3), dtype=np.uint8)
        for k in kernels.values():
            k.launches = 0
        got = fused32.run_batch(imgs)
        torch.cuda.synchronize()
        counts = {k: kernels[k].launches for k in ("stem_block0", "stem_conv")}
        ref = base32.run_batch(imgs)
        with torch.inference_mode():
            d = torch.from_numpy(imgs).cuda()
            lg = logits(fused32, d, cfg32, torch.float32, True)
            lr = logits(base32, d, cfg32, torch.float32, False)
        err = compare(f"fused stem f32 {res} logits", lg, lr, 1e-4, 1e-3)
        perr = compare(f"fused stem f32 {res} probs", torch.from_numpy(got),
                       torch.from_numpy(ref), 1e-4, 1e-3)
        emit("fused_stem_route", model=cfg32.variant_name(), dtype="float32", batch=2,
             max_abs_err=err, probs_max_abs_err=perr, atol=1e-4, rtol=1e-3,
             fused=fuses, launches=counts)
        if counts != ({"stem_block0": 1, "stem_conv": 0} if fuses
                      else {"stem_block0": 0, "stem_conv": 1}):
            raise AssertionError(f"fused stem f32 {res}: launches {counts}")
        del base32, fused32
        torch.cuda.empty_cache()

    # -- 40. benchmark(): fuse_stem on and off, alternating; batch-1 latency ----------------
    pipes = [("default", InferencePipeline(cfg, device="cuda")),
             ("fuse_stem", InferencePipeline(cfg, device="cuda", fuse_stem=True))]
    runs = {name: [] for name, _ in pipes}
    for name, p in pipes + pipes[::-1]:
        runs[name].append(p.benchmark(batch_size=256, steps=20, latency_iters=5))
    for name, rs in runs.items():
        emit("benchmark", route=f"auto {name}", nvidia_smi=smi,
             images_per_sec=[x["images_per_sec"] for x in rs],
             e2e_images_per_sec=[x["e2e_images_per_sec"] for x in rs],
             device=rs[0]["device"], batch_size=256)
    emit("batch1_latency", nvidia_smi=smi, **batch1_latency(pipes))

    # -- 41. the fused-stem main path: 64-stream server ------------------------------------
    got = serve_main_path(pipes[1][1], kernels,
                          ("stem_block0", "separable_block", "fused_head", "chain"),
                          "serving_fuse_stem", smi)
    launches["stem_block0"] = got["stem_block0"]
    del pipes
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def chain_knob(variant, value):
    """mobilenet_v3's chain knob of `variant` set to `value` inside."""
    from mobilenet_tpu_torch.models import mobilenet_v3

    name = "CHAIN_V3_SMALL" if variant == "small" else "CHAIN_V3"
    old = getattr(mobilenet_v3, name)
    setattr(mobilenet_v3, name, value)
    try:
        yield
    finally:
        setattr(mobilenet_v3, name, old)


class ChainKnobView:
    """A pipeline run with the variant's chain knob at `value`, for helpers
    that alternate pipelines (batch1_latency). forget=True drops the chain
    wrapper's kept checks and tables before every call, so that each call
    pays them, as the wrapper did before it kept them."""

    def __init__(self, pipe, variant, value, forget=False):
        self.pipe, self.variant, self.value, self.forget = pipe, variant, value, forget

    def _forget(self):
        from mobilenet_tpu_torch.ops import v3_chain

        if self.forget:
            v3_chain._PLANS.clear()

    def run_batch(self, frame):
        self._forget()
        with chain_knob(self.variant, self.value):
            return self.pipe.run_batch(frame)

    def _entry(self, kind):
        entry = self.pipe._entry(kind)

        def run(x):
            self._forget()
            with chain_knob(self.variant, self.value):
                return entry(x)
        return run


def v3_chain_work(n, h, defs, kind):
    """(bytes, ops) of a chain over blocks `defs` on (n, h, h, Cin): the
    input read once, the output written once, every block's weights once,
    and the blocks' operations (ir_work's, summed). Intermediates need not
    leave the chip, so they are not counted (the kernel still writes them
    to its scratch buffers)."""
    act = ELEM_BYTES[kind][0]
    nbytes, ops = n * h * h * defs[0].cin * act, 0
    for bd in defs:
        b, o = ir_work(n, h, bd.cin, bd.cexp, bd.cout, bd.stride, kind, k=bd.kernel,
                       se=bd.se_mid, identity=not bd.has_expand)
        ho = -(-h // bd.stride)
        nbytes += b - n * h * h * bd.cin * act - n * ho * ho * bd.cout * act  # its weights
        ops += o
        h = ho
    return nbytes + n * h * h * defs[-1].cout * act, ops


def v3_chain_checks(summary, gen):
    """Phase 42: the chain kernel on every run the greedy knob forms at
    V3-Large and V3-Small 1.0-224, bf16 at batch 256 and 1 and float32 at
    batch 8 (random weights, non-zero SE biases): bit-equal to v3_block in
    sequence, within the kernel tolerance of v3_chain_plain; its ms beside
    the same blocks' per-block ms, plain ms, its bound and the sum of the
    per-block bounds; the launch's grid; and the wrapper's host ms a call
    (host clock around one call on an idle card, median), with its checks
    and tables made anew ("miss") and kept from an earlier call ("hit").
    V3-Small bf16 batch 256 (the run the chained server of phase 44 takes)
    fills the row."""
    from mobilenet_tpu_torch import V3Config
    from mobilenet_tpu_torch.models import mobilenet_v3
    from mobilenet_tpu_torch.ops import v3_chain as v3_chain_mod
    from mobilenet_tpu_torch.ops.v3_block import v3_block
    from mobilenet_tpu_torch.ops.v3_chain import v3_chain, v3_chain_plain

    def host_ms(fn, forget, reps=30):
        times = []
        for _ in range(reps):
            if forget:
                v3_chain_mod._PLANS.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return float(np.median(times) * 1e3)

    row = summary["v3_chain"]
    for variant in ("large", "small"):
        for dtype, batch in ((torch.bfloat16, 256), (torch.bfloat16, 1), (torch.float32, 8)):
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            item = 2 if kind == "bf16" else 4
            atol, rtol = (BF16_ATOL, BF16_RTOL) if kind == "bf16" else (F32_ATOL, F32_RTOL)
            cfg = V3Config(variant, ALPHA, RES, compute_dtype="bfloat16" if item == 2
                           else "float32")
            with chain_knob(variant, True):
                runs = mobilenet_v3.chain_runs(cfg, mobilenet_v3._routing_v3(cfg, "auto", batch),
                                               batch, RES // 2, RES // 2, item)
            if not runs:
                raise AssertionError(f"{cfg.variant_name()} batch {batch}: no chain formed")
            sides, h = [], RES // 2
            for bd in cfg.block_defs:
                sides.append(h)
                h = -(-h // bd.stride)
            for start, stop in runs.items():
                defs, h = cfg.block_defs[start:stop], sides[start]
                blocks = []
                for bd in defs:
                    t = rand_v3(gen, 1, 1, bd, dtype)
                    blocks.append(dict(zip(("exp_w", "exp_b", "dw_w", "dw_b", "prj_w", "prj_b",
                                            "se_w1", "se_b1", "se_w2", "se_b2"), t[1:]),
                                       k=bd.kernel, stride=bd.stride, act=bd.act,
                                       residual=bd.has_res))
                x = rand_v3(gen, batch, h, defs[0], dtype)[0]

                def per_block(x=x, blocks=blocks):
                    y = x
                    for b in blocks:
                        y = v3_block(y, **b)
                    return y

                name = (f"{cfg.variant_name()} b{start:02d}-b{stop - 1:02d} batch {batch} "
                        f"{kind}")
                got, ref = v3_chain(x, blocks), per_block()
                grid = v3_chain.grid
                plain = v3_chain_plain(x, blocks)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name}: the chain differs from v3_block in sequence "
                                         f"by {float((got.float() - ref.float()).abs().max())}")
                err = compare(name, got, plain, atol, rtol)
                kms = cuda_ms(lambda: v3_chain(x, blocks))
                bms = cuda_ms(per_block)
                pms = cuda_ms(lambda: v3_chain_plain(x, blocks), reps=2, warmup=1)
                b_ms, b_by, t_b, t_o = bound(*v3_chain_work(batch, h, defs, kind), kind)
                per_bounds, hh = 0.0, h
                for bd in defs:
                    per_bounds += bound(*ir_work(batch, hh, bd.cin, bd.cexp, bd.cout, bd.stride,
                                                 kind, k=bd.kernel, se=bd.se_mid), kind)[0]
                    hh = -(-hh // bd.stride)
                host = {"miss": host_ms(lambda: v3_chain(x, blocks), True),
                        "hit": host_ms(lambda: v3_chain(x, blocks), False)}
                emit("v3_chain", run=name, blocks=stop - start, bit_equal_to_v3_block=True,
                     max_abs_err_vs_plain=err, atol=atol, rtol=rtol, ms=kms, per_block_ms=bms,
                     plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                     sum_of_per_block_bounds_ms=per_bounds, grid=grid, host_ms=host)
                if variant == "small" and kind == "bf16" and batch == 256:
                    row.update(ms=kms, per_block_ms=bms, plain_ms=pms, bound_ms=b_ms,
                               bytes_ms=t_b, ops_ms=t_o, max_abs_err=err,
                               run=name, bit_equal_to_v3_block=True)
                elif kind == "f32":
                    row["max_abs_err_f32"] = max(row["max_abs_err_f32"], err)
                del x, blocks, got, ref, plain
                torch.cuda.empty_cache()


def v3_chain_phases(smi, gen, kernels, launches):
    """Phases 42-44. Fills launches["v3_chain"] from the chained V3-Small
    server; returns the chain kernel's row."""
    from mobilenet_tpu_torch import InferencePipeline, V3Config
    from mobilenet_tpu_torch.models import mobilenet_v3
    from mobilenet_tpu_torch.ops.preprocess import preprocess

    v3_chain = kernels["v3_chain"]
    summary = {"v3_chain": {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/v3_chain.cu",
                            "design": V3_DESIGN,
                            "replaces": "mobilenet_tpu/ops/pallas_chain_v3.py:239",
                            **FLOAT_ROW, "per_block_ms": 0.0}}

    # -- 42. the chain kernel at full width ------------------------------------------
    v3_chain_checks(summary, gen)

    # -- 43. the chained pipelines -----------------------------------------------------
    pipes = {}
    for variant in ("large", "small"):
        cfg = V3Config(variant, ALPHA, RES, compute_dtype="bfloat16")
        tree = v3_folded(cfg, 0)
        pipe = pipes[variant] = InferencePipeline(cfg, tree, device="cuda")
        rng = np.random.default_rng(3)
        for batch in (256, 1):
            imgs = torch.from_numpy(
                rng.integers(0, 256, (batch, RES, RES, 3), dtype=np.uint8)).cuda()
            with torch.inference_mode():
                x = preprocess(imgs, RES, torch.bfloat16)
                base = mobilenet_v3.forward_v3(pipe.params, x, cfg, dw_backend="auto")
                v3_chain.launches = 0
                with chain_knob(variant, True):
                    got = mobilenet_v3.forward_v3(pipe.params, x, cfg, dw_backend="auto")
                torch.cuda.synchronize()
            if v3_chain.launches != 1 or not torch.equal(got, base):
                raise AssertionError(f"{cfg.variant_name()} batch {batch}: {v3_chain.launches} "
                                     "chain launches; logits equal to the per-block route: "
                                     f"{torch.equal(got, base)}")
            emit("chained_pipeline", model=cfg.variant_name(), batch=batch,
                 logits_equal_to_per_block=True, v3_chain_launches=v3_chain.launches,
                 top1_agree=batch)
        with chain_knob(variant, True):
            check_routes(pipe, mobilenet_v3.forward_v3, V3Config(variant, ALPHA, RES),
                         V3_F32_ATOL, V3_F32_RTOL, anchored=True, params=tree)
        arms = [("per_block", False), ("chain", True)]
        if variant == "large":  # the run split before b12, whose tile halves residency
            arms.append(("chain_b01-b11_b13-b14", ((1, 12), (13, 15))))
        rates = {name: [] for name, _ in arms}
        for name, value in arms + arms[::-1]:
            with chain_knob(variant, value):
                r = pipe.benchmark(batch_size=256, steps=40, latency_iters=10)
            rates[name].append(r["images_per_sec"])
        emit("benchmark_chain", model=cfg.variant_name(), nvidia_smi=smi, batch_size=256,
             images_per_sec=rates)
        views = [(name, ChainKnobView(pipe, variant, value)) for name, value in arms]
        views.append(("chain_checks_each_call", ChainKnobView(pipe, variant, True, forget=True)))
        emit("batch1_latency_chain", model=cfg.variant_name(), nvidia_smi=smi,
             **batch1_latency(views))
        torch.cuda.empty_cache()

    # -- 44. the 64-stream server on the chained V3-Small pipeline ---------------------
    with chain_knob("small", True):
        got = serve_main_path(pipes["small"], kernels, ("v3_chain", "v3_block", "fused_head"),
                              "serving_v3small_chain", smi)
    launches["v3_chain"] = got["v3_chain"]
    del pipes
    torch.cuda.empty_cache()
    return summary


# the stencil's edge shapes (n, h, w, c) for `floors.check_stencil`
STENCIL_EDGES = ((1, 7, 9, 17), (3, 5, 7, 1), (2, 9, 11, 3), (1, 7, 7, 1024), (8, 56, 56, 128))


def png_rgb(path, img):
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array, written with zlib and
    struct alone."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# Phase 46's `cli eval` runs: (name, extra arguments, kernels that must launch).
# V1 1.0-224 at the JAX package's defaults (float32, 32 structured images,
# the NumPy oracle, batch 16, --min-agreement 1.0) on the exported folded
# weights, then --int8 and --dtype bfloat16; V2, V3-Large and V3-Small
# float32 on their seeded weights at 8 images.
EVAL_RUNS = (
    ("v1 float32", ["--ckpt", "{folded}"], ("stem_conv", "separable_block", "fused_head")),
    ("v1 int8", ["--ckpt", "{folded}", "--int8"], ("separable_block_i8",)),
    ("v1 bfloat16", ["--ckpt", "{folded}", "--dtype", "bfloat16"],
     ("stem_conv", "separable_block", "fused_head")),
    ("v2 float32", ["--model", "v2", "--n", "8"], ("inverted_residual", "fused_head")),
    ("v3 float32", ["--model", "v3", "--n", "8"], ("v3_block", "fused_head")),
    ("v3small float32", ["--model", "v3small", "--n", "8"], ("v3_block", "fused_head")),
)

# Phase 46's `cli eval --dir`: PNG files of these (h, w) shapes, two of each,
# so that the device resizes them to 224 squared (the oracle's input is the
# host's resize); V1 float32 at the JAX package's defaults otherwise.
DIR_SHAPES = ((256, 320), (320, 256), (180, 200), (375, 500)) * 2


def accuracy_phases(smi, kernels):
    """Phase 46, the accuracy path: `cli export` of the seeded V1 1.0-224
    weights, then `cli eval` (EVAL_RUNS, then V1 float32 on a directory of
    PNG files of DIR_SHAPES) and `cli classify` of a PNG at
    batch 1, each in this process with the launch counters set to 0 before
    and read after. Each run must exit 0 and launch its path's kernels.
    Prints each eval's report (agreement, near ties, the largest oracle
    margin among mismatches, seconds) and whether the native decoder
    builds here (else classify decodes with PIL)."""
    import tempfile
    from pathlib import Path

    from mobilenet_tpu_torch import native_io
    from mobilenet_tpu_torch.runtime.eval import synth_images

    def run(argv, required):
        timed, counts, seconds = run_cli(kernels, argv)
        lines = [ln for _, ln in timed if ln.strip()]
        missing = [k for k in required if not counts.get(k)]
        if missing:
            raise AssertionError(f"cli {' '.join(argv)}: {missing} not launched ({counts})")
        torch.cuda.empty_cache()
        return lines, counts, seconds

    size = ["--alpha", str(ALPHA), "--res", str(RES)]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        lines, _, seconds = run(["export", *size, "--out", str(tmp)], ())
        folded = tmp / f"mobilenet_v1_{ALPHA:g}_{RES}_folded.npz"
        emit("accuracy_export", seconds=seconds, last_line=lines[-1],
             files=sorted(p.name for p in tmp.iterdir()))
        evaldir = tmp / "images"
        evaldir.mkdir()
        images = synth_images(types.SimpleNamespace(resolution=500), len(DIR_SHAPES), seed=46)
        for i, ((h, w), img) in enumerate(zip(DIR_SHAPES, images)):
            png_rgb(evaldir / f"img{i:02d}.png", np.ascontiguousarray(img[:h, :w]))
        runs = EVAL_RUNS + (("v1 float32 --dir", ["--ckpt", "{folded}", "--dir", str(evaldir)],
                             EVAL_RUNS[0][2]),)
        for name, extra, required in runs:
            argv = ["eval", *size, *(a.format(folded=folded) for a in extra)]
            lines, counts, seconds = run(argv, required)
            rep = json.loads(lines[-1])
            emit("accuracy_eval", run=name, nvidia_smi=smi, seconds=seconds,
                 n_images=rep["n_images"], dtype=rep["dtype"], oracle=rep["oracle"],
                 top1_agreement=rep["top1_agreement"],
                 top1_agreement_tie_aware=rep["top1_agreement_tie_aware"],
                 near_ties=rep["near_ties"], top5_overlap=rep["top5_overlap"],
                 tie_margin=rep["tie_margin"],
                 max_mismatch_rel_margin=max((m["oracle_rel_margin"] for m in rep["mismatches"]),
                                             default=None),
                 mismatches=rep["mismatches"][:8], launches=counts)
        png = tmp / "classify.png"
        png_rgb(png, np.random.default_rng(46).integers(0, 256, (RES, RES, 3), dtype=np.uint8))
        lines, counts, seconds = run(["classify", str(png), *size],
                                     ("stem_conv", "chain", "fused_head"))
        emit("accuracy_classify", nvidia_smi=smi, seconds=seconds, dtype="bfloat16", batch=1,
             top=lines, launches=counts, native_decoder=native_io.available(),
             native_decoder_error=native_io.build_error(),
             decoder="native" if native_io.available() else "PIL")


def floor_phases(smi, launches):
    """Phase 45: the floor probes (`python -m mobilenet_tpu_torch.floors`'s
    run, counters set to 0 before and read after), then each probe against
    its plain version, and the roofline floors of V1, V2, V3-Large and
    V3-Small 1.0-224 at batch 256 at the published and the measured rates.
    Returns the three probes' rows: hbm_copy's is hbm_copy_flat's, its
    kernel (an image's bytes are contiguous), timed and counted once."""
    from mobilenet_tpu_torch import floors, roofline

    probes = {"hbm_copy_flat": floors.hbm_copy_flat, "stencil": floors.stencil}
    for fn in probes.values():
        fn.launches = 0
    res = floors.measure()
    torch.cuda.synchronize()
    launches.update({name: fn.launches for name, fn in probes.items()})
    launches["hbm_copy"] = launches["hbm_copy_flat"]
    floors.OUT.parent.mkdir(parents=True, exist_ok=True)
    floors.OUT.write_text(json.dumps(res, indent=1))
    emit("floors", **res)

    src = "mobilenet_tpu_torch/csrc/floors.cu"
    rows = {name: {"route": "cuda", "source": src, "replaces": f"tools/microbench_floors.py:{ln}",
                   **FLOAT_ROW, "library_ms": 0.0 if name != "stencil" else LIBRARY_MS}
            for name, ln in (("stencil", 116), ("hbm_copy_flat", 144))}
    r = rows["hbm_copy_flat"]
    for label, shape in floors.AUDIT_SHAPES:  # the copy: bit-equal; summed over the shapes
        x = torch.randn(shape, device="cuda").to(torch.bfloat16)
        got = floors.hbm_copy_flat(x)
        torch.cuda.synchronize()
        if not torch.equal(got, x):
            raise AssertionError(f"hbm_copy_flat {label}: the copy differs from its input")
        b_ms, _, t_b, t_o = bound(2 * x.numel() * x.element_size(), 0, "bf16")
        r["ms"] += res["hbm_ms"][label]["hbm_copy_flat"]
        r["plain_ms"] += cuda_ms(lambda: floors.hbm_copy_plain(x))
        r["library_ms"] += res["hbm_ms"][label]["library_copy"]
        r["bound_ms"] += b_ms
        r["bytes_ms"] += t_b
        r["ops_ms"] += t_o
        del x, got
        torch.cuda.empty_cache()
    # a batch of more images than a grid's y dimension holds (65,535), 16
    # bytes each: the whole batch copied
    x = torch.randn((65_537, 8), device="cuda").to(torch.bfloat16)
    got = floors.hbm_copy(x)
    torch.cuda.synchronize()
    if not torch.equal(got, x):
        raise AssertionError("hbm_copy (65537, 8): the copy differs from its input")
    del x, got
    # the stencil against its plain version (floors.check_stencil: within
    # STENCIL_RTOL relative, bf16 bit-equal) at the timed run's 256 rounds,
    # whose output the weights set, and at 2 and 8 rounds, where it must
    # still depend on x; then at the plan's edges: odd C (bf16 pairs across
    # pixels), C = 1 and 3, C = 1024 at an odd pixel count, fewer elements
    # than a wave's threads, and 8 x 56^2 x 128 (several passes a thread),
    # at 0, 1 and 19 rounds (19: not a multiple of any unroll)
    label, _, h, w, c, reps, images = floors.STENCIL_RUNS[0]
    checks = {f"{variant} x{r}": floors.check_stencil(variant, images, h, w, c, r, "cuda")
              for variant in floors.VARIANTS for r in (2, 8, reps)}
    for shape in STENCIL_EDGES:
        checks.update({f"{variant} {'x'.join(map(str, shape))} x{r}":
                       floors.check_stencil(variant, *shape, r, "cuda")
                       for variant in floors.VARIANTS for r in (0, 1, 19)})
    x, wt = floors.stencil_inputs(images, h, w, c, "cuda")
    elems = x.numel()
    b_ms, t_b, t_o = floors.stencil_bound(elems, c, reps, "chain")
    rows["stencil"].update(
        ms=res["stencil_ms"][label],
        max_abs_err=max(v["max_abs"] for k, v in checks.items() if k.startswith("chain ")),
        plain_ms=cuda_ms(lambda: floors.stencil_plain(x, wt, reps), reps=1, warmup=1),
        bound_ms=b_ms, bytes_ms=t_b, ops_ms=t_o, atol=0.0, rtol=floors.STENCIL_RTOL)
    rows["hbm_copy"] = {**r, "replaces": "tools/microbench_floors.py:52",
                        "same_kernel_as": "hbm_copy_flat"}
    emit("floor_probes", nvidia_smi=smi, stencil_checks=checks,
         stencil_rtol=floors.STENCIL_RTOL, copies_bit_equal=True)
    # each stencil run's time on the card (`floors.graph_ms`) against its bound
    bounds = {lb: floors.stencil_bound(n * hh * ww * cc, cc, r, v)[0]
              for lb, v, hh, ww, cc, r, n in floors.STENCIL_RUNS}
    emit("stencil_runs", nvidia_smi=smi, **{
        lb: {"ms": res["stencil_ms"][lb], "events_ms": res["stencil_events_ms"][lb],
             "bound_ms": b, "share_of_bound": b / res["stencil_ms"][lb]}
        for lb, b in bounds.items()})
    # the copies' A/B (`floors --copy-ab 7`): alternating runs, medians and spreads
    emit("copy_ab", nvidia_smi=smi, **floors.copy_ab(7, floors.copy_fns()))
    measured, _ = roofline.achievable_rates(floors.OUT)
    for model in ("v1", "v2", "v3", "v3small"):
        out = {}
        for tag, rates in (("published", roofline.H100), ("achievable", measured)):
            cfg, fl = roofline.floors(model, 256, 2, rates)
            out[tag] = {"total_ms": sum(f["floor_ms"] for f in fl.values()),
                        "floors_ms": {k: f["floor_ms"] for k, f in fl.items()},
                        "binding": {k: f["binding"] for k, f in fl.items()}}
        emit("roofline", model=cfg.variant_name(), batch=256, dtype="bf16", nvidia_smi=smi,
             **out)
    return rows



# -- phase 47: training, QAT, multi-variant serving and warmup ------------------

# Train step on the card against the same step on the CPU: each gradient
# leaf within GRAD_REL x the leaf's absmax (float32 reassociation in cuDNN's
# and MKL's sums; TF32 would miss it by ~10x). Two correct float32 forwards
# can put a ReLU6 input that lies within their rounding of a bound on
# opposite sides of it, and every earlier layer's gradient then moves by up
# to ~2% (V1 1.0-224 at batch 4 has such an element: the port against the
# JAX package on the CPU, 1.9%); so the CPU's step replays the card's clip
# decisions (`clip_masks`) and the comparison holds the backward alone.
GRAD_REL = 1e-4
# serve --variants runs of phase 47: (name, extra flags, variants, the
# kernels each variant's route launches)
MULTI_RUNS = (
    ("bf16", [], (("1.0:224", ("stem_conv", "separable_block", "fused_head", "chain")),
                  ("0.25:128", ("stem_conv", "separable_block", "fused_head", "chain")),
                  ("v2:1.0:224", ("inverted_residual", "separable_block", "fused_head")))),
    ("int8", ["--int8"], (("1.0:224", ("separable_block_i8",)),
                          ("v3:1.0:224", ("v3_block_i8",)))),
)


class _Lines(io.TextIOBase):
    """A stdout that keeps each line with the host time it was written."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


def run_cli(kernels, argv):
    """`cli.main(argv)` in this process, the launch counters set to 0 before;
    returns ([(host time, line)], {kernel: launches}, seconds). A non-zero
    exit raises."""
    from mobilenet_tpu_torch import cli

    for k in kernels.values():
        k.launches = 0
    out = _Lines()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"cli {' '.join(argv)}: exit {e.code}: {out.lines[-3:]}")
    torch.cuda.synchronize()
    return out.lines, {k: v.launches for k, v in kernels.items() if v.launches}, \
        time.perf_counter() - t0


def step_times(lines):
    """ms a step of `cli train` from its JSON lines' host times: the median
    interval after the first step (which sets up cuDNN and cuBLAS)."""
    ts = [t for t, ln in lines if ln.startswith("{")]
    return float(np.median(np.diff(ts[1:]))) * 1e3


@contextlib.contextmanager
def clip_masks(record=None, replay=None):
    """Within: every ReLU / ReLU6 of the plain ops (`ops.conv.
    apply_activation`) appends its gradient mask ((y >= 0) & (y <= 6), the
    clamp's) to `record`, or, with `replay`, takes the next recorded mask
    as its gradient mask while keeping its own value."""
    from mobilenet_tpu_torch.ops import conv

    orig = conv.apply_activation
    masks = iter(replay) if replay is not None else None

    def act(y, relu6):
        out = orig(y, relu6)
        if record is not None:
            record.append(((y >= 0) & (y <= 6) if relu6 else y >= 0).cpu())
        if masks is not None:
            m = next(masks).to(device=y.device, dtype=y.dtype)
            out = out.detach() + (y - y.detach()) * m
        return out

    conv.apply_activation = act
    try:
        yield
    finally:
        conv.apply_activation = orig


def card_step_grads(cfg, folded, x, y, tf32, trainer=True):
    """The loss and gradients of one float32 step on the card, and the clip
    masks of its forward. trainer=True: the program's step (`make_trainer`
    at lr 0; its gradients are left in each leaf's .grad); False: a bare
    autograd step outside any guard (the control). tf32: cuDNN's TF32 and a
    float32 matmul precision of "high" set beforehand, restored after."""
    from mobilenet_tpu_torch.checkpoints import to_device
    from mobilenet_tpu_torch.models import train

    params = to_device(folded, "cuda", torch.float32)
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    masks = []
    prev = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    try:
        with clip_masks(record=masks):
            if trainer:
                loss, _ = train.make_trainer(cfg, params, lr=0.0, weight_decay=0.0)(xt, yt)
                grads = [p.grad for p in train.tree_leaves(params)]
            else:
                leaves = train.tree_leaves(params)
                for p in leaves:
                    p.requires_grad_(True)
                loss = train.cross_entropy_loss(params, xt, yt, cfg)
                grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    return float(loss.detach()), [g.cpu() for g in grads], masks


def cpu_step_grads(cfg, folded, x, y, masks):
    """The same step's loss and gradients on the CPU, the card's clip
    decisions replayed."""
    from mobilenet_tpu_torch.checkpoints import to_device
    from mobilenet_tpu_torch.models import train

    params = to_device(folded, "cpu", torch.float32)
    leaves = train.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with clip_masks(replay=masks):
        loss = train.cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(y), cfg)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def worst_leaf(got, ref) -> float:
    """The largest leaf error over that leaf's absmax."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def qat_tap_checks(smi):
    """QAT taps on the card against the NumPy int8 oracles, bit for bit: V1
    1.0-224 at batch 4; V2, V3-Large and V3-Small 1.0-224 at batch 2 (8
    calibration images)."""
    from mobilenet_tpu_torch import V2Config, V3Config
    from mobilenet_tpu_torch.checkpoints import default_folded, to_device
    from mobilenet_tpu_torch.config import ModelConfig
    from mobilenet_tpu_torch.quant import oracle, qat
    from mobilenet_tpu_torch.quant.quantize import quantize, quantize_input
    from mobilenet_tpu_torch.quant.v2 import forward_all_v2_i8, quantize_v2
    from mobilenet_tpu_torch.quant.v3 import calibrate_v3, forward_all_v3_i8, quantize_v3

    n_cal = 8
    for name, cfg, n in (("v1", ModelConfig(ALPHA, RES), 4), ("v2", V2Config(ALPHA, RES), 2),
                         ("v3", V3Config("large", ALPHA, RES), 2),
                         ("v3small", V3Config("small", ALPHA, RES), 2)):
        folded = default_folded(cfg, seed=0)
        x = np.random.default_rng(47).uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)
        t0 = time.perf_counter()
        if name == "v1":
            fwd = lambda p, xt: qat.qat_forward(p, xt, cfg, collect=True)  # noqa: E731
            ref = oracle.forward_all(quantize(folded, cfg), quantize_input(x), cfg)
        elif name == "v2":
            q = quantize_v2(folded, cfg, n_calib=n_cal)
            s_blk = tuple(float(s) for s in q.s_blk)
            fwd = lambda p, xt: qat.qat_forward_v2(p, xt, cfg, s_blk, collect=True)  # noqa: E731
            ref = forward_all_v2_i8(q, quantize_input(x), cfg)
        else:
            cal = calibrate_v3(folded, cfg, n_images=n_cal)
            q = quantize_v3(folded, cfg, n_calib=n_cal)
            fwd = lambda p, xt: qat.qat_forward_v3(p, xt, cfg, cal, collect=True)  # noqa: E731
            ref = forward_all_v3_i8(q, quantize_input(x), cfg)
        host_s = time.perf_counter() - t0
        with torch.no_grad():
            logits, acts = fwd(to_device(folded, "cuda", torch.float32),
                               torch.from_numpy(x).cuda())
        acts = {**acts, "logits": logits}
        ref_logits, ref_acts = ref
        bad = [k for k, r in {**ref_acts, "logits": ref_logits}.items()
               if not np.array_equal(acts[k].float().cpu().numpy(), r.astype(np.float32))]
        emit("qat_taps", model=name, batch=n, nvidia_smi=smi, taps=len(ref_acts) + 1,
             exact=not bad, mismatched=bad[:8], oracle_and_calibration_s=host_s)
        if bad:
            raise AssertionError(f"QAT {name} 1.0-224 on the card: taps {bad[:4]} differ "
                                 "from the int8 oracle")
        torch.cuda.empty_cache()


async def _tcp_variant_roundtrip(server, variant, res):
    """One NDJSON request naming `variant` and one naming no served
    variant, over an ephemeral localhost port."""
    import base64

    from mobilenet_tpu_torch.runtime.serving import make_tcp_server

    srv = await make_tcp_server(server, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        img = np.random.default_rng(5).integers(0, 256, (res, res, 3), np.uint8)
        for rid, name in ((1, variant), (2, "mobilenet_v9_1.0_224")):
            req = {"id": rid, "shape": list(img.shape), "variant": name,
                   "image_b64": base64.b64encode(img.tobytes()).decode()}
            writer.write((json.dumps(req) + "\n").encode())
        await writer.drain()
        resps = {r["id"]: r for r in [json.loads(await reader.readline()) for _ in range(2)]}
        writer.close()
        return resps, img
    finally:
        srv.close()
        await srv.wait_closed()


def multi_variant_checks(smi, kernels):
    """`cli serve --variants` in bf16 and int8 (0 errors, every route
    kernel launched), then the same deployments built by build_server:
    each variant's selftest and one lone request (bucket 1, where V1 runs
    the chain), the counters set to 0 before and read after (its own
    route's kernels launched), selftest_multi, and for bf16 one TCP round
    trip naming a variant."""
    from mobilenet_tpu_torch.runtime.serving import (
        build_server, config_from_variant, selftest, selftest_multi,
    )

    for name, extra, variants in MULTI_RUNS:
        argv = ["serve", "--variants", ",".join(v for v, _ in variants), "--streams", "64",
                *extra]
        lines, counts, seconds = run_cli(kernels, argv)
        stats = [json.loads(ln) for _, ln in lines if ln.startswith("{")]
        required = sorted({k for _, ks in variants for k in ks})
        emit("serve_variants", run=name, nvidia_smi=smi, seconds=seconds, launches=counts,
             selftests=stats)
        if len(stats) != len(variants) + 1 or any(s["errors"] for s in stats):
            raise AssertionError(f"serve --variants ({name}): {stats}")
        missing = [k for k in required if not counts.get(k)]
        if missing:
            raise AssertionError(f"serve --variants ({name}): {missing} not launched")

        cfgs = {c.variant_name(): c for c in (config_from_variant(v) for v, _ in variants)}

        async def serve():
            server, servers = build_server(cfgs, 64, device="cuda", int8=bool(extra),
                                           multi=True)
            await server.start()
            try:
                per = {}
                for (vname, sub), (_, ks) in zip(servers.items(), variants):
                    for k in kernels.values():
                        k.launches = 0
                    st = await selftest(sub, streams=16, requests_per_stream=4)
                    res = cfgs[vname].resolution
                    await server.submit(np.zeros((res, res, 3), np.uint8), variant=vname)
                    torch.cuda.synchronize()
                    per[vname] = {"errors": sub.stats.errors, "images_per_sec": st["images_per_sec"],
                                  "launches": {k: kernels[k].launches for k in ks}}
                for sub in servers.values():
                    sub.stats.reset_window()
                mixed = await selftest_multi(server, streams=64, requests_per_stream=4)
                tcp = None
                if not extra:
                    second = list(servers)[1]
                    resps, img = await _tcp_variant_roundtrip(server, second,
                                                              cfgs[second].resolution)
                    want = servers[second].pipeline.run_batch(img[None])[0].argmax()
                    tcp = {"variant": second, "top1": resps[1].get("top", [[None]])[0][0],
                           "pipeline_top1": int(want), "unknown": resps[2].get("error")}
                return per, mixed, tcp
            finally:
                await server.close()

        per, mixed, tcp = asyncio.run(serve())
        emit("serve_variants_build", run=name, nvidia_smi=smi, per_variant=per,
             selftest_multi=mixed, tcp=tcp)
        for vname, st in per.items():
            if st["errors"] or not all(st["launches"].values()):
                raise AssertionError(f"{name} variant {vname}: {st}")
        if mixed["errors"]:
            raise AssertionError(f"selftest_multi ({name}): {mixed['errors']} errors")
        if tcp and (tcp["top1"] != tcp["pipeline_top1"] or "unknown variant"
                    not in (tcp["unknown"] or "")):
            raise AssertionError(f"TCP variant round trip: {tcp}")
        torch.cuda.empty_cache()


def warmup_checks(smi):
    """`cli warmup` (V1 1.0-224 bf16, --streams 64: buckets 1, 8, 64) in two
    fresh processes, from a copy of the package whose kernels are not built
    yet: the first builds them (its first bucket "compiled"), the second
    must find every bucket "cached". Seconds of each bucket."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        shutil.copytree(root / "mobilenet_tpu_torch", Path(tmp) / "mobilenet_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for i in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mobilenet_tpu_torch.cli", "warmup", "--alpha",
                 str(ALPHA), "--res", str(RES), "--streams", "64"],
                cwd=tmp, capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            buckets = [(int(m.group(1)), float(m.group(2)), m.group(3)) for m in
                       (re.match(r"warm batch +(\d+): +([\d.]+)s \((\w+)\)", ln) for ln in lines)
                       if m]
            runs.append({"process": i + 1, "seconds": time.perf_counter() - t0,
                         "buckets": buckets, "last_line": lines[-1] if lines else None,
                         "returncode": proc.returncode})
            if proc.returncode != 0:
                raise AssertionError(f"cli warmup: exit {proc.returncode}: {proc.stderr[-2000:]}")
    emit("warmup", nvidia_smi=smi, runs=runs)
    if [b for b, _, _ in runs[0]["buckets"]] != [1, 8, 64]:
        raise AssertionError(f"cli warmup: buckets {runs[0]['buckets']}, not the server's")
    if any(kind != "cached" for _, _, kind in runs[1]["buckets"]):
        raise AssertionError(f"cli warmup: the second process built again: {runs[1]}")
    if runs[0]["buckets"][0][2] != "compiled":
        raise AssertionError("cli warmup: the first process found the kernels built")


def training_phases(smi, kernels):
    """Phase 47: the training path, QAT, multi-variant serving and warmup on
    the card, each part printing its JSON lines.
    (a) one V1 1.0-224 float32 train step at batch 4 on the card (the
        program's trainer) against the same step on the CPU with the card's
        clip decisions (every gradient leaf within GRAD_REL x its absmax),
        again with cuDNN's TF32 allowed and a float32 matmul precision of
        "high" set beforehand, and as a control with those flags and no
        guard around the backward, which must miss the gate (the gate's
        sensitivity); `cli train --steps 5 --batch 32`
        (the loss descends; ms a step and img/s from its lines' host times)
        and the float and QAT trainers' steps at batch 32 timed on the card;
    (b) the QAT taps of V1, V2, V3-Large and V3-Small 1.0-224 against the
        NumPy int8 oracles, bit for bit; `cli train --qat --steps 3 --batch
        16 --out` at V1 1.0-224, its tree through `quantize` into the int8
        pipeline on the card: its taps equal to the oracle's (verify_int8),
        its fused route's logits (separable_block_i8 launched) equal to the
        QAT forward's on the card, top-1 too;
    (c) `serve --variants 1.0:224,0.25:128,v2:1.0:224` (bf16) and `--int8
        --variants 1.0:224,v3:1.0:224`, then the same deployments' variants
        alone, selftest_multi and one TCP round trip naming a variant;
    (d) `cli warmup` in two fresh processes."""
    import tempfile
    from pathlib import Path

    from mobilenet_tpu_torch.checkpoints import default_folded, load_npz, to_device
    from mobilenet_tpu_torch.config import ModelConfig
    from mobilenet_tpu_torch.models import train
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant import qat
    from mobilenet_tpu_torch.quant.model import forward_i8, quantize_for_device, to_device_i8
    from mobilenet_tpu_torch.quant.quantize import ACT_IN_SCALE
    from mobilenet_tpu_torch.quant.verify import verify_int8

    cfg = ModelConfig(ALPHA, RES, compute_dtype="float32")
    folded = default_folded(cfg, seed=0)
    rng = np.random.default_rng(47)
    x = rng.uniform(-1, 1, (4, RES, RES, 3)).astype(np.float32)
    y = rng.integers(0, 16, (4,))

    # (a) the float32 step against the CPU, then with TF32 allowed; the
    # control: TF32 allowed and no guard around the backward
    grads = {}
    for run, tf32, trainer in (("trainer", False, True), ("trainer_tf32_flags", True, True),
                               ("control_unguarded_tf32", True, False)):
        loss_d, g_d, masks = card_step_grads(cfg, folded, x, y, tf32, trainer)
        loss_h, g_h = cpu_step_grads(cfg, folded, x, y, masks)
        rel = worst_leaf(g_d, g_h)
        grads[run] = g_d
        emit("train_grads", run=run, batch=4, nvidia_smi=smi, loss_card=loss_d, loss_cpu=loss_h,
             max_leaf_err_over_absmax=rel, limit=GRAD_REL if trainer else None,
             relu6_masks=len(masks))
        if trainer and not (rel <= GRAD_REL and abs(loss_d - loss_h) <= 1e-5 * abs(loss_h)):
            raise AssertionError(f"train step on the card ({run}): loss {loss_d} against "
                                 f"{loss_h}, a gradient leaf off the CPU's by {rel:.3e} of its "
                                 "absmax")
        if not trainer and not rel > GRAD_REL:
            raise AssertionError("the unguarded TF32 control passed the gradient gate: the "
                                 "gate cannot tell a TF32 backward apart")
    emit("train_grads_tf32_flags_vs_default", nvidia_smi=smi,
         max_leaf_err_over_absmax=worst_leaf(grads["trainer_tf32_flags"], grads["trainer"]))

    size = ["--alpha", str(ALPHA), "--res", str(RES)]
    lines, counts, seconds = run_cli(kernels, ["train", *size, "--steps", "5", "--batch", "32"])
    steps = [json.loads(ln) for _, ln in lines if ln.startswith("{")]
    ms = step_times(lines)
    emit("train_cli", batch=32, nvidia_smi=smi, steps=steps, seconds=seconds,
         ms_per_step=ms, images_per_sec=32e3 / ms, launches=counts)
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"cli train: the loss did not descend: {steps}")

    xb = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (32, RES, RES, 3)).astype(np.float32)).cuda()
    yb = torch.from_numpy(np.random.default_rng(1).integers(0, 16, (32,))).cuda()
    for kind in ("float32", "qat"):
        torch.cuda.reset_peak_memory_stats()
        params = to_device(folded, "cuda", torch.float32)
        step = (train.make_trainer(cfg, params) if kind == "float32"
                else qat.make_qat_trainer(cfg, params))
        step(xb, yb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            loss, _ = step(xb, yb)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / 4 * 1e3
        emit("train_step_time", kind=kind, batch=32, nvidia_smi=smi, ms_per_step=ms_step,
             images_per_sec=32e3 / ms_step, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             loss=float(loss))
        del params, step
        torch.cuda.empty_cache()

    # (b) QAT taps, then cli train --qat, export and serve through int8
    qat_tap_checks(smi)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        out = str(Path(tmp) / "qat.npz")
        lines, counts, seconds = run_cli(
            kernels, ["train", "--qat", *size, "--steps", "3", "--batch", "16", "--out", out])
        steps = [json.loads(ln) for _, ln in lines if ln.startswith("{")]
        emit("train_qat_cli", batch=16, nvidia_smi=smi, steps=steps, seconds=seconds,
             ms_per_step=step_times(lines))
        trained = load_npz(out)
    xq = x[:2]
    verify_out = io.StringIO()
    with contextlib.redirect_stdout(verify_out):
        taps_ok = verify_int8(cfg, trained, xq, device="cuda", oracle="numpy")
    with torch.no_grad():
        qlogits = qat.qat_forward(to_device(trained, "cuda", torch.float32),
                                  torch.from_numpy(xq).cuda(), cfg)
    for k in kernels.values():
        k.launches = 0
    with torch.inference_mode():
        dev = to_device_i8(quantize_for_device(trained, cfg, "auto"), "cuda")
        x_q = qops.quantize_input_dev(torch.from_numpy(xq).cuda(), ACT_IN_SCALE)
        ilogits = forward_i8(dev, x_q, cfg, dw_backend="auto")
    torch.cuda.synchronize()
    served = {k: v.launches for k, v in kernels.items() if v.launches}
    top_q, top_i = qlogits.argmax(-1).tolist(), ilogits.argmax(-1).tolist()
    equal = torch.equal(qlogits.float().cpu(), ilogits.float().cpu())
    emit("train_qat_export", nvidia_smi=smi, verify_int8=taps_ok,
         verify_summary=verify_out.getvalue().strip().splitlines()[-1],
         qat_top1=top_q, int8_top1=top_i, logits_equal=equal, launches=served)
    if not (taps_ok and top_q == top_i and equal and served.get("separable_block_i8")):
        raise AssertionError("the QAT-trained V1 1.0-224 served through int8 on the card "
                             "differs from its QAT forward or the oracle")
    torch.cuda.empty_cache()

    # (c) serving several variants, (d) warmup
    multi_variant_checks(smi, kernels)
    warmup_checks(smi)


# -- phase 48: data, tensor and pipeline parallelism ------------------------------

# The raw partial (separable_block(pw_epilogue=False)) against its plain
# version. float32: golden.MM_TOL (F32_ATOL, F32_RTOL). bf16: both sides
# take the same bf16-rounded depthwise result into the same float32 product,
# and no output rounding follows, so the gap is absolute: the order of the
# float32 sums (~1e-6), or a depthwise value that rounds to its other bf16
# neighbour (one step, ~2^-8 of a value up to 6) times a weight of the data's
# scale, Cin^-0.5. No relative term: an output rounded to bf16 (half a step
# of outputs up to ~3, so up to ~8e-3) must miss it, and the plain output
# rounded so is checked to.
def partial_bf16_atol(cin: int) -> float:
    return 6 * 2 ** -8 / cin ** 0.5


# forward_tp_fused in float32 against the single-device forward: the JAX
# package's tests/test_tp_fused.py (the psum reassociates the pointwise sum).
TP_F32_ATOL, TP_F32_RTOL = 2e-4, 1e-3
PARTIAL_DESIGN = ["mobilenet_tpu_torch/csrc/separable_wgmma.cuh",
                  "mobilenet_tpu_torch/csrc/hopper.cuh"]
SHARED_CARD = "ranks sharing one card: not a scaling figure"
PARTIAL_LIBRARY = ("F.conv2d(groups=C, channels-last, TF-SAME) + bias, clamp_, "
                   "torch.mm(out_dtype=float32)")


def tp_shard_shapes(cfg, tp):
    """(block, H, Cin / tp, Cout, stride) of each block that
    forward_tp_fused's "auto" routes to the kernel at `tp`."""
    from mobilenet_tpu_torch.parallel.tp_fused import _block_cins, tp_routing

    out, hw = [], cfg.resolution // 2
    for i, (r, stride, cin, cout) in enumerate(zip(tp_routing(cfg, tp, "auto"),
                                                   cfg.block_strides, _block_cins(cfg),
                                                   cfg.block_channels)):
        if r == "fused":
            out.append((i, hw, cin // tp, cout, stride))
        hw = -(-hw // stride)
    return out


def partial_work(n, h, cin, cout, stride, kind):
    """(bytes, ops) of one raw partial: block_work's, with a 4-byte output
    and no pointwise bias read."""
    nbytes, ops = block_work(n, h, cin, cout, stride, kind)
    act, _, b, m = ELEM_BYTES[kind]
    ho = -(-h // stride)
    return nbytes + n * ho * ho * cout * (4 - act) - cout * (b + m), ops


def partial_checks(smi, gen, cfg, row):
    """48a: the raw partial at the shard shapes of tp 2 (blocks 4-12) and
    tp 4 (blocks 6-12), batch 256 and 1, bf16 and float32, against its plain
    version; CUDA-event ms of it, of the plain version and of the library
    sequence; the bound. The row sums tp 2's blocks at batch 256 (one
    rank's partials of a forward)."""
    from collections import Counter

    from mobilenet_tpu_torch.ops.conv import no_tf32
    from mobilenet_tpu_torch.ops.separable_block import separable_block, separable_block_plain

    def kfn(*a):
        return separable_block(*a, pw_epilogue=False)

    def pfn(*a):
        return separable_block_plain(*a, pw_epilogue=False)

    for tp in (2, 4):
        shapes = Counter((h, c, co, s) for _, h, c, co, s in tp_shard_shapes(cfg, tp))
        for (h, cin, cout, stride), cnt in shapes.items():
            for n in (256, 1):
                rec = {}
                for tag, dt, atol, rtol in (
                        ("bf16", torch.bfloat16, partial_bf16_atol(cin), 0.0),
                        ("f32", torch.float32, F32_ATOL, F32_RTOL)):
                    args = rand_block(gen, n, h, cin, cout, dt) + (stride, True)
                    got, ref = kfn(*args), pfn(*args)
                    torch.cuda.synchronize()
                    if got.dtype != torch.float32:
                        raise AssertionError(f"raw partial: output {got.dtype}, not float32")
                    name = f"separable_block[partial] tp{tp} ({n},{h},{h},{cin})->{cout} {tag}"
                    err = compare(name, got, ref, atol, rtol)
                    if tag == "bf16":  # the planted control: a bf16-rounded output
                        ctrl = float((ref.to(dt).float() - ref).abs().max())
                        if ctrl <= atol:
                            raise AssertionError(f"{name}: the bf16-rounded control "
                                                 f"({ctrl:.3e}) passes atol {atol:.3e}")
                    kms, pms = cuda_ms(lambda: kfn(*args)), cuda_ms(lambda: pfn(*args))
                    with no_tf32(args[0]):
                        lms = cuda_ms(separable_library(*args, pw_epilogue=False))
                    b_ms, b_by, t_b, t_o = bound(*partial_work(n, h, cin, cout, stride, tag), tag)
                    rec[tag] = dict(max_abs_err=err, atol=atol, rtol=rtol, ms=kms, plain_ms=pms,
                                    library_ms=lms, bound_ms=b_ms, bound_by=b_by)
                    if tag == "bf16":
                        rec[tag]["control_max_abs_err"] = ctrl
                    key = "max_abs_err" if tag == "bf16" else "max_abs_err_f32"
                    row[key] = max(row[key], err)
                    sums = {}
                    if (tp, n, tag) == (2, 256, "bf16"):
                        sums = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                                    bytes_ms=t_b, ops_ms=t_o)
                    elif (tp, n, tag) == (2, 256, "f32"):
                        sums = dict(f32_ms=kms, f32_plain_ms=pms, f32_library_ms=lms,
                                    f32_bound_ms=b_ms)
                    elif (tp, n, tag) == (4, 256, "bf16"):
                        sums = dict(tp4_ms=kms, tp4_bound_ms=b_ms, tp4_library_ms=lms)
                    elif (tp, n, tag) == (2, 1, "bf16"):
                        sums = dict(b1_ms=kms, b1_bound_ms=b_ms, b1_library_ms=lms)
                    for k, v in sums.items():
                        row[k] = row.get(k, 0.0) + cnt * v
                    del args, got, ref
                emit("parallel_kernel", kernel="separable_block[partial]", tp=tp,
                     shape=f"({n},{h},{h},{cin})->{cout} s{stride}", count_per_forward=cnt,
                     nvidia_smi=smi, **rec)
            torch.cuda.empty_cache()
    row["library"] = PARTIAL_LIBRARY


def near_tie_flips(got, ref, atol):
    """Rows whose top-1 differs; raises unless the two classes are within
    `atol` of each other in `ref` (check_routes' rule)."""
    top_g, top_r = got.argmax(-1), ref.argmax(-1)
    flips = (top_g != top_r).nonzero().flatten().tolist()
    for i in flips:
        gap = float(ref[i, top_r[i]] - ref[i, top_g[i]])
        if gap > atol:
            raise AssertionError(f"row {i}: top-1 {int(top_g[i])} vs {int(top_r[i])}, "
                                 f"gap {gap:.3e}")
    return len(flips)


def reset(kernels):
    from mobilenet_tpu_torch.ops.separable_block import separable_block

    for k in kernels.values():
        k.launches = 0
    separable_block.partial_launches = 0


def tp_checks(smi, cfg, kernels, launches, imgs):
    """48b-c: forward_tp_fused (bf16 batch 256 and float32 batch 8) and
    forward_i8_tp (batch 64) at V1 1.0-224 on ranks that share the card."""
    from mobilenet_tpu_torch import ModelConfig
    from mobilenet_tpu_torch.checkpoints import default_folded, to_device
    from mobilenet_tpu_torch.models import mobilenet_v1
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.ops.separable_block import separable_block
    from mobilenet_tpu_torch.parallel.mesh import make_mesh
    from mobilenet_tpu_torch.parallel.tp_fused import (forward_tp_fused, shard_params_tp_fused,
                                                       tp_routing)
    from mobilenet_tpu_torch.quant import ops as qops
    from mobilenet_tpu_torch.quant.model import Int8Pipeline, forward_i8
    from mobilenet_tpu_torch.quant.quantize import ACT_IN_SCALE
    from mobilenet_tpu_torch.quant.tp import forward_i8_tp, shard_dev_i8_tp

    host = default_folded(cfg, seed=0)
    cfg32 = ModelConfig(ALPHA, RES, compute_dtype="float32")
    for tag, dt, c, n in (("bf16", torch.bfloat16, cfg, 256), ("f32", torch.float32, cfg32, 8)):
        params = to_device(host, "cuda", dt)
        x = preprocess(imgs[:n], RES, dt)
        single = mobilenet_v1.forward(params, x, c, dw_backend="auto").float()
        scale = float(single.abs().max())
        for dp, tp in ((1, 2), (1, 4), (2, 2)):
            mesh = make_mesh(dp * tp, tp, devices=["cuda:0"] * (dp * tp))
            sharded = shard_params_tp_fused(params, mesh)
            reset(kernels)
            out = forward_tp_fused(sharded, x, c, mesh)
            torch.cuda.synchronize()
            n_part = separable_block.partial_launches
            fused = tp_routing(c, tp, "auto").count("fused")
            if n_part != fused * tp * dp:
                raise AssertionError(f"forward_tp_fused dp {dp} tp {tp}: {n_part} partial "
                                     f"launches, not {fused} x {tp} x {dp}")
            if (tag, dp, tp) == ("bf16", 1, 2):
                launches["separable_block[partial]"] = n_part
            other = {k: v.launches - (n_part if k == "separable_block" else 0)
                     for k, v in kernels.items() if v.launches}
            name = f"forward_tp_fused {tag} dp {dp} tp {tp}"
            if tag == "bf16":
                atol, rtol = max(ROUTE_ATOL, ROUTE_REL * scale), 0.0
            else:
                atol, rtol = TP_F32_ATOL, TP_F32_RTOL
            err = compare(name, out, single, atol, rtol)
            flips = near_tie_flips(out, single, atol)
            if tag == "f32" and flips:
                raise AssertionError(f"{name}: top-1 differs in {flips} rows")
            ms = cuda_ms(lambda: forward_tp_fused(sharded, x, c, mesh), reps=3, warmup=1)
            emit("parallel_tp", dtype=tag, dp=dp, tp=tp, batch=n, max_abs_err=err, atol=atol,
                 rtol=rtol, logits_absmax=scale, top1_agree=n - flips, rows=n,
                 partial_launches=n_part, fused_blocks=fused, other_launches=other,
                 ms=ms, img_per_s=n / ms * 1e3, timing=SHARED_CARD, nvidia_smi=smi)
            del sharded, out
            torch.cuda.empty_cache()
        del params, x, single
    # 48c: int8 channel-TP, bit-equal to the single-device int8 forward
    pipe8 = Int8Pipeline(cfg, device="cuda")
    x_q = qops.quantize_input_dev(preprocess(imgs[:64], RES, torch.float32), ACT_IN_SCALE)
    single = forward_i8(pipe8.dev, x_q, cfg, dw_backend="plain")
    fused = forward_i8(pipe8.dev, x_q, cfg, dw_backend="auto")
    for tp in (2, 4):
        mesh = make_mesh(tp, tp, devices=["cuda:0"] * tp)
        arrays, six = shard_dev_i8_tp(pipe8.dev, mesh)
        out = forward_i8_tp(arrays, six, x_q, cfg, mesh)
        torch.cuda.synchronize()
        equal = torch.equal(out, single)
        ms = cuda_ms(lambda: forward_i8_tp(arrays, six, x_q, cfg, mesh), reps=3, warmup=1)
        emit("parallel_tp_int8", tp=tp, batch=64, equal_to_forward_i8=equal,
             equal_to_fused_route=torch.equal(out, fused), ms=ms, img_per_s=64 / ms * 1e3,
             timing=SHARED_CARD, nvidia_smi=smi)
        if not equal:
            raise AssertionError(f"forward_i8_tp tp {tp}: logits differ from forward_i8, "
                                 f"max {float((out - single).abs().max()):.3e}")
        del arrays
    del pipe8
    torch.cuda.empty_cache()


def host_img_per_s(pipe, imgs, reps=3):
    pipe.run_batch(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pipe.run_batch(imgs)
    return reps * len(imgs) / (time.perf_counter() - t0)


def dp_checks(smi, cfg, kernels, imgs):
    """48d: the data-parallel pipelines on two ranks of the card against the
    single-device ones, a 64-stream selftest through build_server(mesh=),
    `cli serve --dp 2` refused on a one-card machine, `cli warmup --dp 1`."""
    from mobilenet_tpu_torch import InferencePipeline, V2Config, V3Config, cli
    from mobilenet_tpu_torch.parallel.mesh import make_mesh
    from mobilenet_tpu_torch.quant.model import Int8Pipeline
    from mobilenet_tpu_torch.quant.v3 import Int8PipelineV3
    from mobilenet_tpu_torch.runtime.serving import build_server, selftest

    mesh = make_mesh(2, devices=["cuda:0"] * 2)
    batch = imgs[:64].cpu().numpy()
    cases = (
        ("v1 bf16", False, lambda m, q: InferencePipeline(cfg, device="cuda", mesh=m)),
        ("v1 int8", True, lambda m, q: Int8Pipeline(cfg, device="cuda", mesh=m)),
        ("v2 bf16", False, lambda m, q: InferencePipeline(
            V2Config(ALPHA, RES, compute_dtype="bfloat16"), device="cuda", mesh=m)),
        ("v3 int8", True, lambda m, q: Int8PipelineV3(V3Config("large", ALPHA, RES),
                                                      device="cuda", quantized=q, mesh=m)),
    )
    for name, exact, build in cases:
        one = build(None, None)
        dp = build(mesh, getattr(one, "q", None))
        a, b = one.run_batch(batch), dp.run_batch(batch)
        diff = float(np.abs(a - b).max())
        rec = dict(model=name, batch=64, ranks=2, bit_equal=bool(np.array_equal(a, b)),
                   max_abs_prob_diff=diff)
        if exact and not rec["bit_equal"]:
            raise AssertionError(f"DP {name}: probabilities differ from one device, {diff:.3e}")
        if not exact:
            if diff > ROUTE_ATOL:
                raise AssertionError(f"DP {name}: probabilities {diff:.3e} from one device")
            rec["top1_agree"] = 64 - near_tie_flips(torch.from_numpy(b), torch.from_numpy(a),
                                                    ROUTE_ATOL)
        rec.update(img_per_s_dp=host_img_per_s(dp, batch), img_per_s_one=host_img_per_s(one, batch),
                   timing=SHARED_CARD + " (host uint8 to host probabilities)", nvidia_smi=smi)
        if name == "v1 bf16":  # benchmark() splits its batches too
            bench = dp.benchmark(batch_size=64, steps=5, warmup=1, latency_iters=3)
            rec["benchmark_dp"] = {k: bench[k] for k in (
                "images_per_sec", "e2e_images_per_sec", "latency_batch", "p50_latency_ms")}
        emit("parallel_dp", **rec)
        del one, dp
        torch.cuda.empty_cache()

    reset(kernels)

    async def serve():
        server, _ = build_server({cfg.variant_name(): cfg}, 64, mesh=mesh)
        await server.start()
        try:
            stats = await selftest(server, streams=64, requests_per_stream=4)
            stats["buckets"] = server.batch_buckets
            return stats
        finally:
            await server.close()

    stats = asyncio.run(serve())
    torch.cuda.synchronize()
    got = {k: v.launches for k, v in kernels.items() if v.launches}
    emit("parallel_dp_serving", launches=got, timing=SHARED_CARD, nvidia_smi=smi, **stats)
    if stats["errors"] or stats["buckets"] != [2, 8, 64]:
        raise AssertionError(f"DP serving: {stats['errors']} errors, buckets {stats['buckets']}")
    for k in ("stem_conv", "separable_block", "fused_head", "chain"):
        if not got.get(k):
            raise AssertionError(f"DP serving: {k} never launched")

    try:
        with contextlib.redirect_stdout(_Lines()):
            cli.main(["serve", "--dp", "2", "--streams", "8"])
        refused = None
    except SystemExit as e:
        refused = str(e.code)
    if torch.cuda.device_count() < 2 and (refused is None or "make_mesh: need 2" not in refused):
        raise AssertionError(f"cli serve --dp 2 on one card: {refused!r}")
    lines, got, secs = run_cli(kernels, ["warmup", "--dp", "1", "--alpha", str(ALPHA), "--res",
                                         str(RES), "--streams", "64"])
    emit("parallel_cli", serve_dp2=refused, warmup_dp1=[ln for _, ln in lines],
         warmup_launches=got, seconds=secs, nvidia_smi=smi)
    if not lines or not lines[-1][1].startswith("WARMUP OK"):
        raise AssertionError(f"cli warmup --dp 1: {lines[-3:]}")


def pp_checks(smi, kernels, imgs):
    """48e: forward_pp of V1, V2, V3-Large and V3-Small at 1.0-224 (bf16,
    batch 64, S 4 on four ranks of the card, M 8, "auto") against the
    single-device forward on each microbatch."""
    from mobilenet_tpu_torch import ModelConfig, V2Config, V3Config
    from mobilenet_tpu_torch.checkpoints import default_folded, to_device
    from mobilenet_tpu_torch.models import mobilenet_v1, mobilenet_v2, mobilenet_v3
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.parallel.pp import forward_pp, make_pipe_mesh, plan_stages

    mesh = make_pipe_mesh(4, ["cuda:0"] * 4)
    cases = (
        (ModelConfig(ALPHA, RES, compute_dtype="bfloat16"), mobilenet_v1.forward,
         ("stem_conv", "separable_block", "fused_head")),
        (V2Config(ALPHA, RES, compute_dtype="bfloat16"), mobilenet_v2.forward_v2,
         ("separable_block", "inverted_residual", "fused_head")),
        (V3Config("large", ALPHA, RES, compute_dtype="bfloat16"), mobilenet_v3.forward_v3,
         ("v3_block", "fused_head")),
        (V3Config("small", ALPHA, RES, compute_dtype="bfloat16"), mobilenet_v3.forward_v3,
         ("v3_block", "fused_head")),
    )
    for c, fwd, required in cases:
        params = to_device(default_folded(c, seed=0), "cuda", torch.bfloat16)
        x = preprocess(imgs[:64], RES, torch.bfloat16)
        bounds = plan_stages(c, params, 4)
        with torch.inference_mode():
            reset(kernels)
            out = forward_pp(params, x, c, mesh, n_microbatches=8)
            torch.cuda.synchronize()
            got = {k: v.launches for k, v in kernels.items() if v.launches}
            ref = torch.cat([fwd(params, mb, c, dw_backend="auto").float() for mb in x.split(8)])
            atol = max(ROUTE_ATOL, ROUTE_REL * float(ref.abs().max()))
            err = compare(f"forward_pp {c.variant_name()}", out, ref, atol, 0.0)
            ms = cuda_ms(lambda: forward_pp(params, x, c, mesh, n_microbatches=8), reps=3,
                         warmup=1)
        emit("parallel_pp", model=c.variant_name(), stages=4, microbatches=8, batch=64,
             bounds=bounds, bit_equal=bool(torch.equal(out, ref)), max_abs_err=err, atol=atol,
             launches=got, ms=ms, img_per_s=64 / ms * 1e3, timing=SHARED_CARD, nvidia_smi=smi)
        for k in required:
            if not got.get(k):
                raise AssertionError(f"forward_pp {c.variant_name()}: {k} never launched")
        del params, x, out, ref
        torch.cuda.empty_cache()


def pp_clip_masks(records, counts, n_micro):
    """The clip masks recorded in a GPipe forward (stage s runs microbatch
    t - s at step t and makes counts[s] records a microbatch), regrouped
    into a single-device forward's order: layer by layer, the
    microbatches' masks concatenated."""
    per_mb = [[] for _ in range(n_micro)]
    it = iter(records)
    for t in range(n_micro + len(counts) - 1):
        for s, cnt in enumerate(counts):
            if 0 <= t - s < n_micro:
                per_mb[t - s].extend(next(it) for _ in range(cnt))
    if next(it, None) is not None:
        raise AssertionError("pp_clip_masks: more records than the schedule makes")
    return [torch.cat(layer) for layer in zip(*per_mb)]


def pp_train_checks(smi, imgs):
    """48f: pp_train_step of V1 1.0-224 (float32, batch 8, S 4, M 4) against
    one single-device SGD step on the whole batch that replays the
    pipelined forward's ReLU6 clip decisions (phase 47's caveat: two
    correct float32 forwards, here at batch 2 and batch 8, can put an input
    within their rounding of a bound on opposite sides of it)."""
    from mobilenet_tpu_torch import ModelConfig
    from mobilenet_tpu_torch.checkpoints import default_folded, to_device
    from mobilenet_tpu_torch.models.train import sgd_train_step, tree_leaves
    from mobilenet_tpu_torch.ops.preprocess import preprocess
    from mobilenet_tpu_torch.parallel.pp import (_units_for, make_pipe_mesh, plan_stages,
                                                 pp_train_step)

    S, M, B = 4, 4, 8
    mesh = make_pipe_mesh(S, ["cuda:0"] * S)
    cfg32 = ModelConfig(ALPHA, RES, compute_dtype="float32")
    params = to_device(default_folded(cfg32, seed=0), "cuda", torch.float32)
    x = preprocess(imgs[:B], RES, torch.float32)
    labels = torch.from_numpy(np.random.default_rng(48).integers(0, 1000, B)).cuda()
    # lr 1: the update, not the float32 rounding of w - lr * g, holds the comparison
    lr = 1.0
    t0 = time.perf_counter()
    new, loss = pp_train_step(params, x, labels, cfg32, mesh, lr=lr, n_microbatches=M)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    # the records each stage makes for one microbatch, then the step again
    # with its clip masks recorded
    _, _, _, run = _units_for(cfg32, params, "plain", B // M)
    counts, y = [], x[:B // M]
    with torch.no_grad():
        for start, stop in plan_stages(cfg32, params, S):
            rec = []
            with clip_masks(record=rec):
                y = run(params, y, start, stop)
            counts.append(len(rec))
    pp_rec, whole_rec = [], []
    with clip_masks(record=pp_rec):
        pp_train_step(params, x, labels, cfg32, mesh, lr=lr, n_microbatches=M)
    pp_masks = pp_clip_masks(pp_rec, counts, M)
    with clip_masks(record=whole_rec):
        whole_new, whole_loss = sgd_train_step(params, x, labels, cfg32, lr=lr)
    if [m.shape for m in whole_rec] != [m.shape for m in pp_masks]:
        raise AssertionError("pp_train_step: the two forwards' clip records do not align")
    flips = sum(int((a != b).sum()) for a, b in zip(pp_masks, whole_rec))
    with clip_masks(replay=pp_masks):
        ref_new, ref_loss = sgd_train_step(params, x, labels, cfg32, lr=lr)
    # each updated leaf within GRAD_REL x the reference's update absmax,
    # plus the float32 rounding of w - lr * g (2 eps x |w'|)
    eps = torch.finfo(torch.float32).eps
    worst = worst_whole = 0.0
    for p, n_ref, n_pp, n_whole in zip(tree_leaves(params), tree_leaves(ref_new),
                                       tree_leaves(new), tree_leaves(whole_new)):
        tol = GRAD_REL * float((p - n_ref).abs().max()) + 2 * eps * float(n_ref.abs().max())
        worst = max(worst, float((n_pp - n_ref).abs().max()) / tol)
        worst_whole = max(worst_whole, float((n_pp - n_whole).abs().max()) / tol)
    rel_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    emit("parallel_pp_train", stages=S, microbatches=M, batch=B, lr=lr, loss=float(loss),
         ref_loss=float(ref_loss), whole_batch_loss=float(whole_loss), loss_rel=rel_loss,
         clip_records_per_stage=counts, clip_decisions=sum(m.numel() for m in pp_masks),
         clip_decisions_differing=flips, worst_leaf_of_tol=worst,
         worst_leaf_of_tol_without_replay=worst_whole, grad_rel=GRAD_REL, step_s=pp_s,
         nvidia_smi=smi)
    if not np.isfinite(float(loss)) or rel_loss > GRAD_REL or worst > 1.0:
        raise AssertionError(f"pp_train_step: loss {float(loss)} vs {float(ref_loss)}, worst "
                             f"leaf at {worst:.3f} of its tolerance (GRAD_REL {GRAD_REL})")
    del params, new, whole_new, ref_new, pp_masks, pp_rec, whole_rec
    torch.cuda.empty_cache()


def parallel_phases(smi, gen, kernels, launches):
    """Phase 48: data, tensor and pipeline parallelism on ranks that share
    the one card (`devices=["cuda:0"] * n`). Returns the raw partial's row
    of the kernels line."""
    from mobilenet_tpu_torch import ModelConfig

    cfg = ModelConfig(ALPHA, RES, compute_dtype="bfloat16")
    row = {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/separable_block.cu",
           "design": PARTIAL_DESIGN, "float32_design": SEP_F32_DESIGN,
           "replaces": "mobilenet_tpu/ops/pallas_block.py:217",
           "mode": "pw_epilogue=False (mobilenet_tpu/ops/pallas_block.py:300-304)",
           **FLOAT_ROW, "library_ms": 0.0,
           "row_sums": "tp 2's kernel blocks 4-12, batch 256, one rank"}
    partial_checks(smi, gen, cfg, row)
    imgs = torch.from_numpy(np.random.default_rng(480).integers(
        0, 256, (256, RES, RES, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        tp_checks(smi, cfg, kernels, launches, imgs)
        dp_checks(smi, cfg, kernels, imgs)
    pp_checks(smi, kernels, imgs)
    pp_train_checks(smi, imgs)
    return {"separable_block[partial]": row}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from mobilenet_tpu_torch import InferencePipeline, ModelConfig
    from mobilenet_tpu_torch.models import mobilenet_v1
    from mobilenet_tpu_torch.ops import _build
    from mobilenet_tpu_torch.ops.chain import chain, chain_plain
    from mobilenet_tpu_torch.ops.depthwise import depthwise
    from mobilenet_tpu_torch.ops.depthwise_i8 import depthwise_i8
    from mobilenet_tpu_torch.block_times import head_library
    from mobilenet_tpu_torch.ops.head import fused_head, fused_head_plain
    from mobilenet_tpu_torch.ops.inverted_residual import inverted_residual
    from mobilenet_tpu_torch.ops.inverted_residual_i8 import inverted_residual_i8
    from mobilenet_tpu_torch.ops.separable_block import (
        separable_block, separable_block_plain,
    )
    from mobilenet_tpu_torch.ops.separable_block_i8 import separable_block_i8
    from mobilenet_tpu_torch.ops.stem import stem_block0, stem_conv
    from mobilenet_tpu_torch.ops.v3_block import v3_block
    from mobilenet_tpu_torch.ops.v3_block_i8 import v3_block_i8
    from mobilenet_tpu_torch.ops.v3_chain import v3_chain

    # -- 1. card, versions, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_lines(_build.build_log)
    emit("build", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         build_s=build_s, nvcc_seconds=_build.build_seconds, ptxas=ptxas)

    # -- 2. kernels vs plain at main-path shapes --------------------------------
    cfg = ModelConfig(ALPHA, RES, compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {
        "separable_block": {"route": "cuda",
                            "source": "mobilenet_tpu_torch/csrc/separable_block.cu",
                            "float32_design": SEP_F32_DESIGN,
                            "replaces": "mobilenet_tpu/ops/pallas_block.py:217",
                            "also_replaces": [
                                "mobilenet_tpu/ops/pallas_block_packed.py:132",
                                "mobilenet_tpu/ops/pallas_block_packed.py:371",
                                "mobilenet_tpu/ops/pallas_block_packed_mxu.py:264"]},
        "fused_head": {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/fused_head.cu",
                       "design": HEAD_DESIGN, "float32_design": HEAD_F32_DESIGN,
                       "replaces": "mobilenet_tpu/ops/pallas_head.py:168"},
        "chain": {"route": "cuda", "source": "mobilenet_tpu_torch/csrc/chain.cu",
                  "float32_design": SEP_F32_DESIGN,
                  "replaces": "mobilenet_tpu/ops/pallas_chain_systolic.py:120",
                  "also_replaces": ["mobilenet_tpu/ops/pallas_chain.py:74"]},
    }
    for s in summary.values():
        s.update(FLOAT_ROW)
    summary["separable_block"].update(library_ms=0.0, library=SEPARABLE_LIBRARY)
    summary["fused_head"].update(library_ms=0.0, library=HEAD_LIBRARY)

    for nm, n, h, cin, cout, stride, cnt in block_shapes(cfg, 256):
        mk = lambda dt: rand_block(gen, n, h, cin, cout, dt) + (stride, True)  # noqa: E731
        check_float(summary, "separable_block", f"{nm} ({n},{h},{h},{cin})->{cout} s{stride}",
                    cnt, separable_block, separable_block_plain, mk(torch.float32),
                    mk(torch.bfloat16), lambda kind: block_work(n, h, cin, cout, stride, kind),
                    separable_library)
        torch.cuda.empty_cache()
    hw, c = cfg.final_spatial, cfg.feature_channels
    for n in (256, 1):
        mk = lambda dt: rand_head(gen, n, hw, c, None, [(cfg.num_classes, "linear")], dt)  # noqa: E731
        check_float(summary, "fused_head", f"({n},{hw},{hw},{c})->{cfg.num_classes}",
                    int(n == 256), fused_head, fused_head_plain, mk(torch.float32),
                    mk(torch.bfloat16),
                    lambda kind: head_work(n, hw, c, None, [cfg.num_classes], kind), head_library)
    check_head_smem(gen)
    hc, cc = RES // 16, cfg.block_channels[6]
    mkc = lambda dt: rand_block(gen, 1, hc, cc, cc, dt, k=5) + (True,)  # noqa: E731
    check_float(summary, "chain", f"(1,{hc},{hc},{cc}) x5", 1, chain, chain_plain,
                mkc(torch.float32), mkc(torch.bfloat16),
                lambda kind: block_work(1, hc, cc, cc, 1, kind, k=5))
    f32_separable_checks(summary, gen, cfg)

    # -- 3. pipeline: kernel route vs plain route ---------------------------------
    pipe = InferencePipeline(cfg, device="cuda")
    check_routes(pipe, mobilenet_v1.forward, ModelConfig(ALPHA, RES, compute_dtype="float32"),
                 F32_ATOL, F32_RTOL)

    # -- 4. benchmark ----------------------------------------------------------
    bench = pipe.benchmark(batch_size=256, steps=40)
    emit("benchmark", route="auto", nvidia_smi=smi, **bench)
    plain = InferencePipeline(cfg, device="cuda", dw_backend="plain")
    emit("benchmark", route="plain", nvidia_smi=smi,
         **plain.benchmark(batch_size=256, steps=10))
    del plain
    torch.cuda.empty_cache()

    # -- 5. the float main path: 64-stream server -------------------------------
    kernels = {"separable_block": separable_block, "fused_head": fused_head,
               "chain": chain, "separable_block_i8": separable_block_i8,
               "depthwise_i8": depthwise_i8, "inverted_residual": inverted_residual,
               "inverted_residual_i8": inverted_residual_i8, "v3_block": v3_block,
               "v3_block_i8": v3_block_i8, "depthwise": depthwise,
               "stem_block0": stem_block0, "stem_conv": stem_conv, "v3_chain": v3_chain}
    launches = serve_main_path(pipe, kernels,
                               ("stem_conv", "separable_block", "fused_head", "chain"),
                               "serving", smi)
    del pipe
    torch.cuda.empty_cache()

    # -- 6-9. the int8 path -------------------------------------------------------
    summary.update(int8_phases(smi, kernels, launches))

    # -- 10-13. the V2 float path ---------------------------------------------------
    summary.update(v2_phases(smi, gen, kernels, launches))

    # -- 14-17. the V2 int8 path ----------------------------------------------------
    summary.update(v2_int8_phases(smi, kernels, launches))

    # -- 18-21. the V3-Large float path -----------------------------------------------
    summary.update(v3_phases(smi, gen, kernels, launches))

    # -- 22-25. the V3-Small float path -----------------------------------------------
    summary.update(v3_phases(smi, gen, kernels, launches, variant="small"))

    # -- 26-30. the V3-Large int8 path ------------------------------------------------
    summary.update(v3_int8_phases(smi, kernels, launches))

    # -- 31-33. the depthwise kernel, the V1 "dw" route and cli verify ----------------------
    summary.update(dw_phases(smi, gen, kernels, launches))

    # -- 34-37. the V3-Small int8 path ------------------------------------------------
    summary.update(v3small_int8_phases(smi, kernels, launches))

    # -- 38-41. the stem kernels and the fused-stem path ----------------------------------
    summary.update(stem_phases(smi, gen, kernels, launches))

    # -- 42-44. the V3 chain kernel and the chained V3 routes ------------------------------
    summary.update(v3_chain_phases(smi, gen, kernels, launches))

    # -- 45. the floor probes and the roofline floors ---------------------------------------
    summary.update(floor_phases(smi, launches))

    # -- 46. the accuracy path: cli export, eval and classify -------------------------------
    accuracy_phases(smi, kernels)

    # -- 47. training, QAT, serve --variants and warmup ---------------------------------------
    training_phases(smi, kernels)

    # -- 48. data, tensor and pipeline parallelism ------------------------------------------
    summary.update(parallel_phases(smi, gen, kernels, launches))
    float32_device_times()
    for k, s in summary.items():
        s["bound_by"] = "bytes" if s.pop("bytes_ms") >= s.pop("ops_ms") else "operations"

    print(json.dumps({"kernels": [
        {"name": k, **summary[k], "launches": launches[k]} for k in summary]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
