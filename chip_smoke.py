#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffsplitting_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each kernel against its plain
PyTorch version at the shapes the serving paths give it, then serves joint-InDI
tiled splitting at full width (configs/splitting_hagen_indi_joint.json: patch
512, batch 8, 3 steps, seeded random weights) on two synthetic 1024² frames,
twice: through the UNet's own forward (GroupNorm+Swish and attention kernels),
and through the stat-carried fused forward (`fused=True`, as DSP_FUSED=1: the
conv+GroupNorm kernel at every ResnetBlock and upsample conv, attention, and
GroupNorm+Swish at the head). For each it checks that every kernel of the path
was launched, that the output is finite and of the right shape, and that it
agrees with the same path run through the plain versions (or with the
unfused slice) and, on a small input, with the port on the CPU. It also serves
configs/splitting_cifar10_indi.json at its own width and patch (32², so
attention at N = 16 tokens), again with inner_channel 32 (attention at
D = 256 through the wide tensor-core kernel; the fused walk plans its wide
conv sites to library ops), and with inner_channel 8 and 8 groups (D = 64,
the narrow tensor-core kernel), unfused and fused, against the port on the
CPU. The D = 128 attention kernel (the Hagen mid block, N = 4096) is held
against its plain version at B = 1, 2, 4 and 8 with its key-split plan logged,
two launches and a CUDA-graph replay bit-identical at B = 2, 4, 8 and at the
CIFAR path's N = 16, and timed by host loop and by CUDA-graph device time
beside SDPA. The attention kernels at other head dims are also held against their
plain version and timed beside it and SDPA, each on its route, at D = 16 ...
1024 (D = 192 on the wide kernel with a chunk of O past D; N = 4096 at D = 64
and 192, the Hagen mid block at inner 8 and 24) and at the SR3 / DDPM
configs' own shapes; the wide kernel's plan is logged at each, and its
error against f64 and a CUDA-graph replay's bits are held too.

Then it trains: the joint-InDI train step at full width (patch 512, batch 4,
the config's) with the kernels against the same step through the plain
versions (loss, grad_norm, every gradient), 58 GN+Swish and 2 attention
launches a step asserted, a small step on the card against the port on the
CPU, 30 steps on one batch (ms a step, samples/s, peak memory, a falling
loss) and one step's device time by family. Last, the training loop
(`phase_train_loop`): the port's split.py at the same width on seeded
synthetic frames, 10 iterations on the device pool and 10 more resumed from
the I10 checkpoint on the host loader (validation, checkpoint pairs and
launches asserted), an exact resume (state and one step, bit for bit, against
the model that never stopped), the loop's it/s, peak memory and idle share on
each data path, and `-p val` from the I20 checkpoint.

Then the time predictor (`phase_time_predictor`,
configs/splitting_hagen_time_predictor.json at its widths, dropout 0.2):
its forward with the kernels against the plain versions at B = 8 and 1,
attention at B = 1 beside SDPA, one train step against the plain versions
with the same dropout masks, ms a step and peak memory, and
`time_prediction_training.start_training` on synthetic frames with its best
checkpoint reloaded; and the t-refinement workflow (`phase_t_refinement`)
on the Hagen joint config at patch 512, batch 8, 10 steps, with the kernels
against the plain versions (classifier t̂, consensus t, PSNRs), UNet
forwards by batch and launches asserted for each t_true, the joint
outputs from the refined start held to differ from those from 0.5, and
each stage's host time.

Then the serving accelerators on the same config with the t-refinement
phase's trained joint weights, N = 10: DeepCache (`phase_deepcache`, depth
1, the slice's frames) with tiles/s and peak memory beside the exact chain's
unfused and fused, the launches of its full and shallow passes asserted, the
kernels against the plain versions, interval 1 against the exact chain and
PSNR(cached, exact); and the sliding window (`phase_sliding_window`, W = 8
on one tile at batch 1) at τ = 0 against the exact chain and the plain
versions, its sweeps, seconds a chain and PSNR at τ = 0 and 0.1.

Then SR3 / DDPM super-resolution (`phase_sr3`) at the full width of
configs/sr_sr3_16_128.json (97,807,491 parameters, seeded weights) on
seeded synthetic LR/HR/SR triples written through the port's prepare_data:
a forward at batch 1 and 4 and the fused walk against the plain versions and
the unfused forward, GN+Swish at each of its 55 calls' shapes and conv_gn at
each site of its fused walk, the port's infer.py over the full 2000-step
schedule unfused and fused with the launches of every forward asserted,
seconds a chain, forwards/s, peak memory and the device-idle share of those
chains, DDPM through infer.py and an unconditional sample through sample.py
(each cut to 50 steps, logged; sample.py again with `--ddim 10`), one sr3
train step at
batch 4 against the plain versions and 10 timed steps, and eval.py on the
written PNGs.

Then SR3 at bf16 (`phase_sr3_512`): configs/sr_sr3_64_512.json (infer.py's
default config) at its full width (155,334,339 parameters, seeded weights),
in its compute dtype bfloat16 with remat, on synthetic 64 -> 512 triples:
infer.py's full 2000-step chain unfused (35 bf16 GN+Swish and 1 bf16
attention launches a forward) and with DSP_FUSED=1 (11 bf16 conv_gn, 1 bf16
GN+Swish, 1 bf16 attention a forward; 27 conv sites on library ops), the
idle share of each from a profiled cut chain, that chain each way and one
forward each way with the kernels against the plain versions, both forwards
against the f32 forward of the same weights and the fused against the
unfused, the bf16 GN+Swish kernel at each of its shapes (C = 64 ... 2048)
and the f32 one at C = 1536 and 2048, the bf16 attention kernel at D = 1024
(B = 1, 2), 512, 128 and 64 (each within 2x the plain bf16 version's error
against f32, bit-identical twice, timed beside the plain version, the
library call and the bound), the bf16 conv_gn kernel at the 11 sites (within
one bf16 step of its plain version, bit-identical twice, timed beside the
plain version, cuDNN in bf16 and the bound), and the sr3 train step at batch
2, 512², with remat on and off (launches, gradients against each other, ms a
step, peak memory, remat's peak the lower).

Last, the DDPM / SR3 serving accelerators (`phase_sr_accelerators`) on the
same config and triple through infer.py: `--ddim 250,1` unfused and with
DSP_FUSED=1, `--deepcache 5,1` over the 2000 steps, `--ddim 250,1
--deepcache 5,1`, and `--sliding_window 8,0.1` on the schedule cut to 50
steps, each with its launches asserted (DeepCache's full and shallow passes
counted from `CachedUNet`'s split and seen on the card), seconds a chain,
passes, sweeps, peak memory and idle share beside the exact chain's; a
20-step DDIM chain with the kernels and through the plain versions against
an f32 one, DDIM at steps = T and eta 1 and the window at tau 0 against the
exact cut chains, DeepCache at interval 1 bit for bit against the uncached
chains (DDIM and a cut chain); and `ddpm_sample_parallel` on
configs/sr_sr3_16_128.json at full width after T sweeps against the exact
chain cut to 20 steps.

Then W8A8 quantized serving (`phase_w8a8`): every int8 site of the Hagen
joint UNets (batch 8) and of sr_sr3_64_512 (batch 1), default and 'all'
sites, the card's int8 conv (im2col + torch._int_mm) int32 bit for bit
against its plain version on the same operands, each 'all' site's W8A8 call
timed beside cuDNN's conv; the Hagen slice with W8A8 (launches and 28 int8
products a forward asserted, tiles/s, peak, calibration seconds, PSNR
against the exact chain, DSP_FUSED=1 serving the W8A8 forward); infer.py's
`--w8a8 --ddim 250,1`, `--w8a8_sites all --ddim 250,1` and `--w8a8 --ddim
250,1 --deepcache 5,1` on sr_sr3_64_512 (launches, 34 int8 sites a forward,
seconds, peak, idle share beside the unquantized DDIM chains, one forward's
rel-L2); the peak memory of a calibration and of single W8A8 and float
forwards, each alone; MFU of the sr_sr3_64_512 exact step and the Hagen train step from
the UNet FLOP count; LPIPS with random weights on the card against the CPU.

Every phase raises on failure, so the script exits non-zero with no result
line. It prints the card's name and power limit, per-kernel times beside
their bounds, each slice's tiles/s and peak memory, the train step's time and
peak memory, a device-time breakdown of one run of each slice and of one
train step (torch.profiler), one JSON line of kernels and, last, the device
line.
TF32 is off throughout, so the convolutions, matmuls and kernels all compute
in float32, but for the bf16 phase, which computes in bf16 where JAX does.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

CONFIG = "configs/splitting_hagen_indi_joint.json"
PATCH, BATCH = 512, 8
FRAMES = (2, 1024, 1024)
ATTN_N, ATTN_D = 4096, 128
CIFAR_CONFIG = "configs/splitting_cifar10_indi.json"
CIFAR_FRAMES = (2, 64, 64)
TRAIN_BATCH = 4  # the config's datasets.train.batch_size
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED = 30, 3, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def graph_replay_equals_eager(what: str, fn, eager) -> None:
    """A CUDA-graph replay of fn (one kernel call on the current stream)
    gives the eager call's bits; raises otherwise."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise AssertionError(f"{what}: a CUDA-graph replay differs from the eager launch")
    del graph, out


def gn_route(x, groups: int) -> str:
    """The GN+Swish kernel's route for x: "cluster" or "stream"."""
    from diffsplitting_tpu_torch.ops import groupnorm

    B, H, W, C = x.shape
    return groupnorm.plan(B, H * W, C, groups, groupnorm._ENTRY[x.dtype][1],
                          groupnorm._sm_count(x.device.index)).route


@contextlib.contextmanager
def plain_versions():
    """Route the UNet blocks and the fused walk through the kernels' plain
    versions (each plain version takes both dtypes: conv_gn_reference at
    bf16 x stands in for the bf16 conv_gn kernel as at f32 for the f32 one)."""
    from diffsplitting_tpu_torch.models import blocks, fused_forward
    from diffsplitting_tpu_torch.ops import (attention_reference, conv_gn_reference,
                                             group_norm_swish_reference)

    swaps = [(blocks, "fused_group_norm_swish", group_norm_swish_reference),
             (blocks, "fused_attention", attention_reference),
             (fused_forward, "fused_group_norm_swish", group_norm_swish_reference),
             (fused_forward, "fused_attention", attention_reference),
             (fused_forward, "conv_gn_fused", conv_gn_reference)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_group_norm(dev, shapes, groups, batch=BATCH, timed=True):
    """Kernel vs plain version at every (C, H, W) of one forward; two
    launches must give the same bits. When `timed`: a CUDA-graph replay gives
    the eager launch's bits; the kernel, plain and library times through a
    host loop of calls (as the kernel has been timed since it was ported; at
    the small shapes the wrapper's host time bounds it), and the kernel's and
    the library's device time alone by CUDA-graph replay, by shape with the
    kernel's route in tot["by_shape"]."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import fused_group_norm_swish, group_norm_swish_reference

    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, device_ms=0.0,
               library_device_ms=0.0)
    worst, by_shape = 0.0, {}
    for (C, H, W), calls in sorted(shapes.items()):
        x = torch.randn(batch, H, W, C, device=dev, generator=g) * 2 + 0.5
        scale = torch.randn(C, device=dev, generator=g)
        bias = torch.randn(C, device=dev, generator=g)
        got = fused_group_norm_swish(x, scale, bias, groups)
        again = fused_group_norm_swish(x, scale, bias, groups)
        want = group_norm_swish_reference(x, scale, bias, groups)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # f32 on both sides; the group sums run over up to H*W*C/G = 786K
        # values in another order
        tol = 1e-4 * (1 + want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f"GN+Swish B={batch} C={C} H={H}: max abs err {err} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"GN+Swish B={batch} C={C} H={H}: two launches differ")
        worst = max(worst, err)
        del again, want
        if not timed:
            log(f"gn_swish B={batch} H={H} W={W} C={C} C/G={C // groups} calls/forward={calls}: "
                f"err {err:.3g} (tol {tol:.3g}), two launches bit-identical")
            continue
        graph_replay_equals_eager(f"GN+Swish B={batch} C={C} H={H}",
                                  lambda: fused_group_norm_swish(x, scale, bias, groups), got)
        route = gn_route(x, groups)
        del got
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the same bytes
        ms = time_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        dev_ms = device_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        plain = time_ms(lambda: group_norm_swish_reference(x, scale, bias, groups), 5)
        lib = time_ms(lambda: F.silu(F.group_norm(x_nchw, groups, scale, bias, 1e-5)), 5)
        lib_dev = device_ms(lambda: F.silu(F.group_norm(x_nchw, groups, scale, bias, 1e-5)), 5)
        bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3  # read x, write y
        log(f"gn_swish B={batch} H={H} W={W} C={C} C/G={C // groups} calls/forward={calls} "
            f"({route} route): err {err:.3g}, graph replay bit-identical; kernel {ms:.4f} ms "
            f"(device time {dev_ms:.4f}) plain {plain:.4f} ms library {lib:.4f} ms (device time "
            f"{lib_dev:.4f}) bound {bound:.4f} ms ({bound / ms:.1%} of HBM rate; "
            f"{bound / dev_ms:.1%} by device time)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("device_ms", dev_ms),
                         ("library_device_ms", lib_dev)):
            tot[key] += calls * val
        by_shape[f"B={batch} H={H} W={W} C={C}"] = dict(
            calls=calls, route=route, device_ms=dev_ms, library_device_ms=lib_dev, bound_ms=bound)
        del x, x_nchw
        torch.cuda.empty_cache()
    if timed:
        log(f"gn_swish per UNet forward ({sum(shapes.values())} calls): "
            + " ".join(f"{k} {v:.4f}" for k, v in tot.items()))
        tot["by_shape"] = by_shape
    return tot, worst


def phase_attention(dev, batches):
    """The D = 128 kernel against its plain version at N = 4096, one head,
    at each of `batches` (the last is the serving batch, whose times the
    kernels line reports): two launches and a CUDA-graph replay
    bit-identical; the kernel's time through a host loop of calls and its
    device time alone by CUDA-graph replay, the plain version's and SDPA's,
    the bound and the key-split plan. Returns the last batch's results with
    every batch's under `by_batch`, and the worst error."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import FusedAttention, attention_reference, fused_attention
    from diffsplitting_tpu_torch.ops.attention import D128_KEY_TILE

    g = torch.Generator(device=dev).manual_seed(2)
    scale = 1.0 / math.sqrt(ATTN_D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, res, by_batch = 0.0, None, {}
    for B in batches:
        # q, k, v as the mid block hands them over: views of one qkv tensor
        qkv = torch.randn(B, ATTN_N, 1, 3, ATTN_D, device=dev, generator=g)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        got = fused_attention(q, k, v, scale)
        how = FusedAttention.last_d128_plan  # the plan the wrapper launched
        again = fused_attention(q, k, v, scale)
        want = attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # f32 FMA on both sides; softmax sums over 4096 keys in another order
        tol = 1e-4 * (1 + want.abs().max().item())
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"attention B={B}: max abs err {err} (tol {tol}), two launches "
                                 f"equal {torch.equal(got, again)}")
        graph_replay_equals_eager(f"attention B={B} N={ATTN_N} D={ATTN_D}",
                                  lambda: fused_attention(q, k, v, scale), got)
        worst = max(worst, err)
        plan = dict(how._asdict(), key_tile=D128_KEY_TILE, blocks=how.blocks * B)
        ms = time_ms(lambda: fused_attention(q, k, v, scale), 10)
        dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
        plain = time_ms(lambda: attention_reference(q, k, v, scale), 3)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10)
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops = 4 * B * ATTN_N * ATTN_N * ATTN_D  # q·kᵀ and p·v
        nbytes = 4 * B * ATTN_N * ATTN_D * 4  # q, k, v in, out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the kernel does each f32 product as three TF32 tensor-core products
        # (3xTF32); the same work on f32 FMA is the slower of the two bounds
        tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
        fma_ms = flops / F32_FLOPS_PER_S * 1e3
        bound = max(tc_ms, bytes_ms)
        bound_by = "operations" if tc_ms >= bytes_ms else "bytes"
        log(f"attention B={B} N={ATTN_N} D={ATTN_D} heads=1: plan {D128_KEY_TILE}-key tiles, "
            f"{how.splits} key splits of {how.tiles_per_split} tiles, {how.blocks * B} blocks "
            f"of 128 queries on {sms} SMs; err {err:.3g} (tol {tol:.3g}), two "
            f"launches and a graph replay bit-identical; kernel {ms:.4f} ms (device time "
            f"{dev_ms:.4f}) plain {plain:.4f} ms library {lib:.4f} ms (device time "
            f"{lib_dev:.4f}; {lib_dev / dev_ms:.2f}x the kernel's); bounds: 3xTF32 tensor-core "
            f"{tc_ms:.4f} ms ({bound / dev_ms:.1%} of it by device time), f32 FMA "
            f"{fma_ms:.4f} ms, bytes {bytes_ms:.4f} ms; {flops / dev_ms / 1e9:.1f} f32 TFLOP/s")
        res = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                   library_device_ms=lib_dev, bound_ms=bound, bound_by=bound_by, plan=plan)
        by_batch[f"B={B} N={ATTN_N} D={ATTN_D}"] = dict(res, max_abs_err=err)
        del qkv, q, k, v, got, again, want
        torch.cuda.empty_cache()
    return dict(res, by_batch=by_batch), worst


# (B, N, D) of attention at head dims other than 128: D = 16, 64 and 256 at
# N = 16, 100 and 1024; D = 512 at the SR3 attention site at 16² (B = 8, N =
# 256); D = 1024 at the mid block of sr_sr3_64_512 (B = 2, N = 1024); the
# Hagen patch's mid block (N = 4096) at inner 8 (D = 64) and at inner 24
# (D = 192, the wide kernel's padded slices, also at N = 1024)
ANY_D_SHAPES = ([(BATCH, n, d) for d in (16, 64, 256) for n in (16, 100, 1024)]
                + [(BATCH, 256, 512), (2, 1024, 1024), (BATCH, 4096, 64), (BATCH, 1024, 192),
                   (BATCH, 4096, 192)])
# the SR3 / DDPM configs' own: sr_sr3_16_128 and sr_ddpm_16_128 at their train
# batch 4 and their serving batch 1 (the 16² sites and the 8² mid block,
# D = 512), sample_ddpm_128's 4² mid block at batch 12 (D = 256)
SR3_SHAPES = [(4, 256, 512), (4, 64, 512), (1, 256, 512), (1, 64, 512), (12, 16, 256)]
# route of ops.attention.head_dim_route -> its launch count in read_launches()
ROUTE_COUNTER = {"d128": "attention", "wide": "attention_wide", "narrow": "attention_narrow"}
# the bf16 kernels' launch counts on a float32 path
BF16_NONE = {"group_norm_swish_bf16": 0, "attention_bf16": 0, "conv_gn_bf16": 0}


def phase_attention_any_d(dev):
    """Attention at head dims other than 128, at ANY_D_SHAPES and SR3_SHAPES,
    each on its route (the wide kernel of csrc/attention_wide.cu above 128,
    its plan logged; the narrow one below): against the plain version (two
    launches must give the same bits; on the wide route a CUDA-graph replay
    too, and the error against f64 at most 2e-6 at these unit-scale scores),
    the error of both against f64, and the times of the kernel, the plain
    version and SDPA through a host loop of calls, with the kernel's and
    SDPA's device time alone by CUDA-graph replay (the wrapper's host time
    exceeds a small call's device time). Returns {(B, N, D): results} and the
    worst error against the plain version, by route."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention, head_dim_route
    from diffsplitting_tpu_torch.ops.attention import wide_plan

    g = torch.Generator(device=dev).manual_seed(10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res, worst = {}, {"wide": 0.0, "narrow": 0.0}
    for B, N, D in ANY_D_SHAPES + SR3_SHAPES:
        route = head_dim_route(D)
        plan = None
        if route == "wide":
            how = wide_plan(B, N, D, sms)
            plan = dict(how._asdict(), blocks=how.blocks * B)
            log(f"attention wide B={B} N={N} D={D}: plan {how.key_tile}-key tiles, {how.splits} "
                f"key splits of {how.tiles_per_split} tiles, {how.slices} slices of "
                f"{how.chunks_per_slice} 64-wide chunks of O, {how.blocks * B} blocks on {sms} "
                f"SMs")
        qkv = torch.randn(B, N, 1, 3, D, device=dev, generator=g)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        scale = 1.0 / math.sqrt(D)
        reset_launches()
        got = fused_attention(q, k, v, scale)
        again = fused_attention(q, k, v, scale)
        launched = read_launches()
        want = attention_reference(q, k, v, scale)
        exact = attention_reference(q.double(), k.double(), v.double(), scale)
        torch.cuda.synchronize()
        err = max_err(got, want)
        err64, plain64 = max_err(got, exact), max_err(want, exact)
        # f32 accuracy on both sides (3xTF32); sums over D and N in another
        # order
        tol = 1e-4 * (1 + want.abs().max().item())
        if launched[ROUTE_COUNTER[route]] != 2 or sum(launched[c] for c in
                                                      ROUTE_COUNTER.values()) != 2:
            raise AssertionError(f"attention B={B} N={N} D={D}: launches {launched}, expected "
                                 f"2 of the {route} kernel")
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"attention B={B} N={N} D={D}: max abs err {err} (tol {tol}), "
                                 f"two launches equal {torch.equal(got, again)}")
        if route == "wide":
            # f32 accuracy against f64 at scores of unit scale
            if not err64 <= 2e-6:
                raise AssertionError(f"attention wide B={B} N={N} D={D}: max abs err against "
                                     f"f64 {err64} > 2e-06")
            graph_replay_equals_eager(f"attention wide B={B} N={N} D={D}",
                                      lambda: fused_attention(q, k, v, scale), got)
        worst[route] = max(worst[route], err)
        ms = time_ms(lambda: fused_attention(q, k, v, scale), 20)
        dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
        plain = time_ms(lambda: attention_reference(q, k, v, scale), 3)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20)
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops = 4 * B * N * N * D
        # both kernels do each f32 product as three TF32 tensor-core products
        # (3xTF32); counted at the true D, not the padded one
        ops_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
        bytes_ms = 4 * B * N * D * 4 / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        log(f"attention {route} B={B} N={N} D={D} heads=1: err {err:.3g} (tol {tol:.3g}; against "
            f"f64 {err64:.3g}, the plain version's {plain64:.3g}), two launches bit-identical"
            f"{' and a graph replay' if route == 'wide' else ''}; "
            f"kernel {ms:.4f} ms (device time {dev_ms:.4f}) plain {plain:.4f} ms SDPA {lib:.4f} "
            f"ms (device time {lib_dev:.4f}; {lib_dev / dev_ms:.2f}x the kernel's) bound "
            f"{bound:.4f} ms ({by}; 3xTF32 tensor-core {ops_ms:.4f}, bytes {bytes_ms:.4f}; "
            f"{bound / dev_ms:.1%} of it by device time, {flops / dev_ms / 1e9:.2f} f32 "
            f"TFLOP/s)")
        res[(B, N, D)] = dict(route=route, ms=ms, device_ms=dev_ms, plain_ms=plain,
                              library_ms=lib, library_device_ms=lib_dev, bound_ms=bound,
                              bound_by=by, max_abs_err=err, err_f64=err64, plan=plan)
        del qkv, q, k, v, got, again, want, exact
        torch.cuda.empty_cache()
    return res, worst


def phase_conv_gn(dev, sites, batch=BATCH, timed=True):
    """conv_gn kernel vs plain version at every site of one fused forward,
    and its statistics against f64 sums of the same inputs as a share of the
    tolerance (logged; `tot["stats_tol_share"]` the worst). When `timed`,
    also the times: the kernel's through a host loop and by CUDA-graph
    replay (`device_ms`, with each site's share of its bound), the plain
    version's, and the library's, cuDNN's F.conv2d on the already-activated
    input (plus the 1x1 F.conv2d of a projected residual): the convolution
    work the kernel replaces, without its prologue, residual add and
    statistics passes."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.conv_gn_variants import f64_stats, site_args
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import conv_gn_fused, conv_gn_reference

    g = torch.Generator(device=dev).manual_seed(6)
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, tc_ms=0.0,
               fma_ms=0.0, bytes_ms=0.0, gflop=0.0, gflop_taps=0.0, gbytes=0.0,
               stats_tol_share=0.0)
    worst = 0.0
    for site, calls in sorted(sites.items(), key=str):
        H, W, Cin, Cout, act, res, Cres = site
        args = site_args(site, batch, g)
        x, w, b, scale, shift, r, w_skip = args
        y, s, q = conv_gn_fused(*args)
        y_ref, s_ref, q_ref = conv_gn_reference(*args)
        torch.cuda.synchronize()
        err = max_err(y, y_ref)
        # f32 accuracy on both sides (3xTF32 tensor-core products, f32 sums);
        # up to 9*256 + 256 terms a sum, in another order
        tol = 1e-4 * (1 + y_ref.abs().max().item())
        # the statistics sum H*W values a channel in another order
        s_tol = 1e-5 * y_ref.abs().sum(dim=(1, 2)) + 1e-3
        q_tol = 1e-5 * q_ref + 1e-3
        if not (err <= tol and ((s - s_ref).abs() <= s_tol).all()
                and ((q - q_ref).abs() <= q_tol).all()):
            raise AssertionError(f"conv_gn B={batch} H={H} Cin={Cin} Cout={Cout} act={act} "
                                 f"res={res}: "
                                 f"max abs err {err} (tol {tol}), sums err "
                                 f"{max_err(s, s_ref)}, sumsqs err {max_err(q, q_ref)}")
        worst = max(worst, err)
        s64, q64, abs64 = f64_stats(args)
        share = max(((s.double() - s64).abs() / (1e-5 * abs64 + 1e-3)).max().item(),
                    ((q.double() - q64).abs() / (1e-5 * q64 + 1e-3)).max().item())
        tot["stats_tol_share"] = max(tot["stats_tol_share"], share)
        del y, y_ref, s, q, s_ref, q_ref, s64, q64, abs64
        if not timed:
            log(f"conv_gn B={batch} H={H} W={W} Cin={Cin} Cout={Cout} prologue={act} "
                f"residual={res} Cres={Cres} calls/forward={calls}: err {err:.3g} (tol {tol:.3g}); "
                f"statistics against f64 {share:.3g} of the tolerance")
            continue
        ms = time_ms(lambda: conv_gn_fused(*args), 10)
        dev_ms = device_ms(lambda: conv_gn_fused(*args), 10)
        plain = time_ms(lambda: conv_gn_reference(*args), 3)
        # cuDNN on the activated input, channels_last as the unfused path feeds it
        xa = (x * scale[:, None, None, :] + shift[:, None, None, :]) if act else x
        xa = F.silu(xa).permute(0, 3, 1, 2) if act else xa.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)
        r_nchw = r.permute(0, 3, 1, 2) if r is not None else None
        ws_oihw = w_skip.t()[:, :, None, None] if w_skip is not None else None

        def library():
            out = F.conv2d(xa, w_oihw, b, padding=1)
            if ws_oihw is not None:
                out = out + F.conv2d(r_nchw, ws_oihw)
            return out

        lib = time_ms(library, 5)
        flops = 2 * batch * H * W * (9 * Cin + (Cres if res == "projected" else 0)) * Cout
        nbytes = 4 * batch * H * W * (Cin + Cout + Cres)
        # each f32 product is three TF32 tensor-core products (3xTF32); the
        # same work at the f32 FMA rate is printed beside it
        tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
        fma_ms = flops / F32_FLOPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(tc_ms, bytes_ms)
        by = "operations" if tc_ms >= bytes_ms else "bytes"
        log(f"conv_gn B={batch} H={H} W={W} Cin={Cin} Cout={Cout} prologue={act} residual={res} "
            f"Cres={Cres} calls/forward={calls}: err {err:.3g}, statistics against f64 "
            f"{share:.3g} of the tolerance; kernel {ms:.4f} ms (device time {dev_ms:.4f}) plain "
            f"{plain:.4f} ms library {lib:.4f} ms bound {bound:.4f} ms ({by}; 3xTF32 tensor-core "
            f"{tc_ms:.4f}, bytes {bytes_ms:.4f}, f32 FMA {fma_ms:.4f}; "
            f"{flops / dev_ms / 1e9:.1f} f32 TFLOP/s, {bound / dev_ms:.1%} of bound by device "
            "time)")
        for key, val in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain),
                         ("library_ms", lib),
                         ("bound_ms", bound), ("tc_ms", tc_ms), ("fma_ms", fma_ms),
                         ("bytes_ms", bytes_ms), ("gflop", flops / 1e9),
                         ("gflop_taps", 2 * batch * H * W * 9 * Cin * Cout / 1e9),
                         ("gbytes", nbytes / 1e9)):
            tot[key] += calls * val
        del x, xa, r, r_nchw, args
        torch.cuda.empty_cache()
    if not timed:
        return tot, worst
    log(f"conv_gn per fused UNet forward ({sum(sites.values())} calls; library = cuDNN "
        "F.conv2d on the activated input, + the 1x1 skip conv): "
        + " ".join(f"{k} {v:.4f}" for k, v in tot.items())
        + f" ({tot['gflop'] / tot['device_ms']:.1f} f32 TFLOP/s, "
        f"{tot['bound_ms'] / tot['device_ms']:.1%} of the bound by device time)")
    tot["bound_by"] = "operations" if tot["tc_ms"] >= tot["bytes_ms"] else "bytes"
    return tot, worst


def phase_small_reference(opt, fused: bool = False):
    """The port on the card (kernels) against the port on the CPU (plain
    versions, the path the CPU tests hold against JAX) on a small noise-free
    input: 1×128×128 frame, 64² patches (mid block at 8×8, N=64); through
    the fused walk when `fused`."""
    import copy

    import torch
    from diffsplitting_tpu_torch.predict import predict_frames
    from diffsplitting_tpu_torch.serving import SplittingModel

    small = copy.deepcopy(opt)
    small["model"]["indi"]["noise_mode"] = "none"
    cpu = SplittingModel(small, device="cpu", seed=3, fused=fused)
    gpu = SplittingModel(small, device="cuda", seed=3, fused=fused)
    gpu.nets.load_state_dict(cpu.nets.state_dict())
    frames = torch.randn(1, 128, 128, 1, generator=torch.Generator().manual_seed(4))
    want = predict_frames(cpu, frames, 64, BATCH)
    got = predict_frames(gpu, frames, 64, BATCH).cpu()
    err = max_err(got, want)
    tol = 2e-4 * max(1.0, want.abs().max().item())  # f32; cuDNN and CPU sum orders
    if not (got.shape == want.shape == (1, 128, 128, 2) and err <= tol):
        raise AssertionError(f"card vs CPU on a small input: shape {tuple(got.shape)}, "
                             f"max abs err {err} > {tol}")
    log(f"small input (1x128x128, patch 64, fused={fused}): card vs CPU max abs err {err:.3g} "
        f"(tol {tol:.3g})")


def phase_cifar10(dev, inner=None, plan=(31, 0), groups=None):
    """configs/splitting_cifar10_indi.json served at its own patch (32², 20
    steps; the mid block at 4×4, so attention at N = 16 tokens) on two 64²
    frames, unfused and fused, at its own width (inner 16: D = 128) or with
    `inner_channel` set to `inner` and `norm_groups` to `groups` in memory
    (inner 32: D = 256, the wide attention kernel; Cout 256 and Cin up to
    512, sites the conv_gn kernel does not take; inner 8 and 8 groups: D =
    64, the narrow attention kernel). `plan` is the (kernel, library) count of
    the fused walk's conv sites a forward, asserted. The launches are checked against the
    config's depth; each kernel is held against its plain version at every
    shape this path gives it, at the serving batch and at the last batch's
    (GN+Swish also bit-identical on two launches); the fused output against
    the unfused one, and, with the noise off, the card against the port on
    the CPU."""
    import copy

    import torch
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data import TileIndexManager, TilingMode
    from diffsplitting_tpu_torch.kernels.conv_gn_variants import conv_gn_sites
    from diffsplitting_tpu_torch.kernels.groupnorm_variants import gn_shapes
    from diffsplitting_tpu_torch.models import fused_unet_forward
    from diffsplitting_tpu_torch.models.fused_forward import ConvSitePlan
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention, head_dim_route
    from diffsplitting_tpu_torch.predict import predict_frames
    from diffsplitting_tpu_torch.serving import SplittingModel

    opt = dict_to_nonedict(load_json(CIFAR_CONFIG))
    if inner is not None:
        opt["model"]["unet"]["inner_channel"] = inner
    if groups is not None:
        opt["model"]["unet"]["norm_groups"] = groups
    name = CIFAR_CONFIG + (f" at inner {inner}" if inner is not None else "") + (
        f", {groups} groups" if groups is not None else "")
    patch = int(opt["datasets"]["patch_size"])
    unet = opt["model"]["unet"]
    levels, res_blocks = len(unet["channel_multiplier"]), unet["res_blocks"]
    # ResnetBlocks: res_blocks a level down, the mid pair, res_blocks + 1 a
    # level up; two GN+Swish calls or conv sites each, the head's GN+Swish,
    # and an upsample conv between decoder levels
    n_resnet = levels * res_blocks + 2 + levels * (res_blocks + 1)
    gn_per_forward, conv_per_forward = 2 * n_resnet + 1, 2 * n_resnet + levels - 1
    dim = unet["inner_channel"] * unet["channel_multiplier"][-1]
    attn_key = ROUTE_COUNTER[head_dim_route(dim)]
    model = SplittingModel(opt, device=dev, seed=8)
    net = model.unets()[0]
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(BATCH, patch, patch, unet["in_channel"], device=dev, generator=g)
    t = torch.full((BATCH,), 0.5, device=dev)
    with torch.inference_mode():
        shapes, sites = gn_shapes(net, x, t), conv_gn_sites(net, x, t)
        reset_launches()
        fused_unet_forward(net, x, t)
        planned = (ConvSitePlan.kernel, ConvSitePlan.library)
    seen = (sum(shapes.values()), sum(sites.values()))
    if seen != (gn_per_forward, plan[0]) or planned != plan or sum(plan) != conv_per_forward:
        raise AssertionError(f"{name}: (GN+Swish, conv_gn) calls a forward {seen}, conv sites "
                             f"(kernel, library) {planned}; expected {(gn_per_forward, plan[0])} "
                             f"and {plan} of {conv_per_forward} from its depth")
    log(f"{name}: fused walk plans {plan[0]} conv sites a forward to the conv_gn kernel and "
        f"{plan[1]} to library ops")

    frames = torch.randn(*CIFAR_FRAMES, 1, device=dev, generator=g)
    n_tiles = TileIndexManager(CIFAR_FRAMES, (1, patch // 2, patch // 2), (1, patch, patch),
                               TilingMode.ShiftBoundary).total_grid_count()
    forwards = model.process.val_num_timesteps * math.ceil(n_tiles / BATCH)

    # every kernel at this path's shapes, at the serving batch and the last
    # batch's (18 tiles: 8, 8, 2)
    n_tok = (patch >> (levels - 1)) ** 2
    for B in sorted({BATCH, n_tiles % BATCH or BATCH}, reverse=True):
        _, gn_err = phase_group_norm(dev, shapes, int(unet["norm_groups"]), batch=B, timed=False)
        _, conv_err = phase_conv_gn(dev, sites, batch=B, timed=False)
        qkv = torch.randn(B, n_tok, 1, 3, dim, device=dev, generator=g)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        got = fused_attention(q, k, v, 1 / math.sqrt(dim))
        again = fused_attention(q, k, v, 1 / math.sqrt(dim))
        want = attention_reference(q, k, v, 1 / math.sqrt(dim))
        err = max_err(got, want)
        tol = 1e-4 * (1 + want.abs().max().item())  # f32 on both sides
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"attention B={B} N={n_tok} D={dim}: max abs err {err} (tol "
                                 f"{tol}), two launches equal {torch.equal(got, again)}")
        graph_replay_equals_eager(f"{name} attention B={B} N={n_tok} D={dim}",
                                  lambda: fused_attention(q, k, v, 1 / math.sqrt(dim)), got)
        ms = time_ms(lambda: fused_attention(q, k, v, 1 / math.sqrt(dim)), 20)
        log(f"{name} kernels at B={B}: GN+Swish at {len(shapes)} shapes max abs err "
            f"{gn_err:.3g}, conv_gn at {len(sites)} sites {conv_err:.3g}, attention N={n_tok} "
            f"D={dim} heads=1 {err:.3g} (tol {tol:.3g}; two launches and a graph replay "
            f"bit-identical), {ms:.4f} ms")
    outs = {}
    for fused in (False, True):
        expected = {"group_norm_swish": (1 if fused else gn_per_forward) * forwards,
                    "attention": 0, "attention_wide": 0, "attention_narrow": 0,
                    "conv_gn": plan[0] * forwards if fused else 0,
                    "sites_kernel": plan[0] * forwards if fused else 0,
                    "sites_library": plan[1] * forwards if fused else 0, **BF16_NONE}
        expected[attn_key] = forwards
        model.generator.manual_seed(0)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = predict_frames(model, frames, patch, BATCH, fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches != expected:
            raise AssertionError(f"{name} fused={fused}: launches {launches}, "
                                 f"expected {expected}")
        if (tuple(out.shape) != CIFAR_FRAMES + (unet["out_channel"],)
                or not torch.isfinite(out).all()):
            raise AssertionError(f"{name} fused={fused}: output shape "
                                 f"{tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        log(f"{name} fused={fused}: {CIFAR_FRAMES[0]} frames {CIFAR_FRAMES[1]}x"
            f"{CIFAR_FRAMES[2]}, {n_tiles} tiles of {patch}², {model.process.val_num_timesteps} "
            f"steps, {forwards} UNet forwards in {wall * 1e3:.1f} ms, launches {launches}")
        outs[fused] = (out, launches)
    err = max_err(outs[True][0], outs[False][0])
    tol = 1e-3 * outs[False][0].abs().max().item() + 1e-4
    if not err <= tol:
        raise AssertionError(f"{name}: fused vs unfused max abs err {err} > {tol}")
    log(f"{name}: fused vs unfused max abs err {err:.3g} (tol {tol:.3g})")

    quiet = copy.deepcopy(opt)
    quiet["model"]["indi"] = {"noise_mode": "none"}
    cpu = SplittingModel(quiet, device="cpu", seed=8)
    gpu = SplittingModel(quiet, device=dev, seed=8)
    gpu.nets.load_state_dict(cpu.nets.state_dict())
    for fused in (False, True):
        want = predict_frames(cpu, frames.cpu(), patch, BATCH, fused=fused)
        got = predict_frames(gpu, frames, patch, BATCH, fused=fused).cpu()
        err = max_err(got, want)
        tol = 2e-4 * max(1.0, want.abs().max().item())  # f32; cuDNN and CPU sum orders
        if not err <= tol:
            raise AssertionError(f"{name} fused={fused}: card vs CPU max abs err "
                                 f"{err} > {tol}")
        log(f"{name} fused={fused}, noise off: card vs CPU max abs err {err:.3g} "
            f"(tol {tol:.3g})")
    return outs[False][1], outs[True][1]


# profile family -> the sources whose __global__ functions make it up, and
# the launch count that says the family ran
KERNEL_FAMILIES = {"group_norm_swish kernel": (("groupnorm_swish.cu",), "group_norm_swish"),
                   "attention kernel": (("attention.cu", "attention_wide.cu"), "attention"),
                   "conv_gn kernel": (("conv_gn.cu", "conv_gn_stats.cuh"), "conv_gn")}


@functools.cache
def kernel_names() -> dict:
    """Family -> names of the __global__ functions its source defines."""
    csrc = Path(__file__).resolve().parent / "diffsplitting_tpu_torch" / "csrc"
    # __launch_bounds__'s arguments may hold one level of parentheses
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?"
                         r"(\w+)\s*\(")
    names = {}
    for fam, (sources, _) in KERNEL_FAMILIES.items():
        names[fam] = [n for src in sources for n in pattern.findall((csrc / src).read_text())]
        if not names[fam]:
            raise AssertionError(f"no __global__ function found in csrc/{sources}")
    return names


def kernel_family(name: str) -> str:
    for fam, names in kernel_names().items():
        if any(n in name for n in names):
            return fam
    # cuDNN's f32 convolutions include FFT passes and NHWC<->NCHW transposes
    if any(s in name.lower() for s in ("conv", "xmma", "cudnn", "gemm", "fft", "cutlass",
                                       "pointwise_mult_and_sum_complex", "nhwctonchw",
                                       "nchwtonhwc")):
        return "convolutions and linears (cuDNN, cuBLAS)"
    return "other (elementwise adds, concat, upsample, the attention block's group_norm)"


def phase_profile(model, frames, fused: bool) -> None:
    """Device time of one slice run by kernel family (torch.profiler), and
    the device's idle share of the run's wall time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from diffsplitting_tpu_torch.predict import predict_frames

    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_frames(model, frames, PATCH, BATCH, fused=fused)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    fams, names = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            fams[kernel_family(e.name)] += ms
            names[e.name[:110]] += ms
    busy = sum(fams.values())
    if not busy:
        log("profile: no device events recorded; breakdown not measured")
        return
    for fam, (_, key) in KERNEL_FAMILIES.items():
        if launches[key] and not fams[fam]:
            raise AssertionError(f"profile, fused={fused}: {launches[key]} {key} launches but no "
                                 f"device time matched {kernel_names()[fam]}")
    log(f"profile (one slice run, fused={fused}, profiler on): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.1%}")
    for fam, ms in fams.most_common():
        log(f"profile:   {fam}: {ms:.1f} ms ({ms / busy:.1%} of device time)")
    for name, ms in names.most_common(12):
        log(f"profile:     {ms:8.1f} ms  {name}")


def reset_launches() -> None:
    """Every launch count to 0, the int8 conv's product count
    (`int8_launches`), and the fused walk's conv-site plan counts."""
    from diffsplitting_tpu_torch.models.fused_forward import ConvSitePlan
    from diffsplitting_tpu_torch.ops import FusedAttention, FusedConvGN, FusedGroupNormSwish
    from diffsplitting_tpu_torch.ops.quant import Int8Conv

    for k in (FusedGroupNormSwish, FusedAttention, FusedConvGN, Int8Conv):
        k.launches = 0
    FusedAttention.launches_wide = FusedAttention.launches_narrow = 0
    FusedGroupNormSwish.launches_bf16 = FusedAttention.launches_bf16 = 0
    FusedConvGN.launches_bf16 = 0
    ConvSitePlan.kernel = ConvSitePlan.library = 0


def read_launches() -> dict:
    from diffsplitting_tpu_torch.models.fused_forward import ConvSitePlan
    from diffsplitting_tpu_torch.ops import FusedAttention, FusedConvGN, FusedGroupNormSwish

    return {"group_norm_swish": FusedGroupNormSwish.launches,
            "attention": FusedAttention.launches, "attention_wide": FusedAttention.launches_wide,
            "attention_narrow": FusedAttention.launches_narrow, "conv_gn": FusedConvGN.launches,
            "sites_kernel": ConvSitePlan.kernel, "sites_library": ConvSitePlan.library,
            "group_norm_swish_bf16": FusedGroupNormSwish.launches_bf16,
            "attention_bf16": FusedAttention.launches_bf16,
            "conv_gn_bf16": FusedConvGN.launches_bf16}


def int8_launches() -> int:
    """`torch._int_mm` products of the W8A8 convs on the card since the last
    `reset_launches` (ops/quant.py `Int8Conv`; a library product, kept apart
    from the kernels' counts)."""
    from diffsplitting_tpu_torch.ops.quant import Int8Conv

    return Int8Conv.launches


def slice_inputs(dev):
    """The seeded tile batch and the two synthetic frames of the slice."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    tile_batch = torch.randn(BATCH, PATCH, PATCH, 1, device=dev, generator=gen)
    return tile_batch, torch.randn(*FRAMES, 1, device=dev, generator=gen)


def phase_slice(model, frames, fused: bool, expected: dict, n_tiles: int, forwards,
                steps=None, label: str = "slice"):
    """Joint-InDI tiled prediction at full width (`steps` reverse steps, None:
    the config's; DeepCache or the window as the model is switched): a
    warm-up run, then one run with every launch count set to 0 just before
    and read just after, then two more for the spread of the host-clock time.
    Returns the output, the launches, and the median tiles/s and the peak
    device memory of the counted run."""
    import torch
    from diffsplitting_tpu_torch.predict import predict_frames

    def run():
        return predict_frames(model, frames, PATCH, BATCH, num_steps=steps, fused=fused)

    model.generator.manual_seed(0)
    run()  # warm-up: plans, allocator
    torch.cuda.synchronize()

    model.generator.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_launches()
    int8 = int8_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches != expected:
        raise AssertionError(f"{label} fused={fused}: launches {launches}, expected {expected}")
    if tuple(out.shape) != FRAMES + (2,) or not torch.isfinite(out).all():
        raise AssertionError(f"{label} fused={fused}: output shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    tiles_per_s = n_tiles / sorted(walls)[1]
    log(f"{label} fused={fused}: {FRAMES[0]} frames {FRAMES[1]}x{FRAMES[2]}, {n_tiles} tiles of "
        f"{PATCH}², batch {BATCH}, {steps or model.process.val_num_timesteps} steps, {forwards} "
        "UNet forwards: "
        f"runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {tiles_per_s:.2f} "
        f"tiles/s, peak memory {peak / 2**30:.2f} GiB ({peak} bytes), launches {launches}")
    return out, launches, dict(tiles_per_s=tiles_per_s, peak=peak, walls=walls, int8_conv=int8)


def smooth_pair(rng, batch: int, patch: int) -> dict:
    """A seeded two-channel batch of smooth structures, NHWC in [0, 1]:
    channel 0 round blobs (sums of Gaussians), channel 1 oriented ridges
    (cos^8 of plane waves); 'input' is their mean, the mixed image."""
    import numpy as np

    yy, xx = np.mgrid[0:patch, 0:patch].astype(np.float32) / patch
    out = np.zeros((batch, patch, patch, 2), np.float32)
    for i in range(batch):
        for _ in range(12):
            cy, cx = rng.uniform(0, 1, 2)
            r = rng.uniform(0.02, 0.08)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        for _ in range(4):
            th, f, ph = rng.uniform(0, np.pi), rng.uniform(3, 12), rng.uniform(0, 2 * np.pi)
            out[i, ..., 1] += np.cos(2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th)) + ph) ** 8
    out /= out.max(axis=(1, 2), keepdims=True)
    return {"target": out, "input": out.mean(axis=-1, keepdims=True)}


def train_draws(trainer, batch: int, patch: int, seed: int, device):
    """Each net's (t, noise) for one step, drawn as the process draws them,
    from a generator of their own."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [(proc.sample_t(batch, trainer.current_T, g, device),
             torch.randn(batch, patch, patch, 1, generator=g, device=device))
            for proc in (trainer.process.indi1, trainer.process.indi2)]


def compare_steps(what: str, got, want, lr=None):
    """Two trainers after one step from the same params and draws: loss
    (relative 1e-5), pre-clip grad_norm (relative 1e-4), every gradient within
    5e-3·s, where s = max(max|g| of its tensor, 1e-5·grad_norm) (f32 on both
    sides; GroupNorm statistics, softmax and convolution sums in another
    order, carried through the backward of 14 ResnetBlocks; a weight's
    gradient sums up to B·H·W = 1M products, which cancel to far less than
    their magnitudes). The floor holds tensors whose gradient is zero up to
    rounding: a time-MLP weight whose per-channel bias the next GroupNorm,
    one channel a group, removes. With
    `lr` (both sides started from the same params), also each parameter
    within 2·lr, and within 1e-2·lr where |g| > 1e-6 and |g| > 10 times the
    element's gradient difference: Adam's first update is about
    lr·g/(|g| + eps), ±lr wherever |g| ≫ eps, so it agrees wherever the sign
    of g does, and moves by anything up to ±lr on rounding elsewhere."""
    import torch

    gl, wl = got.get_current_log(), want.get_current_log()
    errs = {k: abs(gl[k] - wl[k]) / max(abs(wl[k]), 1e-30) for k in ("l_pix", "grad_norm")}
    if not (errs["l_pix"] <= 1e-5 and errs["grad_norm"] <= 1e-4):
        raise AssertionError(f"train step, {what}: loss {gl['l_pix']} vs {wl['l_pix']}, "
                             f"grad_norm {gl['grad_norm']} vs {wl['grad_norm']}")
    worst, worst_name, worst_dp = compare_grads(what, got.nets, want.nets, wl["grad_norm"], lr)
    log(f"train step, {what}: loss rel err {errs['l_pix']:.3g} (tol 1e-05), grad_norm rel err "
        f"{errs['grad_norm']:.3g} (tol 0.0001), worst gradient err {worst:.3g} of "
        f"max(max|g|, 1e-5 grad_norm) (tol 0.005) at {worst_name}"
        + (f", worst param err {worst_dp:.3g} lr where the sign of g is sure (tol 0.01)"
           if lr is not None else ""))


def compare_grads(what: str, got_net, want_net, grad_norm: float, lr=None):
    """The gradient (and, with `lr`, parameter) checks of `compare_steps`
    over two modules' parameters; returns (worst gradient error, where,
    worst parameter error in lr)."""
    worst, worst_dp, worst_name = 0.0, 0.0, ""
    wparams = dict(want_net.named_parameters())
    for name, p in got_net.named_parameters():
        q = wparams[name]
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"train step, {what}: {name} has a gradient on one side only")
        if p.grad is None:
            continue
        g, h = p.grad.detach().cpu(), q.grad.detach().cpu()
        gmax = max(h.abs().max().item(), 1e-5 * grad_norm)
        rel = (g - h).abs().max().item() / gmax
        if not rel <= 5e-3:
            raise AssertionError(f"train step, {what}: gradient of {name} off by {rel:.3g} of "
                                 f"{gmax:.3g}")
        if rel > worst:
            worst, worst_name = rel, f"{name} (max|g| {h.abs().max().item():.3g})"
        if lr is not None:
            dp = (p.detach().cpu() - q.detach().cpu()).abs()
            big = (h.abs() > 1e-6) & (h.abs() > 10 * (g - h).abs())
            dp_big = dp[big].max().item() if big.any() else 0.0
            if dp_big > 1e-2 * lr or dp.max().item() > 2 * lr:
                raise AssertionError(f"train step, {what}: {name} moved differently")
            worst_dp = max(worst_dp, dp_big / lr)
    return worst, worst_name, worst_dp


def train_family(name: str, ancestors) -> str:
    """A train step's device kernel -> its family: the forward kernels by
    name; the plain backward of GN+Swish and attention, the optimizer and the
    backward by the CPU ops that launched them (autograd nodes
    FusedGroupNormSwishBackward, FusedAttentionBackward; Optimizer.step)."""
    fam = kernel_family(name)
    if fam in ("group_norm_swish kernel", "attention kernel"):
        return "forward: " + fam
    joined = " ".join(ancestors)
    if "FusedGroupNormSwishBackward" in joined:
        return "backward: GN+Swish plain version"
    if "FusedAttentionBackward" in joined:
        return "backward: attention plain version"
    if "Optimizer.step" in joined:
        return "optimizer (Adam)"
    side = "backward: " if "autograd::engine" in joined else "forward: "
    if not ancestors:
        side = "unattributed: "
    if fam.startswith("convolutions"):
        return side + "convolutions and linears (cuDNN, cuBLAS)"
    return side + "other (elementwise, reductions, the loss)"


def profile_train_step(trainer) -> dict:
    """Device time of one train step by family (torch.profiler), and the
    device's idle share of its wall time (profiler on). A kernel is
    attributed through the CPU op that launched it (the profiler's `kernels`
    of that op) and that op's ancestors; a kernel no op claims is classed by
    its name alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.optimize_parameters()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    by_name = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    fams, claimed = collections.Counter(), collections.Counter()
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ancestors, c = [], e
        while c is not None:
            ancestors.append(c.name)
            c = c.cpu_parent
        for k in e.kernels:
            fams[train_family(k.name, ancestors)] += k.duration / 1e3
            claimed[k.name] += k.duration / 1e3
    for name, ms in by_name.items():
        if ms - claimed[name] > 1e-6:
            fams[train_family(name, [])] += ms - claimed[name]
    busy = sum(by_name.values())
    if not busy:
        log("train profile: no device events recorded; breakdown not measured")
        return {}
    log(f"train profile (one step, profiler on): wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}")
    for fam, ms in fams.most_common():
        log(f"train profile:   {fam}: {ms:.2f} ms ({ms / busy:.1%} of device time)")
    for name, ms in by_name.most_common(8):
        log(f"train profile:     {ms:8.2f} ms  {name[:110]}")
    return dict(fams, wall_ms=wall_ms, busy_ms=busy)


def phase_train(dev):
    """The joint-InDI train step at full width (configs/splitting_hagen_indi_joint.json:
    patch 512, its batch 4, seeded random weights, a seeded batch of smooth
    structures): one step with the kernels against the same step under
    plain_versions() from the same params, t and noise; exactly 58 GN+Swish
    and 2 attention launches a step (29 and 1 a forward, 2 nets; none from
    the backward or the optimizer); a small step (patch 64, batch 2) on the
    card against the port on the CPU; then 30 steps on the batch: 3 warm-up
    steps after the first, 10 timed (ms a step, samples/s, peak memory), one
    profiled after them, and the mean loss of the last 5 below that of the
    first 5."""
    import numpy as np
    import torch
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.train import DiffusionModel

    opt = dict_to_nonedict(load_json(CONFIG))
    batch_size = int(opt["datasets"]["train"]["batch_size"])
    if (batch_size, int(opt["datasets"]["patch_size"])) != (TRAIN_BATCH, PATCH):
        raise AssertionError(f"{CONFIG} no longer trains batch {TRAIN_BATCH} of {PATCH}²")
    lr = float(opt["train"]["optimizer"]["lr"])
    batch = smooth_pair(np.random.default_rng(12), TRAIN_BATCH, PATCH)

    kern = DiffusionModel(opt, device=dev, seed=0)
    plain = DiffusionModel(opt, device=dev, seed=0, state_dict=kern.nets.state_dict())
    draws = train_draws(kern, TRAIN_BATCH, PATCH, 13, dev)
    for m in (kern, plain):
        m.feed_data(batch)
    torch.cuda.synchronize()
    reset_launches()
    kern.optimize_parameters(draws)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = {"group_norm_swish": 58, "attention": 2, "attention_wide": 0, "attention_narrow": 0,
                "conv_gn": 0, "sites_kernel": 0, "sites_library": 0, **BF16_NONE}
    if launches != expected:
        raise AssertionError(f"train step: launches {launches}, expected {expected}")
    log(f"train step B={TRAIN_BATCH} {PATCH}²: launches {launches} (forward, backward and "
        "optimizer)")
    with plain_versions():
        plain.optimize_parameters(draws)
    compare_steps(f"kernels vs plain versions, B={TRAIN_BATCH} {PATCH}²", kern, plain)
    losses = [kern.get_current_log()["l_pix"]]
    del plain
    torch.cuda.empty_cache()

    cpu = DiffusionModel(opt, device="cpu", seed=1)
    gpu = DiffusionModel(opt, device=dev, seed=1, state_dict=cpu.nets.state_dict())
    small_batch = smooth_pair(np.random.default_rng(14), 2, 64)
    small_draws = train_draws(cpu, 2, 64, 15, "cpu")
    cpu.feed_data(small_batch)
    cpu.optimize_parameters(small_draws)
    gpu.feed_data(small_batch)
    gpu.optimize_parameters([(t.to(dev), n.to(dev)) for t, n in small_draws])
    compare_steps("card vs CPU, B=2 64²", gpu, cpu, lr)
    del cpu, gpu

    walls = []
    for step in range(2, TRAIN_STEPS + 1):
        timed = 2 + TRAIN_WARMUP <= step < 2 + TRAIN_WARMUP + TRAIN_TIMED
        torch.cuda.synchronize()
        if step == 2 + TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kern.optimize_parameters()
        torch.cuda.synchronize()
        if timed:
            walls.append(time.perf_counter() - t0)
        if step == 1 + TRAIN_WARMUP + TRAIN_TIMED:
            peak = torch.cuda.max_memory_allocated()
        losses.append(kern.get_current_log()["l_pix"])
    ms = sorted(walls)[len(walls) // 2] * 1e3
    log(f"train step B={TRAIN_BATCH} {PATCH}² x 2 nets: {TRAIN_TIMED} steps "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {ms:.2f} ms, "
        f"{TRAIN_BATCH / ms * 1e3:.2f} samples/s, peak memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes)")
    prof = profile_train_step(kern)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"train loss over {TRAIN_STEPS} steps on one batch: " + ", ".join(f"{v:.4f}" for v in losses))
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and last < first):
        raise AssertionError(f"train loss did not fall: mean of the first 5 {first}, of the "
                             f"last 5 {last}")
    log(f"train loss: mean of the first 5 steps {first:.5f}, of the last 5 {last:.5f}")
    return dict(launches=launches, ms=ms, peak=peak, profile=prof)


LOOP_FRAMES, LOOP_SIZE = 8, 1024  # train frames; the synthesis adds 2 val frames
LOOP_WARMUP, LOOP_TIMED = 2, 8


def loop_config(work: str, iters: int, resume=None, pool=None) -> str:
    """The Hagen joint config at its own patch (512) and batch (4) on the
    synthetic stacks in `work`: print every 5 iterations, validate and save
    every 10, the EMA on (exact tracking before step_start_ema), the device
    pool as `pool` says (None: auto). Returns the config's path."""
    from diffsplitting_tpu_torch.scripts import quality_joint_indi_synthetic as quality

    path = quality.write_config(work, iters, PATCH, TRAIN_BATCH, save_freq=10, resume=resume,
                                print_freq=5, val_freq=10)
    with open(path) as f:
        opt = json.load(f)
    opt["datasets"]["train"]["device_pool"] = pool
    opt["train"]["ema_scheduler"]["enabled"] = True
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def checkpoint_prefix(run: dict, iters: int) -> str:
    """The `I{iters}_E*` prefix a split run saved, asserting both files."""
    ckpt_dir = Path(run["opt"]["path"]["checkpoint"])
    gens = sorted(ckpt_dir.glob(f"I{iters}_E*_gen.pth"))
    if len(gens) != 1 or not Path(str(gens[0]).replace("_gen.pth", "_opt.pth")).is_file():
        raise AssertionError(f"no I{iters}_E* checkpoint pair in {ckpt_dir}: "
                             f"{sorted(p.name for p in ckpt_dir.iterdir())}")
    return str(gens[0])[: -len("_gen.pth")]


def trainer_state(m) -> dict:
    """Every tensor an exact resume needs, by name."""
    import torch

    out = {f"net.{k}": v for k, v in m.nets.state_dict().items()}
    if m.ema_nets is not None:
        out.update({f"ema.{k}": v for k, v in m.ema_nets.state_dict().items()})
    for i, st in m.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    out.update({f"acc.{i}": a for i, a in enumerate(m._acc or [])})
    out["generator"] = m.generator.get_state()
    return out


def assert_same_state(what: str, a: dict, b: dict) -> None:
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: state keys differ: {sorted(set(a) ^ set(b))[:5]}")
    for k in a:
        if not torch_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def torch_equal(x, y) -> bool:
    import torch

    return torch.equal(x.detach().cpu(), y.detach().cpu())


def time_loop(model, paths: dict, step_ms: float) -> dict:
    """The split loop's body (`feed_data`, `optimize_parameters`) on each
    data path of `paths` (name -> an endless iterator of batches; the first
    is the reference the others are held to): per path a warm-up, the
    launches of one iteration (asserted) and one iteration under
    torch.profiler (the device's idle share of its wall time); then timed
    passes of LOOP_TIMED iterations, each ended by a synchronize, in turns
    (A, B, C, C, B, A): it/s from the two passes of a path, peak memory over
    them, and the host's time in each iteration's calls (the calls return
    before the device is done: near the iteration's time, the loop waits on
    the host or on a copy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step(batches):
        model.feed_data(next(batches))
        model.optimize_parameters()

    out = {}
    for what, batches in paths.items():
        for _ in range(LOOP_WARMUP):
            step(batches)
        torch.cuda.synchronize()
        reset_launches()
        step(batches)
        torch.cuda.synchronize()
        launches = read_launches()
        if (launches["group_norm_swish"], launches["attention"]) != (58, 2):
            raise AssertionError(f"train loop, {what}: launches an iteration {launches}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(batches)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) * 1e3
        busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        out[what] = dict(launches=launches, prof_ms=prof_ms, busy=busy, walls=[], host=[],
                         peak=0)
    order = list(paths)
    for what in order + order[::-1]:
        r = out[what]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(LOOP_TIMED):
            t1 = time.perf_counter()
            step(paths[what])
            r["host"].append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        r["walls"].append(time.perf_counter() - t0)
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
    for what, r in out.items():
        its = 2 * LOOP_TIMED / sum(r["walls"])
        idle = (f"{1 - r['busy'] / r['prof_ms']:.1%}" if r["busy"]
                else "not measured (no device events)")
        log(f"train loop, {what}: {its:.3f} it/s over 2 x {LOOP_TIMED} iterations in turns "
            f"(passes {', '.join(f'{w / LOOP_TIMED * 1e3:.2f}' for w in r['walls'])} ms an "
            f"iteration, each ended by a synchronize; the host's time in an iteration's calls "
            f"{sorted(r['host'])[len(r['host']) // 2] * 1e3:.2f} ms, median), "
            f"{its * step_ms / 1e3:.1%} of phase_train's lone step ({step_ms:.2f} ms); "
            f"peak memory {r['peak'] / 2**30:.2f} GiB ({r['peak']} bytes); one profiled "
            f"iteration: wall {r['prof_ms']:.1f} ms, device busy {r['busy']:.1f} ms, idle share "
            f"{idle}; launches an iteration: group_norm_swish "
            f"{r['launches']['group_norm_swish']}, attention {r['launches']['attention']}")
        r["its"] = its
    base = out[order[0]]["its"]
    log("train loop, it/s against " + order[0] + " in the same turns: " + ", ".join(
        f"{what} {r['its'] / base:.1%}" for what, r in out.items()))
    return out


def phase_train_loop(dev, step_ms: float) -> dict:
    """The port's split.py at full width on the Hagen joint config (patch
    512, batch 4, two nets, Adam at lr 1e-3, the EMA on) and seeded synthetic
    frames (8 train and 2 val frames of 1024², from
    scripts/quality_joint_indi_synthetic.py):
      * `split.main -p train` for 10 iterations (the device pool, as auto
        picks it), then resumed from its I10 checkpoint to 20 on the host
        loader: print every 5, validate and save every 10; both I10 and I20
        pairs, finite validation PSNRs and the launches of each run
        (58 GN+Swish and 2 attention an iteration, 522 and 18 a validation:
        3 items, 3 steps, 2 nets) asserted;
      * a model resumed from I10 holds exactly the state of the first run's
        model, which never stopped (weights, EMA, Adam, counters, generator)
        and the files' contents; one step of each on one fed batch, with
        cuDNN deterministic, gives the same bits;
      * the loop's body timed on each data path in turns with one fed batch
        (`time_loop`), beside the lone step's `step_ms`, and the pool's
        draw alone;
      * `split.main -p val` from the I20 checkpoint.
    Returns the launches of the two train runs."""
    import tempfile

    import numpy as np
    import torch
    from diffsplitting_tpu_torch import split
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data.device_pool import DevicePatchPool
    from diffsplitting_tpu_torch.scripts import quality_joint_indi_synthetic as quality
    from diffsplitting_tpu_torch.train import create_model

    t_phase = time.perf_counter()
    per_run = {"group_norm_swish": 10 * 58 + 522, "attention": 10 * 2 + 18}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        quality.make_stacks(work, LOOP_FRAMES, LOOP_SIZE, seed=0)
        log(f"train loop: synthesized {LOOP_FRAMES} + 2 frames of {LOOP_SIZE}² in "
            f"{time.perf_counter() - t0:.1f} s")

        runs, launches = [], collections.Counter()
        # the first run's stacks (64 MiB as float32) fit the pool's cap: auto takes it
        for iters, resume, pool in ((10, None, None), (20, "I10", False)):
            cfg = loop_config(work, iters, resume and checkpoint_prefix(runs[0], 10), pool)
            reset_launches()
            t0 = time.perf_counter()
            run = split.main(["-c", cfg, "-p", "train"])
            torch.cuda.synchronize()
            got = read_launches()
            prefix = checkpoint_prefix(run, iters)
            psnrs = run["val_psnrs"]
            if len(psnrs) != 1 or not np.isfinite(psnrs).all():
                raise AssertionError(f"split run to {iters}: validation PSNRs {psnrs}")
            want = dict(per_run, attention_wide=0, attention_narrow=0, conv_gn=0,
                        sites_kernel=0, sites_library=0, **BF16_NONE)
            if got != want:
                raise AssertionError(f"split run to {iters}: launches {got}, expected {want}")
            launches.update({k: got[k] for k in per_run})
            log(f"train loop: split.main -p train to iteration {iters} "
                f"({'resumed from ' + resume if resume else 'from scratch'}, "
                f"{'device pool, picked by auto' if pool is None else 'host loader'}): "
                f"{time.perf_counter() - t0:.1f} s, saved {Path(prefix).name}, validation PSNR "
                f"{psnrs[0]:.3f} dB, launches {got}")
            runs.append(run)

        # resume from I10: the state of the model that never stopped
        never = runs[0]["model"]
        opt = dict_to_nonedict(load_json(loop_config(work, 20)))
        opt["phase"] = "train"
        opt["path"]["checkpoint"] = runs[0]["opt"]["path"]["checkpoint"]
        opt["path"]["resume_state"] = checkpoint_prefix(runs[0], 10)
        resumed = create_model(opt, device=dev)
        assert_same_state("resume from I10 vs the model that never stopped",
                          trainer_state(resumed), trainer_state(never))
        gen = torch.load(opt["path"]["resume_state"] + "_gen.pth", map_location="cpu")
        saved = torch.load(opt["path"]["resume_state"] + "_opt.pth", map_location="cpu")
        assert_same_state("resume from I10 vs its _gen.pth",
                          {f"net.{k}": v for k, v in resumed.nets.state_dict().items()},
                          {f"net.{k}": v for k, v in gen.items()})
        if not ((resumed.begin_step, resumed.global_step, resumed.updates)
                == (saved["iter"], saved["global_step"], saved["updates"]) == (10, 10, 10)
                and torch_equal(resumed.generator.get_state(), saved["generator"])):
            raise AssertionError("resume from I10: counters or generator differ from the file")
        batch = smooth_pair(np.random.default_rng(16), TRAIN_BATCH, PATCH)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for m in (never, resumed):
                m.feed_data(batch)
                m.optimize_parameters()
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        assert_same_state("one step after resume vs without a stop", trainer_state(resumed),
                          trainer_state(never))
        if resumed.get_current_log() != never.get_current_log():
            raise AssertionError("one step after resume: logs differ")
        log("train loop: resumed from I10 = the model that never stopped (weights, EMA, Adam, "
            "counters, generator; and the files), and one step of each on one batch gives the "
            "same bits (cuDNN deterministic)")
        del never, resumed

        # the loop's body on each data path, on the resumed run's model, with
        # the EMA off as the config trains (and as phase_train's lone step runs)
        model = runs[1]["model"]
        model.use_ema = False
        train_set, _ = split.get_datasets(runs[1]["opt"])
        # the reference: one batch fed once, as phase_train steps
        fixed = {k: torch.as_tensor(v, device=dev)
                 for k, v in smooth_pair(np.random.default_rng(17), TRAIN_BATCH, PATCH).items()}
        paths = {"one fed batch": itertools.repeat(fixed)}
        for what, pool in (("host loader", False), ("device pool", True)):
            runs[1]["opt"]["datasets"]["train"]["device_pool"] = pool
            epochs = split.train_batches(runs[1]["opt"], train_set, dev)
            paths[what] = (b for _ in iter(int, 1) for b in epochs())
        loop = time_loop(model, paths, step_ms)
        pool = DevicePatchPool(train_set, TRAIN_BATCH, seed=1, device=dev)
        draw_ms = time_ms(pool.draw, 20)
        t0 = time.perf_counter()
        for _ in range(20):
            pool.draw()
        draw_host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        log(f"train loop: the device pool's draw of a batch alone: {draw_ms:.4f} ms (CUDA events "
            f"over 20 draws), the host's time in a draw {draw_host_ms:.4f} ms")
        del pool
        del model, runs[0]

        val = split.main(["-c", loop_config(work, 20, checkpoint_prefix(runs[-1], 20)), "-p", "val"])
        if not (np.isfinite(val["psnr"]) and 0 < val["ssim"] <= 1):
            raise AssertionError(f"split -p val from I20: PSNR {val['psnr']}, SSIM {val['ssim']}")
        log(f"train loop: split.main -p val from I20: PSNR {val['psnr']:.3f} dB, SSIM "
            f"{val['ssim']:.4f} over the 8 val patches")
        del runs, val
    torch.cuda.empty_cache()
    log(f"train loop phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(launches), loop=loop)

TP_CONFIG = "configs/splitting_hagen_time_predictor.json"
TP_WARMUP, TP_TIMED = 3, 10
TREF_T_TRUE = (0.35, 0.5, 0.65)
TREF_STEPS, TREF_TRAIN_STEPS = 10, 30
GN_ATTN_ONLY = {"attention_wide": 0, "attention_narrow": 0, "conv_gn": 0, "sites_kernel": 0,
                "sites_library": 0, **BF16_NONE}


def tp_mixtures(rng, batch: int, patch: int):
    """Seeded classifier inputs: t·ch0 + (1 − t)·ch1 of smooth_pair's two
    channels, rescaled to [−1, 1], NHWC, with their t in [0.1, 0.9]."""
    import numpy as np

    pair = smooth_pair(rng, batch, patch)["target"]
    t = rng.uniform(0.1, 0.9, batch).astype(np.float32)
    mix = t[:, None, None] * pair[..., 0] + (1 - t[:, None, None]) * pair[..., 1]
    return (2 * mix - 1)[..., None].astype(np.float32), t


def attention_at_batch(dev, B: int) -> dict:
    """The D = 128 attention kernel at B, N = 4096 (the one-step inversions'
    mid block at B = 1, whose plan splits the keys and adds the combine
    launch) against its plain version, two launches and a CUDA-graph replay
    bit-identical, with the kernel's, the plain version's and SDPA's device
    time by CUDA-graph replay (and the kernel's through a host loop of
    calls)."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import FusedAttention, attention_reference, fused_attention
    from diffsplitting_tpu_torch.ops.attention import D128_KEY_TILE

    g = torch.Generator(device=dev).manual_seed(22)
    scale = 1.0 / math.sqrt(ATTN_D)
    qkv = torch.randn(B, ATTN_N, 1, 3, ATTN_D, device=dev, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    got = fused_attention(q, k, v, scale)
    how = FusedAttention.last_d128_plan  # the plan the wrapper launched
    again = fused_attention(q, k, v, scale)
    want = attention_reference(q, k, v, scale)
    err = max_err(got, want)
    tol = 1e-4 * (1 + want.abs().max().item())  # as phase_attention
    if not err <= tol or not torch.equal(got, again):
        raise AssertionError(f"attention B={B}: max abs err {err} (tol {tol}), two launches "
                             f"equal {torch.equal(got, again)}")
    graph_replay_equals_eager(f"attention B={B} N={ATTN_N} D={ATTN_D}",
                              lambda: fused_attention(q, k, v, scale), got)
    ms = time_ms(lambda: fused_attention(q, k, v, scale), 20)
    dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
    plain_dev = device_ms(lambda: attention_reference(q, k, v, scale), 5)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    flops = 4 * B * ATTN_N * ATTN_N * ATTN_D
    tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    bytes_ms = 4 * B * ATTN_N * ATTN_D * 4 / HBM_BYTES_PER_S * 1e3
    bound = max(tc_ms, bytes_ms)
    log(f"attention B={B} N={ATTN_N} D={ATTN_D}: plan {how.splits} key splits of "
        f"{how.tiles_per_split} {D128_KEY_TILE}-key tiles, {how.blocks * B} blocks; err "
        f"{err:.3g} (tol {tol:.3g}), two launches and a graph replay bit-identical; device time "
        f"(CUDA-graph replay): kernel {dev_ms:.4f} ms, SDPA {lib_dev:.4f} ms ({lib_dev / dev_ms:.2f}x "
        f"the kernel's), plain {plain_dev:.4f} ms; kernel through a host loop {ms:.4f} ms; bound "
        f"{bound:.4f} ms ({'operations' if tc_ms >= bytes_ms else 'bytes'}; {bound / dev_ms:.1%} "
        "of it by device time)")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_device_ms=plain_dev,
                library_device_ms=lib_dev, bound_ms=bound,
                plan=dict(how._asdict(), key_tile=D128_KEY_TILE, blocks=how.blocks * B))


def phase_time_predictor(dev, work: str) -> dict:
    """The time predictor at full width (configs/splitting_hagen_time_predictor.json:
    inner 16, 16 groups, mults (1,2,4,8), dropout 0.2, patch 512, batch 8,
    seeded weights):
      * the forward (eval) with the kernels against the plain versions at
        B = 8 and B = 1, 29 GN+Swish and 1 attention launches a forward;
      * attention at B = 1, N = 4096, D = 128 beside SDPA and the plain
        version (`attention_at_batch`);
      * one train step (Adam, l2, dropout on) with the kernels against the
        same step through the plain versions, the masks from generators of
        one seed: loss and every gradient; then ms a step over TP_TIMED steps
        (median), samples/s, peak memory; the forward's time at B = 8;
      * `time_prediction_training.start_training` on seeded synthetic frames
        (8 train frames of 1024² and 2 val frames, so one val batch of 8): 2
        epochs of 3 steps, launches asserted, the best checkpoint written and
        reloaded by `load_time_predictor` into a fresh classifier that gives
        the same outputs as the weights it saved.
    Returns the launches of start_training and what the JSON line reports."""
    import copy

    import numpy as np
    import torch
    from diffsplitting_tpu_torch import time_prediction_training as tpt
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.models import set_dropout_generator
    from diffsplitting_tpu_torch.scripts import quality_joint_indi_synthetic as quality
    from diffsplitting_tpu_torch.train.optim import optax_adam

    t_phase = time.perf_counter()
    opt = load_json(TP_CONFIG)
    u, ds = opt["model"]["unet"], opt["datasets"]
    if ((u["inner_channel"], u["norm_groups"], tuple(u["channel_multiplier"]), u["dropout"],
         ds["patch_size"], ds["train"]["batch_size"]) != (16, 16, (1, 2, 4, 8), 0.2, PATCH, BATCH)):
        raise AssertionError(f"{TP_CONFIG} no longer has the time predictor's published widths")
    rng = np.random.default_rng(20)
    per_forward = dict(GN_ATTN_ONLY, group_norm_swish=29, attention=1)

    net = tpt.build_time_predictor(dict_to_nonedict(opt), seed=0).to(dev).eval()
    for B in (BATCH, 1):
        x = torch.from_numpy(tp_mixtures(rng, B, PATCH)[0]).to(dev)
        with torch.inference_mode():
            reset_launches()
            got = net(x)
            torch.cuda.synchronize()
            launches = read_launches()
            with plain_versions():
                want = net(x)
        err = max_err(got, want)
        # f32 on both sides; 29 GroupNorms and a softmax over 4096 keys in
        # another order, then a masked mean over 512² pixels
        tol = 1e-4 * max(1.0, want.abs().max().item())
        if launches != per_forward:
            raise AssertionError(f"time predictor forward B={B}: launches {launches}")
        if not (got.shape == (B,) and torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"time predictor forward B={B}: shape {tuple(got.shape)}, max "
                                 f"abs err {err} > {tol}")
        log(f"time predictor forward (eval) B={B} {PATCH}²: kernels vs plain versions max abs "
            f"err {err:.3g} (tol {tol:.3g}), t̂ {[round(v, 4) for v in got.tolist()]}, launches "
            f"{launches}")
    x8 = torch.from_numpy(tp_mixtures(rng, BATCH, PATCH)[0]).to(dev)
    walls = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(x8)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    fwd_ms = sorted(walls[1:])[2] * 1e3
    del net

    attn_b1 = attention_at_batch(dev, 1)

    lr = float(opt["train"]["optimizer"]["lr"])
    x, t = tp_mixtures(rng, BATCH, PATCH)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    steps = []
    for plain in (False, True):
        m = tpt.build_time_predictor(dict_to_nonedict(opt), seed=0).to(dev).train()
        set_dropout_generator(m, torch.Generator(device=dev).manual_seed(21))
        optim = optax_adam(m.parameters(), lr)
        reset_launches()
        with plain_versions() if plain else contextlib.nullcontext():
            loss = float(tpt.train_step(m, optim, x, y, "l2"))
        torch.cuda.synchronize()
        steps.append((m, optim, loss, read_launches()))
    (kern, kopt, kloss, klaunch), (plain, _, ploss, plaunch) = steps
    if klaunch != per_forward or plaunch["group_norm_swish"] or plaunch["attention"]:
        raise AssertionError(f"time predictor train step: launches {klaunch} with the kernels, "
                             f"{plaunch} through the plain versions")
    rel = abs(kloss - ploss) / abs(ploss)
    grad_norm = math.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in plain.parameters()
                              if p.grad is not None))
    if not rel <= 1e-5:
        raise AssertionError(f"time predictor train step: loss {kloss} vs {ploss}")
    worst, where, _ = compare_grads("time predictor, kernels vs plain versions", kern, plain,
                                    grad_norm)
    log(f"time predictor train step B={BATCH} {PATCH}² (dropout 0.2, the same masks): kernels "
        f"vs plain versions loss rel err {rel:.3g} (tol 1e-05), worst gradient err {worst:.3g} of "
        f"max(max|g|, 1e-5 grad_norm) (tol 0.005) at {where}; launches {klaunch}")
    del plain, steps
    torch.cuda.empty_cache()

    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TP_WARMUP + TP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpt.train_step(kern, kopt, x, y, "l2")
        torch.cuda.synchronize()
        if i >= TP_WARMUP:
            walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(walls)[len(walls) // 2] * 1e3
    log(f"time predictor train step B={BATCH} {PATCH}²: {TP_TIMED} steps "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {step_ms:.2f} ms, "
        f"{BATCH / step_ms * 1e3:.2f} samples/s, peak memory {peak / 2**30:.2f} GiB ({peak} "
        f"bytes); forward (eval) B={BATCH}: {fwd_ms:.2f} ms (median of 5, host clock ended by a "
        "synchronize)")
    del kern, kopt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    data = f"{work}/tp_data"
    quality.make_stacks(data, LOOP_FRAMES, LOOP_SIZE, seed=0)
    log(f"time predictor: synthesized {LOOP_FRAMES} + 2 frames of {LOOP_SIZE}² in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = copy.deepcopy(opt)
    for split_name in ("train", "val"):
        cfg["datasets"][split_name]["datapath"] = {
            "ch0": f"{data}/{split_name}/{split_name}_actin.tif",
            "ch1": f"{data}/{split_name}/{split_name}_mito.tif"}
    cfg["path"] = {"experiment_root": f"{work}/tp_experiment"}
    cfg["enable_wandb"] = False
    cfg = dict_to_nonedict(cfg)
    saved = []
    real_save = tpt.save_checkpoint

    def keep_a_copy(ckpt_dir, prefix, gen_state, payload):
        saved.append({k: v.detach().cpu().clone() for k, v in gen_state.items()})
        return real_save(ckpt_dir, prefix, gen_state, payload)

    tpt.save_checkpoint = keep_a_copy
    try:
        reset_launches()
        t0 = time.perf_counter()
        _, best = tpt.start_training(cfg, max_epochs=2, steps_per_epoch=3, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        tpt.save_checkpoint = real_save
    # 3 train steps and the val batches (at most 3) an epoch: at patch 512, 8
    # forwards (the 2 val frames give one batch of 8)
    val_batches = min(3, 2 * (LOOP_SIZE // PATCH) ** 2 // BATCH)
    forwards = 2 * (3 + val_batches)
    want = dict(GN_ATTN_ONLY, group_norm_swish=29 * forwards, attention=forwards)
    if launches != want:
        raise AssertionError(f"start_training: launches {launches}, expected {want}")
    prefix = f"{work}/tp_experiment/{tpt.BEST_PREFIX}"
    state = torch.load(prefix + "_opt.pth", map_location="cpu", weights_only=True)
    if not (saved and np.isfinite(best) and state["val_loss"] == best
            and state["iter"] == 3 * (state["epoch"] + 1)):
        raise AssertionError(f"start_training: best {best}, checkpoint {state['epoch']}, "
                             f"{state['iter']}, {state['val_loss']}")
    fresh = tpt.load_time_predictor(cfg, prefix, dev)
    ref = tpt.build_time_predictor(cfg)
    ref.load_state_dict(saved[-1])
    ref = ref.to(dev).eval()
    with torch.inference_mode():
        a, b = fresh(x), ref(x)
    if not torch.equal(a, b):
        raise AssertionError("the reloaded best checkpoint gives other outputs than its weights")
    log(f"time predictor: start_training 2 epochs x 3 steps + validation in {train_s:.1f} s, "
        f"best val loss {best:.5f} (epoch {state['epoch']}), saved {Path(prefix).name}_gen.pth "
        f"/ _opt.pth; reloaded into a fresh classifier: outputs equal to its saved weights' "
        f"({[round(v, 4) for v in a.tolist()]}); launches {launches}")
    del fresh, ref
    torch.cuda.empty_cache()
    log(f"time predictor phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, classifier=prefix, attn_b1=attn_b1, step_ms=step_ms,
                fwd_ms=fwd_ms, peak=peak)


def phase_t_refinement(dev, work: str, classifier: str) -> dict:
    """The t-refinement workflow's `main(argv)` on configs/splitting_hagen_indi_joint.json
    at patch 512, batch 8 (the 8 synthetic train frames of phase_time_predictor,
    center-cropped), `--num_steps 10`, each t_true of TREF_T_TRUE in a run of
    its own, with the classifier `phase_time_predictor` trained and joint
    weights seeded and trained here for TREF_TRAIN_STEPS steps on the same
    crops (so the PSNR grid's consensus lies inside (0, 1)), saved as a
    reference-layout `.pth`. Each run once with the kernels and once through
    the plain versions: the classifier's t̂ within 1e-4, the per-sample and
    consensus t equal, the PSNRs within 1e-3 dB, all finite. Asserted with
    the kernels, per t_true: 2 classifier forwards at B = 8, 16 one-step
    forwards at B = 1, 40 joint forwards at B = 8 (UNet forwards counted by
    batch), and 58 × 29 GN+Swish and 58 attention launches; none through the
    plain versions. The refined start must reach the joint inference: the
    two inferences are handed exactly (1 − consensus t, 0.5), and where the
    refined start is not 0.5 their outputs differ by more than 1e-3
    somewhere (their range-invariant PSNRs may not, as with weights trained
    this briefly). The consensus itself depends on the briefly trained joint
    weights, whose training is not bit-reproducible on the card, and 0.5 is
    one of the grid's answers: then both inferences start at 0.5 and the
    difference of their outputs is logged, not required. Logs each stage's
    host time."""
    import copy

    import numpy as np
    import torch
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.models import unet as unet_mod
    from diffsplitting_tpu_torch.scripts import t_refinement_workflow as workflow
    from diffsplitting_tpu_torch.train import DiffusionModel

    t_phase = time.perf_counter()
    opt = load_json(CONFIG)
    frames = f"{work}/tp_data/train"
    opt["datasets"]["val"]["datapath"] = {"ch0": f"{frames}/train_actin.tif",
                                          "ch1": f"{frames}/train_mito.tif"}
    cfg = f"{work}/tref_joint.json"
    with open(cfg, "w") as f:
        json.dump(opt, f)
    nopt = dict_to_nonedict(copy.deepcopy(opt))
    c0, c1 = workflow.load_normalized_channels(nopt, patch=PATCH)
    target = np.stack([c0, c1], axis=-1).astype(np.float32)
    m = DiffusionModel(nopt, device=dev, seed=0)
    t0 = time.perf_counter()
    for i in range(TREF_TRAIN_STEPS):
        m.feed_data({"target": target[(i % 2) * TRAIN_BATCH: (i % 2 + 1) * TRAIN_BATCH]})
        m.optimize_parameters()
    torch.cuda.synchronize()
    joint = f"{work}/tref_joint_gen.pth"
    torch.save({k: v.detach().cpu() for k, v in m.nets.state_dict().items()}, joint)
    log(f"t-refinement: joint weights from seed 0 and {TREF_TRAIN_STEPS} train steps on the "
        f"{len(target)} crops ({time.perf_counter() - t0:.1f} s, last loss "
        f"{m.get_current_log()['l_pix']:.4f}), saved as {Path(joint).name}")
    del m
    torch.cuda.empty_cache()

    calls = collections.Counter()
    forward = unet_mod.UNet.forward
    test = DiffusionModel.test
    outputs, starts = [], []

    def counted(self, x, time=None):
        calls["classifier" if self.time_mlp is None else "joint", x.shape[0]] += 1
        return forward(self, x, time)

    def kept(self, *args, **kwargs):
        out = test(self, *args, **kwargs)
        starts.append(kwargs["t_float_start"])
        outputs.append(out.detach().cpu())
        return out

    argv = ["-c", cfg, "--resume", joint, "--time-config", TP_CONFIG, "--time-resume",
            classifier, "--num_steps", str(TREF_STEPS), "--batch", str(BATCH), "--patch",
            str(PATCH), "--device", str(dev)]
    want_calls = {("classifier", BATCH): 2, ("joint", 1): 2 * BATCH, ("joint", BATCH): 4 * TREF_STEPS}
    forwards = sum(want_calls.values())  # 58 at batch 8
    per_t = dict(GN_ATTN_ONLY, group_norm_swish=29 * forwards, attention=forwards)
    launches, rows = collections.Counter(), []
    unet_mod.UNet.forward = counted
    DiffusionModel.test = kept
    try:
        for t_true in TREF_T_TRUE:
            pair = []
            for plain in (False, True):
                calls.clear()
                outputs.clear()
                starts.clear()
                reset_launches()
                t0 = time.perf_counter()
                with plain_versions() if plain else contextlib.nullcontext():
                    (row,) = workflow.main(argv + ["--t-true", str(t_true)])
                torch.cuda.synchronize()
                row["run_s"] = time.perf_counter() - t0
                got = read_launches()
                if dict(calls) != want_calls:
                    raise AssertionError(f"t-refinement t_true={t_true}: UNet forwards by batch "
                                         f"{dict(calls)}, expected {want_calls}")
                if plain and (got["group_norm_swish"] or got["attention"]):
                    raise AssertionError(f"t-refinement, plain versions: launches {got}")
                if not plain:
                    if got != per_t:
                        raise AssertionError(f"t-refinement t_true={t_true}: launches {got}, "
                                             f"expected {per_t}")
                    launches.update({k: got[k] for k in ("group_norm_swish", "attention")})
                    refined = row["refined_t_start"]
                    if starts != [refined, 0.5] or refined != 1.0 - row["consensus_t"]:
                        raise AssertionError(
                            f"t-refinement t_true={t_true}: joint inferences started at "
                            f"{starts}, expected [1 - consensus {row['consensus_t']}, 0.5]")
                    refined_out, naive_out = outputs
                    start_gap = float((refined_out - naive_out).abs().max())
                    if refined != 0.5 and not start_gap > 1e-3:
                        raise AssertionError(
                            f"t-refinement t_true={t_true}: refined start {refined}, joint "
                            f"outputs refined vs naive differ by at most {start_gap:.3g} "
                            f"(need > 1e-3)")
                    row["refined_vs_naive_max_abs"] = start_gap
                pair.append(row)
            kern, ref = pair
            psnr_keys = [k for k in kern if k.startswith("psnr_")]
            errs = {k: abs(kern[k] - ref[k]) for k in psnr_keys}
            ok = (abs(kern["classifier_t"] - ref["classifier_t"]) <= 1e-4
                  and all(kern[k] == ref[k] for k in ("per_sample_t_mean", "consensus_t",
                                                      "refined_t_start"))
                  and all(np.isfinite(kern[k]) for k in psnr_keys)
                  and max(errs.values()) <= 1e-3)
            if not ok:
                raise AssertionError(f"t-refinement t_true={t_true}: kernels {kern}, plain "
                                     f"versions {ref}")
            sec = kern["seconds"]
            log(f"t-refinement t_true={t_true}: classifier t̂ {kern['classifier_t']:.4f} (plain "
                f"{ref['classifier_t']:.4f}), consensus t {kern['consensus_t']:.2f} (equal), "
                f"per-sample mean {kern['per_sample_t_mean']:.4f}; joint outputs from the refined "
                f"start {kern['refined_t_start']:.2f} and from 0.5 differ by up to "
                f"{kern['refined_vs_naive_max_abs']:.4g}"
                + (" (both start at 0.5: not required to differ)"
                   if kern["refined_t_start"] == 0.5 else "")
                + f"; PSNR refined "
                f"{kern['psnr_refined_ch0']:.3f} / {kern['psnr_refined_ch1']:.3f} dB, naive "
                f"{kern['psnr_naive_ch0']:.3f} / {kern['psnr_naive_ch1']:.3f} dB (kernels vs "
                f"plain versions max {max(errs.values()):.3g} dB, tol 1e-3); host s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
                + f"; whole run {kern['run_s']:.2f} s (plain versions {ref['run_s']:.2f} s); "
                f"launches {per_t['group_norm_swish']} GN+Swish, {per_t['attention']} attention")
            rows.append(kern)
    finally:
        unet_mod.UNet.forward = forward
        DiffusionModel.test = test
    log(f"t-refinement phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(launches), rows=rows, joint=joint)


SERVE_STEPS = 10  # N of the DeepCache and sliding-window phases
SW_WINDOW = 8


def serving_model(dev, weights: str):
    """The Hagen joint config's SplittingModel with the reference-layout
    weights at `weights`."""
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.serving import SplittingModel
    from diffsplitting_tpu_torch.utils.weights import load_reference_checkpoint

    model = SplittingModel(dict_to_nonedict(load_json(CONFIG)), device=dev, seed=0)
    model.nets.load_state_dict(load_reference_checkpoint(weights, "joint_indi"))
    return model


def psnr_per_channel(want, got) -> list:
    """PSNR(got against want) of each channel, the mean over the first axis
    (utils/psnr.py, float64 on the host)."""
    import numpy as np
    from diffsplitting_tpu_torch.utils.psnr import PSNR

    want, got = want.cpu().numpy(), got.cpu().numpy()
    return [float(np.mean(PSNR(want[..., c], got[..., c]))) for c in range(want.shape[-1])]


def check_close(what: str, got, want) -> float:
    """max |got − want| within 1e-3·max|want| + 1e-4 (the slice's tolerance)."""
    err = max_err(got, want)
    tol = 1e-3 * want.abs().max().item() + 1e-4
    if not (got.shape == want.shape and err <= tol):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}, max abs "
                             f"err {err} > {tol}")
    log(f"{what}: max abs err {err:.3g} (tol {tol:.3g}), bit-equal {bool(torch_equal(got, want))}")
    return err


def phase_deepcache(dev, weights: str) -> dict:
    """DeepCache serving of the Hagen joint config at full width (patch 512,
    batch 8, depth 1) on the slice's two synthetic 1024² frames (18 tiles, 3
    tile batches), N = SERVE_STEPS = 10, with the joint weights at `weights`
    (phase_t_refinement's: seed 0 and 30 train steps):
      * tiles/s (median of 3) and peak memory of the exact chain unfused and
        fused, DeepCache 'auto' (interval 4) and interval 5 (`phase_slice`),
        with their launches asserted: a full pass 29 GN+Swish and 1
        attention, a shallow pass (stem, encoder and decoder stage 0, head) 7
        and none; 'auto' 3 full and 7 shallow passes a chain: 816 and 18 over
        two nets and 3 tile batches; interval 5: 684 and 12;
      * the 'auto' chain with the kernels against the same chain through the
        plain versions on a tile batch (the frames' quadrants), and interval 1
        against the exact chain from the same generator seed, at the slice's
        tolerance (bit-equality logged);
      * PSNR(cached, exact) a channel over the two frames at 'auto' and 5."""
    import torch

    t_phase = time.perf_counter()
    log(f"DeepCache phase: joint weights {Path(weights).name}")
    model = serving_model(dev, weights)
    unet = model.unets()[0]
    if len(unet.downs) != 8 or len(unet.ups) != 11:  # mults (1,2,4,8), one res block
        raise AssertionError("the Hagen joint UNet changed; the launch counts below assume it")
    _, frames = slice_inputs(dev)
    n_tiles = 18
    chains = 2 * math.ceil(n_tiles / BATCH)  # two nets a tile batch
    forwards = chains * SERVE_STEPS
    counted = {}

    def counts(full: int, shallow: int) -> dict:
        return dict(GN_ATTN_ONLY, group_norm_swish=chains * (29 * full + 7 * shallow),
                    attention=chains * full)

    model.set_deepcache(None)
    exact, counted["exact unfused"], exact_stats = phase_slice(
        model, frames, False, counts(SERVE_STEPS, 0), n_tiles, forwards, SERVE_STEPS,
        "exact chain")
    _, counted["exact fused"], fused_stats = phase_slice(
        model, frames, True,
        dict(GN_ATTN_ONLY, group_norm_swish=forwards, attention=forwards,
             conv_gn=31 * forwards, sites_kernel=31 * forwards), n_tiles, forwards,
        SERVE_STEPS, "exact chain")
    rows = {"exact unfused": exact_stats, "exact fused": fused_stats}
    for interval, want in (("auto", (816, 18)), (5, (684, 12))):
        model.set_deepcache(interval, 1)
        k = model.dc_interval(SERVE_STEPS)
        full = len(range(0, SERVE_STEPS, k))
        expected = counts(full, SERVE_STEPS - full)
        if (expected["group_norm_swish"], expected["attention"]) != want:
            raise AssertionError(f"DeepCache {interval}: expected launches {expected}, not {want}")
        label = f"DeepCache {interval} (interval {k}, depth 1)"
        out, counted[label], stats = phase_slice(
            model, frames, False, expected, n_tiles, f"{chains * full} full and "
            f"{chains * (SERVE_STEPS - full)} shallow", SERVE_STEPS, label)
        stats["psnr_vs_exact"] = psnr_per_channel(exact, out)
        log(f"{label}: PSNR(cached, exact) {stats['psnr_vs_exact'][0]:.2f} / "
            f"{stats['psnr_vs_exact'][1]:.2f} dB, "
            f"{stats['tiles_per_s'] / exact_stats['tiles_per_s']:.3f}x "
            "the exact unfused chain's tiles/s")
        rows[label] = stats
        if interval == "auto":
            # one tile batch: the frames' four quadrants
            tiles = torch.cat([frames[:, i:i + PATCH, j:j + PATCH] for i in (0, PATCH)
                               for j in (0, PATCH)])[:BATCH]
            outs = []
            for plain in (False, True):
                model.generator.manual_seed(0)
                plain_or_not = plain_versions() if plain else contextlib.nullcontext()
                with torch.inference_mode(), plain_or_not:
                    outs.append(model.test(tiles, num_timesteps=SERVE_STEPS))
            err_plain = check_close(f"{label}, a tile batch: kernels vs plain versions", *outs)
    model.set_deepcache(1, 1)
    model.generator.manual_seed(0)
    from diffsplitting_tpu_torch.predict import predict_frames

    one = predict_frames(model, frames, PATCH, BATCH, num_steps=SERVE_STEPS)
    check_close("DeepCache interval 1 vs the exact chain, same seed", one, exact)
    launches = collections.Counter()
    for c in counted.values():
        launches.update({k: c[k] for k in ("group_norm_swish", "attention", "conv_gn")})
    del model, frames, exact, one
    torch.cuda.empty_cache()
    log(f"DeepCache phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(launches), rows=rows, err_plain=err_plain)


def phase_sliding_window(dev, weights: str) -> dict:
    """Sliding-window serving of the Hagen joint config (the weights at
    `weights`) on one 512² tile at batch 1, N = SERVE_STEPS, W = 8 (a
    windowed forward is a batch-8 forward):
      * τ = 0 against the exact chain at batch 1 from the same generator
        seed, and with the kernels against the plain versions, at the
        slice's tolerance; 20 sweeps (10 a net) and 29 GN+Swish and 1
        attention launch a sweep and net, asserted;
      * at τ = 0 and 0.1, and for the exact chain at batch 1: sweeps,
        seconds a chain (median of 3, host clock ended by a synchronize) and
        PSNR against the exact chain a channel."""
    import torch

    t_phase = time.perf_counter()
    model = serving_model(dev, weights)
    tile = slice_inputs(dev)[1][:1, :PATCH, :PATCH]

    def chain(window=None, tau=0.0, plain=False):
        model.set_sliding_window(window, tau)
        model.generator.manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), plain_versions() if plain else contextlib.nullcontext():
            out = model.test(tile, num_timesteps=SERVE_STEPS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    chain(), chain(SW_WINDOW)  # warm-up
    exact, _ = chain()
    reset_launches()
    windowed, _ = chain(SW_WINDOW, 0.0)
    launches = read_launches()
    sweeps = model.last_sliding_sweeps
    want = dict(GN_ATTN_ONLY, group_norm_swish=29 * 2 * SERVE_STEPS, attention=2 * SERVE_STEPS)
    if sweeps != 2 * SERVE_STEPS or launches != want:
        raise AssertionError(f"window τ=0: {sweeps} sweeps, launches {launches}; expected "
                             f"{2 * SERVE_STEPS} and {want}")
    plain, _ = chain(SW_WINDOW, 0.0, plain=True)
    err = check_close("window W=8 τ=0 vs the exact chain at batch 1", windowed, exact)
    err_plain = check_close("window W=8 τ=0: kernels vs plain versions", windowed, plain)
    rows = {}
    for label, window, tau in (("exact B=1", None, 0.0), ("window τ=0", SW_WINDOW, 0.0),
                               ("window τ=0.1", SW_WINDOW, 0.1)):
        runs = [chain(window, tau) for _ in range(3)]
        secs = sorted(r[1] for r in runs)
        row = dict(seconds=secs[1], runs=secs,
                   sweeps=model.last_sliding_sweeps if window else None,
                   psnr_vs_exact=psnr_per_channel(exact, runs[0][0]) if window else None)
        rows[label] = row
        log(f"sliding window phase, {label} (N={SERVE_STEPS}, one {PATCH}² tile): "
            f"{row['seconds']:.4f} s a chain (median of {', '.join(f'{x:.4f}' for x in secs)})"
            + (f", {row['sweeps']} sweeps, PSNR vs exact {row['psnr_vs_exact'][0]:.2f} / "
               f"{row['psnr_vs_exact'][1]:.2f} dB" if window else ""))
    del model
    torch.cuda.empty_cache()
    log(f"sliding window phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches={k: launches[k] for k in ("group_norm_swish", "attention")},
                rows=rows, err=max(err, err_plain))


SR3_CONFIG = "configs/sr_sr3_16_128.json"
DDPM_CONFIG = "configs/sr_ddpm_16_128.json"
SAMPLE_CONFIG = "configs/sample_sr3_128.json"
# sr_sr3_16_128's UNet (inner 64, mults (1, 2, 4, 8, 8), 2 res blocks, attention
# at 16²): its parameters, its down and up layers, and its GN+Swish and
# attention calls a forward
SR3_PARAMS, SR3_LAYERS, SR3_GN_FWD, SR3_ATTN_FWD = 97807491, (15, 19), 55, 6
SR3_IMAGES = 4  # LR/HR/SR triples written; serving takes the first, training all four
SR3_CUT_STEPS = 20  # the val schedule cut for the kernels-vs-plain chain and the profile
# DDPM's infer.py chain and sample.py's chain, cut from the configs' 2000 steps:
# the two 2000-step sr3 chains alone fill the phase's 120 s budget (host-bound
# at batch 1), and a fixed cut keeps forwards/s comparable between runs
SR3_SERVE_CUT_STEPS = 50
SAMPLE_DDIM_STEPS = 10  # sample.py's --ddim run, respaced from SR3_SERVE_CUT_STEPS
SR3_TRAIN_BATCH, SR3_TRAIN_WARMUP, SR3_TRAIN_TIMED = 4, 2, 10


def write_lrhr_root(work: str, n: int, size: int, seed: int) -> str:
    """n seeded smooth RGB images of size² (sums of colored Gaussian blobs,
    numpy) through the port's prepare_data (PIL bicubic resize to size / 8
    and back): an LRHR root with lr_<l>, hr_<r> and sr_<l>_<r> PNG dirs."""
    import numpy as np
    from PIL import Image
    from diffsplitting_tpu_torch.data.prepare_data import prepare

    rng = np.random.default_rng(seed)
    src = Path(work) / f"sr_src_{size}"
    src.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(16):
            cy, cx = rng.uniform(0, 1, 2)
            r = rng.uniform(0.03, 0.15)
            img += rng.uniform(0, 1, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                                 / (2 * r * r))[..., None]
        img = 255 * img / img.max()
        Image.fromarray(img.astype(np.uint8)).save(src / f"{i}.png")
    root = str(Path(work) / f"sr_{size // 8}_{size}")
    if prepare(str(src), root, n_worker=1, sizes=(size // 8, size)) != n:
        raise AssertionError("prepare_data wrote the wrong number of triples")
    return root


def sr_config(work: str, base: str, dataroot: str, val_items: int, steps=None) -> str:
    """`base` with its datasets at `dataroot` (val: `val_items` items) and,
    when `steps` is given, its val schedule cut to that many steps; written
    as JSON under `work`."""
    from diffsplitting_tpu_torch.config import load_json

    opt = load_json(base)
    for phase in ("train", "val"):
        opt["datasets"][phase]["dataroot"] = dataroot
    opt["datasets"]["val"]["data_len"] = val_items
    if steps is not None:
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = steps
    path = Path(work) / f"{Path(base).stem}_{val_items}_{steps}.json"
    path.write_text(json.dumps(opt, indent=1))
    return str(path)


def conv_site_plan(unet) -> tuple:
    """(sites the conv_gn kernel takes, sites on library ops) of one fused
    forward, from the UNet's widths by `conv_gn_takes`, as the walk plans
    them: two a ResnetBlock (the second with the block's input as its
    residual) and one an upsample."""
    from diffsplitting_tpu_torch.models.blocks import ResnetBlockWithAttn, Upsample
    from diffsplitting_tpu_torch.ops import conv_gn_takes

    sites = []
    for layer in list(unet.downs[1:]) + list(unet.mid) + list(unet.ups):
        if isinstance(layer, ResnetBlockWithAttn):
            conv = layer.res_block.block1.block[3]
            sites += [(conv.in_channels, conv.out_channels, 0),
                      (conv.out_channels, conv.out_channels, conv.in_channels)]
        elif isinstance(layer, Upsample):
            sites.append((layer.conv.in_channels, layer.conv.out_channels, 0))
    kernel = sum(conv_gn_takes(*s) for s in sites)
    return kernel, len(sites) - kernel


@contextlib.contextmanager
def fused_env(on: bool):
    """DSP_FUSED=1 while `on`, as a user switches the fused forward on."""
    import os

    old = os.environ.get("DSP_FUSED")
    if on:
        os.environ["DSP_FUSED"] = "1"
    else:
        os.environ.pop("DSP_FUSED", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DSP_FUSED", None)
        else:
            os.environ["DSP_FUSED"] = old


def serve_cli(label: str, cli, argv: list, per_forward: dict, steps: int, want=None) -> dict:
    """One run of a CLI's `main(argv)` (one item, one chain of `steps`
    steps) with every launch count set to 0 just before and read just after:
    the launches must be `per_forward` × steps, or `want` (a dict, or a
    function of the CLI's result giving one) where a step's passes differ.
    Returns the CLI's result with the launches, seconds a chain, steps (one
    UNet call each) a second and peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    int8 = int8_launches()
    peak = torch.cuda.max_memory_allocated()
    if want is None:
        want = {k: v * steps for k, v in per_forward.items()}
    elif callable(want):
        want = want(out)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    secs = out["seconds"][0]
    log(f"{label}: one {steps}-step chain at batch 1 in {secs:.3f} s ({steps / secs:.1f} "
        f"forwards/s; the CLI's run {wall:.1f} s), peak memory {peak / 2**30:.2f} GiB ({peak} "
        f"bytes), launches {launches}")
    return dict(out, launches=launches, chain_s=secs, forwards_per_s=steps / secs, peak=peak,
                int8_conv=int8)


def chain_profile(model, steps: int, fused: bool, full_steps: int, full_chain_s: float,
                  label: str = "sr3 profile") -> dict:
    """The device's busy time a step of one conditional chain of `steps`
    steps on the fed input, unfused or fused, under torch.profiler, and the
    idle share of an unprofiled chain of `full_steps` steps that took
    `full_chain_s` seconds: 1 − busy a step × full_steps / full_chain_s. The
    profiler adds host time to every launch, so its own wall time gives a
    larger idle share; that one is kept as `idle_profiled`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.test(fused=fused)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    if not busy:
        log(f"{label}: no device events recorded; idle share not measured")
        return dict(wall_ms=wall_ms, busy_ms=None, idle=None, idle_profiled=None)
    idle = 1 - busy / steps * full_steps / (full_chain_s * 1e3)
    log(f"{label} ({steps}-step chain, batch 1, fused={fused}): device busy {busy:.1f} ms "
        f"({busy / steps:.4f} ms a step); idle share of the unprofiled {full_steps}-step chain "
        f"({full_chain_s:.3f} s) {idle:.2%}; with the profiler on, wall {wall_ms:.1f} ms, idle "
        f"share {1 - busy / wall_ms:.2%}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle=idle, idle_profiled=1 - busy / wall_ms)


def phase_sr3(dev, work: str) -> dict:
    """SR3 / DDPM super-resolution at the full width of configs/sr_sr3_16_128.json
    (inner 64, mults (1, 2, 4, 8, 8), 2 res blocks, attention at 16², 32
    groups, 128² images, 97,807,491 parameters, seeded weights) on
    SR3_IMAGES seeded synthetic LR/HR/SR triples (16 -> 128, numpy and PIL
    bicubic, through the port's prepare_data):
      * one forward at B = 1 and B = 4 with the kernels against the plain
        versions, and the fused walk against the unfused forward; 55
        GN+Swish and 6 wide-route attention launches a forward (5 at N = 256,
        the 16² sites, 1 at N = 64, the 8² mid block); GN+Swish at each of
        the forward's (C, H, W) against its plain version (timed at B = 1),
        and conv_gn at each site of the fused walk (the rest planned to
        library ops by `conv_gn_takes`, counts asserted); the wide attention
        kernel at (1, 256, 512) and (1, 64, 512) runs in
        phase_attention_any_d (SR3_SHAPES);
      * the port's infer.py `main` over the config's full 2000-step val
        schedule on one image, unfused (110,000 GN+Swish and 12,000 wide
        attention launches) and with DSP_FUSED=1 (the plan's counts × 2000):
        seconds a chain, forwards/s, peak memory; the device time a step of
        a chain cut to SR3_CUT_STEPS steps under the profiler, and from it
        the device-idle share of the unprofiled 2000-step chains, unfused
        and fused; that cut chain with the kernels against the plain
        versions, and fused against unfused, from the same noise;
      * DDPM (configs/sr_ddpm_16_128.json) through infer.py, one chain,
        unfused; sample.py (configs/sample_sr3_128.json) in the val phase,
        one unconditional sample, and one with `--ddim 10` (10 forwards, the
        final frame only); each cut to SR3_SERVE_CUT_STEPS steps (logged);
      * one sr3 train step at batch 4, 128², dropout 0.2, kernels against
        the plain versions with the same draws and dropout masks
        (compare_steps), then 10 timed steps (ms, samples/s, peak);
      * eval.py on the PNGs infer.py wrote."""
    import numpy as np
    import torch
    from PIL import Image
    from diffsplitting_tpu_torch import eval as sr_eval, infer, sample
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data.lrhr_dataset import LRHRDataset
    from diffsplitting_tpu_torch.kernels import conv_gn_variants, groupnorm_variants
    from diffsplitting_tpu_torch.models import fused_unet_forward
    from diffsplitting_tpu_torch.train import DiffusionModel

    t_phase = time.perf_counter()
    base = dict_to_nonedict(load_json(SR3_CONFIG))
    T = int(base["model"]["beta_schedule"]["val"]["n_timestep"])
    size = int(base["model"]["diffusion"]["image_size"])
    groups = int(base["model"]["unet"]["norm_groups"] or 32)
    root = write_lrhr_root(work, SR3_IMAGES, size, seed=30)
    cfg = sr_config(work, SR3_CONFIG, root, 1)
    rootdir = str(Path(work) / "sr_experiments")

    # ------------------------------------------------ serving, unfused
    gn_fwd, attn_fwd = SR3_GN_FWD, SR3_ATTN_FWD
    per_forward = dict(GN_ATTN_ONLY, group_norm_swish=gn_fwd, attention=0,
                       attention_wide=attn_fwd)
    unfused = serve_cli("sr3 infer.py unfused", infer, ["-c", cfg, "-rootdir", rootdir],
                        per_forward, T)
    model = unfused["model"]
    net = model.nets.denoise_fn
    n_params = sum(p.numel() for p in net.parameters())
    widths = [m.out_channels for m in net.modules() if isinstance(m, torch.nn.Conv2d)
              and m.kernel_size == (3, 3)]
    unet_opt = base["model"]["unet"]
    if (n_params, max(widths), (len(net.downs), len(net.ups)), net.cond_type) != (
            SR3_PARAMS, int(unet_opt["inner_channel"]) * max(unet_opt["channel_multiplier"]),
            SR3_LAYERS, "noise_level"):
        raise AssertionError(f"{SR3_CONFIG}: {n_params} parameters, widest conv {max(widths)}, "
                             f"{len(net.downs)} down and {len(net.ups)} up layers, "
                             f"cond_type {net.cond_type}")
    results = unfused["results"]
    pngs = sorted(p.name for p in Path(results).glob("*.png"))
    if pngs != ["0_1_hr.png", "0_1_inf.png", "0_1_sr.png", "0_1_sr_process.png"]:
        raise AssertionError(f"infer.py wrote {pngs}")
    sr = np.asarray(Image.open(Path(results) / "0_1_sr.png"))
    if sr.shape != (size, size, 3):
        raise AssertionError(f"infer.py's SR image is {sr.shape}")

    # ------------------------------------------------ kernels at this config's shapes
    g = torch.Generator(device=dev).manual_seed(31)
    checks = {}
    with torch.inference_mode():
        net.eval()
        for B in (1, SR3_TRAIN_BATCH):
            x = torch.randn(B, size, size, net.in_channel, device=dev, generator=g)
            level = torch.rand(B, device=dev, generator=g)
            reset_launches()
            got = net(x, level)
            launched = read_launches()
            if (launched["group_norm_swish"], launched["attention_wide"],
                    launched["attention"]) != (gn_fwd, attn_fwd, 0):
                raise AssertionError(f"sr3 forward B={B}: launches {launched}")
            fused = fused_unet_forward(net, x, level)
            with plain_versions():
                want = net(x, level)
                fused_plain = fused_unet_forward(net, x, level)
            tol = 1e-3 * want.abs().max().item() + 1e-4
            for what, a, b in (("kernels vs plain", got, want),
                               ("fused vs unfused (kernels)", fused, got),
                               ("fused kernels vs fused plain", fused, fused_plain)):
                err = max_err(a, b)
                if not (a.shape == b.shape and err <= tol):
                    raise AssertionError(f"sr3 forward B={B}, {what}: max abs err {err} > {tol}")
                checks[f"B={B} {what}"] = err
                log(f"sr3 forward B={B} {size}², {what}: max abs err {err:.3g} (tol {tol:.3g})")
            if B == 1:
                shapes = groupnorm_variants.gn_shapes(net, x, level)
                sites = conv_gn_variants.conv_gn_sites(net, x, level)
        del x, got, fused, want, fused_plain
    if sum(shapes.values()) != gn_fwd:
        raise AssertionError(f"expected {gn_fwd} GN+Swish calls a forward, saw {dict(shapes)}")
    plan = conv_site_plan(net)
    if sum(sites.values()) != plan[0]:
        raise AssertionError(f"fused walk: {sum(sites.values())} conv_gn sites, planned {plan}")
    gn, gn_err = phase_group_norm(dev, shapes, groups, batch=1)
    _, gn_err4 = phase_group_norm(dev, shapes, groups, batch=SR3_TRAIN_BATCH, timed=False)
    _, conv_err = phase_conv_gn(dev, sites, batch=1, timed=False)
    log(f"sr3 fused walk: {plan[0]} conv sites on the conv_gn kernel, {plan[1]} on library ops "
        "(conv_gn_takes)")

    # ------------------------------------------------ serving, fused
    with fused_env(True):
        fused_run = serve_cli(
            "sr3 infer.py DSP_FUSED=1", infer, ["-c", cfg, "-rootdir", rootdir],
            dict(GN_ATTN_ONLY, group_norm_swish=1, attention=0, attention_wide=attn_fwd,
                 conv_gn=plan[0], sites_kernel=plan[0], sites_library=plan[1]), T)
    del fused_run["model"]

    # ------------------------------------------------ a cut chain: profile, plain, fused
    cut = dict(base["model"]["beta_schedule"]["val"], n_timestep=SR3_CUT_STEPS)
    model.set_new_noise_schedule(cut, "cut")
    item = LRHRDataset(root, "img", size // 8, size, split="val", need_LR=False)[0]
    model.feed_data({"input": item["SR"][None], "target": item["HR"][None]})
    prof = {fused: chain_profile(model, SR3_CUT_STEPS, fused, T, run["chain_s"])
            for fused, run in ((False, unfused), (True, fused_run))}
    outs = {}
    for label, fused, plain in (("kernels", False, False), ("plain", False, True),
                                ("fused", True, False)):
        model.sample_generator.manual_seed(0)
        with plain_versions() if plain else contextlib.nullcontext():
            outs[label] = model.test(fused=fused).clone()
    cut_errs = [check_close(f"sr3 {SR3_CUT_STEPS}-step chain, {what}", outs[a], outs[b])
                for what, a, b in (("kernels vs plain versions", "kernels", "plain"),
                                   ("fused vs unfused", "fused", "kernels"))]
    del model, unfused["model"], outs
    torch.cuda.empty_cache()

    # ------------------------------------------------ DDPM and sample.py, cut
    steps = SR3_SERVE_CUT_STEPS
    log(f"sr3 phase: DDPM's infer.py chain and sample.py's chain are cut to {steps} of "
        f"{T} steps")
    ddpm = serve_cli(f"ddpm infer.py unfused ({steps} steps)", infer,
                     ["-c", sr_config(work, DDPM_CONFIG, root, 1, steps),
                      "-rootdir", str(Path(work) / "ddpm_experiments")], per_forward, steps)
    if ddpm["model"].which != "ddpm" or ddpm["model"].nets.denoise_fn.cond_type != "time":
        raise AssertionError("the DDPM config did not build a ddpm model")
    del ddpm["model"]
    gen = serve_cli(f"sample.py val phase ({steps} steps)", sample,
                    ["-c", sr_config(work, SAMPLE_CONFIG, root, 1, steps),
                     "-p", "val", "-rootdir", str(Path(work) / "sample_experiments")],
                    per_forward, steps)
    final = np.asarray(Image.open(Path(gen["results"]) / "0_1_sample.png"))
    if final.shape != (size, size, 3) or gen["model"].process.conditional:
        raise AssertionError(f"sample.py wrote a {final.shape} sample")
    del gen["model"]
    # respaced DDIM through sample.py: 10 forwards, the final frame only
    gen_ddim = serve_cli(f"sample.py val phase --ddim {SAMPLE_DDIM_STEPS} (of {steps} steps)",
                         sample, ["-c", sr_config(work, SAMPLE_CONFIG, root, 1, steps),
                                  "-p", "val", "-rootdir", str(Path(work) / "sample_ddim"),
                                  "--ddim", str(SAMPLE_DDIM_STEPS)],
                         per_forward, SAMPLE_DDIM_STEPS)
    written = sorted(p.name for p in Path(gen_ddim["results"]).glob("*.png"))
    if written != ["0_1_sample.png"] or gen_ddim["model"].ddim != (SAMPLE_DDIM_STEPS, 0.0):
        raise AssertionError(f"sample.py --ddim wrote {written}")
    del gen_ddim["model"]
    torch.cuda.empty_cache()

    # ------------------------------------------------ the train step
    opt = dict_to_nonedict(load_json(cfg))
    if float(opt["model"]["unet"]["dropout"]) != 0.2:
        raise AssertionError(f"{SR3_CONFIG} no longer trains with dropout 0.2")
    ds = LRHRDataset(root, "img", size // 8, size, split="val", need_LR=False)
    items = [ds[i] for i in range(SR3_TRAIN_BATCH)]
    batch = {"target": np.stack([it["HR"] for it in items]),
             "input": np.stack([it["SR"] for it in items])}
    kern = DiffusionModel(opt, device=dev, seed=0)
    plain = DiffusionModel(opt, device=dev, seed=0, state_dict=kern.nets.state_dict())
    gd = torch.Generator(device=dev).manual_seed(32)
    sched = kern.current_sched
    t = 1 + int(torch.randint(0, sched.num_timesteps, (), generator=gd, device=dev))
    lo, hi = sched.sqrt_alphas_cumprod_prev[t - 1], sched.sqrt_alphas_cumprod_prev[t]
    gamma = lo + torch.rand(SR3_TRAIN_BATCH, device=dev, generator=gd) * (hi - lo)
    noise = torch.randn(SR3_TRAIN_BATCH, size, size, 3, device=dev, generator=gd)
    draws = [(t, gamma, noise)]
    for m in (kern, plain):
        m.feed_data(batch)
    torch.cuda.synchronize()
    reset_launches()
    kern.optimize_parameters(draws)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != per_forward:
        raise AssertionError(f"sr3 train step: launches {launches}, expected {per_forward}")
    with plain_versions():
        plain.optimize_parameters(draws)
    compare_steps(f"sr3 kernels vs plain versions, B={SR3_TRAIN_BATCH} {size}², dropout 0.2, "
                  f"t={t}", kern, plain)
    del plain
    torch.cuda.empty_cache()
    walls = []
    for step in range(SR3_TRAIN_WARMUP + SR3_TRAIN_TIMED):
        if step == SR3_TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern.optimize_parameters()
        torch.cuda.synchronize()
        if step >= SR3_TRAIN_WARMUP:
            walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    loss = kern.get_current_log()["l_pix"]
    if not np.isfinite(loss):
        raise AssertionError(f"sr3 train loss {loss}")
    train_ms = sorted(walls)[len(walls) // 2] * 1e3
    log(f"sr3 train step B={SR3_TRAIN_BATCH} {size}², dropout 0.2: {SR3_TRAIN_TIMED} steps "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {train_ms:.2f} ms, "
        f"{SR3_TRAIN_BATCH / train_ms * 1e3:.2f} samples/s, peak memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes), loss {loss:.2f}")
    del kern
    torch.cuda.empty_cache()

    # ------------------------------------------------ eval.py on infer.py's PNGs
    scores = sr_eval.main(["-p", results])
    if scores["n"] != 1 or not (np.isfinite(scores["psnr"]) and -1 <= scores["ssim"] <= 1):
        raise AssertionError(f"eval.py on {results}: {scores}")
    log(f"sr3 eval.py (random weights, one image): PSNR {scores['psnr']:.4f} dB, SSIM "
        f"{scores['ssim']:.4f}")

    secs = time.perf_counter() - t_phase
    log(f"sr3 phase: {secs:.1f} s")
    counted = (unfused["launches"], fused_run["launches"], ddpm["launches"], gen["launches"],
               gen_ddim["launches"], launches)
    return dict(launches={k: sum(c[k] for c in counted) for k in
                          ("group_norm_swish", "attention_wide", "conv_gn")},
                gn=gn, gn_err=max(gn_err, gn_err4), conv_err=conv_err, checks=checks,
                cut_errs=cut_errs, profile=prof, seconds=secs,
                chains={k: {f: r[f] for f in ("chain_s", "forwards_per_s", "peak")}
                        for k, r in (("sr3 unfused", unfused), ("sr3 fused", fused_run),
                                     ("ddpm unfused", ddpm), ("sample", gen),
                                     ("sample ddim", gen_ddim))},
                train=dict(ms=train_ms, samples_per_s=SR3_TRAIN_BATCH / train_ms * 1e3,
                           peak=peak))



ATTN_BF16_DESIGN = (
    "wgmma.mma_async m64n64k16 bf16 with f32 accumulators (S = Q K^T with Q and K by 128-byte-"
    "swizzle descriptors; O += P V with P from registers and V read transposed), 64 queries a "
    "block, Q, K and V by TMA tensor maps into an mbarrier ring filled by one producer thread; "
    "up to D = 256 a block holds O and walks its keys with an online softmax; above, the wide "
    "kernel sums S over all of D itself for a group of 128 keys, takes its softmax in one "
    "pass, then O in 256-wide chunks one after another; keys split across blocks by "
    "ops.attention.plan, the splits' f32 partials combined in split order by a second launch")
GN_DESIGN = ("two routes chosen per call by ops.groupnorm.plan: cluster (one launch; a "
             "thread-block cluster of up to 8 blocks holds a slab of whole groups of one element "
             "in shared memory, loaded by cp.async (a slab of the row) or TMA bulk copies (the "
             "whole row) in 4 stages; f32 sums added across the cluster through distributed "
             "shared memory in rank order; y stored from shared memory) or stream (two launches: "
             "per-chunk sums, added across clusters of up to 8 chunks where an element has more "
             "than 128; every normalize block folds its element's partials, in a fixed order, "
             "into a_c and b_c, and reads x again)")
SR512_CONFIG = "configs/sr_sr3_64_512.json"
# sr_sr3_64_512's UNet (inner 64, mults (1, 2, 4, 8, 16), 1 res block, 16
# groups, attention only in the mid block at 32², D = 1024; bf16, remat): its
# parameters, and its GN+Swish and attention calls a forward
SR512_PARAMS, SR512_GN_FWD, SR512_ATTN_FWD = 155334339, 35, 1
SR512_BLOCKS = 17  # ResnetBlockWithAttn modules, each rematerialized in the backward
SR512_SERVE_STEPS = 2000  # the config's val schedule, run in full
SR512_CUT_STEPS = 20  # the chain cut for kernels vs plain versions and the profile
SR512_TRAIN_BATCH, SR512_TRAIN_WARMUP, SR512_TRAIN_TIMED = 2, 1, 3
BF16_FLOPS_PER_S = 989e12
# conv sites a fused forward plans to the bf16 conv_gn kernel (the 512² and
# 256² ResnetBlock and upsample convs) and to library ops
SR512_CONV_FWD = (11, 27)
# the bf16 attention kernel at the mid block (B = 1 serving, 2 training) and
# at other head dims (N = 1024)
SR512_ATTN_SHAPES = [(1, 1024, 1024), (2, 1024, 1024), (1, 1024, 512), (1, 1024, 128),
                     (1, 1024, 64)]


def phase_gn_bf16(dev, shapes, groups) -> tuple:
    """The bf16 GN+Swish kernel at every (C, H, W) of one sr_sr3_64_512
    forward at batch 1, and the f32 kernel at its C > 1024 shapes: each
    against an f32 reference from the same inputs (bf16: at most 2x the plain
    bf16 version's error; f32: the f32 kernel's 1e-4 tolerance), two launches
    bit-identical, a CUDA-graph replay bit-identical to the eager launch, and
    the times (host loop, device time by CUDA-graph replay, plain,
    `F.silu(F.group_norm)` in the same dtype through a host loop and by
    device time, bound) summed over the forward's calls (bf16; by shape with
    the kernel's route in tot["by_shape"]) or listed by shape (f32)."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import fused_group_norm_swish, group_norm_swish_reference

    g = torch.Generator(device=dev).manual_seed(41)
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               library_device_ms=0.0)
    worst, f32_rows, by_shape = dict(kernel=0.0, plain=0.0), {}, {}
    cases = [(shape, calls, torch.bfloat16) for shape, calls in sorted(shapes.items())]
    cases += [(shape, 0, torch.float32) for shape in sorted(shapes) if shape[0] > 1024]
    for (C, H, W), calls, dtype in cases:
        x = (torch.randn(1, H, W, C, device=dev, generator=g) * 2 + 0.5).to(dtype)
        scale = torch.randn(C, device=dev, generator=g)
        bias = torch.randn(C, device=dev, generator=g)
        got = fused_group_norm_swish(x, scale, bias, groups)
        again = fused_group_norm_swish(x, scale, bias, groups)
        plain = group_norm_swish_reference(x, scale, bias, groups)
        ref = group_norm_swish_reference(x.float(), scale, bias, groups)
        torch.cuda.synchronize()
        err, plain_err = max_err(got, ref), max_err(plain, ref)
        ok = (err <= 2 * plain_err if dtype == torch.bfloat16
              else err <= 1e-4 * (1 + ref.abs().max().item()))
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"GN+Swish {dtype} C={C} H={H}: err {err} (plain {plain_err}), "
                                 f"two launches equal {torch.equal(got, again)}")
        graph_replay_equals_eager(f"GN+Swish {dtype} C={C} H={H}",
                                  lambda: fused_group_norm_swish(x, scale, bias, groups), got)
        route = gn_route(x, groups)
        x_nchw = x.permute(0, 3, 1, 2)
        sc, bi = scale.to(dtype), bias.to(dtype)
        ms = time_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        dev_ms = device_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        plain_ms = time_ms(lambda: group_norm_swish_reference(x, scale, bias, groups), 5)
        lib = time_ms(lambda: F.silu(F.group_norm(x_nchw, groups, sc, bi, 1e-5)), 5)
        lib_dev = device_ms(lambda: F.silu(F.group_norm(x_nchw, groups, sc, bi, 1e-5)), 5)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3  # read x, write y
        log(f"gn_swish {str(dtype)[6:]} B=1 H={H} W={W} C={C} calls/forward={calls} ({route} "
            f"route): err {err:.3g} (plain {str(dtype)[6:]} {plain_err:.3g}, against f32 of the "
            "same inputs), two launches and a graph replay bit-identical; kernel "
            f"{ms:.4f} ms (device time {dev_ms:.4f}) plain {plain_ms:.4f} ms library {lib:.4f} "
            f"ms (device time {lib_dev:.4f}) bound {bound:.4f} ms ({bound / dev_ms:.1%} of the "
            "HBM rate by device time)")
        row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                   library_device_ms=lib_dev)
        if dtype == torch.bfloat16:
            for k in tot:
                tot[k] += calls * row[k]
            worst = dict(kernel=max(worst["kernel"], err), plain=max(worst["plain"], plain_err))
            by_shape[f"B=1 H={H} W={W} C={C}"] = dict(
                calls=calls, route=route, device_ms=dev_ms, library_device_ms=lib_dev,
                bound_ms=bound)
        else:
            f32_rows[f"C={C} H={H}"] = dict(row, max_abs_err=err, route=route)
        del x, x_nchw, got, again, plain, ref
    torch.cuda.empty_cache()
    log(f"gn_swish bf16 per sr_sr3_64_512 forward at B=1 ({sum(shapes.values())} calls): "
        + " ".join(f"{k} {v:.4f}" for k, v in tot.items()))
    tot["by_shape"] = by_shape
    return tot, worst, f32_rows


def phase_attention_bf16(dev) -> tuple:
    """The bf16 attention kernel at SR512_ATTN_SHAPES (q, k, v as views of
    one qkv tensor, as the attention block hands them over): against an f32
    reference from the same bf16 inputs, at most 2x the plain bf16 version's
    error; two launches and a CUDA-graph replay bit-identical; device time
    by CUDA-graph replay beside the plain version and SDPA in bf16, and the
    bound (4·B·N²·D operations at 989 TFLOP/s bf16, or q, k, v and out once
    through HBM); the launch plan (kernel, key splits) logged."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention
    from diffsplitting_tpu_torch.ops.attention import plan
    from diffsplitting_tpu_torch.ops.groupnorm import _sm_count

    g = torch.Generator(device=dev).manual_seed(42)
    res, worst = {}, dict(kernel=0.0, plain=0.0)
    for B, N, D in SR512_ATTN_SHAPES:
        qkv = torch.randn(B, N, 1, 3, D, device=dev, generator=g).bfloat16()
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        scale = 1.0 / math.sqrt(D)
        reset_launches()
        got = fused_attention(q, k, v, scale)
        again = fused_attention(q, k, v, scale)
        launched = read_launches()
        plain = attention_reference(q, k, v, scale)
        ref = attention_reference(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err, plain_err = max_err(got, ref), max_err(plain, ref)
        if launched["attention_bf16"] != 2 or not (err <= 2 * plain_err) or not torch.equal(
                got, again):
            raise AssertionError(f"attention bf16 B={B} N={N} D={D}: launches {launched}, err "
                                 f"{err} (plain {plain_err}), two launches equal "
                                 f"{torch.equal(got, again)}")
        graph_replay_equals_eager(f"attention bf16 B={B} N={N} D={D}",
                                  lambda: fused_attention(q, k, v, scale), got)
        how = plan(B, N, D, _sm_count(dev.index or 0))
        worst = dict(kernel=max(worst["kernel"], err), plain=max(worst["plain"], plain_err))
        ms = time_ms(lambda: fused_attention(q, k, v, scale), 20)
        dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
        plain_ms = device_ms(lambda: attention_reference(q, k, v, scale), 5)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops = 4 * B * N * N * D
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = 4 * B * N * D * 2 / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        log(f"attention bf16 B={B} N={N} D={D} heads=1 ({'wide kernel, ' if how.wide else ''}"
            f"{how.splits} key splits of {how.tiles_per_split} tiles, {how.blocks * B} blocks): "
            f"err {err:.3g} (plain bf16 "
            f"{plain_err:.3g}, against f32 of the same inputs), two launches and a graph replay "
            f"bit-identical; kernel {ms:.4f} ms "
            f"(device time {dev_ms:.4f}) plain {plain_ms:.4f} ms SDPA bf16 {lib:.4f} ms (device "
            f"times; SDPA {lib / dev_ms:.2f}x the kernel's) bound {bound:.4f} ms ({by}; bf16 "
            f"tensor-core {ops_ms:.4f}, bytes {bytes_ms:.4f}; {bound / dev_ms:.1%} of it, "
            f"{flops / dev_ms / 1e9:.1f} bf16 TFLOP/s)")
        res[(B, N, D)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                              bound_ms=bound, bound_by=by, max_abs_err=err,
                              plain_max_abs_err=plain_err, splits=how.splits, wide=how.wide)
        del qkv, q, k, v, got, again, plain, ref
    torch.cuda.empty_cache()
    return res, worst


def phase_conv_gn_bf16(dev, sites) -> tuple:
    """The bf16 conv_gn kernel at each site of one sr_sr3_64_512 fused
    forward at batch 1 that the walk plans to it (`sites`: site -> calls),
    on seeded bf16 x and residual and f32 weights (as the walk passes the
    UNet's parameters): against its plain version (y within one bf16 step,
    2^-7·|y|, + 1e-4·max|y|, a rounding that the order of the f32 sums
    flips; the statistics within 1e-5 of Σ|y|), two launches bit-identical;
    the kernel's time through a host loop and by CUDA-graph replay, the
    plain version's and the library's (cuDNN `F.conv2d` in bf16 on the
    activated input, channels_last, + the residual or its 1x1 skip conv;
    device times), and the bound (the larger of 2·H·W·(9·Cin [+ Cres])·Cout
    operations at 989 TFLOP/s bf16 and x, the residual, y, the weights and
    vectors once through HBM), each summed over the forward's calls."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.conv_gn_variants import site_args
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import conv_gn_fused, conv_gn_reference

    g = torch.Generator(device=dev).manual_seed(45)
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
               bytes_ms=0.0, gflop=0.0, gbytes=0.0)
    worst, by_site = 0.0, {}
    for site, calls in sorted(sites.items(), key=str):
        H, W, Cin, Cout, act, res, Cres = site
        x, w, b, scale, shift, r, w_skip = site_args(site, 1, g)
        x = x.bfloat16()
        r = r.bfloat16() if r is not None else None
        args = (x, w, b, scale, shift, r, w_skip)
        reset_launches()
        got = conv_gn_fused(*args)
        again = conv_gn_fused(*args)
        launched = read_launches()["conv_gn_bf16"]
        y_ref, s_ref, q_ref = conv_gn_reference(*args)
        torch.cuda.synchronize()
        (y, s, q), yf, rf = got, got[0].float(), y_ref.float()
        err = (yf - rf).abs().max().item()
        ok = (launched == 2 and y.dtype == torch.bfloat16
              and all(torch.equal(a, c) for a, c in zip(got, again))
              and ((yf - rf).abs() <= 2.0 ** -7 * rf.abs() + 1e-4 * rf.abs().max()).all()
              and ((s - s_ref).abs() <= 1e-5 * rf.abs().sum(dim=(1, 2)) + 1e-4).all()
              and ((q - q_ref).abs() <= 1e-5 * q_ref + 1e-4).all())
        if not ok:
            raise AssertionError(f"conv_gn bf16 H={H} Cin={Cin} Cout={Cout} act={act} res={res} "
                                 f"Cres={Cres}: launches {launched}, max abs err {err}, sums err "
                                 f"{max_err(s, s_ref)}, sumsqs err {max_err(q, q_ref)}, two "
                                 f"launches equal {all(torch.equal(a, c) for a, c in zip(got, again))}")
        worst = max(worst, err)
        del got, again, y, yf, rf, y_ref
        ms = time_ms(lambda: conv_gn_fused(*args), 10)
        dev_ms = device_ms(lambda: conv_gn_fused(*args), 10)
        plain = device_ms(lambda: conv_gn_reference(*args), 3)
        xa = x if not act else F.silu(x.float() * scale[:, None, None, :]
                                      + shift[:, None, None, :]).bfloat16()
        xa = xa.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        w16 = w.permute(3, 2, 0, 1).bfloat16()
        b16 = b.bfloat16()
        r_nchw = r.permute(0, 3, 1, 2) if r is not None else None
        ws16 = w_skip.t()[:, :, None, None].bfloat16() if w_skip is not None else None

        def library():
            out = F.conv2d(xa, w16, b16, padding=1)
            if ws16 is not None:
                out = out + F.conv2d(r_nchw, ws16)
            elif r_nchw is not None:
                out = out + r_nchw
            return out

        lib = device_ms(library, 10)
        k_skip = Cres if res == "projected" else 0
        flops = 2 * H * W * (9 * Cin + k_skip) * Cout
        nbytes = (2 * H * W * (Cin + Cout + Cres) + 4 * (9 * Cin * Cout + k_skip * Cout)
                  + 4 * (Cout + 2 * Cin) + 8 * Cout)
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        log(f"conv_gn bf16 B=1 H={H} W={W} Cin={Cin} Cout={Cout} prologue={act} residual={res} "
            f"Cres={Cres} calls/forward={calls}: err {err:.3g} against the plain version, two "
            f"launches bit-identical; kernel {ms:.4f} ms (device time {dev_ms:.4f}) plain "
            f"{plain:.4f} ms library {lib:.4f} ms (device times) bound {bound:.4f} ms ({by}; bf16 "
            f"tensor-core {ops_ms:.4f}, bytes {bytes_ms:.4f}; {bound / dev_ms:.1%} of it, "
            f"{flops / dev_ms / 1e9:.1f} bf16 TFLOP/s)")
        row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                   ops_ms=ops_ms, bytes_ms=bytes_ms, gflop=flops / 1e9, gbytes=nbytes / 1e9)
        for k in tot:
            tot[k] += calls * row[k]
        by_site[f"H={H} Cin={Cin} Cout={Cout} prologue={act} residual={res} Cres={Cres}"] = dict(
            row, bound_by=by, max_abs_err=err, calls=calls)
        del x, xa, r, r_nchw, args
        torch.cuda.empty_cache()
    tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
    log(f"conv_gn bf16 per sr_sr3_64_512 fused forward at B=1 ({sum(sites.values())} calls; "
        "library = cuDNN F.conv2d in bf16 on the activated input + the residual or 1x1 "
        "skip): "
        + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tot.items())
        + f" ({tot['gflop'] / tot['device_ms']:.1f} bf16 TFLOP/s, "
        f"{tot['bound_ms'] / tot['device_ms']:.1%} of the bound by device time)")
    return tot, worst, by_site


def phase_sr3_512(dev, work: str) -> dict:
    """configs/sr_sr3_64_512.json (infer.py's default config) at its full
    width (inner 64, mults (1, 2, 4, 8, 16), 1 res block, 16 groups, 512²
    images, 155,334,339 parameters, seeded weights), at its compute dtype
    bfloat16 with remat on, on seeded synthetic 64 -> 512 LR/HR/SR triples
    (numpy and PIL bicubic, through the port's prepare_data):
      * the port's infer.py `main` over the config's full 2000-step val
        schedule on one image, unfused and with DSP_FUSED=1: unfused 35 bf16
        GN+Swish and 1 bf16 attention (D = 1024, N = 1024) launches a
        forward asserted; fused 11 bf16 conv_gn (the sites SR512_CONV_FWD
        plans to the kernel; 27 on library ops), 1 bf16 GN+Swish (the head),
        1 bf16 attention and no f32 kernel; seconds a chain, forwards/s, peak
        memory; the device time a step of a chain cut to SR512_CUT_STEPS
        steps under the profiler, and from it the idle share of the
        unprofiled chain, each way; that cut chain, each way, with the
        kernels against the plain versions from the same noise;
      * one forward at batch 1 with the kernels against the plain versions,
        and against the f32 forward of the same weights (the error bf16
        costs); the fused forward against the fused forward through the
        plain versions, the unfused bf16 forward and the f32 forward; all
        reported as max and mean abs error over max|f32|;
      * the bf16 GN+Swish kernel at each of the forward's (C, H, W) (C = 64
        ... 2048) and the f32 kernel at C = 1536 and 2048, the bf16
        attention kernel at SR512_ATTN_SHAPES, the bf16 conv_gn kernel at
        each of the fused forward's 11 sites (phase_gn_bf16,
        phase_attention_bf16, phase_conv_gn_bf16);
      * the sr3 train step at batch 2, 512², with remat on and off, from the
        same weights and draws, under cuDNN's deterministic algorithms: loss
        and every gradient of the two against each other, the launches of
        each (the remat step recomputes every block's two GN+Swish and the
        mid block's attention), ms a step and peak memory, remat's peak below
        the other's."""
    import numpy as np
    import torch
    from PIL import Image
    from diffsplitting_tpu_torch import infer
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data.lrhr_dataset import LRHRDataset
    from diffsplitting_tpu_torch.kernels import conv_gn_variants, groupnorm_variants
    from diffsplitting_tpu_torch.models import UNet, fused_unet_forward
    from diffsplitting_tpu_torch.serving import unet_kwargs
    from diffsplitting_tpu_torch.train import DiffusionModel

    t_phase = time.perf_counter()
    base = dict_to_nonedict(load_json(SR512_CONFIG))
    model_opt = base["model"]
    if (model_opt["compute_dtype"], model_opt["remat"]) != ("bfloat16", True):
        raise AssertionError(f"{SR512_CONFIG} no longer trains in bf16 with remat")
    T = int(model_opt["beta_schedule"]["val"]["n_timestep"])
    size = int(model_opt["diffusion"]["image_size"])
    groups = int(model_opt["unet"]["norm_groups"])
    lr_size = int(base["datasets"]["val"]["l_resolution"])
    root = write_lrhr_root(work, SR512_TRAIN_BATCH, size, seed=40)
    steps = SR512_SERVE_STEPS
    cfg = sr_config(work, SR512_CONFIG, root, 1, None if steps == T else steps)
    if steps != T:
        log(f"sr3_512 phase: infer.py's chain is cut to {steps} of {T} steps")

    # ------------------------------------------------ serving: infer.py, bf16
    per_forward = dict(GN_ATTN_ONLY, group_norm_swish=0, attention=0,
                       group_norm_swish_bf16=SR512_GN_FWD, attention_bf16=SR512_ATTN_FWD)
    served = serve_cli("sr3_512 infer.py (bf16)", infer,
                       ["-c", cfg, "-rootdir", str(Path(work) / "sr512_experiments")],
                       per_forward, steps)
    model = served["model"]
    net = model.nets.denoise_fn
    n_params = sum(p.numel() for p in net.parameters())
    unet_opt = model_opt["unet"]
    widest = max(m.out_channels for m in net.modules()
                 if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3))
    if (n_params, net.compute_dtype, widest) != (
            SR512_PARAMS, torch.bfloat16,
            int(unet_opt["inner_channel"]) * max(unet_opt["channel_multiplier"])):
        raise AssertionError(f"{SR512_CONFIG}: {n_params} parameters, compute dtype "
                             f"{net.compute_dtype}, widest conv {widest}")
    results = served["results"]
    sr = np.asarray(Image.open(Path(results) / "0_1_sr.png"))
    if sr.shape != (size, size, 3):
        raise AssertionError(f"infer.py's SR image is {sr.shape}")

    # ------------------------------------------------ serving: infer.py, DSP_FUSED=1, bf16
    if conv_site_plan(net) != SR512_CONV_FWD:
        raise AssertionError(f"{SR512_CONFIG}: conv sites {conv_site_plan(net)} on the kernel / "
                             f"library ops, expected {SR512_CONV_FWD}")
    fused_per_forward = dict(per_forward, group_norm_swish_bf16=1, conv_gn_bf16=SR512_CONV_FWD[0],
                             sites_kernel=SR512_CONV_FWD[0], sites_library=SR512_CONV_FWD[1])
    with fused_env(True):
        fused_served = serve_cli(
            "sr3_512 infer.py (bf16, DSP_FUSED=1)", infer,
            ["-c", cfg, "-rootdir", str(Path(work) / "sr512_fused_experiments")],
            fused_per_forward, steps)
    fused_sr = torch.as_tensor(fused_served["model"].prediction)
    if not (torch.isfinite(fused_sr).all() and (Path(fused_served["results"]) / "0_1_sr.png")
            .exists()):
        raise AssertionError("sr3_512 fused chain: non-finite output or no SR image")
    del fused_served["model"]

    # ------------------------------------------------ a cut chain: profile, plain
    cut = dict(model_opt["beta_schedule"]["val"], n_timestep=SR512_CUT_STEPS)
    model.set_new_noise_schedule(cut, "cut")
    item = LRHRDataset(root, "img", lr_size, size, split="val", need_LR=False)[0]
    model.feed_data({"input": item["SR"][None], "target": item["HR"][None]})
    prof = chain_profile(model, SR512_CUT_STEPS, False, steps, served["chain_s"])
    fused_prof = chain_profile(model, SR512_CUT_STEPS, True, steps, fused_served["chain_s"])
    chain_err = {}
    for fused in (False, True):
        outs = {}
        for label, plain in (("kernels", False), ("plain", True)):
            model.sample_generator.manual_seed(0)
            with plain_versions() if plain else contextlib.nullcontext():
                outs[label] = model.test(fused=fused).clone()
        scale = outs["plain"].abs().max().item()
        err = chain_err[fused] = max_err(outs["kernels"], outs["plain"]) / scale
        # bf16 on both sides; the attention kernel keeps f32 scores where the
        # plain version rounds them to bf16, and the chain carries the
        # difference (and, fused, the conv_gn kernel's other order of sums)
        if not (torch.isfinite(outs["kernels"]).all() and err <= 5e-2):
            raise AssertionError(f"sr3_512 {SR512_CUT_STEPS}-step chain, fused={fused}, kernels "
                                 f"vs plain versions: max abs err {err} of max|plain| > 5e-2")
        log(f"sr3_512 {SR512_CUT_STEPS}-step chain, fused={fused}, kernels vs plain versions: "
            f"max abs err {err:.3g} of max|plain| (tol 5e-2)")
        del outs

    # ------------------------------------------------ one forward: plain versions, f32
    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.randn(1, size, size, net.in_channel, device=dev, generator=g)
    level = torch.rand(1, device=dev, generator=g)
    f32_net = UNet(**dict(unet_kwargs(model_opt, "noise_level"), dtype=None)).to(dev).eval()
    f32_net.load_state_dict(net.state_dict())
    with torch.inference_mode():
        net.eval()
        reset_launches()
        got = net(x, level)
        launched = read_launches()
        shapes = groupnorm_variants.gn_shapes(net, x, level)
        reset_launches()
        fused = fused_unet_forward(net, x, level)
        fused_launched = read_launches()
        sites = conv_gn_variants.conv_gn_sites(net, x, level)
        with plain_versions():
            want = net(x, level)
            fused_plain = fused_unet_forward(net, x, level)
        exact = f32_net(x, level)
    if (launched["group_norm_swish_bf16"], launched["attention_bf16"]) != (SR512_GN_FWD,
                                                                           SR512_ATTN_FWD):
        raise AssertionError(f"sr3_512 forward: launches {launched}")
    if fused_launched != fused_per_forward:
        raise AssertionError(f"sr3_512 fused forward: launches {fused_launched}, expected "
                             f"{fused_per_forward}")
    m = exact.abs().max().item()
    fwd = {}
    for what, a, b in (("kernels vs plain versions (bf16)", got, want),
                       ("bf16 kernels vs f32 forward", got, exact),
                       ("bf16 plain vs f32 forward", want, exact),
                       ("fused kernels vs fused plain versions (bf16)", fused, fused_plain),
                       ("fused vs unfused (bf16 kernels)", fused, got),
                       ("fused bf16 kernels vs f32 forward", fused, exact)):
        d = (a - b).abs()
        fwd[what] = dict(max=d.max().item() / m, mean=d.mean().item() / m)
        log(f"sr3_512 forward B=1 {size}², {what}: max abs err {fwd[what]['max']:.3g}, mean "
            f"{fwd[what]['mean']:.3g} of max|f32| ({m:.3g})")
    # bf16 on both sides of the first, fourth and fifth: each rounds at
    # other places (fused: the carried statistics, cuDNN's rounding before
    # the bias at library sites); against f32, bf16's own error
    if not (torch.isfinite(got).all() and torch.isfinite(fused).all()
            and fwd["kernels vs plain versions (bf16)"]["max"] <= 5e-2
            and fwd["fused kernels vs fused plain versions (bf16)"]["max"] <= 5e-2
            and fwd["fused vs unfused (bf16 kernels)"]["max"] <= 5e-2
            and fwd["bf16 kernels vs f32 forward"]["max"] <= 1e-1
            and fwd["fused bf16 kernels vs f32 forward"]["max"] <= 1e-1):
        raise AssertionError(f"sr3_512 forward: {fwd}")
    if sum(shapes.values()) != SR512_GN_FWD:
        raise AssertionError(f"expected {SR512_GN_FWD} GN+Swish calls a forward, saw {shapes}")
    if sum(sites.values()) != SR512_CONV_FWD[0]:
        raise AssertionError(f"expected {SR512_CONV_FWD[0]} conv_gn calls a fused forward, saw "
                             f"{dict(sites)}")
    del x, got, want, exact, fused, fused_plain, f32_net, model, served["model"]
    torch.cuda.empty_cache()

    # ------------------------------------------------ kernels at this config's shapes
    gn, gn_worst, gn_f32 = phase_gn_bf16(dev, shapes, groups)
    attn, attn_worst = phase_attention_bf16(dev)
    conv, conv_worst, conv_sites = phase_conv_gn_bf16(dev, sites)

    # ------------------------------------------------ the train step, remat on and off
    opt = dict_to_nonedict(load_json(cfg))
    ds = LRHRDataset(root, "img", lr_size, size, split="val", need_LR=False)
    items = [ds[i] for i in range(SR512_TRAIN_BATCH)]
    batch = {"target": np.stack([it["HR"] for it in items]),
             "input": np.stack([it["SR"] for it in items])}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    train, grads = {}, {}
    try:
        for remat in (True, False):
            opt["model"]["remat"] = remat
            trainer = DiffusionModel(opt, device=dev, seed=0)
            trainer.feed_data(batch)
            gd = torch.Generator(device=dev).manual_seed(44)
            sched = trainer.current_sched
            t = 1 + int(torch.randint(0, sched.num_timesteps, (), generator=gd, device=dev))
            lo, hi = sched.sqrt_alphas_cumprod_prev[t - 1], sched.sqrt_alphas_cumprod_prev[t]
            gamma = lo + torch.rand(SR512_TRAIN_BATCH, device=dev, generator=gd) * (hi - lo)
            noise = torch.randn(SR512_TRAIN_BATCH, size, size, 3, device=dev, generator=gd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            trainer.optimize_parameters([(t, gamma, noise)])
            torch.cuda.synchronize()
            launches = read_launches()
            peak_first = torch.cuda.max_memory_allocated()
            recompute = 2 * SR512_BLOCKS if remat else 0
            want = dict(per_forward, group_norm_swish_bf16=SR512_GN_FWD + recompute,
                        attention_bf16=SR512_ATTN_FWD * (2 if remat else 1))
            if launches != want:
                raise AssertionError(f"sr3_512 train step, remat={remat}: launches {launches}, "
                                     f"expected {want}")
            grads[remat] = (trainer.get_current_log(),
                            {n: p.grad.detach().clone()
                             for n, p in trainer.nets.named_parameters() if p.grad is not None})
            walls = []
            for step in range(SR512_TRAIN_WARMUP + SR512_TRAIN_TIMED):
                if step == SR512_TRAIN_WARMUP:
                    torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.optimize_parameters()
                torch.cuda.synchronize()
                if step >= SR512_TRAIN_WARMUP:
                    walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            ms = sorted(walls)[len(walls) // 2] * 1e3
            loss = trainer.get_current_log()["l_pix"]
            if not np.isfinite(loss):
                raise AssertionError(f"sr3_512 train loss {loss}")
            train[remat] = dict(ms=ms, samples_per_s=SR512_TRAIN_BATCH / ms * 1e3, peak=peak,
                                peak_first_step=peak_first, launches=launches)
            log(f"sr3_512 train step B={SR512_TRAIN_BATCH} {size}², bf16, remat={remat}: "
                f"{SR512_TRAIN_TIMED} steps {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, "
                f"median {ms:.2f} ms, {train[remat]['samples_per_s']:.2f} samples/s, peak memory "
                f"{peak / 2**30:.2f} GiB ({peak} bytes; first step {peak_first}), launches "
                f"{launches}, loss {loss:.2f}")
            del trainer
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    (log_on, g_on), (log_off, g_off) = grads[True], grads[False]
    worst, bit_equal = 0.0, True
    for name, gw in g_off.items():
        d = (g_on[name] - gw).abs().max().item()
        bit_equal = bit_equal and d == 0.0
        worst = max(worst, d / max(gw.abs().max().item(), 1e-30))
    # remat recomputes the same deterministic forward: the gradients are
    # expected bit for bit; the bound allows cuDNN's own rounding only
    if not (g_on.keys() == g_off.keys() and log_on["l_pix"] == log_off["l_pix"]
            and worst <= 1e-3):
        raise AssertionError(f"sr3_512 train step, remat vs not: loss {log_on['l_pix']} vs "
                             f"{log_off['l_pix']}, worst gradient err {worst} of max|g|")
    if not train[True]["peak"] < train[False]["peak"]:
        raise AssertionError(f"sr3_512 remat peak {train[True]['peak']} not below "
                             f"{train[False]['peak']}")
    log(f"sr3_512 train step, remat vs not: loss equal, gradients bit-equal {bit_equal} (worst "
        f"{worst:.3g} of max|g|, tol 1e-3); peak memory {train[True]['peak'] / 2**30:.2f} vs "
        f"{train[False]['peak'] / 2**30:.2f} GiB, ms a step {train[True]['ms']:.2f} vs "
        f"{train[False]['ms']:.2f}")

    secs = time.perf_counter() - t_phase
    log(f"sr3_512 phase: {secs:.1f} s")
    runs = [served, fused_served, *train.values()]
    return dict(launches={k: sum(r["launches"][k] for r in runs)
                          for k in ("group_norm_swish_bf16", "attention_bf16", "conv_gn_bf16")},
                gn=gn, gn_worst=gn_worst, gn_f32=gn_f32, attn=attn, attn_worst=attn_worst,
                conv=conv, conv_worst=conv_worst, conv_sites=conv_sites,
                chain=dict(chain_s=served["chain_s"], forwards_per_s=served["forwards_per_s"],
                           peak=served["peak"], steps=steps, **prof),
                fused_chain=dict(chain_s=fused_served["chain_s"],
                                 forwards_per_s=fused_served["forwards_per_s"],
                                 peak=fused_served["peak"], steps=steps, **fused_prof),
                chain_err=chain_err, forward=fwd, train=train, seconds=secs, root=root)


SRA_DDIM = "250,1"  # infer.py's --ddim: 250 respaced steps at eta 1
SRA_DEEPCACHE = "5,1"  # --deepcache: a full pass every 5th step, the cache at depth 1
SRA_WINDOW = "8,0.1"  # --sliding_window: 8 steps a sweep, tau 0.1
SRA_WINDOW_STEPS = 50  # the val schedule cut for the window (its frozen noise: 50 draws)
SRA_CHECK_STEPS = 20  # the cut of the exactness checks and of the profiled chains
SR3_PARALLEL_STEPS = 20  # sr_sr3_16_128's schedule cut for ddpm_sample_parallel


def pass_launches(unet, depth: int) -> tuple:
    """(full, shallow) bf16 kernel launches of one `CachedUNet` pass at
    `depth`, from the modules each pass runs: one GN+Swish launch a
    `GroupNormSwish`, one attention launch a `SelfAttention`."""
    from diffsplitting_tpu_torch.models.blocks import GroupNormSwish, SelfAttention
    from diffsplitting_tpu_torch.models.deepcache import CachedUNet

    cnet = CachedUNet(unet, depth)

    def count(layers):
        mods = [m for layer in layers for m in layer.modules()]
        return dict(group_norm_swish_bf16=sum(isinstance(m, GroupNormSwish) for m in mods),
                    attention_bf16=sum(isinstance(m, SelfAttention) for m in mods))

    shallow = count(cnet.shallow_down + cnet.shallow_up + [unet.final_conv])
    deep = count(cnet.deep_down + list(unet.mid) + cnet.deep_up)
    return {k: shallow[k] + deep[k] for k in shallow}, shallow


def phase_sr_accelerators(dev, work: str, sr512: dict) -> dict:
    """The DDPM / SR3 serving accelerators through the port's infer.py on
    configs/sr_sr3_64_512.json at full width (155,334,339 parameters, seeded
    weights, bf16 with remat), on phase_sr3_512's first synthetic 64 -> 512
    triple at batch 1:
      * `--ddim 250,1` unfused and with DSP_FUSED=1 (250 full passes);
        `--deepcache 5,1` over the full 2000-step val schedule (400 full
        passes, 1600 shallow); `--ddim 250,1 --deepcache 5,1` (50 and 200);
        `--sliding_window 8,0.1` over the val schedule cut to
        SRA_WINDOW_STEPS steps (one batch-8 pass a sweep): each run's
        launches asserted, seconds a chain, passes, sweeps, peak memory, and
        the idle share from a profiled cut chain of the same pattern, beside
        phase_sr3_512's exact chains: DDIM's a step from phase_sr3_512's
        profiled cut chains (each step one full forward), DeepCache's and
        DDIM x DeepCache's from a SRA_CHECK_STEPS-step cut chain at the same
        share of full passes, the window's a sweep from the window at
        tau 0 on that cut (one batch-8 pass a sweep);
      * a full and a shallow pass on the card: their launches against the
        counts `pass_launches` derives from `CachedUNet`'s split (full: the
        forward's 35 GN+Swish and 1 attention; shallow at depth 1: the 512²
        level's, no attention);
      * a 20-step DDIM chain (respaced from 2000) with the kernels and
        through the plain versions, each against the same chain through an
        f32 copy of the UNet: the kernels' error within twice the plain
        version's (a respaced step carries ε̂'s bf16 rounding into x at
        √(1/ᾱ − 1), so no fixed bound fits both ends of the schedule);
        DDIM at steps = T, eta = 1 on the 20-step cut against the exact cut
        chain from one generator; DeepCache at interval 1 against the
        uncached chain, bit for bit, for DDIM and for the ancestral chain on
        the 20-step cut (the same loop and modules, so the 2000-step chain's
        bits follow; running it would take the exact chain's ~40 s again);
        the window at tau = 0 on the 50-step cut against the exact cut chain
        (batch 8 against batch 1: other cuDNN algorithms);
      * `ddpm_sample_parallel` on configs/sr_sr3_16_128.json at full width
        (f32), batch 1, on its val schedule cut to SR3_PARALLEL_STEPS steps:
        after T sweeps (each one batch-T forward) against the exact cut
        chain."""
    import numpy as np
    import torch
    from PIL import Image
    from diffsplitting_tpu_torch import infer
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data.lrhr_dataset import LRHRDataset
    from diffsplitting_tpu_torch.diffusion.ddim import ddim_sample_loop, ddim_timesteps
    from diffsplitting_tpu_torch.diffusion.parallel_sampling import ddpm_sample_parallel
    from diffsplitting_tpu_torch.models import UNet, apply_unet
    from diffsplitting_tpu_torch.models.deepcache import CachedUNet
    from diffsplitting_tpu_torch.serving import unet_kwargs
    from diffsplitting_tpu_torch.train import DiffusionModel
    from diffsplitting_tpu_torch.utils.cli import parse_accel_flag

    t_phase = time.perf_counter()
    model_opt = dict_to_nonedict(load_json(SR512_CONFIG))["model"]
    val = model_opt["beta_schedule"]["val"]
    T, size = int(val["n_timestep"]), int(model_opt["diffusion"]["image_size"])
    root = sr512["root"]
    cfg = sr_config(work, SR512_CONFIG, root, 1)
    window_cfg = sr_config(work, SR512_CONFIG, root, 1, SRA_WINDOW_STEPS)
    log(f"sr_accel phase: the window's chain is cut to {SRA_WINDOW_STEPS} of {T} steps")
    ddim = parse_accel_flag(SRA_DDIM, 0.0)
    S = len(ddim_timesteps(T, ddim[0]))
    interval, depth = parse_accel_flag(SRA_DEEPCACHE, 1, second_cast=int)
    W, _ = parse_accel_flag(SRA_WINDOW, 0.1)
    per_forward = dict(GN_ATTN_ONLY, group_norm_swish=0, attention=0,
                       group_norm_swish_bf16=SR512_GN_FWD, attention_bf16=SR512_ATTN_FWD)
    fused_per_forward = dict(per_forward, group_norm_swish_bf16=1, conv_gn_bf16=SR512_CONV_FWD[0],
                             sites_kernel=SR512_CONV_FWD[0], sites_library=SR512_CONV_FWD[1])

    def argv(name, *flags, config=cfg):
        return ["-c", config, "-rootdir", str(Path(work) / f"sra_{name}")] + list(flags)

    def split(n_steps):
        """(full, shallow) passes of an n-step cached chain: a full pass every
        `interval`-th step from the first, shallow passes between."""
        F = len(range(0, n_steps, interval))
        return F, n_steps - F

    def cached(n_steps, full, shallow):
        F, rest = split(n_steps)
        return dict(per_forward, **{k: full[k] * F + shallow[k] * rest for k in full})

    # ------------------------------------------------ infer.py: DDIM, unfused and fused
    runs = {}
    runs["ddim"] = serve_cli(f"sr_accel infer.py --ddim {SRA_DDIM}", infer,
                             argv("ddim", "--ddim", SRA_DDIM), per_forward, S)
    model = runs["ddim"]["model"]
    net = model.nets.denoise_fn
    if sum(p.numel() for p in net.parameters()) != SR512_PARAMS or model.ddim != ddim:
        raise AssertionError(f"sr_accel: the DDIM run served {model.ddim}")
    full, shallow = pass_launches(net, depth)
    if full != {k: per_forward[k] for k in full}:
        raise AssertionError(f"sr_accel: CachedUNet's full pass runs {full}, the forward "
                             f"{per_forward}")
    with fused_env(True):
        runs["ddim_fused"] = serve_cli(f"sr_accel infer.py --ddim {SRA_DDIM} (DSP_FUSED=1)",
                                       infer, argv("ddim_fused", "--ddim", SRA_DDIM),
                                       fused_per_forward, S)
    del runs["ddim_fused"]["model"]

    # ------------------------------------------------ infer.py: DeepCache, DDIM x DeepCache
    runs["deepcache"] = serve_cli(f"sr_accel infer.py --deepcache {SRA_DEEPCACHE} ({T} steps)",
                                  infer, argv("dc", "--deepcache", SRA_DEEPCACHE), per_forward,
                                  T, want=cached(T, full, shallow))
    del runs["deepcache"]["model"]
    runs["ddim_deepcache"] = serve_cli(
        f"sr_accel infer.py --ddim {SRA_DDIM} --deepcache {SRA_DEEPCACHE}", infer,
        argv("ddim_dc", "--ddim", SRA_DDIM, "--deepcache", SRA_DEEPCACHE), per_forward, S,
        want=cached(S, full, shallow))
    del runs["ddim_deepcache"]["model"]

    # ------------------------------------------------ infer.py: the sliding window, cut
    def window_launches(out):
        sweeps = out["model"].last_sliding_sweeps
        return dict(per_forward, **{k: per_forward[k] * sweeps for k in full})

    runs["window"] = serve_cli(
        f"sr_accel infer.py --sliding_window {SRA_WINDOW} ({SRA_WINDOW_STEPS} steps)", infer,
        argv("window", "--sliding_window", SRA_WINDOW, config=window_cfg), per_forward,
        SRA_WINDOW_STEPS, want=window_launches)
    runs["window"]["sweeps"] = runs["window"]["model"].last_sliding_sweeps
    del runs["window"]["model"]
    for name, run in runs.items():
        pngs = sorted(p.name for p in Path(run["results"]).glob("*.png"))
        if pngs != ["0_1_hr.png", "0_1_inf.png", "0_1_sr.png"]:
            raise AssertionError(f"sr_accel {name}: infer.py wrote {pngs}")
        sr = np.asarray(Image.open(Path(run["results"]) / "0_1_sr.png"))
        if sr.shape != (size, size, 3):
            raise AssertionError(f"sr_accel {name}: infer.py's SR image is {sr.shape}")
    torch.cuda.empty_cache()

    cli_s = time.perf_counter() - t_phase

    # ------------------------------------------------ a full and a shallow pass on the card
    g = torch.Generator(device=dev).manual_seed(45)
    x = torch.randn(1, size, size, net.in_channel, device=dev, generator=g)
    level = torch.rand(1, device=dev, generator=g)
    cnet = CachedUNet(net, depth)
    with torch.inference_mode():
        net.eval()
        reset_launches()
        got_full, deep = cnet(x, level)
        seen_full = read_launches()
        reset_launches()
        got_shallow, _ = cnet(x, level, deep)
        seen_shallow = read_launches()
        want_full = net(x, level)
    for what, seen, want in (("full", seen_full, full), ("shallow", seen_shallow, shallow)):
        if {k: seen[k] for k in want} != want or seen["conv_gn_bf16"]:
            raise AssertionError(f"sr_accel {what} pass at depth {depth}: launches {seen}, "
                                 f"expected {want}")
    if not (torch.equal(got_full, want_full) and torch.equal(got_shallow, want_full)):
        raise AssertionError("sr_accel: CachedUNet's passes are not the forward's bits")
    log(f"sr_accel passes at depth {depth}: full {full}, shallow {shallow} (from CachedUNet's "
        "split), seen on the card; both the forward's output bit for bit")
    del x, deep, got_full, got_shallow, want_full

    # ------------------------------------------------ exactness on one model, one generator
    item = LRHRDataset(root, "img", size // 8, size, split="val", need_LR=False)[0]
    model.feed_data({"input": item["SR"][None], "target": item["HR"][None]})
    model.set_ddim(None)

    def chain(fused=False, plain=False):
        model.sample_generator.manual_seed(0)
        with plain_versions() if plain else contextlib.nullcontext():
            return model.test(fused=fused).clone()

    def rel_err(what, got, want, tol):
        scale = want.abs().max().item()
        err = max_err(got, want) / scale
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"sr_accel {what}: max abs err {err} of max|want| > {tol}")
        log(f"sr_accel {what}: max abs err {err:.3g} of max|want| (tol {tol:g})")
        return err

    def bit_equal(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"sr_accel {what}: not bit-equal (max abs err "
                                 f"{max_err(got, want)})")
        log(f"sr_accel {what}: bit-equal")

    checks, prof = {}, {}
    cut = SRA_CHECK_STEPS
    model.set_ddim(cut, 1.0)  # respaced from the 2000-step schedule
    ddim_k = chain()
    ddim_p = chain(plain=True)
    f32_net = UNet(**dict(unet_kwargs(model_opt, "noise_level"), dtype=None)).to(dev).eval()
    f32_net.load_state_dict(net.state_dict())
    model.sample_generator.manual_seed(0)
    with torch.inference_mode():
        ddim_f32 = ddim_sample_loop(model.process, f32_net, model.current_sched,
                                    model.data["input"], cut, 1.0,
                                    generator=model.sample_generator)
    del f32_net
    plain_err = rel_err(f"{cut}-step DDIM (of {T}), plain versions (bf16) vs f32", ddim_p,
                        ddim_f32, 1.0)
    checks["ddim kernels vs f32"] = rel_err(
        f"{cut}-step DDIM (of {T}), kernels (bf16) vs f32 (tol: twice the plain versions')",
        ddim_k, ddim_f32, 2 * plain_err)
    checks["ddim kernels vs plain"] = max_err(ddim_k, ddim_p) / ddim_p.abs().max().item()
    log(f"sr_accel {cut}-step DDIM (of {T}), kernels vs plain versions: max abs err "
        f"{checks['ddim kernels vs plain']:.3g} of max|plain|")
    del ddim_p, ddim_f32
    model.set_deepcache(1, depth)
    bit_equal(f"{cut}-step DDIM, DeepCache at interval 1 vs uncached", chain(), ddim_k)
    model.set_deepcache(None)
    model.set_ddim(None)

    model.set_new_noise_schedule(dict(val, n_timestep=cut), "cut")
    exact = chain()
    model.set_ddim(cut, 1.0)
    checks["ddim T eta 1 vs exact"] = rel_err(
        f"DDIM at steps = T = {cut}, eta 1, vs the exact {cut}-step chain", chain(), exact, 5e-2)
    model.set_ddim(None)
    model.set_deepcache(1, depth)
    bit_equal(f"exact {cut}-step chain, DeepCache at interval 1 vs uncached", chain(), exact)
    model.set_deepcache(interval, depth)  # 4 full passes in 20, as 400 in 2000 and 50 in 250
    prof["deepcache"] = chain_profile(model, cut, False, T, runs["deepcache"]["chain_s"],
                                      label="sr_accel profile, DeepCache")
    model.set_deepcache(None)
    model.set_sliding_window(W, 0.0)  # one batch-W pass a sweep, one sweep a step at tau 0
    prof["window"] = chain_profile(model, cut, False, runs["window"]["sweeps"],
                                   runs["window"]["chain_s"], label="sr_accel profile, window")
    if model.last_sliding_sweeps != cut:
        raise AssertionError(f"sr_accel: the window at tau 0 took {model.last_sliding_sweeps} "
                             f"sweeps over {cut} steps")
    model.set_sliding_window(None)

    # the device time a step of the chains profiled above (DDIM: phase_sr3_512's
    # cut chains, each step one full forward; DDIM x DeepCache: the cached
    # chain's, the same share of full passes) over each run's own seconds
    for name, busy_ms, profiled, n_steps in (
            ("ddim", sr512["chain"].get("busy_ms"), SR512_CUT_STEPS, S),
            ("ddim_fused", sr512["fused_chain"].get("busy_ms"), SR512_CUT_STEPS, S),
            ("ddim_deepcache", prof["deepcache"]["busy_ms"], cut, S)):
        if busy_ms is None:
            prof[name] = dict(idle=None)
            continue
        step_ms = busy_ms / profiled
        prof[name] = dict(idle=1 - step_ms * n_steps / (runs[name]["chain_s"] * 1e3))
        log(f"sr_accel {name}: {step_ms:.4f} ms of device time a step (profiled above) x "
            f"{n_steps} steps in {runs[name]['chain_s']:.3f} s: idle share {prof[name]['idle']:.2%}")

    model.set_new_noise_schedule(dict(val, n_timestep=SRA_WINDOW_STEPS), "window cut")
    exact = chain()
    model.set_sliding_window(W, 0.0)
    windowed = chain()
    tau0_sweeps = model.last_sliding_sweeps
    checks["window tau 0 vs exact"] = rel_err(
        f"window W={W} at tau 0 ({tau0_sweeps} sweeps) vs the exact {SRA_WINDOW_STEPS}-step "
        "chain", windowed, exact, 5e-2)
    model.set_sliding_window(None)
    del exact, ddim_k, windowed, model, runs["ddim"]["model"], net, cnet
    torch.cuda.empty_cache()

    checks_s = time.perf_counter() - t_phase - cli_s

    # ------------------------------------------------ ddpm_sample_parallel, sr_sr3_16_128
    t_parallel = time.perf_counter()
    opt = dict_to_nonedict(load_json(SR3_CONFIG))
    sr3_size = int(opt["model"]["diffusion"]["image_size"])
    # phase_sr3's triples (the same images again: its root, when it ran in this work directory)
    sr3_item = LRHRDataset(write_lrhr_root(work, SR3_IMAGES, sr3_size, seed=30), "img",
                           sr3_size // 8, sr3_size, split="val", need_LR=False)[0]
    sr3 = DiffusionModel(opt, device=dev, seed=0)
    sr3.set_new_noise_schedule(dict(opt["model"]["beta_schedule"]["val"],
                                    n_timestep=SR3_PARALLEL_STEPS), "cut")
    sr3.feed_data({"input": sr3_item["SR"][None]})
    sr3.sample_generator.manual_seed(0)
    sr3_exact = sr3.test()
    sr3.sample_generator.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        unet = sr3.nets.denoise_fn.eval()  # as test() serves it: eval mode, no dropout
        parallel = ddpm_sample_parallel(sr3.process, functools.partial(apply_unet, unet),
                                        sr3.current_sched, sr3.data["input"],
                                        num_sweeps=SR3_PARALLEL_STEPS,
                                        generator=sr3.sample_generator)
    torch.cuda.synchronize()
    parallel_s = time.perf_counter() - t0
    parallel_launches = read_launches()
    want = dict(GN_ATTN_ONLY, group_norm_swish=SR3_GN_FWD * SR3_PARALLEL_STEPS, attention=0,
                attention_wide=SR3_ATTN_FWD * SR3_PARALLEL_STEPS)
    if parallel_launches != want:
        raise AssertionError(f"sr_accel ddpm_sample_parallel: launches {parallel_launches}, "
                             f"expected {want}")
    checks["parallel vs exact"] = check_close(
        f"sr3 ddpm_sample_parallel, {SR3_PARALLEL_STEPS} sweeps of a batch-{SR3_PARALLEL_STEPS} "
        f"forward, vs the exact {SR3_PARALLEL_STEPS}-step chain", parallel, sr3_exact)
    log(f"sr3 ddpm_sample_parallel ({SR3_PARALLEL_STEPS} steps, batch 1, {sr3_size}²): "
        f"{parallel_s:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {parallel_launches}")
    del sr3, sr3_exact, parallel
    torch.cuda.empty_cache()

    # ------------------------------------------------ the table
    exact_runs = {"exact": sr512["chain"], "exact_fused": sr512["fused_chain"]}
    passes = {"ddim": (S, 0), "ddim_fused": (S, 0), "deepcache": split(T),
              "ddim_deepcache": split(S), "window": (runs["window"]["sweeps"], 0)}
    noise_gib = T * 3 * size * size * 4 / 2**30
    log(f"sr_accel: the window's frozen noise is {SRA_WINDOW_STEPS} x 1 x {size}² x 3 float32 "
        f"here; at the full {T} steps it would be {noise_gib:.2f} GiB a sample")
    def exact_s(name):
        """The exact unfused chain's seconds over the run's schedule (the
        window's is cut), at the 2000-step chain's rate."""
        steps = SRA_WINDOW_STEPS if name == "window" else T
        return sr512["chain"]["chain_s"] * steps / T

    log(f"sr_accel: the five infer.py runs took {cli_s:.1f} s (each builds and seeds the "
        f"model), the checks and profiles {checks_s:.1f} s, the sr3 parallel part "
        f"{time.perf_counter() - t_parallel:.1f} s")
    for name, r in list(exact_runs.items()) + list(runs.items()):
        p = prof.get(name) or r
        log(f"sr_accel {name}: {r['chain_s']:.3f} s a chain"
            + (f" (passes full/shallow {passes[name][0]}/{passes[name][1]})" if name in passes
               else f" ({r['steps']} steps)")
            + (f", {r['sweeps']} sweeps of batch {W}" if name == "window" else "")
            + f", peak {r['peak'] / 2**30:.2f} GiB ({r['peak']} bytes), idle share "
            + ("not measured" if p.get("idle") is None else f"{p['idle']:.2%}")
            + (f", {exact_s(name) / r['chain_s']:.2f}x the exact unfused chain's speed over "
               f"the same schedule ({exact_s(name):.3f} s)" if name not in exact_runs else ""))
    secs = time.perf_counter() - t_phase
    log(f"sr_accel phase: {secs:.1f} s")
    counted = [r["launches"] for r in runs.values()] + [seen_full, seen_shallow]
    return dict(launches={k: sum(c[k] for c in counted)
                          for k in ("group_norm_swish_bf16", "attention_bf16", "conv_gn_bf16")},
                parallel_launches=parallel_launches, checks=checks, seconds=secs,
                tau0_sweeps=tau0_sweeps,
                chains={k: dict(chain_s=r["chain_s"], peak=r["peak"], passes=passes[k],
                                idle=prof[k]["idle"], sweeps=r.get("sweeps"))
                        for k, r in runs.items()})


W8A8_SITES_HAGEN = 28  # int8 sites a Hagen forward by default: 14 ResnetBlocks x 2 Block convs
W8A8_SITES_SR512 = 34  # int8 sites an sr_sr3_64_512 forward by default: 17 x 2
W8A8_PROFILE_STEPS = 10  # the W8A8 DDIM chain cut for the idle share's profile
W8A8_SITE_ITERS = 5  # calls captured per CUDA graph when a site is timed
LPIPS_SHAPE = (2, 256, 256, 3)


def w8a8_sites(label: str, float_net, qnet, forward, timed: bool) -> dict:
    """Every W8A8 site of `qnet`: its input captured on one forward
    (`forward(qnet)`), quantized with the site's a_scale; the card route
    (im2col + torch._int_mm) against the plain version (the exact float64
    conv, cuDNN off) on those int8 operands, int32 bit for bit; with `timed`,
    the device time of the site's whole W8A8 call (quantize, im2col, product,
    dequantize, bias) beside `float_net`'s conv at the same path and input
    (cuDNN in the compute dtype), each by CUDA-graph replay. Returns
    {path: {kind, shape, stride[, w8a8_ms, float_ms]}}."""
    import torch
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.models.quant_unet import classify, iter_quant_sites
    from diffsplitting_tpu_torch.ops import quant

    inputs = {}

    def keep(name):
        def hook(_, args):
            inputs[name] = args[0]
        return hook

    handles = [m.register_forward_pre_hook(keep(n)) for n, m in iter_quant_sites(qnet)]
    try:
        with torch.inference_mode():
            forward(qnet)
    finally:
        for h in handles:
            h.remove()
    rows = {}
    with torch.inference_mode():
        for name, m in iter_quant_sites(qnet):
            x = inputs.pop(name)
            x_i8 = quant.quantize_act(x.to(m.compute_dtype or torch.float32),
                                      quant.act_inverse(m.a_scale))
            got = quant.int8_conv(x_i8, m.weight_i8, m.stride, m.weight_mat)
            with torch.backends.cudnn.flags(enabled=False):
                want = quant.int8_conv_reference(x_i8, m.weight_i8, m.stride)
            if not (got.dtype == want.dtype == torch.int32 and torch.equal(got, want)):
                raise AssertionError(f"{label} {name}: the card's int8 conv differs from the "
                                     f"plain version (max abs {(got - want).abs().max()})")
            row = dict(kind=classify(name), shape=tuple(x.shape), stride=m.stride,
                       cout=m.out_channels, k=m.kernel_size[0])
            if timed:
                fconv = float_net.get_submodule(name)
                row.update(w8a8_ms=device_ms(lambda: m(x), W8A8_SITE_ITERS),
                           float_ms=device_ms(lambda: fconv(x), W8A8_SITE_ITERS))
            rows[name] = row
            del x, x_i8, got, want
    torch.cuda.synchronize()
    kinds = collections.Counter(r["kind"] for r in rows.values())
    log(f"{label}: {len(rows)} int8 sites ({dict(kinds)}), the card route int32 bit-equal to the "
        "plain version at every one")
    return rows


def site_times(label: str, rows: dict, float_label: str) -> dict:
    """The sums of the timed sites' device ms, all and the default (block)
    ones, logged with the slowest site."""
    out = {}
    for which, keep in (("default", lambda r: r["kind"] == "block"), ("all", lambda r: True)):
        sel = [r for r in rows.values() if keep(r)]
        out[which] = dict(sites=len(sel), w8a8_ms=sum(r["w8a8_ms"] for r in sel),
                          float_ms=sum(r["float_ms"] for r in sel))
        log(f"{label}, {which} sites ({len(sel)}): W8A8 convs {out[which]['w8a8_ms']:.4f} ms of "
            f"device time a forward (CUDA-graph replay) against {out[which]['float_ms']:.4f} for "
            f"{float_label} at the same sites ({out[which]['w8a8_ms'] / out[which]['float_ms']:.2f}x)")
    name, r = max(rows.items(), key=lambda kv: kv[1]["w8a8_ms"])
    log(f"{label}: slowest W8A8 site {name} {r['shape']} -> {r['cout']} (k {r['k']}, stride "
        f"{r['stride']}): {r['w8a8_ms']:.4f} ms against {r['float_ms']:.4f}")
    out["by_site"] = {n: {k: r[k] for k in ("kind", "shape", "w8a8_ms", "float_ms")}
                      for n, r in rows.items()}
    return out


def memory_split(label: str, calibrate, forwards: dict) -> dict:
    """Peak device memory of a W8A8 calibration (`calibrate()`, with the
    quantized-net cache dropped before) and of each of `forwards`, each run
    alone from a reset of the peak: {name: (peak, allocated before)} in bytes."""
    import torch

    out = {}
    for name, fn in (("calibration", calibrate), *forwards.items()):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        out[name] = (torch.cuda.max_memory_allocated(), base)
    log(f"{label} peak memory alone: " + "; ".join(
        f"{name} {peak / 2**30:.2f} GiB ({peak} bytes, {base} allocated before)"
        for name, (peak, base) in out.items()))
    return out


W8A8_REL_L2_MAX = 0.25  # one W8A8 forward against the float one, seeded weights (sanity bound)


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def phase_w8a8(dev, work: str, exact_slice: dict, sr512: dict, sra: dict, train: dict) -> dict:
    """W8A8 quantized serving (ops/quant.py, models/quant_unet.py,
    `set_quant`) at full width, with the FLOP count's MFU and LPIPS:
      * every int8 site of configs/splitting_hagen_indi_joint.json (both nets,
        patch 512, batch 8) and of configs/sr_sr3_64_512.json (batch 1), at
        the default sites and at 'all' (Down/Upsample and 1x1 shortcuts too):
        the card route against the plain version on the same int8 operands,
        int32 bit-equal (`w8a8_sites`); at 'all' each site's W8A8 call timed
        beside the float cuDNN conv (f32 Hagen, bf16 SR);
      * the Hagen joint slice with W8A8 through `predict_frames` (patch 512,
        batch 8, 3 steps, 18 tiles): 29 GN+Swish, 1 attention and 28 int8
        products a forward asserted, tiles/s and peak beside the exact slice
        of this run (main's), the calibration's seconds, PSNR against the
        exact chain from the same noise; DSP_FUSED=1 serving the W8A8 forward
        (the same bits, no conv_gn launch); the peak memory of a calibration
        and of one W8A8 and one float forward, each alone (`memory_split`);
      * sr_sr3_64_512 (bf16) through infer.py at batch 1: `--w8a8 --ddim
        250,1`, `--w8a8_sites all --ddim 250,1`, `--w8a8 --ddim 250,1
        --deepcache 5,1`; launches asserted (the calibration forward's
        included), int8 products a forward (34 by default), seconds a chain
        (calibration included, and without it), peak, idle share from a
        profiled 20-step W8A8 DDIM chain, beside phase_sr_accelerators' DDIM
        chains; one forward's rel-L2 against the unquantized forward on the
        calibration batch, default and all sites, held in (0, 0.25); the
        peak memory of the calibration, of its 8-row float forward and of one
        W8A8 and one float forward at batch 1, each alone;
      * MFU (utils/flops.py, utils/profiling.py) of the exact sr_sr3_64_512
        step (phase_sr3_512's device time a step and its chain's wall time a
        step, against the bf16 peak) and of the Hagen train step (phase_train's
        ms a step and its profiled device time, against the FP32 peak: TF32
        is off);
      * LPIPS (utils/lpips.py) with random weights on the card against the
        CPU."""
    import torch
    from diffsplitting_tpu_torch import infer
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.data.lrhr_dataset import LRHRDataset
    from diffsplitting_tpu_torch.diffusion.ddim import ddim_timesteps
    from diffsplitting_tpu_torch.models.blocks import GroupNormSwish, ResnetBlock, SelfAttention
    from diffsplitting_tpu_torch.models.deepcache import CachedUNet
    from diffsplitting_tpu_torch.models.quant_unet import W8A8Conv2d, iter_quant_sites
    from diffsplitting_tpu_torch.predict import predict_frames
    from diffsplitting_tpu_torch.serving import SplittingModel, sr_calib_inputs
    from diffsplitting_tpu_torch.split import train_flops_per_step
    from diffsplitting_tpu_torch.utils import lpips
    from diffsplitting_tpu_torch.utils.cli import parse_accel_flag
    from diffsplitting_tpu_torch.utils.flops import config_forward_flops
    from diffsplitting_tpu_torch.utils.profiling import peak_flops

    t_phase = time.perf_counter()
    result = {}

    # ------------------------------------------------ Hagen joint: sites, slice, fused
    opt = dict_to_nonedict(load_json(CONFIG))
    model = SplittingModel(opt, device=dev, seed=0)
    tile_batch, frames = slice_inputs(dev)
    t_vec = torch.full((BATCH,), 0.5, device=dev)
    hagen_sites = {}
    for sites, wide in (("default", False), ("all", True)):
        model.set_quant(8, updown=wide, shortcut=wide)
        with torch.inference_mode():
            qnets = model.served_unets(tile_batch)
        for i, qnet in enumerate(qnets):
            rows = w8a8_sites(f"w8a8 Hagen net {i + 1}, {sites} sites, B={BATCH} {PATCH}²",
                              model.unets()[i], qnet, lambda q: q(tile_batch, t_vec),
                              timed=wide and i == 0)
            if sites == "default" and len(rows) != W8A8_SITES_HAGEN:
                raise AssertionError(f"w8a8 Hagen: {len(rows)} default int8 sites, expected "
                                     f"{W8A8_SITES_HAGEN}")
            hagen_sites[sites] = len(rows)
            if wide and i == 0:
                result["hagen_sites"] = site_times(f"w8a8 Hagen B={BATCH} {PATCH}²", rows,
                                                   "cuDNN's f32 convs (TF32 off)")
    del qnets, rows
    model.set_quant(8)
    steps = model.process.val_num_timesteps
    n_tiles = 18
    forwards = 2 * steps * math.ceil(n_tiles / BATCH)
    # a forward's GN+Swish and attention launches and int8 sites, from the UNet's modules
    net = model.unets()[0]
    gn_fwd = sum(isinstance(m, GroupNormSwish) for m in net.modules())
    attn_fwd = sum(isinstance(m, SelfAttention) for m in net.modules())
    blocks = sum(isinstance(m, ResnetBlock) for m in net.modules())
    if (gn_fwd, attn_fwd, 2 * blocks) != (29, 1, W8A8_SITES_HAGEN):
        raise AssertionError(f"w8a8 slice: {CONFIG} has {gn_fwd} GN+Swish, {attn_fwd} attention "
                             f"and {blocks} ResnetBlocks a forward")
    expected = {"group_norm_swish": gn_fwd * forwards, "attention": attn_fwd * forwards,
                "attention_wide": 0,
                "attention_narrow": 0, "conv_gn": 0, "sites_kernel": 0, "sites_library": 0,
                **BF16_NONE}
    out, launches, stats = phase_slice(model, frames, False, expected, n_tiles, forwards,
                                       label="w8a8 slice")
    if stats["int8_conv"] != W8A8_SITES_HAGEN * forwards:
        raise AssertionError(f"w8a8 slice: {stats['int8_conv']} int8 products, expected "
                             f"{W8A8_SITES_HAGEN} x {forwards}")
    calib_s = model.last_calibration_s
    fused_out, fused_launches, fused_stats = phase_slice(
        model, frames, True, expected, n_tiles, forwards, label="w8a8 slice (fused requested)")
    if not (torch.equal(fused_out, out) and fused_stats["int8_conv"] == stats["int8_conv"]):
        raise AssertionError("w8a8 slice: DSP_FUSED did not serve the W8A8 forward")
    model.set_quant(8)  # drops the cached nets: the calibration below runs anew
    hagen_memory = memory_split(
        f"w8a8 Hagen B={BATCH} {PATCH}²", lambda: model.served_unets(tile_batch),
        {"w8a8_forward": lambda: model.served_unets(tile_batch)[0](tile_batch, t_vec),
         "float_forward": lambda: net(tile_batch, t_vec)})
    model.set_quant(None)
    model.generator.manual_seed(0)
    exact = predict_frames(model, frames, PATCH, BATCH)
    psnr = psnr_per_channel(exact, out)
    log(f"w8a8 slice: {stats['tiles_per_s']:.2f} tiles/s, peak {stats['peak'] / 2**30:.2f} GiB "
        f"({stats['peak']} bytes) against the exact slice's {exact_slice['tiles_per_s']:.2f} "
        f"tiles/s, {exact_slice['peak'] / 2**30:.2f} GiB of this run; calibration (two nets, 8 "
        f"rows each) {calib_s:.3f} s; int8 products "
        f"{stats['int8_conv']} ({W8A8_SITES_HAGEN} a forward); PSNR against the exact chain "
        f"{psnr[0]:.2f} / {psnr[1]:.2f} dB; with a fused request: the same bits, launches "
        f"{fused_launches}")
    result["hagen"] = dict(tiles_per_s=stats["tiles_per_s"], peak=stats["peak"],
                           exact_tiles_per_s=exact_slice["tiles_per_s"],
                           exact_peak=exact_slice["peak"], calibration_s=calib_s, psnr=psnr,
                           sites=hagen_sites, launches=launches, int8_conv=stats["int8_conv"],
                           fused_launches=fused_launches, memory=hagen_memory)
    del model, net, frames, tile_batch, out, fused_out, exact
    torch.cuda.empty_cache()
    hagen_s = time.perf_counter() - t_phase

    # ------------------------------------------------ sr_sr3_64_512: infer.py with W8A8
    model_opt = dict_to_nonedict(load_json(SR512_CONFIG))["model"]
    T = int(model_opt["beta_schedule"]["val"]["n_timestep"])
    size = int(model_opt["diffusion"]["image_size"])
    cfg = sr_config(work, SR512_CONFIG, sr512["root"], 1)
    S = len(ddim_timesteps(T, parse_accel_flag(SRA_DDIM, 0.0)[0]))
    interval, depth = parse_accel_flag(SRA_DEEPCACHE, 1, second_cast=int)
    per_forward = dict(GN_ATTN_ONLY, group_norm_swish=0, attention=0,
                       group_norm_swish_bf16=SR512_GN_FWD, attention_bf16=SR512_ATTN_FWD)
    F = len(range(0, S, interval))
    full = shallow = None  # a CachedUNet pass's launches, from the first run's UNet
    calib = per_forward  # the calibration forward: one bf16 forward of the float net

    def with_calib(counts):
        return {k: counts[k] + calib[k] for k in counts}

    runs, prof, rel, sr_sites = {}, {}, {}, {}
    plans = (("w8a8", ["--w8a8"], with_calib({k: v * S for k, v in per_forward.items()})),
             ("w8a8_all", ["--w8a8_sites", "all"],
              with_calib({k: v * S for k, v in per_forward.items()})),
             ("w8a8_deepcache", ["--w8a8", "--deepcache", SRA_DEEPCACHE], None))
    for name, flags, want in plans:
        if want is None:
            want = with_calib(dict(per_forward, **{k: full[k] * F + shallow[k] * (S - F)
                                                   for k in full}))
        t_run = time.perf_counter()
        run = serve_cli(f"w8a8 infer.py {' '.join(flags)} --ddim {SRA_DDIM}", infer,
                        ["-c", cfg, "-rootdir", str(Path(work) / f"w8a8_{name}"), "--ddim",
                         SRA_DDIM] + flags, per_forward, S, want=want)
        model = run.pop("model")
        if full is None:
            full, shallow = pass_launches(model.nets.denoise_fn, depth)
        (_, (_, (qnet,))), = model.switches._quant_nets.items()
        n_sites = sum(1 for _ in iter_quant_sites(qnet))
        if name == "w8a8" and n_sites != W8A8_SITES_SR512:
            raise AssertionError(f"w8a8 sr512: {n_sites} default int8 sites, expected "
                                 f"{W8A8_SITES_SR512}")
        if name == "w8a8_deepcache":
            cnet = CachedUNet(qnet, depth)
            shallow_sites = sum(isinstance(m, W8A8Conv2d) for layer in
                                cnet.shallow_down + cnet.shallow_up + [qnet.final_conv]
                                for m in layer.modules())
            want_int8 = n_sites * F + shallow_sites * (S - F)
        else:
            want_int8 = n_sites * S
        if run["int8_conv"] != want_int8:
            raise AssertionError(f"w8a8 sr512 {name}: {run['int8_conv']} int8 products, "
                                 f"expected {want_int8}")
        run.update(calibration_s=model.switches.last_calibration_s, sites=n_sites,
                   int8_conv=run["int8_conv"])
        serve_s = run["chain_s"] - run["calibration_s"]
        # the idle share: device time a step of a profiled 20-step W8A8 DDIM chain
        # (DeepCache at the same share of full passes) over the chain's own seconds
        item = LRHRDataset(sr512["root"], "img", size // 8, size, split="val", need_LR=False)[0]
        model.feed_data({"input": item["SR"][None], "target": item["HR"][None]})
        model.set_ddim(W8A8_PROFILE_STEPS, 1.0)
        t_checks = time.perf_counter()
        prof[name] = chain_profile(model, W8A8_PROFILE_STEPS, False, S, serve_s,
                                   label=f"w8a8 profile, {name}")
        if name != "w8a8_deepcache":
            net = model.nets.denoise_fn
            x, t = sr_calib_inputs("sr3", model.process, model.current_sched, "test", 8,
                                   model.data["input"][:1], dev)
            with torch.inference_mode():
                rel[name] = rel_l2(qnet(x, t), net(x, t))
            log(f"w8a8 sr512 {name}: one forward on the calibration batch (8 rows) rel-L2 "
                f"{rel[name]:.5f} against the unquantized bf16 forward")
            # 0 is a forward that quantizes nothing; the bound is about twice the
            # error measured at 'all' sites on these seeded weights
            if not 0 < rel[name] < W8A8_REL_L2_MAX:
                raise AssertionError(f"w8a8 sr512 {name}: rel-L2 {rel[name]} outside "
                                     f"(0, {W8A8_REL_L2_MAX})")
            if name == "w8a8":
                model.set_quant(8)  # drops the cached nets: the calibration below runs anew
                result["sr512_memory"] = memory_split(
                    f"w8a8 sr512 B=1 {size}²",
                    lambda: model.switches.quantized_unets((net,), "test", lambda i: (x, t)),
                    {"float_forward_8_rows": lambda: net(x, t),
                     "w8a8_forward": lambda: qnet(x[:1], t[:1]),
                     "float_forward": lambda: net(x[:1], t[:1])})
            sr_sites[name] = w8a8_sites(
                f"w8a8 sr512 {name}, B=1 {size}²", net, qnet,
                lambda q: q(x[:1], t[:1]), timed=name == "w8a8_all")
            if name == "w8a8_all":
                result["sr512_sites"] = site_times(f"w8a8 sr512 B=1 {size}²", sr_sites[name],
                                                   "cuDNN's bf16 convs")
            del x, t, net
        log(f"w8a8 sr512 {name}: the infer.py run {t_checks - t_run:.1f} s, the profile and "
            f"checks {time.perf_counter() - t_checks:.1f} s")
        runs[name] = dict(chain_s=run["chain_s"], serve_s=serve_s,
                          calibration_s=run["calibration_s"], peak=run["peak"],
                          idle=prof[name]["idle"], sites=n_sites, int8_conv=run["int8_conv"],
                          launches=run["launches"])
        del model, qnet
        torch.cuda.empty_cache()
    base = {"w8a8": "ddim", "w8a8_all": "ddim", "w8a8_deepcache": "ddim_deepcache"}
    for name, r in runs.items():
        b = sra["chains"][base[name]]
        log(f"w8a8 sr512 {name}: {r['chain_s']:.3f} s a {S}-step chain ({r['serve_s']:.3f} s "
            f"without the calibration's {r['calibration_s']:.3f} s), peak {r['peak'] / 2**30:.2f} "
            f"GiB ({r['peak']} bytes), idle share "
            + ("not measured" if r["idle"] is None else f"{r['idle']:.2%}")
            + f", {r['sites']} int8 sites a forward; the unquantized {base[name]} chain of this "
            f"run {b['chain_s']:.3f} s, {b['peak'] / 2**30:.2f} GiB, idle "
            + ("not measured" if b["idle"] is None else f"{b['idle']:.2%}")
            + f" ({r['serve_s'] / b['chain_s']:.2f}x its seconds)")
    result["sr512"] = dict(runs=runs, rel_l2=rel)
    sr_s = time.perf_counter() - t_phase - hagen_s

    # ------------------------------------------------ MFU from the FLOP count
    name = torch.cuda.get_device_name(0)
    fwd = config_forward_flops(model_opt, size, 1)
    step_ms = sr512["chain"].get("busy_ms")
    step_ms = None if step_ms is None else step_ms / SR512_CUT_STEPS
    wall_ms = sr512["chain"]["chain_s"] * 1e3 / sr512["chain"]["steps"]
    bf16_peak = peak_flops(torch.bfloat16, dev)
    mfu = dict(sr512_flops_a_step=fwd, sr512_wall=fwd / (wall_ms / 1e3) / bf16_peak,
               sr512_device=None if step_ms is None else fwd / (step_ms / 1e3) / bf16_peak)
    train_flops = train_flops_per_step(opt)
    f32_peak = peak_flops(torch.float32, dev)
    busy = (train.get("profile") or {}).get("busy_ms")
    mfu.update(hagen_train_flops_a_step=train_flops,
               hagen_train_wall=train_flops / (train["ms"] / 1e3) / f32_peak,
               hagen_train_device=None if not busy else train_flops / (busy / 1e3) / f32_peak)
    log(f"MFU on {name}: sr_sr3_64_512 exact step, {fwd / 1e9:.1f} GFLOP a forward at batch 1: "
        f"{mfu['sr512_wall']:.2%} of the bf16 peak ({bf16_peak / 1e12:.0f} TFLOP/s) by the "
        f"chain's wall time a step ({wall_ms:.3f} ms), "
        + ("device time not measured" if step_ms is None else
           f"{mfu['sr512_device']:.2%} by its device time a step ({step_ms:.4f} ms)")
        + f"; Hagen joint train step, {train_flops / 1e12:.3f} TFLOP (3 x forward x 2 nets at "
        f"batch {TRAIN_BATCH}): {mfu['hagen_train_wall']:.2%} of the FP32 peak "
        f"({f32_peak / 1e12:.0f} TFLOP/s; TF32 is off) at {train['ms']:.2f} ms a step, "
        + ("device time not measured" if not busy else
           f"{mfu['hagen_train_device']:.2%} by its profiled device time ({busy:.2f} ms)"))
    result["mfu"] = mfu

    # ------------------------------------------------ LPIPS, card against CPU
    params = lpips.random_lpips_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(46)
    a = torch.rand(LPIPS_SHAPE, generator=g) * 2 - 1
    b = (a + 0.3 * torch.randn(LPIPS_SHAPE, generator=g)).clamp(-1, 1)
    with torch.inference_mode():
        want = lpips.lpips(params, a, b)
        card = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
        got = lpips.lpips(card, a.to(dev), b.to(dev))
        lp_ms = time_ms(lambda: lpips.lpips(card, a.to(dev), b.to(dev)), 5)
    err = (got.cpu() - want).abs().max().item()
    if not err <= 1e-4 * want.abs().max().item() + 1e-6:
        raise AssertionError(f"LPIPS card vs CPU: max abs err {err}")
    log(f"LPIPS (random weights) at {LPIPS_SHAPE}: card {got.cpu().tolist()} against CPU "
        f"{want.tolist()}, max abs err {err:.3g}; {lp_ms:.3f} ms a call on the card")
    result["lpips"] = dict(err=err, ms=lp_ms)

    secs = time.perf_counter() - t_phase
    log(f"w8a8 phase: {secs:.1f} s (Hagen {hagen_s:.1f} s, sr512 {sr_s:.1f} s)")
    result["seconds"] = secs
    result["launches"] = {
        "group_norm_swish": launches["group_norm_swish"] + fused_launches["group_norm_swish"],
        "attention": launches["attention"] + fused_launches["attention"],
        **{k: sum(r["launches"][k] for r in runs.values())
           for k in ("group_norm_swish_bf16", "attention_bf16")}}
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.kernels import build, conv_gn_variants, groupnorm_variants, variants
    from diffsplitting_tpu_torch.models import fused_unet_forward
    from diffsplitting_tpu_torch.predict import predict_frames
    from diffsplitting_tpu_torch.serving import SplittingModel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"nvidia-smi: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path, build_log = build.build()
    build.library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    conv_bf16_regs = variants.ptxas_summary(build_log.split("== conv_gn_bf16.cu")[1]
                                            .split("\n== ")[0])
    log("conv_gn_bf16 registers and spills (consumer warpgroups raised to 232 by setmaxnreg, "
        "the producer lowered to 40; ptxas reports the launch's 168): "
        + "; ".join(conv_bf16_regs))
    attn_bf16_regs = variants.ptxas_summary(build_log.split("== attention_bf16.cu")[1]
                                            .split("\n== ")[0])
    log("attention_bf16 registers and spills (<panels> up to D = 256, then the wide kernel): "
        + "; ".join(attn_bf16_regs))

    opt = dict_to_nonedict(load_json(CONFIG))
    if int(opt["datasets"]["patch_size"]) != PATCH:
        raise AssertionError(f"{CONFIG} no longer serves {PATCH}² patches")
    groups = int(opt["model"]["unet"]["norm_groups"])
    model = SplittingModel(opt, device=dev, seed=0)
    net = model.unets()[0]
    tile_batch, frames = slice_inputs(dev)
    t_vec = torch.full((BATCH,), 0.5, device=dev)

    # GN+Swish at the unfused slice's shapes
    with torch.inference_mode():
        shapes = groupnorm_variants.gn_shapes(net, tile_batch, t_vec)
    if sum(shapes.values()) != 29:
        raise AssertionError(f"expected 29 GN+Swish calls per forward, saw {dict(shapes)}")
    gn, gn_err = phase_group_norm(dev, shapes, groups)
    # and at the train step's batch, untimed
    _, gn_train_err = phase_group_norm(dev, shapes, groups, batch=TRAIN_BATCH, timed=False)
    gn_err = max(gn_err, gn_train_err)

    # attention at the mid block's shape, at B=2, the train batch and the
    # serving batch (timed at the last)
    attn, attn_err = phase_attention(dev, (2, TRAIN_BATCH, BATCH))
    # the wide and narrow kernels, at head dims of other configs
    any_d, any_d_err = phase_attention_any_d(dev)

    # conv_gn at every site of one fused forward
    with torch.inference_mode():
        sites = conv_gn_variants.conv_gn_sites(net, tile_batch, t_vec)
    if sum(sites.values()) != 31:
        raise AssertionError(f"expected 31 conv_gn calls per fused forward, saw {dict(sites)}")
    conv, conv_err = phase_conv_gn(dev, sites)

    # one UNet forward on a tile batch: kernels vs plain versions, and the
    # fused walk vs the UNet's own forward and vs itself on plain versions
    with torch.inference_mode():
        got = net(tile_batch, t_vec)
        fused = fused_unet_forward(net, tile_batch, t_vec)
        with plain_versions():
            want = net(tile_batch, t_vec)
            fused_plain = fused_unet_forward(net, tile_batch, t_vec)
    tol = 1e-3 * want.abs().max().item() + 1e-4
    for what, a, b in (("kernels vs plain", got, want),
                       ("fused vs unfused (kernels)", fused, got),
                       ("fused kernels vs fused plain", fused, fused_plain)):
        err = max_err(a, b)
        if not (a.shape == b.shape and err <= tol):
            raise AssertionError(f"UNet forward, {what}: max abs err {err} > {tol}")
        log(f"UNet forward B={BATCH} {PATCH}², {what}: max abs err {err:.3g} (tol {tol:.3g})")
    del got, want, fused, fused_plain

    phase_small_reference(opt)
    phase_small_reference(opt, fused=True)
    phase_cifar10(dev)
    # inner 32: attention at D = 256 (the wide kernel), wide conv sites
    # planned to library ops in the fused walk
    wide = phase_cifar10(dev, inner=32, plan=(18, 13))
    # inner 8, 8 groups: attention at D = 64 (the narrow kernel)
    narrow = phase_cifar10(dev, inner=8, plan=(31, 0), groups=8)

    # the slice: joint-InDI tiled prediction at full width, unfused and fused
    steps = model.process.val_num_timesteps
    n_tiles = 18  # 3×3 tiles per 1024² frame: 512² patches on a 256² grid
    forwards = 2 * steps * math.ceil(n_tiles / BATCH)
    out, launches, exact_slice = phase_slice(
        model, frames, False,
        {"group_norm_swish": 29 * forwards, "attention": forwards, "attention_wide": 0,
         "attention_narrow": 0,
         "conv_gn": 0, "sites_kernel": 0, "sites_library": 0, **BF16_NONE},
        n_tiles, forwards)
    model.generator.manual_seed(0)
    with plain_versions():
        ref = predict_frames(model, frames, PATCH, BATCH)
    err = max_err(out, ref)
    tol = 1e-3 * ref.abs().max().item() + 1e-4
    if not err <= tol:
        raise AssertionError(f"slice, kernels vs plain versions: max abs err {err} > {tol}")
    log(f"slice: kernels vs plain versions max abs err {err:.3g} (tol {tol:.3g})")
    del ref
    phase_profile(model, frames, fused=False)

    # fused: 31 conv_gn a forward (28 ResnetBlock convs, 3 upsample convs), the
    # mid block's attention, and GroupNorm+Swish once, at the head
    out_fused, fused_launches, _ = phase_slice(
        model, frames, True,
        {"group_norm_swish": forwards, "attention": forwards, "attention_wide": 0,
         "attention_narrow": 0,
         "conv_gn": 31 * forwards, "sites_kernel": 31 * forwards, "sites_library": 0,
         **BF16_NONE},
        n_tiles, forwards)
    err = max_err(out_fused, out)
    tol = 1e-3 * out.abs().max().item() + 1e-4
    if not err <= tol:
        raise AssertionError(f"fused slice vs unfused slice: max abs err {err} > {tol}")
    log(f"slice: fused vs unfused max abs err {err:.3g} (tol {tol:.3g})")
    del out, out_fused
    phase_profile(model, frames, fused=True)
    del model, frames, tile_batch
    torch.cuda.empty_cache()

    train = phase_train(dev)
    loop = phase_train_loop(dev, train["ms"])
    with tempfile.TemporaryDirectory() as work:
        tp = phase_time_predictor(dev, work)
        tref = phase_t_refinement(dev, work, tp["classifier"])
        dcache = phase_deepcache(dev, tref["joint"])
        window = phase_sliding_window(dev, tref["joint"])
        sr3 = phase_sr3(dev, work)
        sr512 = phase_sr3_512(dev, work)
        sra = phase_sr_accelerators(dev, work, sr512)
        w8a8 = phase_w8a8(dev, work, exact_slice, sr512, sra, train)
    wide_shape = (BATCH, 16, 256)  # the mid block of the inner-32 path
    narrow_shape = (BATCH, 16, 64)  # the mid block of the inner-8 path

    kernels = [
        dict(name="group_norm_swish", route="cuda",
             source="diffsplitting_tpu_torch/csrc/groupnorm_swish.cu",
             replaces="diffsplitting_tpu/experimental/groupnorm_pallas.py:21,58",
             launches=launches["group_norm_swish"] + train["launches"]["group_norm_swish"]
             + loop["launches"]["group_norm_swish"] + tp["launches"]["group_norm_swish"]
             + tref["launches"]["group_norm_swish"] + dcache["launches"]["group_norm_swish"]
             + window["launches"]["group_norm_swish"] + sr3["launches"]["group_norm_swish"]
             + sra["parallel_launches"]["group_norm_swish"] + w8a8["launches"]["group_norm_swish"],
             max_abs_err=max(gn_err, sr3["gn_err"]), ms=gn["ms"],
             plain_ms=gn["plain_ms"], bound_ms=gn["bound_ms"], bound_by="bytes",
             library_ms=gn["library_ms"], device_ms=gn["device_ms"],
             library_device_ms=gn["library_device_ms"], design=GN_DESIGN, by_shape=gn["by_shape"],
             sr3_forward_b1={k: sr3["gn"][k] for k in ("ms", "device_ms", "plain_ms",
                                                       "library_ms", "bound_ms",
                                                       "library_device_ms")},
             sr3_by_shape=sr3["gn"]["by_shape"]),
        dict(name="attention", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention_wide.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=launches["attention"] + train["launches"]["attention"]
             + loop["launches"]["attention"] + tp["launches"]["attention"]
             + tref["launches"]["attention"] + dcache["launches"]["attention"]
             + window["launches"]["attention"] + w8a8["launches"]["attention"],
             max_abs_err=max(attn_err, tp["attn_b1"]["max_abs_err"]), ms=attn["ms"],
             plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"], bound_by=attn["bound_by"],
             library_ms=attn["library_ms"], device_ms=attn["device_ms"],
             library_device_ms=attn["library_device_ms"], plan=attn["plan"],
             by_shape={f"B=1 N={ATTN_N} D={ATTN_D}": {k: tp["attn_b1"][k] for k in (
                 "ms", "device_ms", "plain_device_ms", "library_device_ms", "bound_ms",
                 "max_abs_err", "plan")}, **attn["by_batch"]}),
        dict(name="attention_wide", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention_wide.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=wide[0]["attention_wide"] + wide[1]["attention_wide"]
             + sr3["launches"]["attention_wide"] + sra["parallel_launches"]["attention_wide"],
             max_abs_err=any_d_err["wide"], at="B=%d N=%d D=%d" % wide_shape,
             **{k: any_d[wide_shape][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "device_ms")},
             by_shape={"B=%d N=%d D=%d" % key: {k: r[k] for k in (
                 "ms", "device_ms", "library_device_ms", "bound_ms", "max_abs_err", "err_f64",
                 "plan")}
                 for key, r in any_d.items() if r["route"] == "wide"}),
        dict(name="attention_narrow", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=narrow[0]["attention_narrow"] + narrow[1]["attention_narrow"],
             max_abs_err=any_d_err["narrow"], at="B=%d N=%d D=%d" % narrow_shape,
             **{k: any_d[narrow_shape][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "device_ms")},
             by_shape={"B=%d N=%d D=%d" % key: {k: r[k] for k in (
                 "route", "device_ms", "plain_ms", "library_device_ms", "bound_ms",
                 "max_abs_err", "err_f64")}
                 for key, r in any_d.items() if r["route"] == "narrow" or key[2] % 128}),
        dict(name="conv_gn", route="cuda",
             source="diffsplitting_tpu_torch/csrc/conv_gn.cu",
             replaces="diffsplitting_tpu/experimental/conv_gn.py:270",
             launches=fused_launches["conv_gn"] + dcache["launches"]["conv_gn"]
             + sr3["launches"]["conv_gn"],
             max_abs_err=max(conv_err, sr3["conv_err"]), ms=conv["ms"],
             device_ms=conv["device_ms"], plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"],
             bound_by=conv["bound_by"], library_ms=conv["library_ms"],
             stats_tol_share=conv["stats_tol_share"]),
        dict(name="group_norm_swish_bf16", route="cuda",
             source="diffsplitting_tpu_torch/csrc/groupnorm_swish.cu",
             replaces="diffsplitting_tpu/experimental/groupnorm_pallas.py:21,58",
             launches=sr512["launches"]["group_norm_swish_bf16"]
             + sra["launches"]["group_norm_swish_bf16"]
             + w8a8["launches"]["group_norm_swish_bf16"],
             max_abs_err=sr512["gn_worst"]["kernel"],
             plain_max_abs_err=sr512["gn_worst"]["plain"],
             **{k: sr512["gn"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                            "device_ms", "library_device_ms")}, bound_by="bytes",
             design=GN_DESIGN, by_shape=sr512["gn"]["by_shape"], f32_wide_c=sr512["gn_f32"]),
        dict(name="attention_bf16", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention_bf16.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             design=ATTN_BF16_DESIGN, registers=attn_bf16_regs,
             launches=sr512["launches"]["attention_bf16"] + sra["launches"]["attention_bf16"]
             + w8a8["launches"]["attention_bf16"],
             max_abs_err=sr512["attn_worst"]["kernel"],
             plain_max_abs_err=sr512["attn_worst"]["plain"], at="B=1 N=1024 D=1024",
             **{k: sr512["attn"][(1, 1024, 1024)][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")},
             by_shape={"B=%d N=%d D=%d" % key: {k: r[k] for k in (
                 "device_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                 "plain_max_abs_err", "splits", "wide")} for key, r in sr512["attn"].items()}),
        dict(name="conv_gn_bf16", route="cuda",
             source="diffsplitting_tpu_torch/csrc/conv_gn_bf16.cu",
             replaces="diffsplitting_tpu/experimental/conv_gn.py:270",
             design="wgmma.mma_async m64nBNk16 bf16 (A from registers, B by a 32-byte-swizzle "
                    "descriptor), each stage's 9 taps summed from 0 and added in f32; weights "
                    "streamed by cp.async.bulk into a 3-stage mbarrier ring by a producer "
                    "warpgroup (setmaxnreg 40 / 232); two consumer warpgroups, each with its own "
                    "halo window (cp.async, activated in place) and taking turns to issue",
             registers=conv_bf16_regs,
             launches=sr512["launches"]["conv_gn_bf16"] + sra["launches"]["conv_gn_bf16"],
             max_abs_err=sr512["conv_worst"],
             **{k: sr512["conv"][k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")},
             by_site={k: {f: r[f] for f in ("calls", "device_ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by", "max_abs_err")}
                      for k, r in sr512["conv_sites"].items()}),
    ]
    log("group_norm_swish times are per UNet forward (29 calls at batch 8), through a host loop "
        "of calls (device_ms: its device time alone, by CUDA-graph replay), and its launches are "
        "the unfused slice's plus one train step's plus the two split.py train runs' plus the "
        "time predictor's start_training run's plus the t-refinement workflow's three runs "
        "(kernels) plus the DeepCache phase's four counted runs (exact unfused and fused, "
        "'auto', 5) plus the sliding window's τ=0 run; attention times are per call at "
        f"B={BATCH}, N={ATTN_N}, D={ATTN_D} (device_ms by CUDA-graph replay; plan: the key "
        "splits), its launches likewise (by_shape: at B=1, the one-step inversions', and at "
        "B=2, 4 and 8, device times by CUDA-graph replay beside the host loop's, with the "
        "plan); "
        "attention_wide times are per call at the inner-32 cifar10 path's mid block "
        "(its launches, unfused and fused; by_shape: host-loop and device times at every "
        "wide-routed shape, with SDPA's, errors and the plan), "
        "attention_narrow times at the inner-8 path's (its launches; by_shape: device times at "
        "every narrow shape and every padded wide one, D = 192), device_ms by CUDA-graph "
        "replay; conv_gn times are per fused UNet forward "
        "(31 calls at batch 8) and its launches are the fused slice's and the DeepCache "
        "phase's fused exact chain's; each kernel's launches also count the SR3 phase's "
        "(infer.py's 2000-step chains unfused and fused, DDPM's chain, sample.py's two, one train "
        "step) and, for group_norm_swish and attention_wide, the accelerator phase's "
        "ddpm_sample_parallel run, attention_wide's its 6 a forward at D = 512, and "
        "group_norm_swish's "
        "sr3_forward_b1 holds its times a forward of sr_sr3_16_128 at batch 1 (55 calls), "
        "by_shape and sr3_by_shape each shape's route, device time, library device time and "
        "bound (ms a call); "
        "group_norm_swish_bf16 times are per sr_sr3_64_512 forward at batch 1 (35 calls; "
        "device_ms and library_device_ms by CUDA-graph replay; plain and library "
        "(F.silu(F.group_norm) in bf16) through a host loop; by_shape per call, with its route) "
        "and its launches are that phase's infer.py chain and its two "
        "train steps (remat on and off) plus the accelerator phase's infer.py runs (DDIM unfused "
        "and fused, DeepCache, DDIM x DeepCache, the window) and its full and shallow pass; "
        "attention_bf16 times are at its mid block (B=1, "
        "N=1024, D=1024; plain_ms and library_ms (SDPA in bf16) by CUDA-graph replay), its "
        "launches likewise; each bf16 max_abs_err is against an f32 reference from the same "
        "bf16 inputs, beside the plain bf16 version's (plain_max_abs_err); conv_gn_bf16 times "
        "are per sr_sr3_64_512 fused forward at batch 1 (11 calls; ms through a host loop, "
        "device_ms, plain_ms and library_ms (cuDNN F.conv2d in bf16 on the activated input, + "
        "the residual or its 1x1 skip conv) by CUDA-graph replay; by_site per call), its "
        "max_abs_err against its plain version (bf16 operands, f32 sums, y rounded to bf16), "
        "its launches the phase's fused infer.py chain's (11 a forward) and the fused DDIM run's; "
        "the W8A8 phase's counted runs add to group_norm_swish and attention (the Hagen W8A8 "
        "slice, unfused and with a fused request) and to their bf16 kernels (its three infer.py "
        "runs, each with its calibration forward)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
