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
the SIMT any-D kernel), unfused and fused, against the port on the CPU. The
attention kernels at other head dims are also held against their plain
version and timed beside it and SDPA, each on its route, at D = 16 ... 1024
and at the SR3 / DDPM configs' own shapes.

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
(each cut to 50 steps, logged), one sr3 train step at
batch 4 against the plain versions and 10 timed steps, and eval.py on the
written PNGs.

Every phase raises on failure, so the script exits non-zero with no result
line. It prints the card's name and power limit, per-kernel times beside
their bounds, each slice's tiles/s and peak memory, the train step's time and
peak memory, a device-time breakdown of one run of each slice and of one
train step (torch.profiler), one JSON line of kernels and, last, the device
line.
TF32 is off throughout, so the convolutions, matmuls and kernels all compute
in float32.
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


@contextlib.contextmanager
def plain_versions():
    """Route the UNet blocks and the fused walk through the kernels' plain
    versions."""
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
    launches must give the same bits. When `timed`: the kernel, plain and
    library times through a host loop of calls (as the kernel has been timed
    since it was ported; at the small shapes the wrapper's host time bounds
    it), and the kernel's device time alone by CUDA-graph replay."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import fused_group_norm_swish, group_norm_swish_reference

    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, device_ms=0.0)
    worst = 0.0
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
        del got, again, want
        if not timed:
            log(f"gn_swish B={batch} H={H} W={W} C={C} C/G={C // groups} calls/forward={calls}: "
                f"err {err:.3g} (tol {tol:.3g}), two launches bit-identical")
            continue
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the same bytes
        ms = time_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        dev_ms = device_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        plain = time_ms(lambda: group_norm_swish_reference(x, scale, bias, groups), 5)
        lib = time_ms(lambda: F.silu(F.group_norm(x_nchw, groups, scale, bias, 1e-5)), 5)
        bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3  # read x, write y
        log(f"gn_swish B={batch} H={H} W={W} C={C} C/G={C // groups} calls/forward={calls}: "
            f"err {err:.3g} kernel {ms:.4f} ms (device time {dev_ms:.4f}) plain {plain:.4f} ms "
            f"library {lib:.4f} ms bound {bound:.4f} ms ({bound / ms:.1%} of HBM rate; "
            f"{bound / dev_ms:.1%} by device time)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("device_ms", dev_ms)):
            tot[key] += calls * val
        del x, x_nchw
        torch.cuda.empty_cache()
    if timed:
        log(f"gn_swish per UNet forward ({sum(shapes.values())} calls): "
            + " ".join(f"{k} {v:.4f}" for k, v in tot.items()))
    return tot, worst


def phase_attention(dev, batches):
    """Kernel vs plain version at N=4096, D=128, one head; timed at the
    serving batch."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention

    g = torch.Generator(device=dev).manual_seed(2)
    scale = 1.0 / math.sqrt(ATTN_D)
    worst, res = 0.0, None
    for B in batches:
        # q, k, v as the mid block hands them over: views of one qkv tensor
        qkv = torch.randn(B, ATTN_N, 1, 3, ATTN_D, device=dev, generator=g)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        got = fused_attention(q, k, v, scale)
        want = attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # f32 FMA on both sides; softmax sums over 4096 keys in another order
        tol = 1e-4 * (1 + want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f"attention B={B}: max abs err {err} > {tol}")
        worst = max(worst, err)
        ms = time_ms(lambda: fused_attention(q, k, v, scale), 10)
        plain = time_ms(lambda: attention_reference(q, k, v, scale), 3)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10)
        flops = 4 * B * ATTN_N * ATTN_N * ATTN_D  # q·kᵀ and p·v
        nbytes = 4 * B * ATTN_N * ATTN_D * 4  # q, k, v in, out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the kernel does each f32 product as three TF32 tensor-core products
        # (3xTF32); the same work on f32 FMA is the slower of the two bounds
        tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
        fma_ms = flops / F32_FLOPS_PER_S * 1e3
        bound = max(tc_ms, bytes_ms)
        bound_by = "operations" if tc_ms >= bytes_ms else "bytes"
        log(f"attention B={B} N={ATTN_N} D={ATTN_D} heads=1: err {err:.3g} (tol {tol:.3g}) kernel "
            f"{ms:.4f} ms plain {plain:.4f} ms library {lib:.4f} ms; bounds: 3xTF32 tensor-core "
            f"{tc_ms:.4f} ms ({bound / ms:.1%} of it), f32 FMA {fma_ms:.4f} ms, bytes "
            f"{bytes_ms:.4f} ms; {flops / ms / 1e9:.1f} f32 TFLOP/s")
        res = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=bound_by)
        del qkv, q, k, v, got, want
        torch.cuda.empty_cache()
    return res, worst


# (B, N, D) of attention at head dims other than 128: D = 16, 64 and 256 at
# N = 16, 100 and 1024; D = 512 at the SR3 attention site at 16² (B = 8, N =
# 256); D = 1024 at the mid block of sr_sr3_64_512 (B = 2, N = 1024)
ANY_D_SHAPES = ([(BATCH, n, d) for d in (16, 64, 256) for n in (16, 100, 1024)]
                + [(BATCH, 256, 512), (2, 1024, 1024)])
# the SR3 / DDPM configs' own: sr_sr3_16_128 and sr_ddpm_16_128 at their train
# batch 4 and their serving batch 1 (the 16² sites and the 8² mid block,
# D = 512), sample_ddpm_128's 4² mid block at batch 12 (D = 256)
SR3_SHAPES = [(4, 256, 512), (4, 64, 512), (1, 256, 512), (1, 64, 512), (12, 16, 256)]
# route of ops.attention.head_dim_route -> its launch count in read_launches()
ROUTE_COUNTER = {"d128": "attention", "wide": "attention_wide", "simt": "attention_any_d"}


def simt_attention(q, k, v, scale):
    """The SIMT kernel called through its C entry point, at any D it takes
    (the wrapper routes D = 256 ... 1024 to the wide kernel): to time the two
    side by side. Not counted as a launch."""
    import torch
    from diffsplitting_tpu_torch.kernels.build import check, library

    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), device=q.device)
    check(library().attention_f32_any_d(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        B, N, H, D, *q.stride()[:3], scale,
                                        torch.cuda.current_stream().cuda_stream),
          "attention_f32_any_d")
    return out


def phase_attention_any_d(dev):
    """Attention at head dims other than 128, at ANY_D_SHAPES and SR3_SHAPES,
    each on its route (the wide tensor-core kernel at D = 256 ... 1024 in
    steps of 128, the SIMT kernel at other D): against the plain version
    (two launches must give the same bits), the error of both against f64,
    and the times of the kernel, the plain version and SDPA through a host
    loop of calls, with the kernel's and SDPA's device time alone by
    CUDA-graph replay (the wrapper's host time exceeds a small call's device
    time); at a wide shape also the SIMT kernel's, at the same D. Returns
    {(B, N, D): results} and the worst error against the plain version, by
    route."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention, head_dim_route

    g = torch.Generator(device=dev).manual_seed(10)
    res, worst = {}, {"wide": 0.0, "simt": 0.0}
    for B, N, D in ANY_D_SHAPES + SR3_SHAPES:
        route = head_dim_route(D)
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
        # f32 accuracy on both sides (3xTF32 or f32 FMA); sums over D and N
        # in another order
        tol = 1e-4 * (1 + want.abs().max().item())
        if launched[ROUTE_COUNTER[route]] != 2 or sum(launched[c] for c in
                                                      ROUTE_COUNTER.values()) != 2:
            raise AssertionError(f"attention B={B} N={N} D={D}: launches {launched}, expected "
                                 f"2 of the {route} kernel")
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"attention B={B} N={N} D={D}: max abs err {err} (tol {tol}), "
                                 f"two launches equal {torch.equal(got, again)}")
        worst[route] = max(worst[route], err)
        ms = time_ms(lambda: fused_attention(q, k, v, scale), 20)
        dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
        plain = time_ms(lambda: attention_reference(q, k, v, scale), 3)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20)
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        simt = ""
        if route == "wide":
            simt_err = max_err(simt_attention(q, k, v, scale), want)
            if not simt_err <= tol:
                raise AssertionError(f"SIMT attention B={B} N={N} D={D}: max abs err {simt_err}")
            simt_dev = device_ms(lambda: simt_attention(q, k, v, scale))
            simt = f"; the SIMT kernel at this D: device time {simt_dev:.4f} ms"
        flops = 4 * B * N * N * D
        # the wide kernel does each f32 product as three TF32 tensor-core
        # products (3xTF32); the SIMT kernel runs on the f32 FMA units
        ops_ms = (3 * flops / TF32_FLOPS_PER_S if route == "wide"
                  else flops / F32_FLOPS_PER_S) * 1e3
        bytes_ms = 4 * B * N * D * 4 / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rate = "3xTF32 tensor-core" if route == "wide" else "f32 FMA"
        log(f"attention {route} B={B} N={N} D={D} heads=1: err {err:.3g} (tol {tol:.3g}; against "
            f"f64 {err64:.3g}, the plain version's {plain64:.3g}), two launches bit-identical; "
            f"kernel {ms:.4f} ms (device time {dev_ms:.4f}) plain {plain:.4f} ms SDPA {lib:.4f} "
            f"ms (device time {lib_dev:.4f}; {lib_dev / dev_ms:.2f}x the kernel's) bound "
            f"{bound:.4f} ms ({by}; {rate} {ops_ms:.4f}, bytes {bytes_ms:.4f}; "
            f"{bound / dev_ms:.1%} of it by device time, {flops / dev_ms / 1e9:.2f} f32 "
            f"TFLOP/s){simt}")
        res[(B, N, D)] = dict(route=route, ms=ms, device_ms=dev_ms, plain_ms=plain,
                              library_ms=lib, library_device_ms=lib_dev, bound_ms=bound,
                              bound_by=by, max_abs_err=err, err_f64=err64)
        if route == "wide":
            res[(B, N, D)]["simt_device_ms"] = simt_dev
        del qkv, q, k, v, got, again, want, exact
        torch.cuda.empty_cache()
    return res, worst


def phase_conv_gn(dev, sites, batch=BATCH, timed=True):
    """conv_gn kernel vs plain version at every site of one fused forward.
    When `timed`, also the times; the library time is cuDNN's F.conv2d on
    the already-activated input (plus the 1x1 F.conv2d of a projected
    residual): the convolution work the kernel replaces, without its
    prologue, residual add and statistics passes."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.conv_gn_variants import site_args
    from diffsplitting_tpu_torch.ops import conv_gn_fused, conv_gn_reference

    g = torch.Generator(device=dev).manual_seed(6)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, tc_ms=0.0, fma_ms=0.0,
               bytes_ms=0.0, gflop=0.0, gflop_taps=0.0, gbytes=0.0)
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
        del y, y_ref, s, q, s_ref, q_ref
        if not timed:
            log(f"conv_gn B={batch} H={H} W={W} Cin={Cin} Cout={Cout} prologue={act} "
                f"residual={res} Cres={Cres} calls/forward={calls}: err {err:.3g} (tol {tol:.3g})")
            continue
        ms = time_ms(lambda: conv_gn_fused(*args), 10)
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
            f"Cres={Cres} calls/forward={calls}: err {err:.3g} kernel {ms:.4f} ms plain "
            f"{plain:.4f} ms library {lib:.4f} ms bound {bound:.4f} ms ({by}; 3xTF32 tensor-core "
            f"{tc_ms:.4f}, bytes {bytes_ms:.4f}, f32 FMA {fma_ms:.4f}; "
            f"{flops / ms / 1e9:.1f} f32 TFLOP/s, {bound / ms:.1%} of bound)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
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
        + f" ({tot['gflop'] / tot['ms']:.1f} f32 TFLOP/s, {tot['bound_ms'] / tot['ms']:.1%} of "
        "the bound)")
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
    64, the SIMT attention kernel). `plan` is the (kernel, library) count of
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
        want = attention_reference(q, k, v, 1 / math.sqrt(dim))
        err = max_err(got, want)
        tol = 1e-4 * (1 + want.abs().max().item())  # f32 on both sides
        if not err <= tol:
            raise AssertionError(f"attention B={B} N={n_tok} D={dim}: max abs err {err} > {tol}")
        ms = time_ms(lambda: fused_attention(q, k, v, 1 / math.sqrt(dim)), 20)
        log(f"{name} kernels at B={B}: GN+Swish at {len(shapes)} shapes max abs err "
            f"{gn_err:.3g}, conv_gn at {len(sites)} sites {conv_err:.3g}, attention N={n_tok} "
            f"D={dim} heads=1 {err:.3g} (tol {tol:.3g}), {ms:.4f} ms")
    outs = {}
    for fused in (False, True):
        expected = {"group_norm_swish": (1 if fused else gn_per_forward) * forwards,
                    "attention": 0, "attention_wide": 0, "attention_any_d": 0,
                    "conv_gn": plan[0] * forwards if fused else 0,
                    "sites_kernel": plan[0] * forwards if fused else 0,
                    "sites_library": plan[1] * forwards if fused else 0}
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


# profile family -> the source whose __global__ functions make it up, and
# the launch count that says the family ran
KERNEL_FAMILIES = {"group_norm_swish kernel": ("groupnorm_swish.cu", "group_norm_swish"),
                   "attention kernel": ("attention.cu", "attention"),
                   "conv_gn kernel": ("conv_gn.cu", "conv_gn")}


@functools.cache
def kernel_names() -> dict:
    """Family -> names of the __global__ functions its source defines."""
    csrc = Path(__file__).resolve().parent / "diffsplitting_tpu_torch" / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    names = {}
    for fam, (src, _) in KERNEL_FAMILIES.items():
        names[fam] = pattern.findall((csrc / src).read_text())
        if not names[fam]:
            raise AssertionError(f"no __global__ function found in csrc/{src}")
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
    """Every launch count to 0, and the fused walk's conv-site plan counts."""
    from diffsplitting_tpu_torch.models.fused_forward import ConvSitePlan
    from diffsplitting_tpu_torch.ops import FusedAttention, FusedConvGN, FusedGroupNormSwish

    for k in (FusedGroupNormSwish, FusedAttention, FusedConvGN):
        k.launches = 0
    FusedAttention.launches_wide = FusedAttention.launches_any_d = 0
    ConvSitePlan.kernel = ConvSitePlan.library = 0


def read_launches() -> dict:
    from diffsplitting_tpu_torch.models.fused_forward import ConvSitePlan
    from diffsplitting_tpu_torch.ops import FusedAttention, FusedConvGN, FusedGroupNormSwish

    return {"group_norm_swish": FusedGroupNormSwish.launches,
            "attention": FusedAttention.launches, "attention_wide": FusedAttention.launches_wide,
            "attention_any_d": FusedAttention.launches_any_d, "conv_gn": FusedConvGN.launches,
            "sites_kernel": ConvSitePlan.kernel, "sites_library": ConvSitePlan.library}


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
    return out, launches, dict(tiles_per_s=tiles_per_s, peak=peak, walls=walls)


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
    expected = {"group_norm_swish": 58, "attention": 2, "attention_wide": 0, "attention_any_d": 0,
                "conv_gn": 0, "sites_kernel": 0, "sites_library": 0}
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
            want = dict(per_run, attention_wide=0, attention_any_d=0, conv_gn=0,
                        sites_kernel=0, sites_library=0)
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
GN_ATTN_ONLY = {"attention_wide": 0, "attention_any_d": 0, "conv_gn": 0, "sites_kernel": 0,
                "sites_library": 0}


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
    mid block at B = 1) against its plain version, with the kernel's, the
    plain version's and SDPA's device time by CUDA-graph replay (and the
    kernel's through a host loop of calls)."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.kernels.variants import device_ms
    from diffsplitting_tpu_torch.ops import attention_reference, fused_attention

    g = torch.Generator(device=dev).manual_seed(22)
    scale = 1.0 / math.sqrt(ATTN_D)
    qkv = torch.randn(B, ATTN_N, 1, 3, ATTN_D, device=dev, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    got = fused_attention(q, k, v, scale)
    want = attention_reference(q, k, v, scale)
    err = max_err(got, want)
    tol = 1e-4 * (1 + want.abs().max().item())  # as phase_attention
    if not err <= tol:
        raise AssertionError(f"attention B={B}: max abs err {err} > {tol}")
    ms = time_ms(lambda: fused_attention(q, k, v, scale), 20)
    dev_ms = device_ms(lambda: fused_attention(q, k, v, scale))
    plain_dev = device_ms(lambda: attention_reference(q, k, v, scale), 5)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    flops = 4 * B * ATTN_N * ATTN_N * ATTN_D
    tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    bytes_ms = 4 * B * ATTN_N * ATTN_D * 4 / HBM_BYTES_PER_S * 1e3
    bound = max(tc_ms, bytes_ms)
    log(f"attention B={B} N={ATTN_N} D={ATTN_D}: err {err:.3g} (tol {tol:.3g}); device time "
        f"(CUDA-graph replay): kernel {dev_ms:.4f} ms, SDPA {lib_dev:.4f} ms ({lib_dev / dev_ms:.2f}x "
        f"the kernel's), plain {plain_dev:.4f} ms; kernel through a host loop {ms:.4f} ms; bound "
        f"{bound:.4f} ms ({'operations' if tc_ms >= bytes_ms else 'bytes'}; {bound / dev_ms:.1%} "
        "of it by device time)")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_device_ms=plain_dev,
                library_device_ms=lib_dev, bound_ms=bound)


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
SR3_TRAIN_BATCH, SR3_TRAIN_WARMUP, SR3_TRAIN_TIMED = 4, 2, 10


def write_lrhr_root(work: str, n: int, size: int, seed: int) -> str:
    """n seeded smooth RGB images of size² (sums of colored Gaussian blobs,
    numpy) through the port's prepare_data (PIL bicubic resize to size / 8
    and back): an LRHR root with lr_<l>, hr_<r> and sr_<l>_<r> PNG dirs."""
    import numpy as np
    from PIL import Image
    from diffsplitting_tpu_torch.data.prepare_data import prepare

    rng = np.random.default_rng(seed)
    src = Path(work) / "sr_src"
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


def serve_cli(label: str, cli, argv: list, per_forward: dict, steps: int) -> dict:
    """One run of a CLI's `main(argv)` (one item, one chain of `steps`
    steps) with every launch count set to 0 just before and read just after:
    the launches must be `per_forward` × steps. Returns the CLI's result
    with the launches, seconds a chain, forwards/s and peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = cli.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    secs = out["seconds"][0]
    log(f"{label}: one {steps}-step chain at batch 1 in {secs:.3f} s ({steps / secs:.1f} "
        f"forwards/s), peak memory {peak / 2**30:.2f} GiB ({peak} bytes), launches {launches}")
    return dict(out, launches=launches, chain_s=secs, forwards_per_s=steps / secs, peak=peak)


def chain_profile(model, steps: int, fused: bool, full_steps: int, full_chain_s: float) -> dict:
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
        log("sr3 profile: no device events recorded; idle share not measured")
        return dict(wall_ms=wall_ms, busy_ms=None, idle=None, idle_profiled=None)
    idle = 1 - busy / steps * full_steps / (full_chain_s * 1e3)
    log(f"sr3 profile ({steps}-step chain, batch 1, fused={fused}): device busy {busy:.1f} ms "
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
        one unconditional sample; each cut to SR3_SERVE_CUT_STEPS steps
        (logged);
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
               launches)
    return dict(launches={k: sum(c[k] for c in counted) for k in
                          ("group_norm_swish", "attention_wide", "conv_gn")},
                gn=gn, gn_err=max(gn_err, gn_err4), conv_err=conv_err, checks=checks,
                cut_errs=cut_errs, profile=prof, seconds=secs,
                chains={k: {f: r[f] for f in ("chain_s", "forwards_per_s", "peak")}
                        for k, r in (("sr3 unfused", unfused), ("sr3 fused", fused_run),
                                     ("ddpm unfused", ddpm), ("sample", gen))},
                train=dict(ms=train_ms, samples_per_s=SR3_TRAIN_BATCH / train_ms * 1e3,
                           peak=peak))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.kernels import build, conv_gn_variants, groupnorm_variants
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
    # the wide and SIMT kernels, at head dims of other configs
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
    # inner 8, 8 groups: attention at D = 64 (the SIMT kernel)
    narrow = phase_cifar10(dev, inner=8, plan=(31, 0), groups=8)

    # the slice: joint-InDI tiled prediction at full width, unfused and fused
    steps = model.process.val_num_timesteps
    n_tiles = 18  # 3×3 tiles per 1024² frame: 512² patches on a 256² grid
    forwards = 2 * steps * math.ceil(n_tiles / BATCH)
    out, launches, _ = phase_slice(
        model, frames, False,
        {"group_norm_swish": 29 * forwards, "attention": forwards, "attention_wide": 0,
         "attention_any_d": 0,
         "conv_gn": 0, "sites_kernel": 0, "sites_library": 0},
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
         "attention_any_d": 0,
         "conv_gn": 31 * forwards, "sites_kernel": 31 * forwards, "sites_library": 0},
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
    wide_shape = (BATCH, 16, 256)  # the mid block of the inner-32 path
    simt_shape = (BATCH, 16, 64)  # the mid block of the inner-8 path

    kernels = [
        dict(name="group_norm_swish", route="cuda",
             source="diffsplitting_tpu_torch/csrc/groupnorm_swish.cu",
             replaces="diffsplitting_tpu/experimental/groupnorm_pallas.py:21,58",
             launches=launches["group_norm_swish"] + train["launches"]["group_norm_swish"]
             + loop["launches"]["group_norm_swish"] + tp["launches"]["group_norm_swish"]
             + tref["launches"]["group_norm_swish"] + dcache["launches"]["group_norm_swish"]
             + window["launches"]["group_norm_swish"] + sr3["launches"]["group_norm_swish"],
             max_abs_err=max(gn_err, sr3["gn_err"]), ms=gn["ms"],
             plain_ms=gn["plain_ms"], bound_ms=gn["bound_ms"], bound_by="bytes",
             library_ms=gn["library_ms"], device_ms=gn["device_ms"],
             sr3_forward_b1={k: sr3["gn"][k] for k in ("ms", "device_ms", "plain_ms",
                                                       "library_ms", "bound_ms")}),
        dict(name="attention", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=launches["attention"] + train["launches"]["attention"]
             + loop["launches"]["attention"] + tp["launches"]["attention"]
             + tref["launches"]["attention"] + dcache["launches"]["attention"]
             + window["launches"]["attention"],
             max_abs_err=max(attn_err, tp["attn_b1"]["max_abs_err"]), ms=attn["ms"],
             plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"], bound_by=attn["bound_by"],
             library_ms=attn["library_ms"],
             by_shape={f"B=1 N={ATTN_N} D={ATTN_D}": {k: tp["attn_b1"][k] for k in (
                 "ms", "device_ms", "plain_device_ms", "library_device_ms", "bound_ms")}}),
        dict(name="attention_wide", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=wide[0]["attention_wide"] + wide[1]["attention_wide"]
             + sr3["launches"]["attention_wide"],
             max_abs_err=any_d_err["wide"], at="B=%d N=%d D=%d" % wide_shape,
             **{k: any_d[wide_shape][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "device_ms")},
             by_shape={"B=%d N=%d D=%d" % key: {k: r[k] for k in (
                 "device_ms", "library_device_ms", "simt_device_ms", "bound_ms")}
                 for key, r in any_d.items() if r["route"] == "wide"}),
        dict(name="attention_any_d", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=narrow[0]["attention_any_d"] + narrow[1]["attention_any_d"],
             max_abs_err=any_d_err["simt"], at="B=%d N=%d D=%d" % simt_shape,
             **{k: any_d[simt_shape][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "device_ms")}),
        dict(name="conv_gn", route="cuda",
             source="diffsplitting_tpu_torch/csrc/conv_gn.cu",
             replaces="diffsplitting_tpu/experimental/conv_gn.py:270",
             launches=fused_launches["conv_gn"] + dcache["launches"]["conv_gn"]
             + sr3["launches"]["conv_gn"],
             max_abs_err=max(conv_err, sr3["conv_err"]), ms=conv["ms"],
             plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
             library_ms=conv["library_ms"]),
    ]
    log("group_norm_swish times are per UNet forward (29 calls at batch 8), through a host loop "
        "of calls (device_ms: its device time alone, by CUDA-graph replay), and its launches are "
        "the unfused slice's plus one train step's plus the two split.py train runs' plus the "
        "time predictor's start_training run's plus the t-refinement workflow's three runs "
        "(kernels) plus the DeepCache phase's four counted runs (exact unfused and fused, "
        "'auto', 5) plus the sliding window's τ=0 run; attention times are per call at "
        f"B={BATCH}, N={ATTN_N}, D={ATTN_D}, its launches likewise (by_shape: at B=1, the "
        "one-step inversions', device times by CUDA-graph "
        "replay); "
        "attention_wide times are per call at the inner-32 cifar10 path's mid block "
        "(its launches, unfused and fused; by_shape: device times at other shapes, with SDPA's "
        "and the SIMT kernel's), attention_any_d (SIMT) times at the inner-8 path's (its "
        "launches), device_ms by CUDA-graph replay; conv_gn times are per fused UNet forward "
        "(31 calls at batch 8) and its launches are the fused slice's and the DeepCache "
        "phase's fused exact chain's; each kernel's launches also count the SR3 phase's "
        "(infer.py's 2000-step chains unfused and fused, DDPM's chain, sample.py's, one train "
        "step), attention_wide's its 6 a forward at D = 512, and group_norm_swish's "
        "sr3_forward_b1 holds its times a forward of sr_sr3_16_128 at batch 1 (55 calls)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
