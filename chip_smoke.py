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
loss) and one step's device time by family.

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
import json
import math
import re
import subprocess
import sys
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
# the SR3 / DDPM configs' own: sr_sr3_16_128 and sr_ddpm_16_128 at their batch
# 4 (the 16² sites and the 8² mid block, D = 512), sample_ddpm_128's 4² mid
# block at batch 12 (D = 256)
SR3_SHAPES = [(4, 256, 512), (4, 64, 512), (12, 16, 256)]
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


def phase_slice(model, frames, fused: bool, expected: dict, n_tiles: int, forwards: int):
    """Joint-InDI tiled prediction at full width: a warm-up run, then one run
    with every launch count set to 0 just before and read just after, then
    two more for the spread of the host-clock time. Returns the output, the
    median tiles/s and the peak device memory of the counted run."""
    import torch
    from diffsplitting_tpu_torch.predict import predict_frames

    model.generator.manual_seed(0)
    predict_frames(model, frames, PATCH, BATCH, fused=fused)  # warm-up: plans, allocator
    torch.cuda.synchronize()

    model.generator.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = predict_frames(model, frames, PATCH, BATCH, fused=fused)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches != expected:
        raise AssertionError(f"fused={fused}: launches {launches}, expected {expected}")
    if tuple(out.shape) != FRAMES + (2,) or not torch.isfinite(out).all():
        raise AssertionError(f"fused={fused}: slice output shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    for _ in range(2):
        t0 = time.perf_counter()
        predict_frames(model, frames, PATCH, BATCH, fused=fused)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    tiles_per_s = n_tiles / sorted(walls)[1]
    log(f"slice fused={fused}: {FRAMES[0]} frames {FRAMES[1]}x{FRAMES[2]}, {n_tiles} tiles of "
        f"{PATCH}², batch {BATCH}, {model.process.val_num_timesteps} steps, {forwards} UNet "
        "forwards: "
        f"runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {tiles_per_s:.2f} "
        f"tiles/s, peak memory {peak / 2**30:.2f} GiB ({peak} bytes), launches {launches}")
    return out, launches


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
    worst, worst_dp, worst_name = 0.0, 0.0, ""
    wparams = dict(want.nets.named_parameters())
    for name, p in got.nets.named_parameters():
        q = wparams[name]
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"train step, {what}: {name} has a gradient on one side only")
        if p.grad is None:
            continue
        g, h = p.grad.detach().cpu(), q.grad.detach().cpu()
        gmax = max(h.abs().max().item(), 1e-5 * wl["grad_norm"])
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
    log(f"train step, {what}: loss rel err {errs['l_pix']:.3g} (tol 1e-05), grad_norm rel err "
        f"{errs['grad_norm']:.3g} (tol 0.0001), worst gradient err {worst:.3g} of "
        f"max(max|g|, 1e-5 grad_norm) (tol 0.005) at {worst_name}"
        + (f", worst param err {worst_dp:.3g} lr where the sign of g is sure (tol 0.01)"
           if lr is not None else ""))


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
    gen = torch.Generator(device=dev).manual_seed(5)
    tile_batch = torch.randn(BATCH, PATCH, PATCH, 1, device=dev, generator=gen)
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
    frames = torch.randn(*FRAMES, 1, device=dev, generator=gen)
    steps = model.process.val_num_timesteps
    n_tiles = 18  # 3×3 tiles per 1024² frame: 512² patches on a 256² grid
    forwards = 2 * steps * math.ceil(n_tiles / BATCH)
    out, launches = phase_slice(
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
    out_fused, fused_launches = phase_slice(
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
    wide_shape = (BATCH, 16, 256)  # the mid block of the inner-32 path
    simt_shape = (BATCH, 16, 64)  # the mid block of the inner-8 path

    kernels = [
        dict(name="group_norm_swish", route="cuda",
             source="diffsplitting_tpu_torch/csrc/groupnorm_swish.cu",
             replaces="diffsplitting_tpu/experimental/groupnorm_pallas.py:21,58",
             launches=launches["group_norm_swish"] + train["launches"]["group_norm_swish"],
             max_abs_err=gn_err, ms=gn["ms"],
             plain_ms=gn["plain_ms"], bound_ms=gn["bound_ms"], bound_by="bytes",
             library_ms=gn["library_ms"], device_ms=gn["device_ms"]),
        dict(name="attention", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=launches["attention"] + train["launches"]["attention"],
             max_abs_err=attn_err, ms=attn["ms"],
             plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"], bound_by=attn["bound_by"],
             library_ms=attn["library_ms"]),
        dict(name="attention_wide", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=wide[0]["attention_wide"] + wide[1]["attention_wide"],
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
             launches=fused_launches["conv_gn"], max_abs_err=conv_err, ms=conv["ms"],
             plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
             library_ms=conv["library_ms"]),
    ]
    log("group_norm_swish times are per UNet forward (29 calls at batch 8), through a host loop "
        "of calls (device_ms: its device time alone, by CUDA-graph replay), and its launches are "
        "the unfused slice's plus one train step's; attention times are per call at "
        f"B={BATCH}, N={ATTN_N}, D={ATTN_D}, its launches the unfused slice's plus one train "
        "step's; attention_wide times are per call at the inner-32 cifar10 path's mid block "
        "(its launches, unfused and fused; by_shape: device times at other shapes, with SDPA's "
        "and the SIMT kernel's), attention_any_d (SIMT) times at the inner-8 path's (its "
        "launches), device_ms by CUDA-graph replay; conv_gn times are per fused UNet forward "
        "(31 calls at batch 8) and its launches are the fused slice's")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
