#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffsplitting_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each kernel against its plain
PyTorch version at the shapes the serving path gives it, then serves joint-InDI
tiled splitting at full width (configs/splitting_hagen_indi_joint.json: patch
512, batch 8, 3 steps, seeded random weights) on two synthetic 1024² frames
and checks that every kernel of the path was launched, that the output is
finite and of the right shape, and that it agrees with the same path run
through the plain versions and, on a small input, with the port on the CPU.

Every phase raises on failure, so the script exits non-zero with no result
line. It prints the card's name and power limit, per-kernel times beside
their bounds, the slice's tiles/s and peak memory, a device-time breakdown of
one slice run (torch.profiler), one JSON line of kernels and, last, the
device line.
TF32 is off throughout, so the convolutions, matmuls and kernels all compute
in float32.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

CONFIG = "configs/splitting_hagen_indi_joint.json"
PATCH, BATCH = 512, 8
FRAMES = (2, 1024, 1024)
ATTN_N, ATTN_D = 4096, 128


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
    """Route the UNet blocks through the kernels' plain versions."""
    from diffsplitting_tpu_torch.models import blocks
    from diffsplitting_tpu_torch.ops import attention_reference, group_norm_swish_reference

    saved = blocks.fused_group_norm_swish, blocks.fused_attention
    blocks.fused_group_norm_swish = group_norm_swish_reference
    blocks.fused_attention = attention_reference
    try:
        yield
    finally:
        blocks.fused_group_norm_swish, blocks.fused_attention = saved


def gn_shapes(net, x, t):
    """(C, H, W) -> count of GroupNorm+Swish calls in one forward of net."""
    from diffsplitting_tpu_torch.models.blocks import GroupNormSwish

    counts = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda _m, args: counts.update([tuple(args[0].shape[1:])]))
        for m in net.modules() if isinstance(m, GroupNormSwish)]
    try:
        net(x, t)
    finally:
        for h in hooks:
            h.remove()
    return counts


def phase_group_norm(dev, shapes, groups):
    """Kernel vs plain version at every (C, H, W) of one forward, batch 8."""
    import torch
    import torch.nn.functional as F
    from diffsplitting_tpu_torch.ops import fused_group_norm_swish, group_norm_swish_reference

    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst = 0.0
    for (C, H, W), calls in sorted(shapes.items()):
        x = torch.randn(BATCH, H, W, C, device=dev, generator=g) * 2 + 0.5
        scale = torch.randn(C, device=dev, generator=g)
        bias = torch.randn(C, device=dev, generator=g)
        got = fused_group_norm_swish(x, scale, bias, groups)
        want = group_norm_swish_reference(x, scale, bias, groups)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # f32 on both sides; the group sums run over up to H*W*C/G = 786K
        # values in another order
        tol = 1e-4 * (1 + want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f"GN+Swish C={C} H={H}: max abs err {err} > {tol}")
        worst = max(worst, err)
        del got, want
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the same bytes
        ms = time_ms(lambda: fused_group_norm_swish(x, scale, bias, groups), 20)
        plain = time_ms(lambda: group_norm_swish_reference(x, scale, bias, groups), 5)
        lib = time_ms(lambda: F.silu(F.group_norm(x_nchw, groups, scale, bias, 1e-5)), 5)
        bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3  # read x, write y
        log(f"gn_swish B={BATCH} H={H} W={W} C={C} C/G={C // groups} calls/forward={calls}: "
            f"err {err:.3g} kernel {ms:.4f} ms plain {plain:.4f} ms library {lib:.4f} ms "
            f"bound {bound:.4f} ms ({bound / ms:.1%} of HBM rate)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound)):
            tot[key] += calls * val
        del x, x_nchw
        torch.cuda.empty_cache()
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
        bound = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / F32_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"attention B={B} N={ATTN_N} D={ATTN_D} heads=1: err {err:.3g} kernel {ms:.4f} ms "
            f"plain {plain:.4f} ms library {lib:.4f} ms bound {bound:.4f} ms ({bound_by}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of f32 peak)")
        res = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=bound_by)
        del qkv, q, k, v, got, want
        torch.cuda.empty_cache()
    return res, worst


def phase_small_reference(opt):
    """The port on the card (kernels) against the port on the CPU (plain
    versions, the path the CPU tests hold against JAX) on a small noise-free
    input: 1×128×128 frame, 64² patches (mid block at 8×8, N=64)."""
    import copy

    import torch
    from diffsplitting_tpu_torch.predict import predict_frames
    from diffsplitting_tpu_torch.serving import SplittingModel

    small = copy.deepcopy(opt)
    small["model"]["indi"]["noise_mode"] = "none"
    cpu = SplittingModel(small, device="cpu", seed=3)
    gpu = SplittingModel(small, device="cuda", seed=3)
    gpu.nets.load_state_dict(cpu.nets.state_dict())
    frames = torch.randn(1, 128, 128, 1, generator=torch.Generator().manual_seed(4))
    want = predict_frames(cpu, frames, 64, BATCH)
    got = predict_frames(gpu, frames, 64, BATCH).cpu()
    err = max_err(got, want)
    tol = 2e-4 * max(1.0, want.abs().max().item())  # f32; cuDNN and CPU sum orders
    if not (got.shape == want.shape == (1, 128, 128, 2) and err <= tol):
        raise AssertionError(f"card vs CPU on a small input: shape {tuple(got.shape)}, "
                             f"max abs err {err} > {tol}")
    log(f"small input (1x128x128, patch 64): card vs CPU max abs err {err:.3g} (tol {tol:.3g})")


def kernel_family(name: str) -> str:
    if "gn_stats_kernel" in name or "gn_normalize_kernel" in name:
        return "group_norm_swish kernel"
    if "attention_d128_kernel" in name:
        return "attention kernel"
    # cuDNN's f32 convolutions include FFT passes and NHWC<->NCHW transposes
    if any(s in name.lower() for s in ("conv", "xmma", "cudnn", "gemm", "fft", "cutlass",
                                       "pointwise_mult_and_sum_complex", "nhwctonchw",
                                       "nchwtonhwc")):
        return "convolutions and linears (cuDNN, cuBLAS)"
    return "other (elementwise adds, concat, upsample, the attention block's group_norm)"


def phase_profile(model, frames) -> None:
    """Device time of one slice run by kernel family (torch.profiler), and
    the device's idle share of the run's wall time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from diffsplitting_tpu_torch.predict import predict_frames

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_frames(model, frames, PATCH, BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    log(f"profile (one slice run, profiler on): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.1%}")
    for fam, ms in fams.most_common():
        log(f"profile:   {fam}: {ms:.1f} ms ({ms / busy:.1%} of device time)")
    for name, ms in names.most_common(12):
        log(f"profile:     {ms:8.1f} ms  {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
    from diffsplitting_tpu_torch.kernels import build
    from diffsplitting_tpu_torch.ops import FusedAttention, FusedGroupNormSwish
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
        if "Used" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    opt = dict_to_nonedict(load_json(CONFIG))
    if int(opt["datasets"]["patch_size"]) != PATCH:
        raise AssertionError(f"{CONFIG} no longer serves {PATCH}² patches")
    groups = int(opt["model"]["unet"]["norm_groups"])
    model = SplittingModel(opt, device=dev, seed=0)
    net = model.denoise_fns()[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    tile_batch = torch.randn(BATCH, PATCH, PATCH, 1, device=dev, generator=gen)
    t_vec = torch.full((BATCH,), 0.5, device=dev)

    # GN+Swish at the slice's shapes
    with torch.inference_mode():
        shapes = gn_shapes(net, tile_batch, t_vec)
    if sum(shapes.values()) != 29:
        raise AssertionError(f"expected 29 GN+Swish calls per forward, saw {dict(shapes)}")
    gn, gn_err = phase_group_norm(dev, shapes, groups)

    # attention at the mid block's shape, at B=2 and at the serving batch
    attn, attn_err = phase_attention(dev, (2, BATCH))

    # one UNet forward on a tile batch: kernels vs plain versions
    with torch.inference_mode():
        got = net(tile_batch, t_vec)
        with plain_versions():
            want = net(tile_batch, t_vec)
    err = max_err(got, want)
    tol = 1e-3 * want.abs().max().item() + 1e-4
    if not err <= tol:
        raise AssertionError(f"UNet forward, kernels vs plain: max abs err {err} > {tol}")
    log(f"UNet forward B={BATCH} {PATCH}²: kernels vs plain max abs err {err:.3g} (tol {tol:.3g})")
    del got, want

    phase_small_reference(opt)

    # the slice: joint-InDI tiled prediction at full width
    frames = torch.randn(*FRAMES, 1, device=dev, generator=gen)
    steps = model.process.num_timesteps
    n_tiles = 18  # 3×3 tiles per 1024² frame: 512² patches on a 256² grid
    forwards = 2 * steps * math.ceil(n_tiles / BATCH)
    model.generator.manual_seed(0)
    predict_frames(model, frames, PATCH, BATCH)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    model.generator.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    FusedGroupNormSwish.launches = 0
    FusedAttention.launches = 0
    t0 = time.perf_counter()
    out = predict_frames(model, frames, PATCH, BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"group_norm_swish": FusedGroupNormSwish.launches,
                "attention": FusedAttention.launches}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"group_norm_swish": 29 * forwards, "attention": forwards}:
        raise AssertionError(f"launches {launches}, expected 29*{forwards} and {forwards}")
    if tuple(out.shape) != FRAMES + (2,) or not torch.isfinite(out).all():
        raise AssertionError(f"slice output: shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    walls = [wall]
    for _ in range(2):  # the spread of the host-clock time
        t0 = time.perf_counter()
        predict_frames(model, frames, PATCH, BATCH)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    log(f"slice: {FRAMES[0]} frames {FRAMES[1]}x{FRAMES[2]}, {n_tiles} tiles of {PATCH}², "
        f"batch {BATCH}, {steps} steps, {forwards} UNet forwards: runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median {n_tiles / wall:.2f} tiles/s, "
        f"peak memory {peak / 2**30:.2f} GiB ({peak} bytes), launches {launches}")

    model.generator.manual_seed(0)
    with plain_versions():
        ref = predict_frames(model, frames, PATCH, BATCH)
    err = max_err(out, ref)
    tol = 1e-3 * ref.abs().max().item() + 1e-4
    if not err <= tol:
        raise AssertionError(f"slice, kernels vs plain versions: max abs err {err} > {tol}")
    log(f"slice: kernels vs plain versions max abs err {err:.3g} (tol {tol:.3g})")
    phase_profile(model, frames)

    kernels = [
        dict(name="group_norm_swish", route="cuda",
             source="diffsplitting_tpu_torch/csrc/groupnorm_swish.cu",
             replaces="diffsplitting_tpu/experimental/groupnorm_pallas.py:21,58",
             launches=launches["group_norm_swish"], max_abs_err=gn_err, ms=gn["ms"],
             plain_ms=gn["plain_ms"], bound_ms=gn["bound_ms"], bound_by="bytes",
             library_ms=gn["library_ms"]),
        dict(name="attention", route="cuda",
             source="diffsplitting_tpu_torch/csrc/attention.cu",
             replaces="diffsplitting_tpu/ops/attention.py:33",
             launches=launches["attention"], max_abs_err=attn_err, ms=attn["ms"],
             plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"], bound_by=attn["bound_by"],
             library_ms=attn["library_ms"]),
    ]
    log("group_norm_swish times are per UNet forward (29 calls at batch 8); "
        f"attention times are per call at B={BATCH}, N={ATTN_N}, D={ATTN_D}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
