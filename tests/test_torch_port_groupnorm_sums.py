"""How csrc/groupnorm_swish.cu sums x and x², emulated on the CPU.

Each route sums in an order fixed by its launch (`ops.groupnorm.plan`):

* cluster: each thread sums its rows of a block (every rpi-th row, rpi rows
  a step) in f32, x² by one FMA; the block adds its threads' sums step row
  by step row; the cluster adds its K blocks' sums in rank order;
* stream: each thread sums every rpi-th row of its chunk; the block adds its
  threads' sums; a cluster of Ks chunks adds its blocks' sums in rank order;
  every normalize block folds the clusters' partials with a fixed stride
  (max(1, threads / 2C) strides, each in order), then the strides;

and both fold a group's channels in order into its mean and variance
(E[x²] − E[x]², clamped at 0). At every GroupNorm+Swish shape of one
sr_sr3_64_512 forward (bf16 x at batch 1, 16 groups), on each route that
takes the shape, the emulated statistics, turned into the scale a_c and
shift b_c the kernel applies, are held against f64: the change they make
to any y, |x|·|Δa_c| + |Δb_c|, stays within a quarter of the f32 kernel's
tolerance, 1e-4·(1 + max|y|) (chip_smoke.py's; the bf16 tolerance, 2× the
plain bf16 version's error, is looser by orders of magnitude).
"""

import numpy as np
import pytest

from diffsplitting_tpu_torch.ops import groupnorm

H100_SMS = 132
GROUPS = 16
EPS = 1e-5
# (H, C) of sr_sr3_64_512's GroupNorm+Swish calls (batch 1, H = W)
SR512 = [(256, 64), (512, 64), (128, 128), (256, 128), (512, 128), (256, 192), (512, 192),
         (64, 256), (128, 256), (128, 384), (256, 384), (32, 512), (64, 512), (64, 768),
         (128, 768), (32, 1024), (32, 1536), (64, 1536), (32, 2048)]


def _bf16(a):
    """f32 values rounded to bf16 (nearest, ties to even), as f32."""
    u = a.view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)).view(np.float32)


def _thread_sums(xr, rpi):
    """xr (..., rows, C), rows a multiple of rpi: each thread's f32 sums of x
    and x² (one FMA) over its rows r0, r0 + rpi, ... in order, as
    (..., rpi, C) each."""
    steps = xr.shape[-2] // rpi
    xs = xr.reshape(*xr.shape[:-2], steps, rpi, xr.shape[-1])
    s = np.zeros(xs.shape[:-3] + xs.shape[-2:], np.float32)
    ss = np.zeros_like(s)
    for j in range(steps):
        v = xs[..., j, :, :]
        s = s + v
        ss = (ss.astype(np.float64) + v.astype(np.float64) ** 2).astype(np.float32)
    return s, ss


def _in_order(a, axis):
    """The f32 sum of a along axis, one term after the other."""
    a = np.moveaxis(a, axis, 0)
    out = np.zeros(a.shape[1:], np.float32)
    for term in a:
        out = out + term
    return out


def _rows(x, blocks, rows, rpi):
    """x (hw, C) as (blocks, rows padded to a multiple of rpi, C), zeros past
    hw (adding +0 leaves an f32 sum as it is)."""
    padded = -(-rows // rpi) * rpi
    out = np.zeros((blocks, padded, x.shape[1]), np.float32)
    for k in range(blocks):
        part = x[k * rows:(k + 1) * rows]
        out[k, :len(part)] = part
    return out


def cluster_sums(x, p, per_vector):
    """Per-channel (Σx, Σx²) of x (hw, C) as the cluster route adds them."""
    vs = p.slab // per_vector
    rpi = min(groupnorm._CLUSTER_THREADS // vs, groupnorm._PART_FLOATS // (2 * p.slab))
    s, ss = _thread_sums(_rows(x, p.cluster, p.rows, rpi), rpi)
    return (_in_order(_in_order(s, 1), 0), _in_order(_in_order(ss, 1), 0))


def stream_sums(x, p, per_vector):
    """Per-channel (Σx, Σx²) of x (hw, C) as the stream route adds them."""
    C = x.shape[1]
    tpr = groupnorm._threads_a_row(C, per_vector)
    rpi = max(1, groupnorm._THREADS // tpr)
    s, ss = _thread_sums(_rows(x, p.chunks, p.rows, rpi), rpi)
    red = np.concatenate([_in_order(s, 1), _in_order(ss, 1)], axis=1)  # (chunks, 2C)
    parts = _in_order(red.reshape(-1, p.cluster, 2 * C), 1)  # (clusters, 2C)
    strides = max(1, rpi * tpr // (2 * C))
    tot = _in_order(np.stack([_in_order(parts[k::strides], 0) for k in range(strides)]), 0)
    return tot[:C], tot[C:]


def coefficients(s, ss, hw, scale, bias, dtype):
    """(a_c, b_c) from per-channel sums, each group's channels in order, in
    `dtype` (np.float32 as the kernel, np.float64 as the reference)."""
    C = s.shape[0]
    cs = C // GROUPS
    f = dtype
    gs = _in_order(s.reshape(GROUPS, cs), 1) if f == np.float32 else s.reshape(GROUPS, cs).sum(1)
    gq = (_in_order(ss.reshape(GROUPS, cs), 1) if f == np.float32
          else ss.reshape(GROUPS, cs).sum(1))
    n = f(hw * cs)
    mean = (gs / n).astype(f)
    var = np.maximum((gq / n).astype(f) - mean * mean, 0).astype(f)
    a = ((1 / np.sqrt(var.astype(np.float64) + EPS)).astype(f).repeat(cs) * scale).astype(f)
    return a, (bias - mean.repeat(cs) * a).astype(f)


def _swish(v):
    return v / (1 + np.exp(-v))


@pytest.mark.parametrize("H,C", SR512)
def test_statistics_in_the_kernels_order_within_tolerance(H, C):
    hw, pv = H * H, 8
    rng = np.random.default_rng(H * 10000 + C)
    x = _bf16(rng.standard_normal((hw, C), dtype=np.float32) * 2 + 0.5)
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    s64 = np.zeros(C)
    ss64 = np.zeros(C)
    for i in range(0, hw, 1 << 16):
        blk = x[i:i + (1 << 16)].astype(np.float64)
        s64 += blk.sum(0)
        ss64 += (blk * blk).sum(0)
    a64, b64 = coefficients(s64, ss64, hw, scale.astype(np.float64),
                            bias.astype(np.float64), np.float64)
    x_abs = np.abs(x).max(0).astype(np.float64)
    # swish is monotonic past -1.28 and bounded by 0.28 below it: |y| peaks at
    # a channel's extreme x
    y_max = max(np.abs(_swish(a64 * x.max(0) + b64)).max(),
                np.abs(_swish(a64 * x.min(0) + b64)).max())
    tol = 1e-4 * (1 + y_max)
    routes = {"stream": groupnorm.plan(1, hw, C, GROUPS, pv, H100_SMS, route="stream")}
    best = groupnorm.plan(1, hw, C, GROUPS, pv, H100_SMS)
    if best.route == "cluster":
        routes["cluster"] = best
    for route, p in routes.items():
        s, ss = (cluster_sums if route == "cluster" else stream_sums)(x, p, pv)
        a, b = coefficients(s, ss, hw, scale, bias, np.float32)
        dy = (x_abs * np.abs(a - a64) + np.abs(b - b64)).max()
        print(f"H={H} C={C} {route} (S={p.slab} K={p.cluster} chunks={p.chunks} rows={p.rows}): "
              f"max Δy {dy:.3g}, {dy / tol:.3g} of the f32 tolerance")
        assert dy <= 0.25 * tol, (route, dy, tol)
