"""Time csrc/conv_gn.cu or csrc/conv_gn_bf16.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.conv_gn_variants [--sr3] [--baseline FILE]
        [--json FILE]
    python -m diffsplitting_tpu_torch.kernels.conv_gn_variants --bf16 [--baseline FILE]

By default at every site of one fused UNet forward of
configs/splitting_hagen_indi_joint.json at batch 8 on 512² patches (31 calls;
seeded random weights and inputs, made as `chip_smoke.py` makes them); with
`--sr3` at the 19 sites of configs/sr_sr3_16_128.json's fused forward at
batch 1 (its 128² and 64² ResnetBlock and upsample convs of 64 and 128
channels; the sites found on the meta device). Each variant is called through
the C entry point `conv_gn_f32`, its y held against the plain version and its
statistics against f64 sums of the same inputs (as a share of chip_smoke.py's
tolerance: 1e-5·Σ|y| + 1e-3 for the sums, 1e-5·Σy² + 1e-3 for the sums of
squares), and timed in turns (forward, then in reverse order) by CUDA-graph
device time, beside each site's bound (the larger of 3 × 2·B·H·W·(9·Cin +
Cres)·Cout TF32 operations at 495 TFLOP/s and (Cin + Cout + Cres) f32 bytes a
pixel at 3.35 TB/s) and cuDNN's device time for the same y (`library_call`:
F.conv2d on the activated input, + the residual or its 1x1 conv; used
nowhere in the port). A variant is the shipped source (and csrc/*.cuh) with
text substitutions (VARIANTS: the tap-group depth, the taps a weight stage
and the ring's depth, the register buffers of A, the warpgroups taking
turns to issue, two warpgroups or one m64 tile a warpgroup at the narrow
widths, the registers of the consumers, when an identity residual is loaded,
the swish by expf and a true division, 1xTF32);
`--baseline` adds another source with the same entry point, called with its
own tile geometry: one without wgmma, as the mma.sync kernel this design
replaced (`git show 1ab4dcc:diffsplitting_tpu_torch/csrc/conv_gn.cu`), with
that kernel's tiling; one whose `conv_gn_f32` takes no split-weights scratch
(the plain f32 FMA kernel before it: 256 threads of 8 pixels × 8 channels)
with that signature and geometry. Prints the card, each variant's registers
and spills, per-site times, errors and shares of the bound, and each
variant's time per forward (the sum over sites, times their calls); `--json`
writes them.

`--bf16` times csrc/conv_gn_bf16.cu instead, at the 11 sites of one fused
forward of configs/sr_sr3_64_512.json at batch 1 (bf16 x and residual, f32
weights, as the walk passes them), through `conv_gn_bf16`, by CUDA-graph
device time in turns. Its variants are the tap-group depth (K steps summed
from 0 in the tensor core: 9, 3, 1, or all of K in the accumulator), the
prologue's reciprocal through the division's per-element branch, the
weight ring's depth, the activation overlapped with the
warpgroup's own wgmma, the warpgroups issuing without taking turns, y stored from registers, and 8×16 tiles (one m64
tile a warpgroup) at Cout ≤ 64; `--baseline` adds an older source with the
same entry point (one without wgmma, as the first `mma.sync` kernel, is
called with the f32 kernel's tiling and unpadded scratch). Each variant's y
is held against the plain version and its statistics against f64 sums of
the same bf16 operands, as a share of chip_smoke.py's tolerance (1e-5·Σ|y|
+ 1e-4 for the sums, 1e-5·Σy² + 1e-4 for the sums of squares). Nothing here
is used by the port.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import tempfile
from pathlib import Path

from .build import SIGNATURES
from .variants import build_all, card, variant_sources

SOURCE = "conv_gn.cu"
CONFIG = "configs/splitting_hagen_indi_joint.json"
PATCH, BATCH = 512, 8
SR3_CONFIG, SR3_SIZE = "configs/sr_sr3_16_128.json", 128
HBM_BYTES_PER_S, TF32_FLOPS_PER_S = 3.35e12, 495e12
_LAUNCHES = ("launch<16, 2, 3, 9, 3, 3, 1>", "launch<32, 2, 3, 3, 4, 2, 3>",
             "launch<64, 2, 2, 3, 3, 2, 3>", "launch<128, 1, 2, 3, 2, 3, 3>")


def _group(depth: int) -> list:
    """Substitutions giving every block width groups of `depth` taps."""
    return [(SOURCE, old, old[:-2] + f"{depth}>") for old in _LAUNCHES
            if not old.endswith(f"{depth}>")]


# name -> (file, old, new) substitutions on the shipped sources
VARIANTS = {
    "shipped": [],
    # one tap a from-zero group (a chain of 6 wgmma an m64 tile), or three
    "group1": _group(1),
    "group3": _group(3),
    # the other count of register buffers of A at 64 and 128 channels
    "abufs": [(SOURCE, _LAUNCHES[2], "launch<64, 2, 2, 3, 3, 3, 3>"),
              (SOURCE, _LAUNCHES[3], "launch<128, 1, 2, 3, 2, 2, 3>")],
    # the warpgroups take turns to issue their groups' wgmma
    "turns": [(SOURCE, "kTurns = 0;", "kTurns = 1;")],
    # two consumer warpgroups on 16 x 16 tiles at 16 and 32 channels
    "two_wg": [(SOURCE, _LAUNCHES[0], "launch<16, 2, 2, 9, 3, 3, 1>"),
               (SOURCE, _LAUNCHES[1], "launch<32, 2, 2, 3, 4, 3, 3>")],
    # one-tap stages at 64 (9 in the ring) and 128 (6)
    "stages": [(SOURCE, _LAUNCHES[2], "launch<64, 2, 2, 1, 9, 2, 3>"),
               (SOURCE, _LAUNCHES[3], "launch<128, 1, 2, 1, 6, 3, 3>")],
    # the consumers of two warpgroups at 232 registers, the producer at 40
    "regs232": [(SOURCE, 'asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");',
                 'if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: '
                 '"memory");\n        else asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" '
                 '::: "memory");'),
                (SOURCE, "kRegs = NWG == 2 ? 240", "kRegs = NWG == 2 ? 232")],
    # 32 channels on 12 x 16 tiles: three warpgroups of one m64 tile, three
    # register buffers of A; or one-tap groups
    "bn32_mt1": [(SOURCE, _LAUNCHES[1], "launch<32, 1, 3, 3, 4, 3, 3>")],
    "bn32_group1": [(SOURCE, _LAUNCHES[1], "launch<32, 2, 3, 3, 4, 2, 1>")],
    # an identity residual loaded where it is added (after stores of y) at
    # every width, or before them at every width
    "residual_late": [(SOURCE, "constexpr bool kEarlyRes = BN == 16 || BN == 128;",
                       "constexpr bool kEarlyRes = false;")],
    "residual_early": [(SOURCE, "constexpr bool kEarlyRes = BN == 16 || BN == 128;",
                        "constexpr bool kEarlyRes = true;")],
    # swish by expf and a true division
    "exact_swish": [(SOURCE, "return __fdividef(v, 1.0f + __expf(-v));",
                     "return v / (1.0f + expf(-v));")],
    # big * big only: plain TF32, to record the error the split removes
    "1xtf32": [(SOURCE, "wgmma_tf32(tmp[i], as[u % NB][h], weight_desc(big), tp > gs || h > 0);\n"
                "                    wgmma_tf32(tmp[i], ab[u % NB][h], weight_desc(small), 1);\n"
                "                    wgmma_tf32(tmp[i], ab[u % NB][h], weight_desc(big), 1);",
                "wgmma_tf32(tmp[i], ab[u % NB][h], weight_desc(big), tp > gs || h > 0);")],
}
# variant -> {block channels: (tile rows, tile columns)} where it departs
# from ops/conv_gn.py `conv_gn_tiling`
TILES = {"two_wg": {16: (16, 16), 32: (16, 16)}, "bn32_mt1": {32: (12, 16)}}
# block channels -> (tile rows, tile columns) of the mma.sync kernel
MMA_SYNC_TILES = {16: (16, 16), 32: (8, 16), 64: (8, 16), 128: (8, 16)}

SOURCE_BF16 = "conv_gn_bf16.cu"
CONFIG_BF16 = "configs/sr_sr3_64_512.json"
_ACC_IN_TC = "Wgmma<BN>::mma(tmp[i], a[k][i], weight_desc(wsm + k * S::STEP), k > k0);"
VARIANTS_BF16 = {
    "shipped": [],
    "group3": [(SOURCE_BF16, "kTapGroup = 9;", "kTapGroup = 3;")],
    "group1": [(SOURCE_BF16, "kTapGroup = 9;", "kTapGroup = 1;")],
    # every K step added in the tensor core's accumulator (rounds toward zero)
    "tc_accumulate": [(SOURCE_BF16, _ACC_IN_TC, _ACC_IN_TC.replace("tmp[i]", "acc[i]")
                       .replace("k > k0", "1")),
                      (SOURCE_BF16, "fence_regs(tmp[i]);", "fence_regs(acc[i]);"),
                      (SOURCE_BF16, "for (int e = 0; e < NA; ++e) acc[i][e] += tmp[i][e];", "")],
    # the prologue's reciprocal through the IEEE division's branch each
    "div_branch": [(SOURCE_BF16, "if (fast) {", "if (false && fast) {")],
    "ring2": [(SOURCE_BF16, "kRing = 3;", "kRing = 2;")],
    "ring4": [(SOURCE_BF16, "kRing = 3;", "kRing = 4;")],
    # the next window activated while the warpgroup's own wgmma run
    "overlap": [(SOURCE_BF16, "            wgmma_wait<0>();\n",
                 "            if (k0 == 0) between();\n            wgmma_wait<0>();\n"),
                (SOURCE_BF16, "            if (k0 == 0) between();\n        }", "        }")],
    # the warpgroups issue their wgmma without taking turns
    "no_turns": [(SOURCE_BF16, "            if (k0 == 0) turn_wait(wg);\n", ""),
                 (SOURCE_BF16, "            if (k0 == 0 && !(wg == 1 && last)) turn_give(1 - wg);\n",
                  ""),
                 (SOURCE_BF16, "    if (wg == 1) turn_give(0);\n", "")],
    "direct_y": [(SOURCE_BF16, "kStageY = 1;", "kStageY = 0;")],
    "mt1": [(SOURCE_BF16, f"launch<{bn}, 2>", f"launch<{bn}, 1>") for bn in (8, 16, 32, 64)],
}
TILES_BF16 = {"mt1": {bn: (8, 16) for bn in (8, 16, 32, 64)}}


def conv_gn_sites(net, x, t):
    """(H, W, Cin, Cout, prologue, residual, Cres) -> count of conv_gn calls in
    one fused forward of net; residual is None, "identity" or "projected"."""
    from ..models import fused_forward

    counts = collections.Counter()
    kernel = fused_forward.conv_gn_fused

    def record(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
        mode = None if residual is None else "identity" if w_skip is None else "projected"
        counts.update([(x.shape[1], x.shape[2], x.shape[3], w.shape[3], scale is not None,
                        mode, 0 if residual is None else residual.shape[3])])
        return kernel(x, w, b, scale, shift, residual, w_skip)

    fused_forward.conv_gn_fused = record
    try:
        fused_forward.fused_unet_forward(net, x, t)
    finally:
        fused_forward.conv_gn_fused = kernel
    return counts


def site_args(site, batch: int, g):
    """Seeded inputs of a site, the weights as the walk passes them (views of
    OIHW parameters): (x, w, b, scale, shift, residual, w_skip)."""
    import torch

    H, W, Cin, Cout, act, res, Cres = site
    rand = lambda *shape: torch.randn(*shape, device=g.device, generator=g)  # noqa: E731
    x = rand(batch, H, W, Cin)
    w = (rand(Cout, Cin, 3, 3) / math.sqrt(9 * Cin)).permute(2, 3, 1, 0)
    b = rand(Cout) * 0.1
    scale = rand(batch, Cin) * 0.2 + 1 if act else None
    shift = rand(batch, Cin) * 0.5 if act else None
    r = rand(batch, H, W, Cres) if res else None
    w_skip = (rand(Cout, Cres) / math.sqrt(Cres)).t() if res == "projected" else None
    return x, w, b, scale, shift, r, w_skip


def _fma_tiling(H: int, W: int, Cout: int):
    """Tile geometry of the plain f32 FMA kernel (no split-weights scratch)."""
    across = next(t for t in (2, 4, 8, 16) if 8 * t >= Cout)
    pixels = 256 // across * 8
    tw = 1 << (min(W, pixels).bit_length() - 1)
    return pixels // tw, tw, -(-H // (pixels // tw)) * -(-W // tw)


def caller(lib, kind: str, args, tiles_by_bn=None):
    """A function that runs `lib`'s conv_gn_f32 on args on the stream current
    at the call (a graph's capture stream), and its outputs (y, sums,
    sumsqs); scratch allocated once. `kind`: "wgmma" (the shipped design's
    tiling), "mma_sync" (that kernel's tiling, the same scratch) or "fma" (no
    split-weights scratch, its own tiling); `tiles_by_bn` overrides the tile
    of some block widths."""
    import torch

    from ..ops.conv_gn import _block_channels, conv_gn_split_floats, conv_gn_tiling

    x, w, b, scale, shift, r, w_skip = args
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    Cres = r.shape[-1] if r is not None else 0
    tr, tw, tiles = (_fma_tiling if kind == "fma" else conv_gn_tiling)(H, W, Cout)
    per_tile = 3 if kind == "wgmma" else 1  # partials a tile: up to a warpgroup's each
    tiles_by_bn = MMA_SYNC_TILES if kind == "mma_sync" else tiles_by_bn
    if tiles_by_bn and _block_channels(Cout) in tiles_by_bn:
        tr, tw = tiles_by_bn[_block_channels(Cout)]
        tiles = -(-H // tr) * -(-W // tw)
    new = lambda *s: torch.empty(s, device=x.device)  # noqa: E731
    y, partials, stats = new(B, H, W, Cout), new(B, per_tile * tiles, 2, Cout), new(2, B, Cout)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    scratch = [partials, stats]
    if kind != "fma":
        scratch.append(new(conv_gn_split_floats(Cin, Cout, Cres if w_skip is not None else 0)))
    ks = w_skip.stride() if w_skip is not None else (0, 0)
    argv = [x.data_ptr(), w.data_ptr(), *w.stride(), b.data_ptr(), ptr(scale), ptr(shift), ptr(r),
            ptr(w_skip), *ks, y.data_ptr(), *(t.data_ptr() for t in scratch),
            B, H, W, Cin, Cout, Cres, int(scale is not None), int(r is not None),
            int(w_skip is not None), tr, tw]

    def run():
        err = lib.conv_gn_f32(*argv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    run.scratch = scratch  # the kernel writes it: keep it allocated while run lives
    return run, (y, stats[0], stats[1])


def caller_bf16(lib, wgmma: bool, args, tiles_by_bn=None):
    """A function that runs `lib`'s conv_gn_bf16 on args (bf16 x and
    residual) into y, the call's output, and (sums, sumsqs); scratch
    allocated once. `wgmma`: the Hopper kernel's tiling and padded scratch,
    else the first kernel's (the f32 kernel's tiling)."""
    import torch

    from ..ops.conv_gn import _block_channels, conv_gn_tiling, conv_gn_weight_elems

    x, w, b, scale, shift, r, w_skip = args
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    Cres = r.shape[-1] if r is not None else 0
    tr, tw, tiles = conv_gn_tiling(H, W, Cout, wgmma)
    if tiles_by_bn and _block_channels(Cout, True) in tiles_by_bn:
        tr, tw = tiles_by_bn[_block_channels(Cout, True)]
        tiles = -(-H // tr) * -(-W // tw)
    y = torch.empty(B, H, W, Cout, device=x.device, dtype=torch.bfloat16)
    partials = torch.empty(B, tiles, 2, Cout, device=x.device)
    stats = torch.empty(2, B, Cout, device=x.device)
    wpack = torch.empty(conv_gn_weight_elems(Cin, Cout, Cres if w_skip is not None else 0, wgmma),
                        device=x.device, dtype=torch.bfloat16)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    ks = w_skip.stride() if w_skip is not None else (0, 0)
    argv = [x.data_ptr(), w.data_ptr(), 0, *w.stride(), b.data_ptr(), ptr(scale), ptr(shift),
            ptr(r), ptr(w_skip), 0, *ks, y.data_ptr(), partials.data_ptr(), stats.data_ptr(),
            wpack.data_ptr(), B, H, W, Cin, Cout, Cres, int(scale is not None),
            int(r is not None), int(w_skip is not None), tr, tw]

    def run():  # on the stream current at the call (a graph's capture stream)
        err = lib.conv_gn_bf16(*argv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    run.scratch = (partials, wpack)
    return run, (y, stats[0], stats[1])


def f64_stats(args):
    """Per-(b, channel) sums, sums of squares and sums of |y| of y in f64:
    at bf16 x from the bf16 operands as the kernel rounds them (the prologue
    by the plain version), at f32 x from the f32 inputs (the prologue in
    f64)."""
    import torch
    import torch.nn.functional as F

    x, w, b, scale, shift, r, w_skip = args
    low = x.dtype == torch.bfloat16
    cast = (lambda t: t.bfloat16().double()) if low else (lambda t: t.double())  # noqa: E731
    xa = x.float() if low else x.double()
    if scale is not None:
        xa = xa * scale[:, None, None, :].to(xa.dtype) + shift[:, None, None, :].to(xa.dtype)
        xa = xa * torch.sigmoid(xa)
        xa = xa.bfloat16().float() if low else xa
    y = F.conv2d(xa.double().permute(0, 3, 1, 2), cast(w).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y = y + b.double()
    if r is not None:
        y = y + (r.double() @ cast(w_skip) if w_skip is not None else r.double())
    return y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2)), y.abs().sum(dim=(1, 2))


def main_bf16(baseline) -> None:
    """The --bf16 mode: csrc/conv_gn_bf16.cu's variants at the 11 sites of an
    sr_sr3_64_512 fused forward at batch 1."""
    import torch

    from ..config import dict_to_nonedict, load_json
    from ..models import UNet
    from ..ops import conv_gn_reference
    from ..serving import unet_kwargs
    from .variants import device_ms

    dev = torch.device("cuda")
    opt = dict_to_nonedict(load_json(CONFIG_BF16))
    size = int(opt["model"]["diffusion"]["image_size"])
    torch.manual_seed(0)
    net = UNet(**unet_kwargs(opt["model"], "noise_level")).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        sites = conv_gn_sites(net, torch.randn(1, size, size, net.in_channel, device=dev,
                                               generator=gen), torch.rand(1, device=dev))
    del net
    torch.cuda.empty_cache()
    sources = variant_sources(SOURCE_BF16, VARIANTS_BF16)
    if baseline:
        sources["baseline"] = {SOURCE_BF16: baseline.read_text()}
    hopper = {name: "wgmma.mma_async" in files[SOURCE_BF16] for name, files in sources.items()}

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE_BF16, Path(work))
        for lib in libs.values():
            lib.conv_gn_bf16.argtypes = SIGNATURES["conv_gn_bf16"]
        order = list(libs)
        total = collections.Counter()
        worst = {n: collections.Counter() for n in order}
        g = torch.Generator(device=dev).manual_seed(6)
        for site, calls in sorted(sites.items(), key=str):
            args = list(site_args(site, 1, g))
            args[0] = args[0].bfloat16()
            if args[5] is not None:
                args[5] = args[5].bfloat16()
            want = conv_gn_reference(*args)[0].float()
            s64, q64, abs64 = f64_stats(args)
            tol_s, tol_q = 1e-5 * abs64 + 1e-4, 1e-5 * q64 + 1e-4
            line = []
            for name in order + order[::-1]:
                run, (y, s, q) = caller_bf16(libs[name], hopper[name], args,
                                             TILES_BF16.get(name))
                run()
                torch.cuda.synchronize()
                y_err = (y.float() - want).abs().max().item()
                e_s = ((s.double() - s64).abs() / tol_s).max().item()
                e_q = ((q.double() - q64).abs() / tol_q).max().item()
                for k, v in (("y", y_err), ("sums", e_s), ("sumsqs", e_q)):
                    worst[name][k] = max(worst[name][k], v)
                ms = device_ms(run, 10)
                total[name] += calls * ms / 2
                line.append(f"{name} {ms:.4f} (y {y_err:.3g}, stats/tol {e_s:.3g} {e_q:.3g})")
            H, W, Cin, Cout, act, res, Cres = site
            print(f"site H={H} Cin={Cin} Cout={Cout} prologue={act} residual={res} Cres={Cres} "
                  f"calls={calls}: device ms (max abs err of y against the plain version; "
                  "statistics' err against f64 over tolerance, sums sumsqs): " + ", ".join(line))
            del args, want
            torch.cuda.empty_cache()
        print(f"per sr_sr3_64_512 fused forward ({sum(sites.values())} calls at batch 1), device "
              "ms, mean of the two turns: "
              + ", ".join(f"{n} {total[n]:.4f} (worst y err {worst[n]['y']:.3g}, statistics/tol "
                          f"{worst[n]['sums']:.3g} {worst[n]['sumsqs']:.3g})" for n in order))


def meta_sites(config: str, batch: int, size: int, cond: str, **unet) -> dict:
    """conv_gn_sites of one fused forward of a config's UNet at `batch` and
    `size`², found on the meta device (no weights, no card); `unet` overrides
    entries of the config's model.unet (e.g. inner_channel)."""
    import torch

    from ..config import dict_to_nonedict, load_json
    from ..models.unet import UNet
    from ..serving import unet_kwargs

    opt = dict_to_nonedict(load_json(config))
    opt["model"]["unet"].update(unet)
    kw = dict(unet_kwargs(opt["model"], cond), dtype=None, remat=False)
    with torch.device("meta"), torch.no_grad():
        net = UNet(**kw).eval()
        return dict(conv_gn_sites(net, torch.empty(batch, size, size, kw["in_channel"]),
                                  torch.empty(batch)))


def site_bound(site, batch: int) -> tuple:
    """(bound ms, "operations" or "bytes") of one f32 conv_gn call: 3xTF32
    operations at 495 TFLOP/s against x, the residual and y once through
    HBM."""
    H, W, Cin, Cout, act, res, Cres = site
    flops = 2 * batch * H * W * (9 * Cin + (Cres if res == "projected" else 0)) * Cout
    ops_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    bytes_ms = 4 * batch * H * W * (Cin + Cout + Cres) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def library_call(args):
    """cuDNN's F.conv2d on the activated input (channels_last, as the
    unfused walk feeds it) + the 1x1 conv of a projected residual, or the
    identity residual: the one PyTorch call sequence that computes the
    kernel's y, without its statistics."""
    import torch.nn.functional as F

    x, w, b, scale, shift, r, w_skip = args
    xa = F.silu(x * scale[:, None, None, :] + shift[:, None, None, :]) if scale is not None else x
    xa, w_oihw = xa.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    r_nchw = r.permute(0, 3, 1, 2) if r is not None else None
    ws_oihw = w_skip.t()[:, :, None, None] if w_skip is not None else None

    def run():
        out = F.conv2d(xa, w_oihw, b, padding=1)
        if ws_oihw is not None:
            return out + F.conv2d(r_nchw, ws_oihw)
        return out + r_nchw if r_nchw is not None else out

    return run


def main_f32(baseline, sr3: bool, out_json) -> None:
    """The f32 kernel's variants at the 31 Hagen sites at batch 8, or (`sr3`)
    sr_sr3_16_128's 19 sites at batch 1; cuDNN's time beside them."""
    import torch

    from ..ops import conv_gn_reference
    from .variants import device_ms

    sites = (meta_sites(SR3_CONFIG, 1, SR3_SIZE, "noise_level") if sr3
             else meta_sites(CONFIG, BATCH, PATCH, "time"))
    batch = 1 if sr3 else BATCH
    sources = variant_sources(SOURCE, VARIANTS)
    if baseline:
        sources["baseline"] = {SOURCE: baseline.read_text()}
    kind = {name: "wgmma" if "wgmma.mma_async" in files[SOURCE] else
            "mma_sync" if "void* wsplit" in files[SOURCE] else "fma"
            for name, files in sources.items()}
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE, Path(work))
        for name, lib in libs.items():
            argtypes = list(SIGNATURES["conv_gn_f32"])
            if kind[name] == "fma":
                del argtypes[16]  # the split-weights pointer
            lib.conv_gn_f32.argtypes = argtypes
        order = list(libs)
        total = collections.Counter()
        worst = {n: collections.Counter() for n in order}
        rows = []
        bound_total = 0.0
        g = torch.Generator(device=dev).manual_seed(6)
        for site, calls in sorted(sites.items(), key=str):
            args = site_args(site, batch, g)
            want = conv_gn_reference(*args)[0]
            s64, q64, abs64 = f64_stats(args)
            tol = 1e-4 * (1 + want.abs().max().item())
            tol_s, tol_q = 1e-5 * abs64 + 1e-3, 1e-5 * q64 + 1e-3
            bound, by = site_bound(site, batch)
            bound_total += calls * bound
            lib = device_ms(library_call(args), 10)
            total["library (cuDNN)"] += calls * lib
            row = dict(site=list(site), calls=calls, bound_ms=bound, bound_by=by, library_ms=lib,
                       variants={})
            line = []
            for name in order + order[::-1]:
                run, (y, s, q) = caller(libs[name], kind[name], args, TILES.get(name))
                run()
                torch.cuda.synchronize()
                err = (y - want).abs().max().item()
                e_s = ((s.double() - s64).abs() / tol_s).max().item()
                e_q = ((q.double() - q64).abs() / tol_q).max().item()
                for k, v in (("y/tol", err / tol), ("sums", e_s), ("sumsqs", e_q)):
                    worst[name][k] = max(worst[name][k], v)
                ms = device_ms(run, 10)
                total[name] += calls * ms / 2
                row["variants"].setdefault(name, dict(ms=[], y_err=err, sums_tol=e_s,
                                                      sumsqs_tol=e_q))["ms"].append(ms)
                line.append(f"{name} {ms:.4f} ({bound / ms:.1%}; y {err:.2g}, stats/tol "
                            f"{e_s:.2g} {e_q:.2g})")
                del run, y, s, q
            rows.append(row)
            H, W, Cin, Cout, act, res, Cres = site
            print(f"site B={batch} H={H} Cin={Cin} Cout={Cout} prologue={act} residual={res} "
                  f"Cres={Cres} calls={calls}, bound {bound:.4f} ms ({by}), cuDNN {lib:.4f} ms: "
                  "device ms (share of "
                  "the bound; max abs err of y against the plain version; statistics' err "
                  "against f64 over tolerance, sums sumsqs): " + ", ".join(line), flush=True)
            del args, want
            torch.cuda.empty_cache()
        what = "sr_sr3_16_128" if sr3 else "Hagen"
        print(f"per {what} fused forward ({sum(sites.values())} calls at batch {batch}, bound "
              f"{bound_total:.4f} ms, cuDNN {total['library (cuDNN)']:.4f} ms), device ms, mean "
              "of the two turns: "
              + ", ".join(f"{n} {total[n]:.4f} ({bound_total / total[n]:.1%} of the bound; "
                          f"worst y err/tol {worst[n]['y/tol']:.3g}, statistics/tol "
                          f"{worst[n]['sums']:.3g} {worst[n]['sumsqs']:.3g})" for n in order))
        if out_json:
            Path(out_json).write_text(json.dumps(dict(
                card=card(), batch=batch, config=SR3_CONFIG if sr3 else CONFIG,
                bound_ms=bound_total, library_ms=total["library (cuDNN)"],
                per_forward={n: total[n] for n in order},
                worst={n: dict(worst[n]) for n in order}, sites=rows), indent=1))


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="time csrc/conv_gn_bf16.cu at the sr_sr3_64_512 sites")
    ap.add_argument("--sr3", action="store_true",
                    help="the f32 kernel at sr_sr3_16_128's sites at batch 1")
    ap.add_argument("--baseline", type=Path, help="another source with the same entry point")
    ap.add_argument("--json", type=Path, help="write the f32 modes' results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_gn_variants: CUDA is not available")
    print(card())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bf16:
        main_bf16(args.baseline)
    else:
        main_f32(args.baseline, args.sr3, args.json)


if __name__ == "__main__":
    main()
