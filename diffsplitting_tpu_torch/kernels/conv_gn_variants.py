"""Time csrc/conv_gn.cu or csrc/conv_gn_bf16.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.conv_gn_variants [--bf16] [--baseline FILE]

At every site of one fused UNet forward of
configs/splitting_hagen_indi_joint.json at batch 8 on 512² patches (31 calls;
seeded random weights and inputs, made as `chip_smoke.py` makes them), each
variant is called through the C entry point `conv_gn_f32`, held against the
plain version, and timed in turns (forward, then in reverse order). A variant
is the shipped source (and csrc/tf32x3.cuh) with text substitutions;
`--baseline` adds any other source with the same entry point. A source whose
`conv_gn_f32` takes no split-weights scratch (the plain f32 FMA kernel the
tensor-core one replaced: 256 threads of 8 pixels × 8 channels) is called
with that signature and its own tile geometry. Prints the card, each
variant's registers and spills, per-site times and errors, and each
variant's time per forward (the sum over sites, times their calls).

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
import math
import tempfile
from pathlib import Path

from .build import SIGNATURES
from .variants import build_all, card, time_ms, variant_sources

SOURCE = "conv_gn.cu"
CONFIG = "configs/splitting_hagen_indi_joint.json"
PATCH, BATCH = 512, 8
# name -> (file, old, new) substitutions on the shipped sources
VARIANTS = {
    "shipped": [],
    # big * big only: plain TF32, to record the error the split removes
    "1xtf32": [("tf32x3.cuh", "    mma_tf32(d, a_small, b0_big, b1_big);\n"
                "    mma_tf32(d, a_big, b0_small, b1_small);\n", "")],
    # K steps accumulated in the tensor core's own accumulator (it rounds
    # toward zero) instead of summed from 0 and added to acc in f32
    "tc_accumulate": [(SOURCE, "float d[4] = {0.f, 0.f, 0.f, 0.f};", "float (&d)[4] = acc[i][j];"),
                      (SOURCE, "for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];", "")],
    # Cout 32 and 64 on 8 warps and 16 x 16 tiles (one block an SM by
    # registers), Cout 128 on 4 warps and 4 x 16 tiles, one tap a stage
    "other_warps": [(SOURCE, "launch<32, 4, 1, 8, 16, 3>", "launch<32, 8, 1, 16, 16, 3>"),
                    (SOURCE, "launch<64, 4, 1, 8, 16, 3>", "launch<64, 8, 1, 16, 16, 3>"),
                    (SOURCE, "launch<128, 8, 2, 8, 16, 3>", "launch<128, 4, 2, 4, 16, 1>")],
    # swish by expf and a true division
    "exact_swish": [(SOURCE, "return __fdividef(v, 1.0f + __expf(-v));",
                     "return v / (1.0f + expf(-v));")],
}
# variant -> {block channels: (tile rows, tile columns)} where it departs
# from ops/conv_gn.py `conv_gn_tiling`
TILES = {"other_warps": {32: (16, 16), 64: (16, 16), 128: (4, 16)}}

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


def caller(lib, split_scratch: bool, args, tiles_by_bn=None):
    """A function that runs `lib`'s conv_gn_f32 on args into y, the call's
    output, with its scratch allocated once; `tiles_by_bn` overrides the
    tile of some block widths."""
    import torch

    from ..ops.conv_gn import _block_channels, conv_gn_split_floats, conv_gn_tiling

    x, w, b, scale, shift, r, w_skip = args
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    Cres = r.shape[-1] if r is not None else 0
    tr, tw, tiles = (conv_gn_tiling if split_scratch else _fma_tiling)(H, W, Cout)
    if tiles_by_bn and _block_channels(Cout) in tiles_by_bn:
        tr, tw = tiles_by_bn[_block_channels(Cout)]
        tiles = -(-H // tr) * -(-W // tw)
    new = lambda *s: torch.empty(s, device=x.device)  # noqa: E731
    y, partials, stats = new(B, H, W, Cout), new(B, tiles, 2, Cout), new(2, B, Cout)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    scratch = [partials, stats]
    if split_scratch:
        scratch.append(new(conv_gn_split_floats(Cin, Cout, Cres if w_skip is not None else 0)))
    ks = w_skip.stride() if w_skip is not None else (0, 0)
    argv = [x.data_ptr(), w.data_ptr(), *w.stride(), b.data_ptr(), ptr(scale), ptr(shift), ptr(r),
            ptr(w_skip), *ks, y.data_ptr(), *(t.data_ptr() for t in scratch),
            B, H, W, Cin, Cout, Cres, int(scale is not None), int(r is not None),
            int(w_skip is not None), tr, tw, torch.cuda.current_stream().cuda_stream]

    def run():
        err = lib.conv_gn_f32(*argv)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    run.scratch = scratch  # the kernel writes it: keep it allocated while run lives
    return run, y


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


def _f64_stats(args):
    """Per-(b, channel) sums and sums of squares of y in f64 from the bf16
    operands as the kernel rounds them (the prologue by the plain version)."""
    import torch
    import torch.nn.functional as F

    x, w, b, scale, shift, r, w_skip = args
    xa = x.float()
    if scale is not None:
        xa = xa * scale[:, None, None, :] + shift[:, None, None, :]
        xa = (xa * torch.sigmoid(xa)).bfloat16().float()
    y = F.conv2d(xa.double().permute(0, 3, 1, 2),
                 w.bfloat16().double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    y = y + b.double()
    if r is not None:
        y = y + (r.double() @ w_skip.bfloat16().double() if w_skip is not None else r.double())
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
            s64, q64, abs64 = _f64_stats(args)
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


def main() -> None:
    import torch

    from ..config import dict_to_nonedict, load_json
    from ..ops import conv_gn_reference
    from ..serving import SplittingModel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="time csrc/conv_gn_bf16.cu at the sr_sr3_64_512 sites")
    ap.add_argument("--baseline", type=Path, help="another source with the same entry point")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_gn_variants: CUDA is not available")
    print(card())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bf16:
        main_bf16(args.baseline)
        return
    sources = variant_sources(SOURCE, VARIANTS)
    if args.baseline:
        sources["baseline"] = {SOURCE: args.baseline.read_text()}
    scratch = {name: "void* wsplit" in files[SOURCE] for name, files in sources.items()}

    dev = torch.device("cuda")
    net = SplittingModel(dict_to_nonedict(load_json(CONFIG)), device=dev, seed=0).unets()[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        sites = conv_gn_sites(net, torch.randn(BATCH, PATCH, PATCH, 1, device=dev, generator=gen),
                              torch.full((BATCH,), 0.5, device=dev))
    del net
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE, Path(work))
        for name, lib in libs.items():
            argtypes = list(SIGNATURES["conv_gn_f32"])
            if not scratch[name]:
                del argtypes[16]  # the split-weights pointer
            lib.conv_gn_f32.argtypes = argtypes
        total = collections.Counter()
        worst = collections.Counter()
        g = torch.Generator(device=dev).manual_seed(6)
        order = list(libs)
        for site, calls in sorted(sites.items(), key=str):
            site_in = site_args(site, BATCH, g)
            want = conv_gn_reference(*site_in)[0]
            tol = 1e-4 * (1 + want.abs().max().item())
            line = []
            for name in order + order[::-1]:
                run, y = caller(libs[name], scratch[name], site_in, TILES.get(name))
                run()
                err = (y - want).abs().max().item()
                worst[name] = max(worst[name], err / tol)
                ms = time_ms(run, iters=10)
                total[name] += calls * ms / 2
                line.append(f"{name} {ms:.4f} ({err:.2g})")
            print(f"site H={site[0]} Cin={site[2]} Cout={site[3]} prologue={site[4]} "
                  f"residual={site[5]} Cres={site[6]} calls={calls}: ms (max abs err): "
                  + ", ".join(line))
            del site_in, want
            torch.cuda.empty_cache()
        print(f"per fused forward ({sum(sites.values())} calls at batch {BATCH}), mean of the two "
              "turns: " + ", ".join(f"{n} {total[n]:.4f} ms (worst err/tol {worst[n]:.3g})"
                                    for n in order))


if __name__ == "__main__":
    main()
