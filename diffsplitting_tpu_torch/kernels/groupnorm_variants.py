"""Time csrc/groupnorm_swish.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.groupnorm_variants [--baseline FILE ...]

At every (C, H, W) of one unfused UNet forward of
configs/splitting_hagen_indi_joint.json at batch 8 on 512² patches (29 calls;
seeded inputs, made as `chip_smoke.py` makes them), each variant is called
through the C entry point `gn_swish_f32`, held against the plain version, run
twice to check that two launches give the same bits, and timed in turns
(forward, then in reverse order) two ways: in a host loop of C calls, and by
CUDA-graph replay (device time alone). A variant is the shipped source with
text substitutions; `--baseline` (repeatable) adds any other source with the
same entry point. A baseline whose `gn_swish_f32` takes a `coef` scratch
pointer (a design with a third launch that folds the partials once a call)
is called with that signature on the shipped grid; any other baseline (the
first design, whose grid was at most 64 chunks of 32K elements) on its own
grid. Prints the card, each variant's registers, per-shape times, errors and
shares of the HBM rate, and each variant's time per forward (the sum over
shapes, times their calls). Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
import collections
import tempfile
from pathlib import Path

from .build import SIGNATURES
from .variants import build_all, card, device_ms, time_ms, variant_sources

SOURCE = "groupnorm_swish.cu"
CONFIG = "configs/splitting_hagen_indi_joint.json"
PATCH, BATCH = 512, 8
HBM_BYTES_PER_S = 3.35e12
# name -> (file, old, new) substitutions on the shipped source
VARIANTS = {
    "shipped": [],
    # eight 16-byte loads in flight a thread
    "unroll_8": [(SOURCE, "constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
}


def gn_shapes(net, x, t):
    """(C, H, W) -> count of GroupNorm+Swish calls in one forward of net."""
    from ..models.blocks import GroupNormSwish

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


def _first_design_chunking(hw: int, C: int):
    """Grid of the first design: at most 64 chunks of 32K elements."""
    chunks = max(1, min(64, hw * C // 32768))
    rows = -(-hw // chunks)
    return -(-hw // rows), rows


def caller(lib, grid: str, with_coef: bool, x, scale, bias, groups: int):
    """A function that runs `lib`'s gn_swish_f32 on x into y, the call's
    output, on the current stream, with its scratch allocated once. `grid`
    is "shipped" (ops/groupnorm.py's) or "first"."""
    import torch

    from ..ops import groupnorm

    B, H, W, C = x.shape
    hw = H * W
    if grid == "first":
        chunks, rows = _first_design_chunking(hw, C)
    else:
        chunks, rows = groupnorm._chunking(B, hw, C, groupnorm._sm_count(x.device.index))
    scratch = [torch.empty((B, chunks, 2, C), device=x.device)]  # partials
    if with_coef:
        scratch.append(torch.empty((B, 2, C), device=x.device))
    y = torch.empty_like(x)
    argv = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), *(t.data_ptr() for t in scratch),
            y.data_ptr(), B, hw, C, groups, chunks, rows, 1e-5]

    def run():
        err = lib.gn_swish_f32(*argv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    run.scratch = scratch  # the kernel writes it: keep it allocated while run lives
    return run, y


def main() -> None:
    import torch

    from ..config import dict_to_nonedict, load_json
    from ..ops import group_norm_swish_reference
    from ..serving import SplittingModel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another source with the same entry point (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_variants: CUDA is not available")
    print(card())
    sources = variant_sources(SOURCE, VARIANTS)
    grid = dict.fromkeys(sources, "shipped")
    for path in args.baseline:
        sources[path.stem] = {SOURCE: path.read_text()}
        grid[path.stem] = "shipped" if "void* coef" in sources[path.stem][SOURCE] else "first"
    with_coef = {name: "void* coef" in files[SOURCE] for name, files in sources.items()}

    dev = torch.device("cuda")
    opt = dict_to_nonedict(load_json(CONFIG))
    groups = int(opt["model"]["unet"]["norm_groups"])
    net = SplittingModel(opt, device=dev, seed=0).unets()[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        shapes = gn_shapes(net, torch.randn(BATCH, PATCH, PATCH, 1, device=dev, generator=gen),
                           torch.full((BATCH,), 0.5, device=dev))
    del net
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE, Path(work))
        for name, lib in libs.items():
            argtypes = list(SIGNATURES["gn_swish_f32"])
            if with_coef[name]:
                argtypes.insert(4, argtypes[3])  # the coef pointer after partials
            lib.gn_swish_f32.argtypes = argtypes
        total, total_dev = collections.Counter(), collections.Counter()
        worst = collections.Counter()
        g = torch.Generator(device=dev).manual_seed(1)
        order = list(libs)
        for (C, H, W), calls in sorted(shapes.items()):
            x = torch.randn(BATCH, H, W, C, device=dev, generator=g) * 2 + 0.5
            scale = torch.randn(C, device=dev, generator=g)
            bias = torch.randn(C, device=dev, generator=g)
            want = group_norm_swish_reference(x, scale, bias, groups)
            tol = 1e-4 * (1 + want.abs().max().item())
            bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
            line = []
            for name in order + order[::-1]:
                run, y = caller(libs[name], grid[name], with_coef[name], x, scale, bias, groups)
                run()
                first = y.clone()
                run()
                same = torch.equal(first, y)
                err = (y - want).abs().max().item()
                worst[name] = max(worst[name], err / tol)
                ms = time_ms(run, iters=20)
                dev_ms = device_ms(run, iters=20)
                total[name] += calls * ms / 2
                total_dev[name] += calls * dev_ms / 2
                line.append(f"{name} {ms:.4f} / {dev_ms:.4f} ({bound / dev_ms:.0%}, err {err:.2g}"
                            f"{'' if same else ', NOT bit-identical'})")
            print(f"B={BATCH} H={H} W={W} C={C} C/G={C // groups} calls={calls} bound "
                  f"{bound:.4f} ms: host loop / device ms (device share of HBM rate, max abs "
                  "err): " + ", ".join(line))
            del x, want, first, y
            torch.cuda.empty_cache()
        print(f"per unfused forward ({sum(shapes.values())} calls at batch {BATCH}), mean of the "
              "two turns, host loop / device: "
              + ", ".join(f"{n} {total[n]:.4f} / {total_dev[n]:.4f} ms (worst err/tol "
                          f"{worst[n]:.3g})" for n in order))


if __name__ == "__main__":
    main()
