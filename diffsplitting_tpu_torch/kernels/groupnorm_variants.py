"""Time csrc/groupnorm_swish.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.groupnorm_variants [--bf16 | --sr3]
        [--baseline FILE ...] [--json PATH]

Shapes, from `gn_shapes` of the config's UNet (built on the meta device, so
nothing is allocated for its weights): by default every GroupNorm+Swish call
of one unfused forward of configs/splitting_hagen_indi_joint.json at batch 8
on 512² patches (29 calls, f32); `--bf16` the 35 calls of
configs/sr_sr3_64_512.json at batch 1 (bf16); `--sr3` the 55 calls of
configs/sr_sr3_16_128.json at batch 1 (f32). Inputs are seeded.

Each variant is called through the C entry point with its scratch allocated
once, held against the plain version (f32: 1e-4·(1 + max|ref|); bf16: 2× the
plain bf16 version's error against f32 of the same inputs), run twice to
check that two launches give the same bits, and timed in turns (forward,
then in reverse order) by CUDA-graph replay (device time alone); the library
call `F.silu(F.group_norm)` in the same dtype is timed beside them. A
variant is the shipped source, or the shipped source with text
substitutions (`SOURCE_VARIANTS`), on the shipped plan or on another
(`PLAN_VARIANTS`: `ops.groupnorm.plan` with a route forced or with other
values of its tuning constants, `plan_with`); `--baseline` (repeatable)
adds a source of the earlier design, whose entry takes (partials, chunks,
rows a chunk), e.g. `git show e9ff4d5:diffsplitting_tpu_torch/csrc/groupnorm_swish.cu`,
called on that design's grid (`_one_wave_chunking`). Prints the card,
each variant's registers, per-shape device times, routes, errors and shares
of the bound, and each variant's time per forward (the sum over shapes,
times their calls, with the bound summed over the same shapes); `--json`
writes the same numbers. Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
from pathlib import Path

from .build import SIGNATURES, _I, _LL, _F, _P
from .variants import build_all, card, device_ms, variant_sources

SOURCE = "groupnorm_swish.cu"
HBM_BYTES_PER_S = 3.35e12
# --flag -> (config, batch, image size, conditioning, dtype name)
SETS = {
    "hagen": ("configs/splitting_hagen_indi_joint.json", 8, 512, "time", "float32"),
    "sr3": ("configs/sr_sr3_16_128.json", 1, 128, "noise_level", "float32"),
    "bf16": ("configs/sr_sr3_64_512.json", 1, 512, "noise_level", "bfloat16"),
}
# name -> (file, old, new) substitutions on the shipped source, run on the
# shipped plan
SOURCE_VARIANTS = {
    "shipped": [],
    # 16-byte loads in flight a thread on the stream route, in both dtypes
    # (shipped: 8 f32, 4 bf16)
    "unroll_4": [(SOURCE, "constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;",
                  "constexpr int kUnroll = 4;")],
    "unroll_8": [(SOURCE, "constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;",
                  "constexpr int kUnroll = 8;")],
}
# name -> (source variant, route forced or None, {ops.groupnorm tuning
# constant: value})
PLAN_VARIANTS = {
    # the route's threshold: every shape on one route (all_cluster only where
    # a slab fits a cluster)
    "all_stream": ("shipped", "stream", {}),
    "all_cluster": ("shipped", "cluster", {}),
    # the cluster's size
    "cluster_to_4": ("shipped", None, {"PLAN_CLUSTER": 4}),
    "cluster_to_16": ("shipped", None, {"PLAN_CLUSTER": 16}),
    # the widest slab, whether or not two blocks fit an SM
    "wide_tiles": ("shipped", None, {"_TWO_SLAB_BYTES": 1 << 30}),
    # blocks alone on their SMs stay on the cluster route whatever the row
    "cluster_alone": ("shipped", None, {"_STREAM_ROW_BYTES": 0}),
    # the stream route's statistics without clusters (every chunk a
    # partial), or with them wherever an element has 8 chunks or more
    "stream_unclustered": ("shipped", None, {"_FOLD_ALONE": 1 << 30}),
    "stream_clustered": ("shipped", None, {"_FOLD_ALONE": 0}),
}
# the entry point of the earlier design's source
_OLD_ARGTYPES = [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _LL, _F, _P]


def plan_with(constants: dict, B: int, hw: int, C: int, G: int, per_vector: int, sms: int,
              route=None):
    """`ops.groupnorm.plan` (uncached) with its tuning constants set to
    `constants` for the call."""
    from ..ops import groupnorm

    saved = {name: getattr(groupnorm, name) for name in constants}
    try:
        for name, value in constants.items():
            setattr(groupnorm, name, value)
        return groupnorm.plan.__wrapped__(B, hw, C, G, per_vector, sms, route=route)
    finally:
        for name, value in saved.items():
            setattr(groupnorm, name, value)


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


def set_shapes(name: str):
    """(groups, dtype name, batch, {(C, H, W): calls}) of one forward of a
    shape set's UNet, found on the meta device."""
    import torch

    from ..config import dict_to_nonedict, load_json
    from ..models.unet import UNet
    from ..serving import unet_kwargs

    config, batch, size, cond, dtype = SETS[name]
    opt = dict_to_nonedict(load_json(config))
    kw = dict(unet_kwargs(opt["model"], cond), dtype=None, remat=False)
    with torch.device("meta"), torch.no_grad():
        net = UNet(**kw).eval()
        shapes = gn_shapes(net, torch.empty(batch, size, size, kw["in_channel"]),
                           torch.empty(batch))
    return kw["norm_groups"], dtype, batch, dict(shapes)


def _one_wave_chunking(B: int, hw: int, C: int, sms: int, per_vector: int):
    """(chunks, rows a chunk) of the earlier design: one wave of 4
    256-thread blocks an SM, no chunk shorter than 4 steps of its block."""
    vectors = C // per_vector
    tpr = vectors if vectors <= 256 else vectors // 2
    rows_per_step = max(1, 256 // tpr) * 4
    chunks = max(1, min(sms * 4 // B, hw // rows_per_step))
    rows = -(-hw // chunks)
    return -(-hw // rows), rows


def caller(lib, entry: str, how, x, scale, bias, groups: int):
    """A function that runs `lib`'s entry on x into y, the call's output, on
    the current stream, its scratch allocated once. `how` is an
    ops.groupnorm.Plan, or None for a source of the earlier design on its
    own grid."""
    import torch

    from ..ops import groupnorm

    B, H, W, C = x.shape
    hw = H * W
    if how is None:
        per_vector = groupnorm._ENTRY[x.dtype][1]
        chunks, rows = _one_wave_chunking(B, hw, C, groupnorm._sm_count(x.device.index),
                                          per_vector)
        scratch = torch.empty((B, chunks, 2, C), device=x.device)
        grid = [chunks, rows]
    else:
        scratch = torch.empty(max(how.scratch, 1), device=x.device)
        grid = [how.slab, how.cluster, how.chunks, how.rows]
    y = torch.empty_like(x)
    argv = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), scratch.data_ptr(), y.data_ptr(), B,
            hw, C, groups, *grid, 1e-5]
    fn = getattr(lib, entry)

    def run():
        err = fn(*argv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    run.scratch = scratch  # the kernel writes it: keep it allocated while run lives
    return run, y


def main() -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import group_norm_swish_reference, groupnorm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--bf16", action="store_true", help="sr_sr3_64_512's 35 calls at B = 1")
    which.add_argument("--sr3", action="store_true", help="sr_sr3_16_128's 55 calls at B = 1")
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="a source of the earlier design (repeatable)")
    ap.add_argument("--json", type=Path, help="write the per-shape numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_variants: CUDA is not available")
    name = "bf16" if args.bf16 else "sr3" if args.sr3 else "hagen"
    groups, dtype_name, batch, shapes = set_shapes(name)
    dtype = getattr(torch, dtype_name)
    entry, per_vector = groupnorm._ENTRY[dtype]
    print(card())
    print(f"{SETS[name][0]} at batch {batch}, {dtype_name}: {sum(shapes.values())} calls, "
          f"{len(shapes)} shapes")

    sources = variant_sources(SOURCE, SOURCE_VARIANTS)
    for path in args.baseline:
        sources[path.stem] = {SOURCE: path.read_text()}
    dev = torch.device("cuda")
    sms = groupnorm._sm_count(dev.index)
    # variant -> (library, route, plan constants), or (library, None, None)
    # for a baseline on its own grid
    runs = {n: (n, None, {}) for n in SOURCE_VARIANTS}
    runs.update(PLAN_VARIANTS)
    runs.update({p.stem: (p.stem, None, None) for p in args.baseline})
    order = list(runs)

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE, Path(work))
        for lib_name, lib in libs.items():
            getattr(lib, entry).argtypes = (
                _OLD_ARGTYPES if lib_name in {p.stem for p in args.baseline}
                else SIGNATURES[entry])
        total = collections.Counter()
        bound_of = collections.Counter()  # the bound over the shapes a variant ran
        lib_total = bound_total = 0.0
        worst = collections.Counter()
        rows = []
        g = torch.Generator(device=dev).manual_seed(1)
        for (C, H, W), calls in sorted(shapes.items()):
            x = (torch.randn(batch, H, W, C, device=dev, generator=g) * 2 + 0.5).to(dtype)
            scale = torch.randn(C, device=dev, generator=g)
            bias = torch.randn(C, device=dev, generator=g)
            ref = group_norm_swish_reference(x.float(), scale, bias, groups)
            if dtype == torch.bfloat16:
                tol = 2 * (group_norm_swish_reference(x, scale, bias, groups).float()
                           - ref).abs().max().item()
            else:
                tol = 1e-4 * (1 + ref.abs().max().item())
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            x_nchw = x.permute(0, 3, 1, 2)
            sc, bi = scale.to(dtype), bias.to(dtype)
            lib_ms = device_ms(lambda: F.silu(F.group_norm(x_nchw, groups, sc, bi, 1e-5)), 10)
            row = dict(C=C, H=H, W=W, calls=calls, bound_ms=bound, library_ms=lib_ms, variants={})
            for v in order + order[::-1]:
                lib_name, route, constants = runs[v]
                try:
                    how = None if constants is None else plan_with(
                        constants, batch, H * W, C, groups, per_vector, sms, route=route)
                except ValueError:  # no slab of this shape fits a cluster
                    continue
                run, y = caller(libs[lib_name], entry, how, x, scale, bias, groups)
                run()
                first = y.clone()
                run()
                torch.cuda.synchronize()
                same = torch.equal(first, y)
                err = (y.float() - ref).abs().max().item()
                if not err <= tol or not same:
                    raise AssertionError(f"{v} at C={C} H={H} W={W}: err {err} (tol {tol}), "
                                         f"two launches equal {same}")
                worst[v] = max(worst[v], err / tol)
                ms = device_ms(run, 20)
                r = row["variants"].setdefault(v, dict(ms=0.0, route=how and how.route,
                                                       slab=how and how.slab,
                                                       cluster=how and how.cluster, err=err))
                r["ms"] += ms / 2
                total[v] += calls * ms / 2
                bound_of[v] += calls * bound / 2
            lib_total += calls * lib_ms
            bound_total += calls * bound
            rows.append(row)
            print(f"B={batch} H={H} W={W} C={C} C/G={C // groups} calls={calls} bound "
                  f"{bound:.4f} library {lib_ms:.4f} ms; device ms (route, share of bound, err): "
                  + ", ".join(f"{v} {r['ms']:.4f} ({r['route'] or 'own'}"
                              f"{'/S=%d/K=%d' % (r['slab'], r['cluster']) if r['slab'] else ''}, "
                              f"{bound / r['ms']:.0%}, {r['err']:.2g})"
                              for v, r in row["variants"].items()))
            del x, ref, first, y, x_nchw
            torch.cuda.empty_cache()
        print(f"per forward ({sum(shapes.values())} calls at batch {batch}), device ms, mean of "
              f"the two turns: bound {bound_total:.4f}, library {lib_total:.4f}, "
              + ", ".join(f"{v} {total[v]:.4f} ({bound_of[v] / total[v]:.1%} of the bound over "
                          f"its shapes; worst err/tol {worst[v]:.3g})" for v in order if v in total)
              + "; variants missing a shape are not summed over it")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(card=card(), set=name, batch=batch,
                                                 bound_ms=bound_total, library_ms=lib_total,
                                                 per_forward=dict(total),
                                                 bound_per_forward=dict(bound_of), shapes=rows),
                                            indent=1))


if __name__ == "__main__":
    main()
