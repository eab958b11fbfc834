"""Time the attention kernels beside variants of themselves on one card.

    python -m diffsplitting_tpu_torch.kernels.attention_variants [--baseline FILE] [--json FILE]
    python -m diffsplitting_tpu_torch.kernels.attention_variants --wide \
        [--baseline FILE [--host]] [--json FILE]
    python -m diffsplitting_tpu_torch.kernels.attention_variants --narrow \
        [--baseline FILE [--baseline FILE]] [--json FILE]
    python -m diffsplitting_tpu_torch.kernels.attention_variants --bf16 [--baseline FILE] [--json FILE]

Each variant is the shipped source (and csrc/*.cuh) with text substitutions,
built by its own `nvcc` into its own library (all started together); a
baseline is an earlier source built with the headers beside it (unpack its
commit's whole csrc/: `git archive <commit> diffsplitting_tpu_torch/csrc`).
By default the variants are of csrc/attention.cu's D = 128 instance
(D128_VARIANTS: 32-key tiles; and csrc/attention_wide.cu's wide kernel at D
= 128, its range widened in that variant only), called through
`attention_f32_d128` at the Hagen mid block's shape (N = 4096, D = 128, one
head; q, k, v views of one qkv tensor) at B = 1, 2, 4 and 8, each at the
plan's key-split count and at 1 and twice it (the plan's count of the
32-key variant's tiles); `--baseline` adds an earlier source's
`attention_f32_d128` called with its own signature (no scratch, no plan for
commit 1e56b1a's mma.sync kernel in attention.cu; commit 2357aaa's
attention_wide.cu has today's). With `--wide` they are of
csrc/attention_wide.cu's wide kernel (WIDE_VARIANTS: ring depth, 1xTF32),
each at the plan's key-split count and at 1 and twice it (the shipped
source also at the other key tile), at WIDE_SHAPES (every wide-routed shape
of chip_smoke.py); the baseline is an earlier source's `attention_f32_wide`,
called with its own signature (before the key splits, e.g. commit 816dfe4's
attention.cu: no scratch, no plan), and each entry reports its device time
and its host-loop time; `--host` times only the two wrappers' host loops at
sr_sr3_16_128's serving shapes, in alternating pairs. With `--narrow` they
are of csrc/attention.cu below D = 128 (NARROW_VARIANTS: more key-tile and
warpgroup pairs, rings of one tile, two blocks an SM) at NARROW_SHAPES, the
shipped source at each of its pairs; `--baseline`, given once or twice,
adds commit 2357aaa's mma.sync kernel (attention.cu, called with its own
signature) and its D = 128 kernel (attention_wide.cu), which runs beside the
shipped D = 128 instance at B = 1, 2, 4 and 8 with its bits required equal
(and D128_DIGESTS printed). With `--bf16` they are of csrc/attention_bf16.cu
(BF16_VARIANTS: the ring depth of either of its kernels), each also at other
key-split counts than the plan's, at BF16_SHAPES (chip_smoke.py's
SR512_ATTN_SHAPES); the baseline is an earlier attention_bf16.cu, called
with its own signature (before the key splits: no scratch arguments), e.g.
commit 0104a7a's. The variants are timed in turns (forward, then in reverse
order, SDPA among them) by CUDA-graph device time, and each is held against
the plain version. Prints the card, each variant's registers and spills, its
time and its max abs error, and SDPA's time. Nothing here is used by the
port.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import tempfile
from pathlib import Path

from .build import SIGNATURES
from .variants import (baseline_sources, build_all, card, device_ms, exp2_ms, sm_clock_hz,
                       time_ms, variant_sources)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCE = "attention.cu"
# the last (key tile, warpgroups) pair attention.cu's launch_tiling builds
_TILING_LAST = ("    if (key_tile == 64 && groups == 2) return launch_dp<64, 2>"
                "(dp, q, k, v, p, B, sb, sn, sh, st);\n")
_RING = "    static constexpr int RING = KRING + 4 * TILE + 8 * 9 + 1024 <= kSmemLimit ? 2 : 1;"


def _tilings(*pairs) -> tuple:
    """A substitution adding (key tile, warpgroups[, padded head dim]) pairs
    to launch_tiling: at every DP, or at the one given."""
    lines = ""
    for tk, ng, *dp in pairs:
        call = (f"launch_tile<{dp[0]}, {tk}, {ng}>(q, k, v, p, B, sb, sn, sh, st)" if dp else
                f"launch_dp<{tk}, {ng}>(dp, q, k, v, p, B, sb, sn, sh, st)")
        cond = f"key_tile == {tk} && groups == {ng}" + (f" && dp == {dp[0]}" if dp else "")
        lines += f"    if ({cond}) return {call};\n"
    return (SOURCE, _TILING_LAST, _TILING_LAST + lines)


# (key tile, warpgroups) pairs of the "tilings" variant: 32-key tiles with
# two consumer warpgroups and 16 with two at every DP; three warpgroups at
# DP = 64, the producer's registers going to them by setmaxnreg (24 / 160)
NARROW_EXTRA_TILINGS = ((32, 2), (16, 2), (64, 3, 64), (32, 3, 64))
_REGS2 = "struct RegSplit<2> {  // 168 a thread at launch"
_REGS3 = ("struct RegSplit<3> {  // 128 a thread at launch\n"
          "    static constexpr bool on = true;\n"
          "    static constexpr int producer = 24, consumer = 160;\n"
          "};\n"
          "template <>\n")
# name -> (file, old, new) substitutions on csrc/attention.cu for the kernel
# below D = 128
NARROW_VARIANTS = {
    "shipped": [],
    "tilings": [_tilings(*NARROW_EXTRA_TILINGS), (SOURCE, _REGS2, _REGS3 + _REGS2)],
    # one K and one V tile in flight at every DP (two where they fit, shipped)
    "ring1": [(SOURCE, _RING, "    static constexpr int RING = 1;")],
    # two blocks an SM at one consumer warpgroup (128 registers a thread),
    # its rings of one tile
    "two_blocks": [(SOURCE, "__launch_bounds__((NG + 1) * kConsumers, 1)",
                    "__launch_bounds__((NG + 1) * kConsumers, NG == 1 ? 2 : 1)"),
                   (SOURCE, _RING, "    static constexpr int RING = NG == 1 ? 1 : " +
                    _RING.split("= ", 1)[1])],
}
# (B, N, D): the narrow shapes of chip_smoke.py's ANY_D_SHAPES (D = 16 and 64
# at N = 16, 100 and 1024; the Hagen mid block at inner 8, N = 4096)
NARROW_SHAPES = [(8, n, d) for d in (16, 64) for n in (16, 100, 1024)] + [(8, 4096, 64)]
# the entry of the mma.sync kernel that attention.cu held at commit 2357aaa:
# no scratch, no plan
NARROW_UNSPLIT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _P]


WIDE_SOURCE = "attention_wide.cu"
_S_CHAIN = ("                wgmma_tf32(acc, qs[P][kk], desc_kmajor(kr + 32 * kk), kk > 0);\n"
            "                wgmma_tf32(acc, qb[P][kk], desc_kmajor(ks + 32 * kk), 1);\n"
            "                wgmma_tf32(acc, qb[P][kk], desc_kmajor(kr + 32 * kk), 1);\n")
_PV_CHAIN = ("                wgmma_tf32(pv, ps[kk], desc_kmajor(vr), kk > 0);\n"
             "                wgmma_tf32(pv, pb[kk], desc_kmajor(vr + L::VT_PLANE), 1);\n"
             "                wgmma_tf32(pv, pb[kk], desc_kmajor(vr), 1);\n")
# name -> (file, old, new) substitutions on csrc/attention_wide.cu
WIDE_VARIANTS = {
    "shipped": [],
    # a ring of at most 3 stages (up to 6 shipped, where they fit)
    "ring3": [(WIDE_SOURCE, "constexpr int kMaxRing = 6;", "constexpr int kMaxRing = 3;")],
    # big * big only: plain TF32, to record what the two small products cost
    "1xtf32": [(WIDE_SOURCE, _S_CHAIN, "                wgmma_tf32(acc, qb[P][kk], "
                "desc_kmajor(kr + 32 * kk), kk > 0);\n"),
               (WIDE_SOURCE, _PV_CHAIN, "                wgmma_tf32(pv, pb[kk], desc_kmajor(vr), "
                "kk > 0);\n")],
}
# name -> (file, old, new) substitutions on csrc/attention.cu for its D =
# 128 instance (the wide kernel at D = 128 is a variant of
# csrc/attention_wide.cu, its range widened there only)
D128_VARIANTS = {
    "shipped": [],
    # 32-key tiles (64 shipped); two K and two V tiles in flight fit at 32
    "tk32": [_tilings((32, 2, 128)),
             (SOURCE, " " * 27 + "64, 2, splits,", " " * 27 + "32, 2, splits,")],
}
D128_WIDE_VARIANT = [(WIDE_SOURCE, "if (d <= 128 ||", "if (d < 128 ||")]
D128_BATCHES = (1, 2, 4, 8)  # the Hagen mid block: N = 4096, D = 128, one head
# the entry of the mma.sync kernel that attention.cu held at commit 1e56b1a:
# no scratch, no plan
D128_UNSPLIT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _F, _P]


# (B, N, D): every wide-routed shape of chip_smoke.py: its ANY_D_SHAPES above
# D = 128 (D = 256 at N = 16, 100 and 1024, D = 512 at N = 256, the mid block
# of sr_sr3_64_512 in f32 at batch 2, the Hagen mid block at inner 24, D =
# 192, at N = 1024 and 4096) and its SR3_SHAPES (sr_sr3_16_128's 16² sites
# and 8² mid block at D = 512, at its serving batch 1 and train batch 4;
# sample_ddpm_128's mid block)
WIDE_SHAPES = [(1, 256, 512), (1, 64, 512), (4, 256, 512), (4, 64, 512), (12, 16, 256),
               (8, 16, 256), (8, 100, 256), (8, 1024, 256), (8, 256, 512), (2, 1024, 1024),
               (8, 1024, 192), (8, 4096, 192)]
# the wide entry before the key splits (attention.cu's, before the kernel
# moved to attention_wide.cu): no scratch, no plan
WIDE_UNSPLIT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _P]
HOST_LOOPS, HOST_ITERS = 5, 40  # host-loop timing: the least of 5 loops of 40 calls (the
# host's time swings from call to call: the least is the wrapper's own cost)
# --host: sr_sr3_16_128's two serving shapes, 20 pairs of loops
HOST_SHAPES = [(1, 256, 512), (1, 64, 512)]
HOST_PAIRS = 20


BF16_SOURCE = "attention_bf16.cu"
# name -> (file, old, new) substitutions on csrc/attention_bf16.cu
BF16_VARIANTS = {
    "shipped": [],
    # up to D = 256: a ring of 3 slots (4 shipped)
    "ring3": [(BF16_SOURCE, "constexpr int kRing = 4;", "constexpr int kRing = 3;")],
    # the wide kernel: a ring of 4 or 3 slots (6 shipped)
    "wide_ring4": [(BF16_SOURCE, "constexpr int kWideRing = 6;", "constexpr int kWideRing = 4;")],
    "wide_ring3": [(BF16_SOURCE, "constexpr int kWideRing = 6;", "constexpr int kWideRing = 3;")],
}
# (B, N, D): chip_smoke.py's SR512_ATTN_SHAPES, sr_sr3_64_512's mid block at
# batch 1 and 2, and other head dims at N = 1024
BF16_SHAPES = [(1, 1024, 1024), (2, 1024, 1024), (1, 1024, 512), (1, 1024, 128), (1, 1024, 64)]
# the entry point before the key splits (PR 14's kernel): no scratch arguments
BF16_UNSPLIT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _P]


def run_bf16(baseline: Path = None, json_path: Path = None) -> None:
    """The bf16 kernels' variants (each at the plan's split count and at 1
    and twice the plan's), the baseline, SDPA in bf16 and the plain version,
    in turns at BF16_SHAPES by CUDA-graph device time; each held against an
    f32 reference from the same inputs (at most 2x the plain bf16 version's
    error) and run twice for the bits."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    sources = variant_sources(BF16_SOURCE, BF16_VARIANTS)
    mains = {name: BF16_SOURCE for name in sources}
    if baseline:
        sources["baseline"] = baseline_sources(baseline)
        mains["baseline"] = baseline.name
    results = []
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, mains, Path(work))
        base = libs.pop("baseline", None)
        for lib in libs.values():
            lib.attention_bf16.argtypes = SIGNATURES["attention_bf16"]
        if base is not None:
            unsplit = "opart" not in baseline.read_text()
            base.attention_bf16.argtypes = (BF16_UNSPLIT_SIGNATURE if unsplit
                                            else SIGNATURES["attention_bf16"])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for B, N, D in BF16_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(42)
            qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g).bfloat16()
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(D)
            ref = A.attention_reference(q.float(), k.float(), v.float(), scale)
            plain_err = (A.attention_reference(q, k, v, scale).float() - ref).abs().max().item()
            out = torch.empty_like(q)
            st = q.stride()
            planned = A.plan(B, N, D, sms).splits
            runs = {}
            for name, lib in libs.items():
                for sp in sorted({planned, 1, min(2 * planned, -(-N // A.BF16_TILE_KEYS))}):
                    tag = name if sp == planned else f"{name}/splits{sp}"
                    runs[tag] = functools.partial(A._launch_bf16, q, k, v, out, scale, sp,
                                                  lib.attention_bf16)
            if base is not None and unsplit:
                runs["baseline"] = lambda: base.attention_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 1, D, *st[:3],
                    scale, torch.cuda.current_stream().cuda_stream)
            elif base is not None:
                runs["baseline"] = functools.partial(A._launch_bf16, q, k, v, out, scale, None,
                                                     base.attention_bf16)
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            runs["plain"] = lambda: A.attention_reference(q, k, v, scale)
            bound = 4 * B * N * N * D / 989e12 * 1e3
            order = list(runs)
            for turn, name in enumerate(order + order[::-1]):
                runs[name]()
                torch.cuda.synchronize()
                row = dict(B=B, N=N, D=D, name=name, turn=turn, device_ms=device_ms(runs[name]),
                           bound_ms=bound, plain_max_abs_err=plain_err)
                line = f"B={B} N={N} D={D} {name}: {row['device_ms']:.4f} ms device time"
                if name not in ("sdpa", "plain"):
                    first = out.clone()
                    runs[name]()
                    err = (first.float() - ref).abs().max().item()
                    row.update(max_abs_err=err, bit_identical=torch.equal(first, out))
                    line += (f", max abs err {err:.3g} (plain bf16 {plain_err:.3g}), "
                             f"twice bit-identical {row['bit_identical']}")
                    if not (err <= 2 * plain_err and row["bit_identical"]):
                        raise AssertionError(line)
                print(line + f"; bound {bound:.4f} ms", flush=True)
                results.append(row)
            del qkv, q, k, v, ref, out, qh, kh, vh
            torch.cuda.empty_cache()
    if json_path:
        json_path.write_text(json.dumps(dict(card=card(), rows=results), indent=1))


def run_wide(baseline: Path = None, json_path: Path = None, host: bool = False) -> None:
    """The wide kernel's variants (each at the plan's split count and at 1
    and twice the plan's, the shipped source also at the other key tile),
    the baseline (an earlier source's `attention_f32_wide`, called with its
    own signature), SDPA and the plain version, in turns at WIDE_SHAPES: each
    entry's device time by CUDA-graph replay and its host-loop time (the
    least of HOST_LOOPS loops of HOST_ITERS calls; the shipped source
    through `fused_attention`, the baseline through `fused_attention` with
    its own wrapper, the `_launch` of the sources before the key splits,
    where it is unsplit; the others
    through `_launch_wide`); each kernel held against the plain version and
    f64, and run twice for the bits. With `host`, only the host-loop times
    of the shipped wrapper and the baseline's at HOST_SHAPES: HOST_PAIRS
    pairs of loops of HOST_ITERS calls in alternating order, with their
    medians and quartiles."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    sources = variant_sources(WIDE_SOURCE, {"shipped": []} if host else WIDE_VARIANTS)
    mains = {name: WIDE_SOURCE for name in sources}
    if baseline:
        sources["baseline"] = baseline_sources(baseline)
        mains["baseline"] = baseline.name
    elif host:
        raise SystemExit("attention_variants --wide --host needs --baseline")
    results = []
    launch_wide = A._launch_wide
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, mains, Path(work))
        base = libs.pop("baseline", None)
        for lib in libs.values():
            lib.attention_f32_wide.argtypes = SIGNATURES["attention_f32_wide"]
        unsplit = base is not None and "opart" not in baseline.read_text()
        if base is not None:
            base.attention_f32_wide.argtypes = (WIDE_UNSPLIT_SIGNATURE if unsplit
                                                else SIGNATURES["attention_f32_wide"])

        def base_launch(q, k, v, out, scale, splits=None):
            if not unsplit:
                return launch_wide(q, k, v, out, scale, splits, entry=base.attention_f32_wide)
            B, N, H, D = q.shape
            A.check(base.attention_f32_wide(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
                *q.stride()[:3], float(scale), torch.cuda.current_stream(q.device).cuda_stream),
                "attention_f32_wide")
            return out

        def unsplit_launch(q, k, v, scale, splits=None):
            """`ops.attention._launch` on the wide route as it was before the
            key splits, with the unsplit baseline's entry: the baseline's
            host path."""
            B, N, H, D = q.shape
            if k.shape != q.shape or v.shape != q.shape:
                raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
            if k.dtype != q.dtype or v.dtype != q.dtype:
                raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
            A.head_dim_route(D, q.dtype)
            strides = q.stride()
            if k.stride() != strides or v.stride() != strides or strides[3] != 1:
                raise ValueError("attention kernel takes q, k, v with one set of strides "
                                 "and a unit stride on the head dim")
            per_16_bytes = 16 // q.element_size()
            if (any(s % per_16_bytes for s in strides[:3])
                    or any(t.data_ptr() % 16 for t in (q, k, v))):
                raise ValueError("attention kernel needs 16-byte aligned rows")
            out = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype)
            stream = torch.cuda.current_stream(q.device).cuda_stream
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            A.check(base.attention_f32_wide(*ptrs, B, N, H, D, *strides[:3], float(scale),
                                            stream), "attention_f32_wide")
            A.FusedAttention.launches_wide += 1
            return out

        def public(name, launch):
            """fused_attention's host loop with `launch` as its `_launch_wide`,
            or, for an unsplit baseline, `unsplit_launch` (the earlier
            `_launch`) as its `_launch`."""
            attr, fn = (("_launch", unsplit_launch) if name == "baseline" and unsplit
                        else ("_launch_wide", launch))
            old = getattr(A, attr)

            def run():
                setattr(A, attr, fn)
                try:
                    return A.fused_attention(q, k, v, scale)
                finally:
                    setattr(A, attr, old)
            return run

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for B, N, D in HOST_SHAPES if host else []:
            g = torch.Generator(device="cuda").manual_seed(2)
            qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(D)
            hosts = {"shipped": public("shipped", functools.partial(
                launch_wide, entry=libs["shipped"].attention_f32_wide)),
                "baseline": public("baseline", base_launch)}
            times = {name: [] for name in hosts}
            for pair in range(HOST_PAIRS):
                for name in (("shipped", "baseline") if pair % 2 == 0
                             else ("baseline", "shipped")):
                    times[name].append(time_ms(hosts[name], HOST_ITERS))
            med = {}
            for name, t in times.items():
                t = sorted(t)
                med[name] = t[len(t) // 2]
                print(f"B={B} N={N} D={D} {name}: host loop a call, median {med[name]:.4f} ms "
                      f"(quartiles {t[len(t) // 4]:.4f}, {t[3 * len(t) // 4]:.4f}) over "
                      f"{len(t)} loops of {HOST_ITERS} calls", flush=True)
                results.append(dict(B=B, N=N, D=D, name=name, host_ms=times[name]))
            wins = sum(a < b for a, b in zip(times["shipped"], times["baseline"]))
            print(f"B={B} N={N} D={D}: shipped / baseline medians "
                  f"{med['shipped'] / med['baseline']:.3f}; the shipped loop faster in {wins} of "
                  f"{HOST_PAIRS} pairs", flush=True)
            del qkv, q, k, v
        for B, N, D in [] if host else WIDE_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(2)
            qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(D)
            want = A.attention_reference(q, k, v, scale)
            exact = A.attention_reference(q.double(), k.double(), v.double(), scale).float()
            tol = 1e-4 * (1 + want.abs().max().item())
            out = torch.empty_like(want)
            how = A.wide_plan(B, N, D, sms)
            runs, hosts, plans = {}, {}, {}
            for name, lib in libs.items():
                tiles = -(-N // how.key_tile)
                for sp in sorted({how.splits, 1, min(2 * how.splits, tiles)}):
                    tag = name if sp == how.splits else f"{name}/splits{sp}"
                    runs[tag] = functools.partial(launch_wide, q, k, v, out, scale, sp,
                                                  entry=lib.attention_f32_wide)
                    plans[tag] = A.wide_plan(B, N, D, sms, sp)
            other = 64 if how.key_tile == 32 else 32  # the next key tile to the plan's
            runs[f"shipped/key_tile{other}"] = functools.partial(
                launch_wide, q, k, v, out, scale, key_tile=other,
                entry=libs["shipped"].attention_f32_wide)
            plans[f"shipped/key_tile{other}"] = A.wide_plan(B, N, D, sms, key_tile=other)
            hosts["shipped"] = public("shipped", functools.partial(
                launch_wide, entry=libs["shipped"].attention_f32_wide))
            if base is not None:
                runs["baseline"] = functools.partial(base_launch, q, k, v, out, scale)
                hosts["baseline"] = public("baseline", base_launch)
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            runs["plain"] = lambda: A.attention_reference(q, k, v, scale)
            bound = max(3 * 4 * B * N * N * D / 495e12, 16 * B * N * D / 3.35e12) * 1e3
            order = list(runs)
            for turn, name in enumerate(order + order[::-1]):
                runs[name]()
                torch.cuda.synchronize()
                row = dict(B=B, N=N, D=D, name=name, turn=turn, device_ms=device_ms(runs[name]),
                           host_ms=min(time_ms(hosts.get(name, runs[name]), HOST_ITERS)
                                       for _ in range(HOST_LOOPS)),
                           bound_ms=bound)
                line = (f"B={B} N={N} D={D} {name}: {row['device_ms']:.4f} ms device time, "
                        f"{row['host_ms']:.4f} ms host loop")
                if name in plans:
                    how_n = plans[name]
                    row.update(how_n._asdict(), blocks=how_n.blocks * B)
                    line += (f" (key tile {how_n.key_tile}, {how_n.splits} splits, "
                             f"{how_n.slices} slices, {how_n.blocks * B} blocks)")
                if name not in ("sdpa", "plain"):
                    first = out.clone()
                    runs[name]()
                    torch.cuda.synchronize()
                    err = (first - want).abs().max().item()
                    err64 = (first - exact).abs().max().item()
                    row.update(max_abs_err=err, err_f64=err64,
                               bit_identical=torch.equal(first, out))
                    line += (f", max abs err {err:.3g} (tol {tol:.3g}; against f64 "
                             f"{err64:.3g}), twice bit-identical {row['bit_identical']}")
                    exact_entry = name.split("/")[0] in ("shipped", "ring3", "baseline")
                    if exact_entry and not (err <= tol and err64 <= 2e-6
                                            and row["bit_identical"]):
                        raise AssertionError(line)
                print(line + f"; bound {bound:.4f} ms", flush=True)
                results.append(row)
            del qkv, q, k, v, want, exact, out, qh, kh, vh
            torch.cuda.empty_cache()
    if json_path:
        json_path.write_text(json.dumps(dict(card=card(), rows=results), indent=1))


def run_d128(baseline: Path = None, json_path: Path = None) -> None:
    """The D = 128 kernel's variants (each at the plan's key-split count and
    at 1 and twice it), the wide kernel at D = 128, the baseline (an earlier source's `attention_f32_d128`, called with its own
    signature), SDPA and the plain version, in turns at the Hagen mid block
    (N = 4096, D = 128, one head) at D128_BATCHES by CUDA-graph device time;
    each kernel held against the plain version and f64 and run twice for the
    bits."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    N, D = 4096, A.D128_HEAD_DIM
    sources = variant_sources(SOURCE, D128_VARIANTS)
    sources.update(variant_sources(WIDE_SOURCE, {"wide128": D128_WIDE_VARIANT}))
    mains = {name: SOURCE for name in D128_VARIANTS}
    mains["wide128"] = WIDE_SOURCE
    if baseline:
        sources["baseline"] = baseline_sources(baseline)
        mains["baseline"] = baseline.name
    results = []
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, mains, Path(work))
        base = libs.pop("baseline", None)
        wide = libs.pop("wide128")
        wide.attention_f32_wide.argtypes = SIGNATURES["attention_f32_wide"]
        for lib in libs.values():
            lib.attention_f32_d128.argtypes = SIGNATURES["attention_f32_d128"]
        unsplit = base is not None and "opart" not in baseline.read_text()
        if base is not None:
            base.attention_f32_d128.argtypes = (D128_UNSPLIT_SIGNATURE if unsplit
                                                else SIGNATURES["attention_f32_d128"])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for B in D128_BATCHES:
            g = torch.Generator(device="cuda").manual_seed(2)
            qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(D)
            want = A.attention_reference(q, k, v, scale)
            exact = A.attention_reference(q.double(), k.double(), v.double(), scale).float()
            tol = 1e-4 * (1 + want.abs().max().item())
            out = torch.empty_like(want)
            runs, plans = {}, {}
            how = A.d128_plan(B, N, sms)
            for name, lib in libs.items():
                # a 32-key variant's tiles, split by the plan's counts
                key_tile = 32 if name.startswith("tk32") else A.D128_KEY_TILE
                tiles = -(-N // key_tile)
                for sp in sorted({how.splits, 1, min(2 * how.splits, tiles)}):
                    tag = name + ("" if sp == how.splits else f"/splits{sp}")
                    runs[tag] = functools.partial(A._launch_d128, q, k, v, out, scale, sp,
                                                  lib.attention_f32_d128)
                    plans[tag] = dict(key_tile=key_tile, splits=sp,
                                      tiles_per_split=-(-tiles // sp),
                                      query_tiles=how.query_tiles)
            runs["wide128"] = functools.partial(A._launch_wide, q, k, v, out, scale,
                                                entry=wide.attention_f32_wide)
            plans["wide128"] = A.wide_plan(B, N, D, sms)._asdict()
            if base is not None and unsplit:
                st = q.stride()
                runs["baseline"] = lambda: A.check(base.attention_f32_d128(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 1, *st[:3],
                    scale, torch.cuda.current_stream().cuda_stream), "attention_f32_d128")
            elif base is not None:
                runs["baseline"] = functools.partial(A._launch_d128, q, k, v, out, scale,
                                                     entry=base.attention_f32_d128)
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            runs["plain"] = lambda: A.attention_reference(q, k, v, scale)
            bound = max(3 * 4 * B * N * N * D / 495e12, 16 * B * N * D / 3.35e12) * 1e3
            order = list(runs)
            for turn, name in enumerate(order + order[::-1]):
                runs[name]()
                torch.cuda.synchronize()
                row = dict(B=B, N=N, D=D, name=name, turn=turn, device_ms=device_ms(runs[name]),
                           bound_ms=bound, plan=plans.get(name))
                line = f"B={B} N={N} D={D} {name}: {row['device_ms']:.4f} ms device time"
                if name in plans:
                    line += f" ({plans[name]})"
                if name not in ("sdpa", "plain"):
                    first = out.clone()
                    runs[name]()
                    torch.cuda.synchronize()
                    err = (first - want).abs().max().item()
                    err64 = (first - exact).abs().max().item()
                    row.update(max_abs_err=err, err_f64=err64,
                               bit_identical=torch.equal(first, out))
                    line += (f", max abs err {err:.3g} (tol {tol:.3g}; against f64 "
                             f"{err64:.3g}), twice bit-identical {row['bit_identical']}")
                    if not (err <= tol and err64 <= 2e-6 and row["bit_identical"]):
                        raise AssertionError(line)
                print(line + f"; bound {bound:.4f} ms ({bound / row['device_ms']:.1%})",
                      flush=True)
                results.append(row)
            del qkv, q, k, v, want, exact, out, qh, kh, vh
            torch.cuda.empty_cache()
    if json_path:
        json_path.write_text(json.dumps(dict(card=card(), rows=results), indent=1))


# (B, N, forced key splits, numpy seed) of the D = 128 kernel's digests: the
# Hagen mid block at batch 1 and 2 at the plan's split counts on 132 SMs,
# forced so that a card of another SM count runs the same sums
D128_DIGEST_INPUTS = [(1, 4096, 4, 22), (2, 4096, 2, 23)]
# sha256 of the result of PR 22's D = 128 kernel (csrc/attention_wide.cu at
# commit 1ab4dcc, the same at 2357aaa) at each of D128_DIGEST_INPUTS, on an
# H100 80GB HBM3 (`--narrow` with that source as a baseline prints them)
D128_DIGESTS = {
    (1, 4096, 4, 22): "36c67cd718dace8168c4fbc817b866a58e23c0270caea447907a891231712fdd",
    (2, 4096, 2, 23): "0bf8efe88f610a6ef157f4cad0138d2959dfc099834f8e72747f3262488a4d89",
}


def d128_digest(B: int, N: int, splits: int, seed: int, entry=None):
    """The D = 128 kernel at (B, N, 1 head), `splits` key splits, on q, k, v
    views of one numpy-seeded qkv tensor, scale 1/sqrt(128) (`entry`: another
    library's attention_f32_d128): its result and the sha256 of its bytes."""
    import hashlib

    import numpy as np
    import torch

    from ..ops import attention as A

    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, N, 1, 3, A.D128_HEAD_DIM), dtype=np.float32)).cuda()
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    out = torch.empty(B, N, 1, A.D128_HEAD_DIM, device="cuda")
    A._launch_d128(q, k, v, out, 1 / math.sqrt(A.D128_HEAD_DIM), splits, entry)
    torch.cuda.synchronize()
    return out, hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def _narrow_inputs(B: int, N: int, D: int, seed: int = 2):
    """q, k, v (B, N, 1, D) views of one seeded qkv tensor on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def run_narrow(baselines=(), json_path: Path = None) -> None:
    """The kernel below D = 128: its variants (the shipped source at every
    built (key tile, warpgroups) pair, each at its plan's key-split count,
    the plan's pair also at 1 and twice the splits; the other variants at
    their pairs), the mma.sync kernel of an earlier attention.cu (a baseline
    holding `attention_tf32x3_narrow_kernel`, called with its own signature),
    SDPA and the plain version, in turns at NARROW_SHAPES by CUDA-graph
    device time, each kernel held against the plain version and f64 and run
    twice for the bits; the bound's two terms (3xTF32 operations, the
    softmax's exp2) beside each. Then the D = 128 instance against an
    earlier `attention_f32_d128` (a baseline holding it: PR 22's kernel) at
    D128_BATCHES, in turns, its result required bit-equal to the baseline's,
    and each one's sha256 at the GPU tests' D128_DIGEST_INPUTS."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A

    sources = variant_sources(SOURCE, NARROW_VARIANTS)
    mains = {name: SOURCE for name in sources}
    kinds = {}
    for i, path in enumerate(baselines):
        text = path.read_text()
        kind = ("narrow" if "attention_tf32x3_narrow_kernel" in text else
                "d128" if "attention_f32_d128" in text else None)
        if kind is None:
            raise SystemExit(f"{path}: neither the mma.sync kernel nor attention_f32_d128")
        kinds[f"baseline_{kind}"] = kind
        sources[f"baseline_{kind}"] = baseline_sources(path)
        mains[f"baseline_{kind}"] = path.name
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    print(f"{sms} SMs, highest SM clock {clock / 1e6:.0f} MHz", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, mains, Path(work))
        base_narrow = libs.pop("baseline_narrow", None)
        base_d128 = libs.pop("baseline_d128", None)
        for lib in libs.values():
            lib.attention_f32_narrow.argtypes = SIGNATURES["attention_f32_narrow"]
            lib.attention_f32_d128.argtypes = SIGNATURES["attention_f32_d128"]
        if base_narrow is not None:
            base_narrow.attention_f32_narrow.argtypes = NARROW_UNSPLIT_SIGNATURE
        if base_d128 is not None:
            base_d128.attention_f32_d128.argtypes = SIGNATURES["attention_f32_d128"]
        pairs = {"shipped": A.NARROW_TILINGS,
                 "tilings": [t[:2] for t in NARROW_EXTRA_TILINGS],
                 "two_blocks": [(16, 1), (64, 1)]}
        for B, N, D in NARROW_SHAPES:
            q, k, v = _narrow_inputs(B, N, D)
            scale = 1 / math.sqrt(D)
            want = A.attention_reference(q, k, v, scale)
            exact = A.attention_reference(q.double(), k.double(), v.double(), scale).float()
            tol = 1e-4 * (1 + want.abs().max().item())
            out = torch.empty_like(want)
            plan = A.narrow_plan(B, N, sms)
            runs, plans = {}, {}
            for name, lib in libs.items():
                for tk, ng in pairs.get(name, [(plan.key_tile, plan.groups)]):
                    if name == "tilings" and ng == 3 and D != 64:
                        continue  # built at DP = 64 only
                    how = A.narrow_plan(B, N, sms, None, tk, ng)
                    counts = [how.splits]
                    if (name, tk, ng) == ("shipped", plan.key_tile, plan.groups):
                        counts += [1, 2, 2 * how.splits]
                    counts = [c for c in counts if c <= -(-N // tk)]
                    for sp in sorted(set(counts)):
                        tag = name if (tk, ng) == (plan.key_tile, plan.groups) else \
                            f"{name}/tk{tk}g{ng}"
                        tag += "" if sp == how.splits else f"/splits{sp}"
                        runs[tag] = functools.partial(A._launch_narrow, q, k, v, out, scale, sp,
                                                      tk, ng, lib.attention_f32_narrow)
                        plans[tag] = A.narrow_plan(B, N, sms, sp, tk, ng)._asdict()
            if base_narrow is not None:
                st = q.stride()
                runs["baseline"] = lambda: A.check(base_narrow.attention_f32_narrow(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 1, D, *st[:3],
                    scale, torch.cuda.current_stream().cuda_stream), "attention_f32_narrow")
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            runs["plain"] = lambda: A.attention_reference(q, k, v, scale)
            ops_ms = 3 * 4 * B * N * N * D / 495e12 * 1e3  # 3xTF32 at the true D
            soft_ms = exp2_ms(B * N * N, sms, clock)
            bound = max(ops_ms, soft_ms)
            order = list(runs)
            for turn, name in enumerate(order + order[::-1]):
                runs[name]()
                torch.cuda.synchronize()
                row = dict(B=B, N=N, D=D, name=name, turn=turn, device_ms=device_ms(runs[name]),
                           bound_ms=bound, ops_ms=ops_ms, softmax_ms=soft_ms,
                           plan=plans.get(name))
                line = f"B={B} N={N} D={D} {name}: {row['device_ms']:.4f} ms device time"
                if name in plans:
                    line += f" ({plans[name]})"
                if name not in ("sdpa", "plain"):
                    first = out.clone()
                    runs[name]()
                    torch.cuda.synchronize()
                    err = (first - want).abs().max().item()
                    err64 = (first - exact).abs().max().item()
                    row.update(max_abs_err=err, err_f64=err64,
                               bit_identical=torch.equal(first, out))
                    line += (f", max abs err {err:.3g} (tol {tol:.3g}; against f64 "
                             f"{err64:.3g}), twice bit-identical {row['bit_identical']}")
                    if not (err <= tol and err64 <= 2e-6 and row["bit_identical"]):
                        raise AssertionError(line)
                print(line + f"; bound {bound:.5f} ms (3xTF32 {ops_ms:.5f}, exp2 {soft_ms:.5f}; "
                      f"{bound / row['device_ms']:.1%})", flush=True)
                results.append(row)
            del q, k, v, want, exact, out, qh, kh, vh
            torch.cuda.empty_cache()
        if base_d128 is not None:
            shipped = libs["shipped"].attention_f32_d128
            for B in D128_BATCHES:
                q, k, v = _narrow_inputs(B, 4096, A.D128_HEAD_DIM)
                scale = 1 / math.sqrt(A.D128_HEAD_DIM)
                outs = {name: torch.empty_like(q, memory_format=torch.contiguous_format)
                        for name in ("shipped", "baseline")}
                runs = {"shipped": functools.partial(A._launch_d128, q, k, v, outs["shipped"],
                                                     scale, None, shipped),
                        "baseline": functools.partial(A._launch_d128, q, k, v, outs["baseline"],
                                                      scale, None, base_d128.attention_f32_d128)}
                for turn, name in enumerate(["shipped", "baseline", "baseline", "shipped"]):
                    ms = device_ms(runs[name])
                    results.append(dict(B=B, N=4096, D=128, name=f"d128/{name}", turn=turn,
                                        device_ms=ms))
                    print(f"B={B} N=4096 D=128 d128/{name}: {ms:.4f} ms device time", flush=True)
                for fn in runs.values():
                    fn()
                torch.cuda.synchronize()
                same = torch.equal(outs["shipped"], outs["baseline"])
                print(f"B={B} N=4096 D=128: the D = 128 instance bit-equal to the baseline's "
                      f"kernel: {same}", flush=True)
                if not same:
                    raise AssertionError(f"B={B}: the D = 128 instance's bits differ")
                del q, k, v, outs
            for key in D128_DIGEST_INPUTS:
                for name, fn in (("shipped", shipped), ("baseline", base_d128.attention_f32_d128)):
                    digest = d128_digest(*key, entry=fn)[1]
                    print(f"D = 128 digest {key} {name}: {digest}", flush=True)
                    results.append(dict(B=key[0], N=key[1], D=128, name=f"digest/{name}",
                                        splits=key[2], seed=key[3], sha256=digest))
    if json_path:
        json_path.write_text(json.dumps(dict(card=card(), sms=sms, sm_clock_hz=clock,
                                             rows=results), indent=1))


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another source with the same entry point (with --narrow, given once "
                         "for the mma.sync kernel's attention.cu and once for PR 22's "
                         "attention_wide.cu)")
    ap.add_argument("--wide", action="store_true", help="variants of the wide kernel")
    ap.add_argument("--narrow", action="store_true",
                    help="variants of the kernel below D = 128, and its D = 128 instance "
                         "against a baseline's")
    ap.add_argument("--bf16", action="store_true", help="variants of the bf16 kernel")
    ap.add_argument("--host", action="store_true",
                    help="with --wide and --baseline: only the wrappers' host-loop times, in "
                         "alternating pairs")
    ap.add_argument("--json", type=Path, help="write every timing here")
    args = ap.parse_args()
    if len(args.baseline) > (2 if args.narrow else 1):
        raise SystemExit("attention_variants: too many baselines")
    baseline = args.baseline[0] if args.baseline else None
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: CUDA is not available")
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bf16:
        run_bf16(baseline, args.json)
        return
    if args.wide:
        run_wide(baseline, args.json, args.host)
        return
    if args.narrow:
        run_narrow(args.baseline, args.json)
        return
    run_d128(baseline, args.json)


if __name__ == "__main__":
    main()
