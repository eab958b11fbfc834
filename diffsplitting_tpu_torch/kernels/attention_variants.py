"""Time csrc/attention.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.attention_variants [--baseline FILE]
    python -m diffsplitting_tpu_torch.kernels.attention_variants --wide

Each variant is the shipped source (and csrc/tf32x3.cuh) with text
substitutions, built by its own `nvcc` into its own library (all started
together). By default the variants are of the D = 128 kernel, called through
`attention_f32_d128` at the mid block's shape (N = 4096, D = 128, one head; q,
k, v views of one qkv tensor) at B = 8 and B = 2; `--baseline` adds any other
source with the same entry point (an earlier version of the kernel, say).
With `--wide` they are of the wide kernel (`attention_f32_wide`: key-tile
size, row groups a block, ring depth), at WIDE_SHAPES, timed beside the SIMT
kernel (`attention_f32_any_d` of the shipped source) at the same D. The
variants are timed in turns (forward, then in reverse order, SDPA among
them) and each is held against the plain version. Prints the card, each
variant's registers and spills, its time and its max abs error, and SDPA's
time. Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
import functools
import math
import tempfile
from pathlib import Path

from .build import SIGNATURES
from .variants import build_all, card, time_ms, variant_sources

SOURCE = "attention.cu"
HEADER = "tf32x3.cuh"
ONE_TF32 = (HEADER, "    mma_tf32(d, a_small, b0_big, b1_big);\n"
            "    mma_tf32(d, a_big, b0_small, b1_small);\n", "")
# S summed per 16-wide head-dim step from 0 and added in f32, rather than over
# all of D in the tensor core's own accumulator (it rounds toward zero); O
# summed over all N keys in the accumulator, rather than per tile from 0
S_PER_STEP = [(SOURCE, "                    mma_3xtf32(s[n], a0b, a0s, xb, yb, xs, ys);\n"
               "                    mma_3xtf32(s[n], a1b, a1s, zb, wb, zs, ws);\n",
               "                    float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
               "                    mma_3xtf32(d, a0b, a0s, xb, yb, xs, ys);\n"
               "                    mma_3xtf32(d, a1b, a1s, zb, wb, zs, ws);\n"
               "                    for (int e = 0; e < 4; ++e) s[n][e] += d[e];\n")]
O_IN_MMA = [(SOURCE, "float d[16][4] = {};  // this tile's P V, from 0", "float (&d)[16][4] = o;"),
            (SOURCE, "o[n][i] += d[n][i];", "(void)0;")]
RESCALE = "#pragma unroll\n            for (int n = 0; n < 16; ++n) {\n                o[n][0] *= corr[0];"
# name -> (file, old, new) substitutions on the shipped sources
VARIANTS = {
    "shipped": [],
    # big * big only: plain TF32, to record the error the split removes
    "1xtf32": [ONE_TF32],
    # 64-key tiles in a ring of two stages (they spill with the P V sum)
    "k64_2stages": [(SOURCE, "constexpr int kTileK = 32;", "constexpr int kTileK = 64;"),
                    (SOURCE, "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    # the summation of PRs 4 and 5: S and O in the MMA accumulator
    "tc_accumulate": O_IN_MMA,
    # S from 0 a head-dim step too
    "s_per_step": S_PER_STEP,
    # O's rescale skipped by a warp none of whose rows' max moved
    "skip_rescale": [(SOURCE, RESCALE, "            if (!__all_sync(0xffffffffu, corr[0] == 1.f && "
                      "corr[1] == 1.f))\n" + RESCALE)],
}


# the wide kernel's tiling, by slice count DS (D = 128 DS)
WIDE_ROWS = "static constexpr int kRowGroups = DS <= 2 ? 4 : DS <= 3 ? 2 : 1;"
WIDE_TILE_K = "static constexpr int kTileK = DS <= 4 ? 32 : 16;  // keys a tile"
WIDE_SLOTS = "static constexpr int kSlots = 2;                  // ring slots of K or V tiles"
WIDE_S_STEP = ("                    float step[4] = {0.f, 0.f, 0.f, 0.f};\n"
               "                    mma_3xtf32(step, a0b, a0s, xb, yb, xs, ys);\n"
               "                    mma_3xtf32(step, a1b, a1s, zb, wb, zs, ws);\n"
               "#pragma unroll\n"
               "                    for (int i = 0; i < 4; ++i) s[n][i] += step[i];\n")
WIDE_VARIANTS = {
    "shipped": [],
    "1xtf32": [ONE_TF32],
    # a slice's 128 terms of S summed in the MMA accumulator, as at D = 128
    "s_in_mma": [(SOURCE, WIDE_S_STEP,
                  "                    mma_3xtf32(s[n], a0b, a0s, xb, yb, xs, ys);\n"
                  "                    mma_3xtf32(s[n], a1b, a1s, zb, wb, zs, ws);\n")],
    # S from 0 an 8-wide k-step; P V from 0 an 8-key k-step
    "s_per_kstep": [(SOURCE, WIDE_S_STEP,
                     "                    float step[4] = {0.f, 0.f, 0.f, 0.f};\n"
                     "                    float step2[4] = {0.f, 0.f, 0.f, 0.f};\n"
                     "                    mma_3xtf32(step, a0b, a0s, xb, yb, xs, ys);\n"
                     "                    mma_3xtf32(step2, a1b, a1s, zb, wb, zs, ws);\n"
                     "#pragma unroll\n"
                     "                    for (int i = 0; i < 4; ++i) "
                     "s[n][i] += step[i] + step2[i];\n")],
    "pv_per_kstep": [(SOURCE, "                        "
                      "mma_3xtf32(d[e], pb[j], ps[j], b0b, b1b, b0s, b1s);\n",
                      "                        float t4[4] = {0.f, 0.f, 0.f, 0.f};\n"
                      "                        mma_3xtf32(t4, pb[j], ps[j], b0b, b1b, b0s, b1s);\n"
                      "#pragma unroll\n"
                      "                        for (int i = 0; i < 4; ++i) d[e][i] += t4[i];\n")],
    # the first design: two row groups and 16-key tiles at D = 512
    "first": [(SOURCE, WIDE_ROWS,
               "static constexpr int kRowGroups = DS <= 2 ? 4 : DS <= 4 ? 2 : 1;"),
              (SOURCE, WIDE_TILE_K, "static constexpr int kTileK = DS <= 3 ? 32 : 16;")],
    # one row group at every D (two warps a block at D = 256), or two at 256
    "rg1": [(SOURCE, WIDE_ROWS, "static constexpr int kRowGroups = 1;")],
    "rg2_at256": [(SOURCE, WIDE_ROWS, "static constexpr int kRowGroups = DS <= 3 ? 2 : 1;")],
    # 16-key tiles at every D
    "tk16": [(SOURCE, WIDE_TILE_K, "static constexpr int kTileK = 16;")],
    # 16-key tiles at D = 512, so that two blocks fit on an SM
    "two_blocks": [(SOURCE, WIDE_TILE_K, "static constexpr int kTileK = DS <= 3 ? 32 : 16;")],
    # as many ring slots as fit in 227 KB, up to 4 (3 or 4 from D = 256 to 768)
    "slots_fit": [(SOURCE, WIDE_SLOTS, "static constexpr int kSlots = (232448 / 4 - 16 * "
                   "kRowGroups * kD - kRowGroups * DS * 16 * kTileK) / (kTileK * kD) < 4 ? "
                   "(232448 / 4 - 16 * kRowGroups * kD - kRowGroups * DS * 16 * kTileK) / "
                   "(kTileK * kD) : 4;")],
}
# (B, N, D): the mid block of sr_sr3_64_512, the 16² attention sites of
# sr_sr3_16_128 at batch 8 and at its batch 4, and D = 256 at N = 1024
WIDE_SHAPES = [(2, 1024, 1024), (8, 256, 512), (4, 256, 512), (8, 1024, 256)]


def run_wide() -> None:
    """The wide kernel's variants, the SIMT kernel and SDPA in turns at
    WIDE_SHAPES."""
    import torch
    import torch.nn.functional as F

    from ..ops import attention_reference

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(variant_sources(SOURCE, WIDE_VARIANTS), SOURCE, Path(work))
        for lib in libs.values():
            for entry in ("attention_f32_wide", "attention_f32_any_d"):
                getattr(lib, entry).argtypes = SIGNATURES[entry]
        for B, N, D in WIDE_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(2)
            qkv = torch.randn(B, N, 1, 3, D, device="cuda", generator=g)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(D)
            want = attention_reference(q, k, v, scale)
            exact = attention_reference(q.double(), k.double(), v.double(), scale).float()
            out = torch.empty_like(want)
            st = q.stride()
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))

            def launch(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 1, D,
                         st[0], st[1], st[2], scale, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")

            runs = {name: functools.partial(launch, lib.attention_f32_wide)
                    for name, lib in libs.items()}
            runs["simt"] = functools.partial(launch, libs["shipped"].attention_f32_any_d)
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            order = list(runs)
            for name in order + order[::-1]:
                ms = time_ms(runs[name])
                line = f"B={B} N={N} D={D} {name}: {ms:.4f} ms"
                if name != "sdpa":
                    line += (f", max abs err {(out - want).abs().max().item():.3g} "
                             f"(against f64: {(out - exact).abs().max().item():.3g})")
                print(line)
            del qkv, q, k, v, want, exact, out, qh, kh, vh
            torch.cuda.empty_cache()


def main() -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import attention_reference

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another source with the same entry point")
    ap.add_argument("--wide", action="store_true",
                    help="variants of the wide kernel, beside the SIMT kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: CUDA is not available")
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.wide:
        run_wide()
        return
    sources = variant_sources(SOURCE, VARIANTS)
    if args.baseline:
        sources["baseline"] = {SOURCE: args.baseline.read_text()}

    with tempfile.TemporaryDirectory() as work:
        libs = build_all(sources, SOURCE, Path(work))
        for lib in libs.values():
            lib.attention_f32_d128.argtypes = SIGNATURES["attention_f32_d128"]
        for B in (8, 2):
            g = torch.Generator(device="cuda").manual_seed(2)
            qkv = torch.randn(B, 4096, 1, 3, 128, device="cuda", generator=g)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            scale = 1 / math.sqrt(128)
            want = attention_reference(q, k, v, scale)
            out = torch.empty_like(want)
            st = q.stride()

            def launch(lib):
                err = lib.attention_f32_d128(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), B, 4096, 1, st[0], st[1], st[2],
                                             scale, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")

            order = list(libs)
            for name in order + order[::-1]:
                launch(libs[name])
                err = (out - want).abs().max().item()
                print(f"B={B} {name}: {time_ms(lambda: launch(libs[name])):.4f} ms, "
                      f"max abs err {err:.3g}")
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
            print(f"B={B} sdpa: {sdpa:.4f} ms")


if __name__ == "__main__":
    main()
