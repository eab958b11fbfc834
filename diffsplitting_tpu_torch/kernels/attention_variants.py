"""Time csrc/attention.cu beside variants of itself on one card.

    python -m diffsplitting_tpu_torch.kernels.attention_variants [--baseline FILE]

Each variant is the shipped source (and csrc/tf32x3.cuh) with text
substitutions, built by its own `nvcc` into its own library (all started
together) and called through the same C entry point, `attention_f32_d128`, at
the mid block's shape (N = 4096, D = 128, one head; q, k, v views of one qkv
tensor) at B = 8 and B = 2. The variants are timed in turns (forward, then in
reverse order) and each is held against the plain version; `--baseline` adds
any other source with the same entry point (an earlier version of the kernel,
say). Prints the card, each variant's registers and spills, its time and its
max abs error, and SDPA's time. Nothing here is used by the port.
"""

from __future__ import annotations

import argparse
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


def main() -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import attention_reference

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another source with the same entry point")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: CUDA is not available")
    print(card())
    sources = variant_sources(SOURCE, VARIANTS)
    if args.baseline:
        sources["baseline"] = {SOURCE: args.baseline.read_text()}
    torch.backends.cuda.matmul.allow_tf32 = False

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
