"""Small shared helpers for the CLI entry points.

Counterpart: diffsplitting_tpu/utils/cli.py.
"""

from __future__ import annotations

import argparse


def parse_accel_flag(value: str, second_default, first_cast=int, second_cast=float):
    """Parse an ``A[,B]`` accelerator flag (``--deepcache K[,D]``,
    ``--sliding_window W[,TAU]``) into ``(A, B)``. ``A='auto'`` passes
    through uncast (DeepCache's auto interval); a missing or empty second
    part takes ``second_default``."""
    parts = value.split(",")
    a = parts[0] if parts[0] == "auto" else first_cast(parts[0])
    if len(parts) > 1 and parts[1] != "":
        return a, second_cast(parts[1])
    return a, second_default


def add_w8a8_flags(parser: argparse.ArgumentParser) -> None:
    """The JAX CLIs' `--w8a8` and `--w8a8_sites` flags."""
    parser.add_argument("--w8a8", action="store_true",
                        help="W8A8 quantized serving: int8 convs (torch._int_mm on the card) "
                             "after a one-time activation-scale calibration. Approximate; "
                             "composes with the other accelerators")
    parser.add_argument("--w8a8_sites", choices=["default", "all", "attn"], default="default",
                        help="'all' also quantizes the Down/Upsample and 1x1 shortcut convs; "
                             "'attn' those and the attention block's 1x1 convs; implies --w8a8")


def apply_w8a8_flags(model, args) -> None:
    """`set_quant` as the flags ask: a sites choice implies --w8a8."""
    if args.w8a8 or args.w8a8_sites != "default":
        wide = args.w8a8_sites in ("all", "attn")
        model.set_quant(8, updown=wide, shortcut=wide, attn=args.w8a8_sites == "attn")
