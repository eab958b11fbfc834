"""Small shared helpers for the CLI entry points.

Counterpart: diffsplitting_tpu/utils/cli.py.
"""

from __future__ import annotations


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
