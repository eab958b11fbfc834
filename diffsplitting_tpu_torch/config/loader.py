"""JSON configs with `//` line comments, and NoneDict defaults.

Counterpart: diffsplitting_tpu/config/loader.py (`load_json`, `NoneDict`,
`dict_to_nonedict`), copied so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from collections import OrderedDict


class NoneDict(dict):
    """dict whose missing keys read as None."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """Recursively convert dicts to NoneDict (missing key -> None)."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def load_json(opt_path: str) -> OrderedDict:
    """Load a JSON config, tolerating `//` line comments."""
    with open(opt_path, "r") as f:
        text = "\n".join(line.split("//")[0] for line in f.read().splitlines())
    return json.loads(text, object_pairs_hook=OrderedDict)
