"""Checkpoint pairs: `I{iter}_E{epoch}_gen.pth` and `I{iter}_E{epoch}_opt.pth`.

Counterpart: diffsplitting_tpu/train/checkpoints.py, in the reference's
contract: a generator payload `{prefix}_gen` and a trainer payload
`{prefix}_opt` holding epoch, iter and the optimizer state, resumed by path
prefix. Here both are torch files:

  * `_gen.pth` is the nets' state dict in the reference layout
    (`indi1.denoise_fn.*`, ...; `utils/weights.py`), on the CPU, which the
    JAX package's torch import and the reference read;
  * `_opt.pth` holds `epoch`, `iter` and `optimizer` (the Adam state dict),
    and what an exact resume of the port needs besides, which JAX keeps in
    its optax state: `updates` (the update count the LR schedule reads),
    `global_step`, `mini_step` and `acc` (gradient accumulation), `ema`
    (the EMA nets' state dict, when the EMA is on) and `generator` (the
    state of the trainer's t and noise generator).

Each file is written under a temporary name and renamed, so a cut run
leaves no half-written checkpoint under the final name.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import torch


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, prefix: str, gen_state: Mapping[str, torch.Tensor],
                    opt_payload: Mapping) -> Tuple[str, str]:
    """Write `<ckpt_dir>/<prefix>_gen.pth` (the state dict, moved to the CPU)
    and `<prefix>_opt.pth`; returns both paths."""
    os.makedirs(ckpt_dir, exist_ok=True)
    gen_path = os.path.join(ckpt_dir, f"{prefix}_gen.pth")
    opt_path = os.path.join(ckpt_dir, f"{prefix}_opt.pth")
    _save({k: v.detach().cpu() for k, v in gen_state.items()}, gen_path)
    _save(dict(opt_payload), opt_path)
    return gen_path, opt_path


def resolve_checkpoint(load_path: str) -> Tuple[str, Optional[str]]:
    """A resume path -> (the `_gen.pth` file, the `_opt.pth` file or None).

    `load_path` is a `.pth` file (weights only: a reference checkpoint or the
    JAX package's export) or a prefix `.../I{iter}_E{epoch}` whose
    `_gen.pth` must exist; its `_opt.pth` is used when it exists."""
    if load_path.endswith(".pth"):
        if not os.path.isfile(load_path):
            raise FileNotFoundError(load_path)
        return load_path, None
    gen_path, opt_path = f"{load_path}_gen.pth", f"{load_path}_opt.pth"
    if not os.path.isfile(gen_path):
        raise FileNotFoundError(f"no checkpoint at prefix {load_path} ({gen_path} is missing)")
    return gen_path, opt_path if os.path.isfile(opt_path) else None


def load_trainer_state(opt_path: str) -> dict:
    """The `_opt.pth` payload, on the CPU."""
    return torch.load(opt_path, map_location="cpu", weights_only=True)
