"""JSON configs with `//` line comments, NoneDict defaults, and the CLI parse.

Counterpart: diffsplitting_tpu/config/loader.py, copied so the port imports
nothing of the JAX package:
  * `load_json` strips everything after `//` on each line before parsing;
  * `parse_config` creates a versioned experiment directory
    (`<root>/<YYMM>/<data>-<model>-<loss>/<N>/`), resolves the `path` entries
    under it and applies the debug shrink when the name contains 'debug'
    (val/print freq 2, checkpoint freq 3, batch 2, train/val n_timestep 10,
    train data_len 6, val data_len 3);
  * while training, the val dataset is capped at 3 items;
  * `NoneDict` returns None for missing keys.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, Optional

from ..utils.experiment import get_workdir


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


def dict2str(opt: Dict, indent_l: int = 1) -> str:
    """Pretty-print a nested config dict for logging."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def load_json(opt_path: str) -> OrderedDict:
    """Load a JSON config, tolerating `//` line comments."""
    with open(opt_path, "r") as f:
        text = "\n".join(line.split("//")[0] for line in f.read().splitlines())
    return json.loads(text, object_pairs_hook=OrderedDict)


def apply_debug_overrides(opt: Dict) -> Dict:
    """Shrink frequencies, timesteps and data lengths for smoke-test runs."""
    opt["train"]["val_freq"] = 2
    opt["train"]["print_freq"] = 2
    opt["train"]["save_checkpoint_freq"] = 3
    opt["datasets"]["train"]["batch_size"] = 2
    opt["model"]["beta_schedule"]["train"]["n_timestep"] = 10
    opt["model"]["beta_schedule"]["val"]["n_timestep"] = 10
    opt["datasets"]["train"]["data_len"] = 6
    opt["datasets"]["val"]["data_len"] = 3
    return opt


def parse_config(
    config_path: str,
    phase: str = "train",
    rootdir: Optional[str] = None,
    debug: bool = False,
    enable_wandb: bool = False,
) -> NoneDict:
    """The config with its `path` entries resolved under a fresh versioned
    experiment directory `<rootdir>/<YYMM>/<data>-<model>-<loss>/<N>/`."""
    opt = load_json(config_path)
    if debug:
        opt["name"] = "debug_{}".format(opt["name"])

    if rootdir is None:
        rootdir = opt["path"].get("root", os.path.join(os.getcwd(), "experiments"))

    experiment_root, expname = get_workdir(opt, rootdir)

    opt["path"]["experiment_root"] = experiment_root
    opt["experiment_name"] = expname

    for key, path in list(opt["path"].items()):
        if ("resume" not in key and "experiments" not in key and key != "experiment_root"
                and key != "root"):
            opt["path"][key] = os.path.join(experiment_root, path)
            os.makedirs(opt["path"][key], exist_ok=True)

    opt["phase"] = phase

    if "debug" in opt["name"]:
        apply_debug_overrides(opt)

    if phase == "train" and "val" in opt.get("datasets", {}):
        opt["datasets"]["val"]["data_len"] = 3

    opt["enable_wandb"] = enable_wandb
    return dict_to_nonedict(opt)


def parse(args) -> NoneDict:
    """The CLI's parse: an argparse namespace with config, phase, rootdir,
    debug and enable_wandb (and the W&B switches, copied into the config)."""
    opt = parse_config(
        config_path=args.config,
        phase=args.phase,
        rootdir=getattr(args, "rootdir", None),
        debug=getattr(args, "debug", False),
        enable_wandb=getattr(args, "enable_wandb", False),
    )
    for key in ("log_wandb_ckpt", "log_eval", "log_infer"):
        if hasattr(args, key):
            opt[key] = getattr(args, key)
    return opt
