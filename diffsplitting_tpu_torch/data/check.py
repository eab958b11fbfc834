"""Fail-fast dataset-layout validation (`--check_data` on the port's
`split.py` and `scripts/evaluate_joint_indi.py`).

Counterpart: diffsplitting_tpu/data/check.py. The Hagen parity rows need the
real actin/mito TIFF stacks, which do not ship. This checks the layout the
loaders expect (per-channel multi-frame TIFF stacks, matching frame counts and
shapes, frames at least a patch wide), collects every problem in one pass and
prints the port's commands that produce the parity numbers once the data is
in place.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .io import load_tiff_stack


def check_hagen_layout(opt) -> Dict:
    """Validate datasets.{train,val}.datapath.{ch0,ch1} TIFF stacks.

    Returns {"ok": bool, "splits": {...}, "errors": [...]} — every problem
    is collected (not fail-on-first) so one pass reports the whole layout.
    """
    report: Dict = {"ok": True, "splits": {}, "errors": []}

    def err(msg: str):
        report["errors"].append(msg)
        report["ok"] = False

    dsets = opt["datasets"]
    patch = int(dsets["patch_size"] or 0)
    for sp in ("train", "val"):
        split_cfg = dsets.get(sp) or {}
        dp = split_cfg.get("datapath") or {}
        info: Dict = {}
        stacks = {}
        for ch in ("ch0", "ch1"):
            path = dp.get(ch) if isinstance(dp, dict) else None
            if not path:
                err(f"datasets.{sp}.datapath.{ch} missing from config "
                    "(expected a per-channel TIFF stack path)")
                continue
            if not os.path.exists(path):
                err(f"datasets.{sp}.datapath.{ch}: file not found: {path}")
                continue
            try:
                arr = load_tiff_stack(path)
            except Exception as e:  # unreadable / not a TIFF
                err(f"datasets.{sp}.datapath.{ch}: unreadable TIFF "
                    f"({type(e).__name__}: {e}): {path}")
                continue
            if arr.ndim not in (3, 4):
                err(f"datasets.{sp}.datapath.{ch}: expected (N,H,W[,C]) "
                    f"stack, got shape {arr.shape}: {path}")
                continue
            stacks[ch] = arr
            info[ch] = {
                "path": path, "frames": int(arr.shape[0]),
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "min": float(np.min(arr)), "max": float(np.max(arr)),
            }
        if len(stacks) == 2:
            a, b = stacks["ch0"], stacks["ch1"]
            if a.shape != b.shape:
                err(f"datasets.{sp}: channel stacks disagree: "
                    f"ch0 {a.shape} vs ch1 {b.shape}")
            H, W = a.shape[1], a.shape[2]
            if patch and (H < patch or W < patch):
                err(f"datasets.{sp}: frames {H}x{W} smaller than "
                    f"datasets.patch_size={patch}")
            if a.shape[0] < 1:
                err(f"datasets.{sp}: empty stack (0 frames)")
        report["splits"][sp] = info
    return report


def parity_commands(config_path: str, opt) -> List[str]:
    """The port's commands that produce the published-parity numbers once
    real data is in place (the reference's EvaluateJointIndi.ipynb cell 34
    for joint-InDI; the training protocol of the README)."""
    which = opt["model"]["which_model_G"]
    cmds = [f"python -m diffsplitting_tpu_torch.split -c {config_path}"]
    if which == "joint_indi":
        cmds += [
            # cell-34 rows: full-frame tiled eval, RangeInvariantPSNR a channel
            f"python -m diffsplitting_tpu_torch.scripts.evaluate_joint_indi -c {config_path} "
            "--resume <ckpt_prefix ...I{iter}_E{epoch}> "
            "--num_steps 1 --mmse 5 --out results/quality_hagen/parity.json",
            # reference .pth checkpoints load directly (utils/weights.py)
            f"python -m diffsplitting_tpu_torch.predict -c {config_path} "
            "--weights <reference_joint.pth> --input <mixed.tif> --out <dir>",
        ]
    else:
        cmds += [
            f"python -m diffsplitting_tpu_torch.split -c {config_path} -p val "
            "(with path.resume_state = <ckpt_prefix ...I{iter}_E{epoch}>)",
        ]
    return cmds


def run_check(config_path: str, opt, print_fn=print) -> bool:
    """--check_data entry: validate, print the report + parity commands,
    return ok (callers sys.exit(0/1) on it)."""
    if (opt["datasets"].get("train") or {}).get("name") != "Hagen":
        print_fn("check_data: only the Hagen channelwise-TIFF layout is "
                 "validated; nothing to check for this config")
        return True
    report = check_hagen_layout(opt)
    print_fn("dataset layout check: " + ("OK" if report["ok"] else "FAILED"))
    for sp, info in report["splits"].items():
        for ch, meta in info.items():
            print_fn(f"  {sp}.{ch}: {meta['frames']} frames "
                     f"{meta['shape']} {meta['dtype']} "
                     f"range [{meta['min']:.1f}, {meta['max']:.1f}]")
    for e in report["errors"]:
        print_fn(f"  ERROR: {e}")
    print_fn("parity-run commands (once data is in place):")
    for c in parity_commands(config_path, opt):
        print_fn(f"  {c}")
    return report["ok"]
