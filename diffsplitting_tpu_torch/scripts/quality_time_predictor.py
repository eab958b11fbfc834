"""Time predictor quality: training and evaluation on synthetic two-channel
frames, through the port's CLIs.

Counterpart: scripts/quality_time_predictor.py of the repository, on the
same protocol: 12 train frames (and 2 val frames) of 512² from
`quality_joint_indi_synthetic.make_stacks`, the config
configs/splitting_hagen_time_predictor.json at patch 256, trained by
`time_prediction_training` for `--epochs`, then the best checkpoint scored by
`scripts/evaluate_time_predictor.py` (RMSE of the mean predicted t over the
grid {0, 0.05, …, 1}). The JAX package's run of this protocol reached an
RMSE of 0.044 after 60 epochs.

  python -m diffsplitting_tpu_torch.scripts.quality_time_predictor \\
      [--epochs 6] [--workdir build/quality_time_predictor] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from .. import time_prediction_training
from ..config import load_json
from . import evaluate_time_predictor
from .quality_joint_indi_synthetic import make_stacks

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX protocol: 12 train frames of 512², patch 256
FRAMES, SIZE, PATCH = 12, 512, 256


def write_config(workdir: str, data: str, epochs: int) -> str:
    """The time predictor config on the synthetic stacks; returns its path."""
    opt = load_json(os.path.join(REPO, "configs/splitting_hagen_time_predictor.json"))
    for split_name in ("train", "val"):
        opt["datasets"][split_name]["datapath"] = {
            "ch0": f"{data}/{split_name}/{split_name}_actin.tif",
            "ch1": f"{data}/{split_name}/{split_name}_mito.tif",
        }
    opt["train"]["num_epochs"] = epochs
    # 512² frames: patch 256 gives 4 patches a frame, and the 2 val frames
    # one full batch of 8
    opt["datasets"]["patch_size"] = PATCH
    cfg = f"{workdir}/cfg_tp.json"
    with open(cfg, "w") as f:
        json.dump(opt, f, indent=1)
    return cfg


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "quality_time_predictor"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    dev = ["--device", args.device] if args.device else []
    data = f"{workdir}/data"
    if not os.path.isdir(f"{data}/train"):
        print("synthesizing frames ...", flush=True)
        make_stacks(data, FRAMES, SIZE)
    cfg = write_config(workdir, data, args.epochs)

    print("training through diffsplitting_tpu_torch.time_prediction_training ...", flush=True)
    run = time_prediction_training.main(["--config", cfg, "--rootdir",
                                         f"{workdir}/experiments", *dev])
    print("evaluating", run["checkpoint"], flush=True)
    out_json = f"{workdir}/metrics.json"
    metrics = evaluate_time_predictor.main(["-c", cfg, "--resume", run["checkpoint"],
                                            "--out", out_json, *dev])
    print("metrics written to", out_json, flush=True)
    return {"best_val_loss": run["best_val_loss"], "metrics": metrics,
            "checkpoint": run["checkpoint"]}


if __name__ == "__main__":
    main()
