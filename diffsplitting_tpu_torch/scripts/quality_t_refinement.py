"""t-refinement quality: a trained joint-InDI model and time predictor composed
by the workflow on held-out synthetic frames.

Synthesizes FRAMES frames of SIZE² with
`quality_joint_indi_synthetic.make_stacks` from SEED (its train split; a
seed other than the training data's 0 gives frames no model saw), points a
copy of the joint config's val split at them and runs
`scripts/t_refinement_workflow.py` on their center crops of PATCH² at each
t_true of T_TRUE in NUM_STEPS steps, the protocol of the JAX package's run
(N = 10, b8, 256², on its quality protocol's models), which is in
results/quality_t_refinement.json.

  python -m diffsplitting_tpu_torch.scripts.quality_t_refinement \\
      --joint-config <cfg> --resume <joint prefix> --time-config <cfg> \\
      --time-resume <time predictor prefix> [--workdir build/quality_t_refinement] \\
      [--out report.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from ..config import load_json
from . import t_refinement_workflow
from .quality_joint_indi_synthetic import REPO, make_stacks

FRAMES, SIZE, PATCH, SEED = 8, 1024, 256, 7
T_TRUE, NUM_STEPS = (0.3, 0.35, 0.4, 0.5, 0.65), 10


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--joint-config", required=True)
    ap.add_argument("--resume", required=True)
    ap.add_argument("--time-config", required=True)
    ap.add_argument("--time-resume", required=True)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "quality_t_refinement"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    data = f"{workdir}/data"
    make_stacks(data, FRAMES, SIZE, seed=SEED)
    opt = load_json(args.joint_config)
    opt["datasets"]["val"]["datapath"] = {"ch0": f"{data}/train/train_actin.tif",
                                          "ch1": f"{data}/train/train_mito.tif"}
    cfg = f"{workdir}/cfg_joint_heldout.json"
    with open(cfg, "w") as f:
        json.dump(opt, f, indent=1)
    dev = ["--device", args.device] if args.device else []
    out = ["--out", args.out] if args.out else []
    return t_refinement_workflow.main(
        ["-c", cfg, "--resume", args.resume, "--time-config", args.time_config,
         "--time-resume", args.time_resume, "--t-true", *[str(t) for t in T_TRUE],
         "--num_steps", str(NUM_STEPS), "--batch", str(FRAMES), "--patch", str(PATCH),
         *out, *dev])


if __name__ == "__main__":
    main()
