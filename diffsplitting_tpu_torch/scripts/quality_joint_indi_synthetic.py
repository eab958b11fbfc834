"""Joint-InDI trained-weight quality on synthetic two-channel microscopy frames.

Counterpart: scripts/quality_joint_indi_synthetic.py of the repository,
with its synthesis redone in numpy and scipy from the same seed: filamentous
"actin-like" random-walk curves and blobby "mito-like" spots, as uint16
counts with an offset and Gaussian read noise. It writes a config from
configs/splitting_hagen_indi_joint.json (patch and batch from the flags),
trains joint-InDI through the port's split.py and scores the newest
checkpoint with scripts/evaluate_joint_indi.py (stitched full-frame
RangeInvariantPSNR per channel at each N of --num_steps). The JAX package's
run of this protocol (16 frames of 1024², patch 256, batch 8, 4000
iterations) reached 45.05 / 45.49 dB at N = 1.

  python -m diffsplitting_tpu_torch.scripts.quality_joint_indi_synthetic \\
      [--iters 4000] [--patch 256] [--batch 8] [--frames 16] [--size 1024] \\
      [--workdir build/quality_joint_indi] [--num_steps 1 5 10] [--device cpu]

`--pool_seed` seeds the device pool's draws (the patches, their frames and
flips); runs that differ in it alone show the run-to-run spread.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np
from scipy.ndimage import gaussian_filter

from .. import split
from ..config import load_json
from ..data.io import save_tiff_stack
from . import evaluate_joint_indi

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_actin(rng, size):
    """Filamentous structure: smooth random-walk curves."""
    img = np.zeros((size, size), np.float32)
    for _ in range(max(8, size // 32)):
        n = rng.integers(200, 600)
        pos = rng.uniform(0, size, 2)
        vel = rng.normal(0, 1, 2)
        for _ in range(n):
            vel = 0.95 * vel + rng.normal(0, 0.45, 2)
            vel /= max(np.linalg.norm(vel), 1e-6)
            pos = pos + vel * 1.5
            y, x = int(pos[0]) % size, int(pos[1]) % size
            img[y, x] += 1.0
    img = gaussian_filter(img, 1.6)
    return img / max(img.max(), 1e-6)


def synth_mito(rng, size):
    """Blobby structure: anisotropic gaussian spots."""
    img = np.zeros((size, size), np.float32)
    for _ in range(max(30, size // 8)):
        y, x = rng.uniform(0, size, 2)
        amp = rng.uniform(0.4, 1.0)
        img[int(y) % size, int(x) % size] += amp * 50
    img = gaussian_filter(img, rng.uniform(2.5, 4.0))
    img += 0.25 * gaussian_filter(img, 8.0)
    return img / max(img.max(), 1e-6)


def make_stacks(workdir, frames, size, seed=0):
    """Writes `<workdir>/{train,val}/{split}_{actin,mito}.tif` (uint16):
    `frames` train frames and max(2, frames // 8) val frames."""
    rng = np.random.default_rng(seed)
    for split_name, n in [("train", frames), ("val", max(2, frames // 8))]:
        os.makedirs(f"{workdir}/{split_name}", exist_ok=True)
        actin = np.stack([synth_actin(rng, size) for _ in range(n)])
        mito = np.stack([synth_mito(rng, size) for _ in range(n)])
        a16 = (100 + actin * 1500 + rng.normal(0, 6, actin.shape)).clip(0, 65535)
        m16 = (100 + mito * 1800 + rng.normal(0, 6, mito.shape)).clip(0, 65535)
        save_tiff_stack(f"{workdir}/{split_name}/{split_name}_actin.tif", a16.astype(np.uint16))
        save_tiff_stack(f"{workdir}/{split_name}/{split_name}_mito.tif", m16.astype(np.uint16))


def write_config(workdir, iters, patch, batch=8, save_freq=None, resume=None, pool_seed=0,
                 **train_opts):
    """The Hagen joint-InDI config on the synthetic stacks; returns its path.
    `train_opts` override keys of `train` (print_freq, val_freq)."""
    opt = load_json(os.path.join(REPO, "configs/splitting_hagen_indi_joint.json"))
    ds = opt["datasets"]
    ds["patch_size"] = patch
    for split_name in ("train", "val"):
        ds[split_name]["datapath"] = {
            "ch0": f"{workdir}/{split_name}/{split_name}_actin.tif",
            "ch1": f"{workdir}/{split_name}/{split_name}_mito.tif",
        }
        ds[split_name]["patch_size"] = patch
    ds["train"]["batch_size"] = batch
    ds["train"]["pool_seed"] = pool_seed
    opt["path"]["root"] = f"{workdir}/experiments/"
    opt["path"]["resume_state"] = resume
    opt["train"]["n_iter"] = iters
    opt["train"]["val_freq"] = max(iters // 4, 1)
    opt["train"]["save_checkpoint_freq"] = save_freq or iters
    opt["train"]["print_freq"] = 100
    opt["train"].update(train_opts)
    cfg_path = f"{workdir}/cfg_joint_indi.json"
    with open(cfg_path, "w") as f:
        json.dump(opt, f, indent=1)
    return cfg_path


def newest_checkpoint(workdir) -> str:
    """The prefix of the newest `*_gen.pth` under `<workdir>/experiments`."""
    gens = glob.glob(f"{workdir}/experiments/**/*_gen.pth", recursive=True)
    if not gens:
        raise FileNotFoundError(f"no checkpoint under {workdir}/experiments")
    return max(gens, key=os.path.getmtime)[: -len("_gen.pth")]


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "quality_joint_indi"))
    ap.add_argument("--num_steps", type=int, nargs="+", default=[1, 5, 10])
    ap.add_argument("--pool_seed", type=int, default=0, help="seed of the device pool's draws")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    dev = ["--device", args.device] if args.device else []
    print("synthesizing frames ...", flush=True)
    make_stacks(workdir, args.frames, args.size)
    cfg = write_config(workdir, args.iters, args.patch, args.batch, pool_seed=args.pool_seed)

    print("training through diffsplitting_tpu_torch.split ...", flush=True)
    run = split.main(["-c", cfg, "-p", "train", *dev])
    ckpt = newest_checkpoint(workdir)
    print("evaluating", ckpt, flush=True)
    out_json = f"{workdir}/metrics.json"
    metrics = evaluate_joint_indi.main(["-c", cfg, "--resume", ckpt, "--num_steps",
                                        *[str(n) for n in args.num_steps], "--out", out_json,
                                        *dev])
    print("metrics written to", out_json, flush=True)
    return {"val_psnrs": run["val_psnrs"], "metrics": metrics, "checkpoint": ckpt}


if __name__ == "__main__":
    main()
