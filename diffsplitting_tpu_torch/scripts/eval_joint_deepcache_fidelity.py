"""Fidelity of DeepCache joint-InDI inference on a trained splitting model.

Counterpart: scripts/eval_joint_deepcache_fidelity.py of the repository.
Loads the newest checkpoint that `scripts/quality_joint_indi_synthetic.py`
wrote under `--workdir` (and its config, `cfg_joint_indi.json`), takes the
first 8 patches of its val frames as one batch, runs the exact joint chain
and the cached one at each interval of `--intervals`, every chain from the
same generator seed (so the same noise), and reports PSNR(cached, exact) a
channel (mean over the batch) and each chain's seconds (host clock, ended
by a device synchronize, after one warm-up chain).

  python -m diffsplitting_tpu_torch.scripts.eval_joint_deepcache_fidelity \\
      [--workdir build/quality_joint_indi] [--n 10] [--intervals 2,5] [--depth 1] \\
      [--out <workdir>/joint_indi_fidelity.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import dict_to_nonedict, load_json
from ..data.split_dataset import DataLocation, SplitDataset
from ..device import resolve_device
from ..serving import SplittingModel
from ..utils.psnr import PSNR
from ..utils.weights import load_reference_checkpoint
from .quality_joint_indi_synthetic import REPO, newest_checkpoint

SEED = 77


def val_batch(opt, n: int = 8) -> np.ndarray:
    """The inputs of the first `n` grid patches of the config's val frames."""
    ds_opt = opt["datasets"]
    loc = DataLocation(channelwise_fpath=(ds_opt["val"]["datapath"]["ch0"],
                                          ds_opt["val"]["datapath"]["ch1"]))
    val = SplitDataset("Hagen", loc, ds_opt["patch_size"], max_qval=ds_opt["max_qval"],
                       upper_clip=bool(ds_opt.get("upper_clip", False)),
                       channel_weights=ds_opt.get("channel_weights"),
                       enable_transforms=False, random_patching=False,
                       input_from_normalized_target=True)
    return np.stack([val[i]["input"] for i in range(n)]).astype(np.float32)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "quality_joint_indi"))
    ap.add_argument("--n", type=int, default=10, help="reverse steps")
    ap.add_argument("--intervals", default="2,5")
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--out", default=None, help="default: <workdir>/joint_indi_fidelity.json")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = dict_to_nonedict(load_json(os.path.join(args.workdir, "cfg_joint_indi.json")))
    ckpt = newest_checkpoint(args.workdir)
    model = SplittingModel(opt, device=device)
    model.nets.load_state_dict(load_reference_checkpoint(f"{ckpt}_gen.pth", "joint_indi"))
    x = torch.from_numpy(val_batch(opt)).to(device)

    def chain(interval):
        model.set_deepcache(interval, args.depth)
        model.generator.manual_seed(SEED)
        t0 = time.perf_counter()
        out = model.test(x, num_timesteps=args.n)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0

    chain(None)  # warm-up
    exact, exact_s = chain(None)
    results = {"checkpoint": ckpt, "n_steps": args.n, "depth": args.depth, "batch": len(x),
               "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
               "exact_s": exact_s}
    for k in (int(v) for v in args.intervals.split(",")):
        out, secs = chain(k)
        ps = [float(np.mean(PSNR(exact[..., c], out[..., c]))) for c in range(out.shape[-1])]
        results[f"interval{k}"] = {"psnr_vs_exact_ch0": ps[0], "psnr_vs_exact_ch1": ps[1],
                                   "seconds": secs}
        print(k, results[f"interval{k}"], flush=True)
    print(f"exact chain: {exact_s:.4f} s", flush=True)
    out_path = args.out or os.path.join(args.workdir, "joint_indi_fidelity.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print("->", out_path, flush=True)
    return results


if __name__ == "__main__":
    main()
