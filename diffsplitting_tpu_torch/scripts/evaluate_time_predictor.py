"""Time predictor evaluation: the predicted t against the true mixing fraction.

Counterpart: scripts/evaluate_time_predictor.py of the repository. For every
t on the grid {0, 1/T, …, 1}, mix the normalized val patches as
t·ch0 + (1−t)·ch1, min-max rescale them with the statistics of that grid
point, run the classifier over the val set and report each t's mean and std
prediction and the RMSE of the means over the grid.

  python -m diffsplitting_tpu_torch.scripts.evaluate_time_predictor \\
      -c configs/splitting_hagen_time_predictor.json --resume <prefix or .pth> \\
      [--num_timesteps 20] [--batch_size 16] [--max_batches 0] [--out metrics.json] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..config import dict_to_nonedict, load_json
from ..data import TimePredictorDataset, compute_input_normalization_dict
from ..data.split_dataset import DataLocation
from ..device import resolve_device
from ..time_prediction_training import load_time_predictor


@torch.inference_mode()
def evaluate(opt, resume: str, num_timesteps: int = 20, batch_size: int = 16,
             max_batches: int = 0, device=None) -> dict:
    """{'per_t': [{'t', 'pred_mean', 'pred_std'}, ...], 'rmse'}."""
    device = resolve_device(device)
    dsets = opt["datasets"]
    val_loc = DataLocation(channelwise_fpath=(dsets["val"]["datapath"]["ch0"],
                                              dsets["val"]["datapath"]["ch1"]))
    val_set = TimePredictorDataset(
        "Hagen", val_loc, dsets["patch_size"],
        max_qval=dsets["max_qval"], upper_clip=bool(dsets.get("upper_clip", False)),
        channel_weights=dsets.get("channel_weights"),
        enable_transforms=False, random_patching=False,
    )
    net = load_time_predictor(opt, resume, device)

    T = num_timesteps
    val_set.fixed_t_norm_dict = compute_input_normalization_dict(
        val_set._data_dict, T, val_set._mean_target, val_set._std_target)
    gt_grid = np.arange(0, 1.01, 1 / T)
    n_items = len(val_set)
    if max_batches:
        n_items = min(n_items, max_batches * batch_size)

    results = []
    for t_int, t in enumerate(gt_grid):
        preds = []
        for start in range(0, n_items, batch_size):
            batch = np.stack([val_set.item_at_t(i, float(t), t_int)
                              for i in range(start, min(start + batch_size, n_items))])
            preds.append(net(torch.from_numpy(batch).to(device)).cpu().numpy())
        preds = np.concatenate(preds)
        results.append({"t": float(t), "pred_mean": float(preds.mean()),
                        "pred_std": float(preds.std())})
        print(f"t={t:.2f}: pred {preds.mean():.3f} ± {preds.std():.3f}", flush=True)

    rmse = float(np.sqrt(np.mean([(r["pred_mean"] - r["t"]) ** 2 for r in results])))
    print(f"RMSE: {rmse:.4f}", flush=True)
    return {"per_t": results, "rmse": rmse}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--resume", required=True, help="checkpoint prefix or a *_gen.pth")
    ap.add_argument("--num_timesteps", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_batches", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    # float32 throughout, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = dict_to_nonedict(load_json(args.config))
    metrics = evaluate(opt, args.resume, args.num_timesteps, args.batch_size, args.max_batches,
                       args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
