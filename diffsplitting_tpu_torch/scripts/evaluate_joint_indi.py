"""Full-frame joint-InDI evaluation: tiled prediction, stitch, metrics.

Counterpart: scripts/evaluate_joint_indi.py of the repository. Loads a
checkpoint (a `.../I{iter}_E{epoch}` prefix or a `*_gen.pth`), builds the
tiled val dataset over the full val frames (patch² tiles on a (patch/2)²
grid), runs the reverse process on every tile batch on the device
(`data/tiled_infer.py`), stitches the tiles' centres and reports the
RangeInvariantPSNR of each channel, for each reverse-step count N of
`--num_steps`; with `--lpips-weights` (a local `.npz` or torch `.pth`,
utils/lpips.py) also each channel's LPIPS, on frames scaled to [-1, 1].

  python -m diffsplitting_tpu_torch.scripts.evaluate_joint_indi \\
      -c configs/splitting_hagen_indi_joint.json --resume <prefix> \\
      [--num_steps 1 5 10] [--t_float_start 0.5] [--mmse 1] [--out metrics.json] \\
      [--lpips-weights lpips.npz]
  python -m diffsplitting_tpu_torch.scripts.evaluate_joint_indi -c <config> --check_data
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import dict_to_nonedict, load_json
from ..data import SplitDatasetTiledPred, predict_tiled
from ..data.check import run_check
from ..data.split_dataset import DataLocation
from ..device import resolve_device
from ..train import create_model
from ..utils.lpips import load_lpips_weights, lpips_grayscale
from ..utils.psnr import RangeInvariantPsnr


def build_val_dataset(opt) -> SplitDatasetTiledPred:
    dsets = opt["datasets"]
    loc = DataLocation(channelwise_fpath=(dsets["val"]["datapath"]["ch0"],
                                          dsets["val"]["datapath"]["ch1"]))
    return SplitDatasetTiledPred(
        "Hagen", loc, dsets["patch_size"],
        max_qval=dsets["max_qval"],
        upper_clip=bool(dsets.get("upper_clip", False)),
        channel_weights=dsets.get("channel_weights"),
        enable_transforms=False, random_patching=False,
        input_from_normalized_target=opt["model"]["which_model_G"] == "joint_indi",
    )


def normalized_input_frames(ds):
    """(F, H, W, 1) mean of the normalized channels (the mixed input) and
    (F, H, W, 2) normalized targets of every full frame."""
    norm = ds.get_normalization_dict()
    mean_t = np.asarray(norm["mean_target"]).reshape(-1)
    std_t = np.asarray(norm["std_target"]).reshape(-1)
    frames, targets = [], []
    for f in range(ds._frameN):
        ch0 = (np.asarray(ds._data_dict[0][f]) - mean_t[0]) / std_t[0]
        ch1 = (np.asarray(ds._data_dict[1][f]) - mean_t[1]) / std_t[1]
        frames.append(((ch0 + ch1) / 2.0)[..., None].astype(np.float32))
        targets.append(np.stack([ch0, ch1], axis=-1).astype(np.float32))
    return np.stack(frames), np.stack(targets)


def to_pm1(a):
    """A frame stack min-max scaled to [-1, 1] (the notebook's convention)."""
    lo, hi = a.min(), a.max()
    return (2.0 * (a - lo) / max(hi - lo, 1e-8) - 1.0).astype(np.float32)


@torch.inference_mode()
def evaluate(opt, resume: str, num_steps: Sequence[int] = (1,), t_float_start: float = 0.5,
             mmse: int = 1, batch_size: int = 8, device=None, lpips_params=None) -> dict:
    """{N: {'psnr_ch0', 'psnr_ch1'}} for each N of `num_steps`, with
    'lpips_ch0' and 'lpips_ch1' (the mean over frames) when `lpips_params`
    (utils/lpips.py) are given."""
    opt["phase"] = "val"
    opt["path"]["resume_state"] = resume
    ds = build_val_dataset(opt)
    frames, targets = normalized_input_frames(ds)
    model = create_model(opt, device=device)
    frames_dev = torch.from_numpy(frames).to(model.device)

    results = {}
    for n in num_steps:
        def infer_fn(tiles, _n=int(n)):
            # mmse chains as one wider batch, averaged
            out = model.inference(tiles.repeat(mmse, 1, 1, 1), num_timesteps=_n,
                                  t_float_start=t_float_start)
            return out.reshape(mmse, tiles.shape[0], *out.shape[1:]).mean(dim=0)

        pred = predict_tiled(infer_fn, frames_dev, ds.tile_manager, batch_size).cpu().numpy()
        psnr0 = float(RangeInvariantPsnr(targets[..., 0], pred[..., 0]).mean())
        psnr1 = float(RangeInvariantPsnr(targets[..., 1], pred[..., 1]).mean())
        results[int(n)] = {"psnr_ch0": psnr0, "psnr_ch1": psnr1}
        print(f"N={n}: RangeInvariantPSNR ch0={psnr0:.2f} dB ch1={psnr1:.2f} dB", flush=True)
        if lpips_params is not None:
            for ch in (0, 1):
                d = lpips_grayscale(
                    lpips_params,
                    torch.from_numpy(to_pm1(targets[..., ch])[..., None]).to(model.device),
                    torch.from_numpy(to_pm1(pred[..., ch])[..., None]).to(model.device))
                results[int(n)][f"lpips_ch{ch}"] = float(d.mean())
            print(f"N={n}: LPIPS ch0={results[int(n)]['lpips_ch0']:.4f} "
                  f"ch1={results[int(n)]['lpips_ch1']:.4f}", flush=True)
    return results


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint prefix (.../I{it}_E{ep}) or a *_gen.pth (required "
                         "unless --check_data)")
    ap.add_argument("--num_steps", type=int, nargs="+", default=[1])
    ap.add_argument("--t_float_start", type=float, default=0.5)
    ap.add_argument("--mmse", type=int, default=1, help="average over this many chains")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--out", default=None, help="write the metrics JSON here")
    ap.add_argument("--lpips-weights", default=None,
                    help="local AlexNet-LPIPS weights (.npz or torch .pth, utils/lpips.py); "
                         "when given, each channel's LPIPS is reported beside the PSNR")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--check_data", action="store_true",
                    help="validate the config's Hagen TIFF layout, print the parity-run "
                         "commands and exit 0 or 1")
    args = ap.parse_args(argv)
    if args.check_data:
        raise SystemExit(0 if run_check(args.config, dict_to_nonedict(load_json(args.config)))
                         else 1)
    if args.resume is None:
        ap.error("--resume is required")

    # float32 throughout, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = dict_to_nonedict(load_json(args.config))
    lpips_params = None
    if args.lpips_weights:
        lpips_params = load_lpips_weights(args.lpips_weights, resolve_device(args.device))
    results = evaluate(opt, args.resume, args.num_steps, args.t_float_start, args.mmse,
                       args.batch_size, args.device, lpips_params)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
