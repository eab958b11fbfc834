"""PSNR-based t-refinement: a trained time predictor and a trained joint-InDI
model composed on mixtures of a fraction t_true other than 0.5.

Counterpart: scripts/t_refinement_workflow.py of the repository. For each
t_true:
  1. mix the normalized val channels, center-cropped to the patch, as
     t_true·ch0 + (1 − t_true)·ch1 (the first `--batch` frames);
  2. the classifier predicts t̂; one-step bridge inversions of both
     directions at t̂; the PSNR grid refines t (`utils/t_refinement.py`);
  3. joint-InDI inference in `--num_steps` steps (the serving N, as JAX sets
     `model.current_T`) from the refined start 1 − t and from the naive 0.5,
     each scored by RangeInvariantPSNR per channel against the ground truth.

  python -m diffsplitting_tpu_torch.scripts.t_refinement_workflow \\
      -c <joint config> --resume <joint checkpoint prefix or .pth> \\
      [--time-config <config>] [--time-resume <time predictor prefix or .pth>] \\
      [--t-true 0.35 0.5 0.65] [--num_steps 10] [--batch 8] [--patch P] \\
      [--seed 0] [--out report.json] [--device cpu]

Without `--time-resume` the classifier is a constant 0.5 (the grid still
refines t), as in JAX. The classifier runs twice a t_true, as in JAX: inside
the estimate and for the reported `classifier_t`. The one-step inversions
draw their noise from a generator seeded by `--seed` anew for every t_true
(JAX folds the same key for each). `main` returns the report rows; each also
holds the host seconds of its stages under 'seconds'.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..config import dict_to_nonedict, load_json
from ..data.normalization import compute_normalization_dict
from ..data.split_dataset import DataLocation, load_data
from ..device import resolve_device
from ..time_prediction_training import load_time_predictor
from ..train import create_model
from ..utils.psnr import RangeInvariantPsnr
from ..utils.t_refinement import estimate_time_using_PSNR


def load_normalized_channels(opt, split="val", patch=None, max_frames=None):
    """The split's channels, quantile-normalized with the config's scheme,
    center-cropped to `patch`. Returns (ch0n, ch1n) as (N, P, P) float32."""
    ds = opt["datasets"]
    dp = ds[split]["datapath"]
    loc = DataLocation(channelwise_fpath=(dp["ch0"], dp["ch1"]))
    data_dict = load_data(ds[split].get("name") or "Hagen", loc)
    norm = compute_normalization_dict(
        data_dict, ds.get("channel_weights") or [1, 1], q_val=ds["max_qval"])
    mean_t = np.asarray(norm["mean_target"], np.float32)
    std_t = np.asarray(norm["std_target"], np.float32)
    ch = [np.stack(data_dict[c]).astype(np.float32) for c in (0, 1)]
    if max_frames:
        ch = [c[:max_frames] for c in ch]
    if patch:
        H, W = ch[0].shape[-2:]
        y0, x0 = (H - patch) // 2, (W - patch) // 2
        ch = [c[:, y0: y0 + patch, x0: x0 + patch] for c in ch]
    ch0n = (ch[0] - mean_t[0]) / std_t[0]
    ch1n = (ch[1] - mean_t[1]) / std_t[1]
    return ch0n, ch1n


def build_time_classifier(opt_path: str, resume: str, device):
    """x (B, H, W, 1) on the device -> (B,) t̂, through the time predictor of
    the config at `opt_path` with the weights of `resume`."""
    net = load_time_predictor(dict_to_nonedict(load_json(opt_path)), resume, device)

    @torch.inference_mode()
    def classify(x):
        return net(x)

    classify.net = net
    return classify


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True, help="joint-InDI config")
    ap.add_argument("--resume", required=True,
                    help="joint-InDI checkpoint prefix (.../I{it}_E{ep}) or a *_gen.pth")
    ap.add_argument("--time-config", default=None,
                    help="time predictor config (default: the joint config)")
    ap.add_argument("--time-resume", default=None,
                    help="time predictor checkpoint prefix or .pth; omit to start the "
                         "one-step estimates from t=0.5")
    ap.add_argument("--t-true", type=float, nargs="+", default=[0.35, 0.5, 0.65])
    ap.add_argument("--num_steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=None,
                    help="center-crop size (default: datasets.patch_size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 throughout, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = dict_to_nonedict(load_json(args.config))
    opt["phase"] = "val"
    opt["path"]["resume_state"] = args.resume
    if opt["model"]["which_model_G"] != "joint_indi":
        raise ValueError("the t-refinement workflow needs a joint_indi config")

    patch = args.patch or int(opt["datasets"]["patch_size"])
    ch0n, ch1n = load_normalized_channels(opt, patch=patch)
    n = min(args.batch, ch0n.shape[0])
    ch0n, ch1n = ch0n[:n], ch1n[:n]

    model = create_model(opt, device=device)
    model.nets.eval()
    proc = model.process
    net1, net2 = model.unets()

    @torch.inference_mode()
    def d1(x, t):
        return net1(x, t)

    @torch.inference_mode()
    def d2(x, t):
        return net2(x, t)

    if args.time_resume:
        classifier = build_time_classifier(args.time_config or args.config, args.time_resume,
                                           device)
    else:
        def classifier(x):
            return torch.full((x.shape[0],), 0.5, device=x.device)

    model.current_T = int(args.num_steps)
    report = []
    for t_true in args.t_true:
        # t_true is ch0's coefficient, as in the time predictor's dataset
        inp = torch.from_numpy(
            (t_true * ch0n + (1 - t_true) * ch1n)[..., None].astype(np.float32)).to(device)
        times = {}
        per_sample_t, consensus_t = estimate_time_using_PSNR(
            inp, proc.indi1, proc.indi2, d1, d2, classifier,
            generator=torch.Generator(device=device).manual_seed(args.seed), times=times)
        t0 = time.perf_counter()
        classifier_t = float(np.mean(torch.as_tensor(classifier(inp)).float().cpu().numpy()))
        times["classifier"] += time.perf_counter() - t0

        # joint inference: indi1 (recovering ch0 from (1−t)·ch0 + t·ch1) starts
        # at t_float_start, indi2 at 1 − t_float_start
        def run(t_start, key):
            t0 = time.perf_counter()
            model.feed_data({"input": inp})
            out = model.test(continuous=False, t_float_start=float(t_start)).cpu().numpy()
            times[key] = time.perf_counter() - t0
            p0 = RangeInvariantPsnr(ch0n, out[..., 0]).mean()
            p1 = RangeInvariantPsnr(ch1n, out[..., 1]).mean()
            return float(p0), float(p1)

        refined_start = 1.0 - consensus_t
        psnr_refined = run(refined_start, "joint_refined")
        psnr_naive = run(0.5, "joint_naive")
        row = {
            "t_true": t_true,
            "classifier_t": classifier_t,
            "per_sample_t_mean": float(np.mean(per_sample_t)),
            "consensus_t": consensus_t,
            "refined_t_start": refined_start,
            "psnr_refined_ch0": psnr_refined[0],
            "psnr_refined_ch1": psnr_refined[1],
            "psnr_naive_ch0": psnr_naive[0],
            "psnr_naive_ch1": psnr_naive[1],
            "seconds": times,
        }
        report.append(row)
        print(f"t_true={t_true:.2f}: classifier t̂={classifier_t:.3f}, "
              f"consensus t={consensus_t:.3f} → start {refined_start:.3f} | "
              f"PSNR refined {psnr_refined[0]:.2f}/{psnr_refined[1]:.2f} dB "
              f"vs naive {psnr_naive[0]:.2f}/{psnr_naive[1]:.2f} dB", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
