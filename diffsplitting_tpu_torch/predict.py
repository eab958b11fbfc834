"""Batch prediction: checkpoint -> tiled splitting inference on the card -> TIFFs.

Counterpart: the repository's top-level predict.py.

Usage:
  python -m diffsplitting_tpu_torch.predict -c configs/splitting_hagen_indi_joint.json \\
      (--weights <I{it}_E{ep}_gen.pth> | --resume <.../I{it}_E{ep}>) \\
      --input mixed.tif --out predictions/ [--num_steps 3] [--t_float_start 0.5] \\
      [--batch_size 8] [--mmse 1] [--coalesce 1] [--deepcache K[,D]] \\
      [--sliding_window W[,TAU]] [--w8a8] [--w8a8_sites default|all|attn] [--png_preview]

The input TIFF is normalized with the config's quantile scheme computed from
the input itself unless --norm_from gives the two training channel TIFFs.
DSP_FUSED=1, as for the JAX package, serves through the stat-carried fused
UNet forward (models/fused_forward.py). `--deepcache` and `--sliding_window`
switch the serving accelerators of `SplittingModel` (exclusive of each
other); `--w8a8` serves the W8A8 quantized UNets (`set_quant`, calibrated on
the first tile; composes with both, and served unfused at DSP_FUSED=1),
`--w8a8_sites all` / `attn` widen its sites as in infer.py; `--coalesce 0`
runs the `--mmse` chains one after another instead of as one wider batch.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .config import dict_to_nonedict, load_json
from .data import TileIndexManager, TilingMode, predict_tiled
from .data.io import load_tiff_stack, save_tiff_stack
from .data.normalization import compute_normalization_dict
from .device import resolve_device
from .serving import SplittingModel
from .train.checkpoints import resolve_checkpoint
from .utils.cli import add_w8a8_flags, apply_w8a8_flags, parse_accel_flag
from .utils.weights import load_reference_checkpoint


@torch.inference_mode()
def predict_frames(model: SplittingModel, frames, patch: int, batch_size: int = 8,
                   t_float_start: Optional[float] = None, num_steps: Optional[int] = None,
                   mmse: int = 1, fused: Optional[bool] = None, coalesce: bool = True,
                   deepcache: Optional[Tuple] = None,
                   sliding_window: Optional[Tuple] = None) -> torch.Tensor:
    """Normalized (F, H, W, 1) frames -> normalized (F, H, W, C_out) prediction
    on the model's device. `mmse` > 1 averages that many chains, run as one
    wider batch (`coalesce`) or one after another. `fused` picks the UNet
    forward (None: the model's choice). `deepcache` ((interval, depth)) and
    `sliding_window` ((window, tau)), when given, set the model's switches
    (`set_deepcache`, `set_sliding_window`); None keeps them."""
    frames = torch.as_tensor(frames, dtype=torch.float32).to(model.device)
    if deepcache is not None:
        model.set_deepcache(*deepcache)
    if sliding_window is not None:
        model.set_sliding_window(*sliding_window)

    def infer_fn(tiles):
        if not coalesce:
            reps = [model.test(tiles, t_float_start, num_steps, fused) for _ in range(mmse)]
            return torch.stack(reps).mean(dim=0)
        out = model.test(tiles.repeat(mmse, 1, 1, 1), t_float_start, num_steps, fused)
        return out.reshape(mmse, tiles.shape[0], *out.shape[1:]).mean(dim=0)

    # patch² tiles on a (patch/2)² grid, as the top-level predict.py tiles
    mng = TileIndexManager(tuple(frames.shape[:3]), (1, patch // 2, patch // 2),
                           (1, patch, patch), TilingMode.ShiftBoundary)
    return predict_tiled(infer_fn, frames, mng, batch_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    weights = ap.add_mutually_exclusive_group(required=True)
    weights.add_argument("--weights", help="*_gen.pth in the reference layout (or the JAX export)")
    weights.add_argument("--resume", help="checkpoint prefix (.../I{it}_E{ep})")
    ap.add_argument("--input", required=True, help="mixed-input TIFF stack")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--norm_from", nargs=2, default=None, metavar=("CH0_TIF", "CH1_TIF"),
                    help="training channel TIFFs for normalization statistics")
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--t_float_start", type=float, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--mmse", type=int, default=1)
    ap.add_argument("--coalesce", type=int, default=1,
                    help="1: the --mmse chains as one wider batch; 0: one after another "
                         "(lower peak memory)")
    ap.add_argument("--deepcache", default=None, metavar="K[,D]",
                    help="DeepCache serving: the full UNet every K steps, the shallow levels "
                         "(split depth D, default 1) in between; K='auto' picks it from the "
                         "step count. Exact chain if unset")
    ap.add_argument("--sliding_window", default=None, metavar="W[,TAU]",
                    help="sliding-window serving: W steps a sweep as one (W*B)-batch forward, "
                         "advancing past steps that moved by at most TAU*sigma^2 (default "
                         "0.1; 0 is the exact chain). Exclusive with --deepcache")
    add_w8a8_flags(ap)
    ap.add_argument("--png_preview", action="store_true",
                    help="also write an 8-bit PNG of each channel's first frame")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # the splitting configs compute in float32 (no compute_dtype), as the JAX
    # package does; cuDNN would otherwise run the convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = dict_to_nonedict(load_json(args.config))
    which = opt["model"]["which_model_G"]
    if which not in ("indi", "joint_indi"):
        raise SystemExit("predict serves the splitting models (indi, joint_indi)")

    frames = load_tiff_stack(args.input).astype(np.float32)
    if frames.ndim == 2:
        frames = frames[None]
    weights = opt["datasets"].get("channel_weights") or [1, 1]
    if args.norm_from:
        ch0 = load_tiff_stack(args.norm_from[0]).astype(np.float32)
        ch1 = load_tiff_stack(args.norm_from[1]).astype(np.float32)
        norm = compute_normalization_dict({0: list(ch0), 1: list(ch1)}, weights,
                                          q_val=opt["datasets"]["max_qval"])
    else:
        # self-statistics: the mixed input is its own reference
        m = np.quantile(frames.reshape(-1), float(opt["datasets"]["max_qval"]))
        norm = {"mean_input": m / 2, "std_input": m / 2,
                "mean_target": np.array([m / 2, m / 2]), "std_target": np.array([m / 2, m / 2])}
    inp = ((frames - norm["mean_input"]) / norm["std_input"])[..., None].astype(np.float32)

    model = SplittingModel(opt, device=device)
    weights_path = args.weights or resolve_checkpoint(args.resume)[0]
    model.nets.load_state_dict(load_reference_checkpoint(weights_path, which))
    apply_w8a8_flags(model, args)
    deepcache = (parse_accel_flag(args.deepcache, 1, second_cast=int) if args.deepcache
                 else None)
    window = parse_accel_flag(args.sliding_window, 0.1) if args.sliding_window else None
    pred = predict_frames(model, inp, int(opt["datasets"]["patch_size"]), args.batch_size,
                          args.t_float_start, args.num_steps, args.mmse,
                          coalesce=bool(args.coalesce), deepcache=deepcache,
                          sliding_window=window).cpu().numpy()

    mean_t = np.asarray(norm["mean_target"]).reshape(1, 1, 1, -1)
    std_t = np.asarray(norm["std_target"]).reshape(1, 1, 1, -1)
    pred_raw = np.clip(pred * std_t + mean_t, 0, 65535).astype(np.uint16)
    os.makedirs(args.out, exist_ok=True)
    for c in range(pred_raw.shape[-1]):
        save_tiff_stack(os.path.join(args.out, f"pred_ch{c}.tif"), pred_raw[..., c])
    if args.png_preview:
        import cv2

        for c in range(pred_raw.shape[-1]):
            img = pred_raw[0, ..., c].astype(np.float32)
            img = (255 * (img - img.min()) / max(float(np.ptp(img)), 1.0)).astype(np.uint8)
            cv2.imwrite(os.path.join(args.out, f"preview_ch{c}.png"), img)
    F, H, W = frames.shape
    print(f"wrote {pred_raw.shape[-1]} channel stacks ({F}x{H}x{W}) to {args.out}")


if __name__ == "__main__":
    main()
