"""Super-resolution inference CLI (sr3, ddpm): the val LR/HR set through the
reverse chain, as PNGs.

Counterpart: the repository's top-level infer.py:

  python -m diffsplitting_tpu_torch.infer -c configs/sr_sr3_16_128.json \\
      [-rootdir DIR] [-debug] [-enable_wandb -log_infer] [--device cpu] \\
      [--ddim S[,ETA]] [--deepcache K[,D]] [--sliding_window W[,TAU]]

For each val item (batch 1, `datasets.val`, mode LRHR): `feed_data`, then
`test(continuous=True)` over the config's val schedule, and
`<step>_<idx>_sr_process.png` (the trajectory as a grid), `_sr.png` (its last
frame), `_hr.png` and `_inf.png` (the bicubic-upsampled condition) under
`path.results`. DSP_FUSED=1 serves through the fused UNet forward, at the
config's compute dtype (bf16 in the default config: the bf16 conv_gn kernel).

The serving accelerators, by flag or by the config's `model.ddim`,
`model.deepcache` and `model.sliding_window`: `--ddim S[,ETA]` (respaced
DDIM, ETA 0 by default), `--deepcache K[,D]` (K may be 'auto'; depth 1 by
default; composes with --ddim), `--sliding_window W[,TAU]` (TAU 0.1 by
default; exclusive with both: ValueError). With one on, the chain gives its
final frame only and no `_sr_process.png` is written. `--w8a8` and
`--w8a8_sites` are accepted and raise NotImplementedError (ROADMAP item 1g).

The device is the card unless `--device` says otherwise; without CUDA the
CLI raises unless `--device cpu` is given. `-gpu` is accepted and ignored.
The config's
`compute_dtype` (bfloat16 in the default config, configs/sr_sr3_64_512.json)
is the UNet's, as in JAX; DSP_PRECAST=1 casts the Conv/Linear weights to it
once a chain (models/precision.py); a dtype JAX does not take is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from . import config as Logger
from . import data as Data
from .device import resolve_device
from .serving import check_compute_dtype
from .train import create_model
from .train.trainer import not_ported_1g
from .utils import setup_logger
from .utils.cli import parse_accel_flag
from .utils.metrics import save_img, tensor2img


def add_accelerator_flags(parser: argparse.ArgumentParser) -> None:
    """The JAX CLIs' serving-accelerator flags."""
    parser.add_argument("--deepcache", type=str, default=None, metavar="K[,D]",
                        help="DeepCache serving: the full UNet every K steps ('auto': from the "
                             "chain length), split at depth D (default 1); final frames only; "
                             "composes with --ddim")
    parser.add_argument("--sliding_window", type=str, default=None, metavar="W[,TAU]",
                        help="sliding-window Picard serving: W steps a sweep, advancing past "
                             "steps that moved by at most TAU (default 0.1; 0 the exact chain) "
                             "times their noise variance; final frames only; exclusive with "
                             "--deepcache and --ddim")
    parser.add_argument("--ddim", type=str, default=None, metavar="S[,ETA]",
                        help="respaced DDIM serving: S steps of the trained chain (default "
                             "ETA 0, deterministic); final frames only")
    parser.add_argument("--w8a8", action="store_true",
                        help="W8A8 quantized serving: not ported (raises)")
    parser.add_argument("--w8a8_sites", choices=["default", "all", "attn"], default="default",
                        help="W8A8 site coverage: not ported (raises unless 'default')")


def refuse_w8a8(args) -> None:
    if args.w8a8 or args.w8a8_sites != "default":
        raise not_ported_1g("--w8a8")


def apply_accelerator_flags(model, args) -> bool:
    """Switch on the accelerators the flags ask for; True when any is on (by
    flag or config), and the chain then gives its final frame only."""
    if args.deepcache:
        model.set_deepcache(*parse_accel_flag(args.deepcache, 1, second_cast=int))
    if args.sliding_window:
        model.set_sliding_window(*parse_accel_flag(args.sliding_window, 0.1))
    if args.ddim:
        model.set_ddim(*parse_accel_flag(args.ddim, 0.0))
    return any(x is not None for x in (model.deepcache, model.sliding_window, model.ddim))


@contextlib.contextmanager
def run_logging(opt):
    """The train and val log files of a CLI run (and the screen); the
    handlers it added are removed after, so that a second run in one process
    logs once and leaves no file open."""
    before = {name: list(logging.getLogger(name).handlers) for name in (None, "val")}
    setup_logger(None, opt["path"]["log"], "train", level=logging.INFO, screen=True)
    setup_logger("val", opt["path"]["log"], "val", level=logging.INFO)
    try:
        yield logging.getLogger("base")
    finally:
        for name, handlers in before.items():
            lg = logging.getLogger(name)
            for h in list(lg.handlers):
                if h not in handlers:
                    lg.removeHandler(h)
                    h.close()


def hwc(img):
    return img if img.ndim == 3 else np.asarray(img)[..., None]


def main(argv: Optional[list] = None) -> dict:
    """Runs the CLI; returns {'opt', 'model', 'results' (the PNG directory),
    'seconds' (host seconds of each item's chain, ended by a synchronize)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default="configs/sr_sr3_64_512.json")
    parser.add_argument("-p", "--phase", type=str, choices=["val"], default="val")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)  # accepted, ignored
    parser.add_argument("-debug", "-d", action="store_true", dest="debug")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_infer", action="store_true")
    parser.add_argument("-rootdir", type=str, default=None)
    add_accelerator_flags(parser)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    refuse_w8a8(args)
    check_compute_dtype(Logger.load_json(args.config)["model"])
    # the config's compute dtype (float32, or bfloat16 with f32 statistics)
    # as the JAX package computes it; cuDNN would otherwise run the float32
    # convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = Logger.parse(args)
    with run_logging(opt) as logger:
        wandb_logger = None
        if opt["enable_wandb"]:
            from .utils.wandb_logger import WandbLogger

            wandb_logger = WandbLogger(opt, opt["path"]["experiment_root"],
                                       opt["experiment_name"])
        val_set = Data.create_dataset(opt["datasets"]["val"], "val")
        val_loader = Data.create_dataloader(val_set, opt["datasets"]["val"], "val")
        logger.info("Initial Dataset Finished")

        diffusion = create_model(opt, device=device)
        logger.info("Initial Model Finished")
        diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
        final_only = apply_accelerator_flags(diffusion, args)

        logger.info("Begin Model Inference.")
        current_step, idx, seconds = 0, 0, []
        result_path = opt["path"]["results"]
        os.makedirs(result_path, exist_ok=True)
        for val_data in val_loader:
            idx += 1
            diffusion.feed_data({"input": val_data["SR"], "target": val_data["HR"]})
            t0 = time.perf_counter()
            diffusion.test(continuous=not final_only)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            visuals = diffusion.get_current_visuals()

            hr_img = tensor2img(visuals["target"])
            fake_img = tensor2img(visuals["input"])  # the bicubic-upsampled condition
            if final_only:
                sr_final = tensor2img(visuals["prediction"])
            else:
                frames = visuals["prediction"]  # (n_frames, B, H, W, C)
                grid = tensor2img(frames.reshape((-1,) + frames.shape[2:]))
                save_img(hwc(grid), f"{result_path}/{current_step}_{idx}_sr_process.png")
                sr_final = tensor2img(frames[-1])
            save_img(hwc(sr_final), f"{result_path}/{current_step}_{idx}_sr.png")
            save_img(hwc(hr_img), f"{result_path}/{current_step}_{idx}_hr.png")
            save_img(hwc(fake_img), f"{result_path}/{current_step}_{idx}_inf.png")
            logger.info("item %d: %d-step schedule in %.3f s", idx,
                        diffusion.current_sched.num_timesteps, seconds[-1])
            if wandb_logger and opt.get("log_infer"):
                wandb_logger.log_eval_data(fake_img, sr_final, hr_img)

        if wandb_logger and opt.get("log_infer"):
            wandb_logger.log_eval_table(commit=True)
    return {"opt": opt, "model": diffusion, "results": result_path, "seconds": seconds}


if __name__ == "__main__":
    main()
