"""Super-resolution inference CLI (sr3, ddpm): the val LR/HR set through the
full reverse chain, as PNGs.

Counterpart: the repository's top-level infer.py:

  python -m diffsplitting_tpu_torch.infer -c configs/sr_sr3_16_128.json \\
      [-rootdir DIR] [-debug] [-enable_wandb -log_infer] [--device cpu]

For each val item (batch 1, `datasets.val`, mode LRHR): `feed_data`, then
`test(continuous=True)` over the config's val schedule, and
`<step>_<idx>_sr_process.png` (the trajectory as a grid), `_sr.png` (its last
frame), `_hr.png` and `_inf.png` (the bicubic-upsampled condition) under
`path.results`. DSP_FUSED=1 serves through the fused UNet forward.

The device is the card unless `--device` says otherwise; without CUDA the
CLI raises unless `--device cpu` is given. `-gpu` is accepted and ignored.
The serving accelerators `--deepcache`, `--sliding_window`, `--ddim`,
`--w8a8` and `--w8a8_sites` are accepted and raise NotImplementedError: they
are not ported for ddpm / sr3 (ROADMAP item 1f). A config with
`compute_dtype: bfloat16` (the default config, configs/sr_sr3_64_512.json)
is refused: the port computes in float32.
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
from .train.trainer import not_ported_1f
from .utils import setup_logger
from .utils.metrics import save_img, tensor2img


def add_accelerator_flags(parser: argparse.ArgumentParser) -> None:
    """The JAX CLIs' serving-accelerator flags, accepted and refused."""
    parser.add_argument("--deepcache", type=str, default=None, metavar="K[,D]",
                        help="DeepCache serving: not ported for ddpm / sr3 (raises)")
    parser.add_argument("--sliding_window", type=str, default=None, metavar="W[,TAU]",
                        help="sliding-window serving: not ported for ddpm / sr3 (raises)")
    parser.add_argument("--ddim", type=str, default=None, metavar="S[,ETA]",
                        help="respaced DDIM serving: not ported (raises)")
    parser.add_argument("--w8a8", action="store_true",
                        help="W8A8 quantized serving: not ported (raises)")
    parser.add_argument("--w8a8_sites", choices=["default", "all", "attn"], default="default",
                        help="W8A8 site coverage: not ported (raises unless 'default')")


def refuse_accelerators(args) -> None:
    for flag in ("deepcache", "sliding_window", "ddim"):
        if getattr(args, flag):
            raise not_ported_1f(f"--{flag}", "ddpm / sr3")
    if args.w8a8 or args.w8a8_sites != "default":
        raise not_ported_1f("--w8a8", "ddpm / sr3")


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
    refuse_accelerators(args)
    check_compute_dtype(Logger.load_json(args.config)["model"])
    # float32 throughout, as the JAX package computes these configs; cuDNN
    # would otherwise run the convolutions in TF32
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

        logger.info("Begin Model Inference.")
        current_step, idx, seconds = 0, 0, []
        result_path = opt["path"]["results"]
        os.makedirs(result_path, exist_ok=True)
        for val_data in val_loader:
            idx += 1
            diffusion.feed_data({"input": val_data["SR"], "target": val_data["HR"]})
            t0 = time.perf_counter()
            diffusion.test(continuous=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            visuals = diffusion.get_current_visuals()

            hr_img = tensor2img(visuals["target"])
            fake_img = tensor2img(visuals["input"])  # the bicubic-upsampled condition
            frames = visuals["prediction"]  # (n_frames, B, H, W, C)
            grid = tensor2img(frames.reshape((-1,) + frames.shape[2:]))
            save_img(hwc(grid), f"{result_path}/{current_step}_{idx}_sr_process.png")
            sr_final = tensor2img(frames[-1])
            save_img(hwc(sr_final), f"{result_path}/{current_step}_{idx}_sr.png")
            save_img(hwc(hr_img), f"{result_path}/{current_step}_{idx}_hr.png")
            save_img(hwc(fake_img), f"{result_path}/{current_step}_{idx}_inf.png")
            logger.info("item %d: %d-step chain in %.3f s", idx,
                        diffusion.current_sched.num_timesteps, seconds[-1])
            if wandb_logger and opt.get("log_infer"):
                wandb_logger.log_eval_data(fake_img, sr_final, hr_img)

        if wandb_logger and opt.get("log_infer"):
            wandb_logger.log_eval_table(commit=True)
    return {"opt": opt, "model": diffusion, "results": result_path, "seconds": seconds}


if __name__ == "__main__":
    main()
