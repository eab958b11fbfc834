"""Unconditional generation CLI (sr3, ddpm): train, or sample in the val phase.

Counterpart: the repository's top-level sample.py:

  python -m diffsplitting_tpu_torch.sample -c configs/sample_sr3_128.json \\
      [-p train|val] [-rootdir DIR] [-debug] [-enable_wandb] [--device cpu]

Train: iterate to `train.n_iter` over `datasets.train` (HR as the target),
log every `print_freq`, every `val_freq` switch to the val schedule and
write `datasets.val.data_len` samples as `<step>_<idx>_sr.png` under
`path.results/<epoch>`, save a checkpoint pair every `save_checkpoint_freq`.
Val: `datasets.val.data_len` samples, each written as its trajectory grid
`<step>_<idx>_sample_process.png` and its last frame `_sample.png`; with a
serving accelerator on, the final frame `_sample.png` only.

The device, `-gpu`, the accelerator flags (`--ddim`, `--deepcache`,
`--sliding_window`, `--w8a8`, `--w8a8_sites`) and the compute dtype are as
in `infer.py`.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from . import config as Logger
from . import data as Data
from .device import resolve_device
from .infer import add_accelerator_flags, apply_accelerator_flags, hwc, run_logging
from .serving import check_compute_dtype
from .train import create_model
from .utils.metrics import save_img, tensor2img


def main(argv: Optional[list] = None) -> dict:
    """Runs the CLI; returns {'opt', 'model', 'results' (the PNG directory of
    the val phase), 'seconds' (host seconds of each val-phase sample, ended
    by a synchronize)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default="configs/sample_sr3_128.json")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "val"], default="train")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)  # accepted, ignored
    parser.add_argument("-debug", "-d", action="store_true", dest="debug")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_wandb_ckpt", action="store_true")
    parser.add_argument("-rootdir", type=str, default=None)
    add_accelerator_flags(parser)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    check_compute_dtype(Logger.load_json(args.config)["model"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = Logger.parse(args)
    seconds = []
    with run_logging(opt) as logger:
        logger.info(Logger.dict2str(opt))
        wandb_logger = None
        if opt["enable_wandb"]:
            from .utils.wandb_logger import WandbLogger

            wandb_logger = WandbLogger(opt, opt["path"]["experiment_root"],
                                       opt["experiment_name"])
        train_loader = None
        if args.phase != "val":
            train_set = Data.create_dataset(opt["datasets"]["train"], "train")
            train_loader = Data.create_dataloader(train_set, opt["datasets"]["train"], "train")
        logger.info("Initial Dataset Finished")

        diffusion = create_model(opt, device=device)
        logger.info("Initial Model Finished")
        accel = apply_accelerator_flags(diffusion, args)

        current_step = diffusion.begin_step
        current_epoch = diffusion.begin_epoch
        n_iter = int(opt["train"]["n_iter"])
        sample_sum = int(opt["datasets"]["val"]["data_len"])
        diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"][opt["phase"]],
                                         schedule_phase=opt["phase"])

        if opt["phase"] == "train":
            while current_step < n_iter:
                current_epoch += 1
                for train_data in train_loader:
                    current_step += 1
                    if current_step > n_iter:
                        break
                    diffusion.feed_data({"target": train_data["HR"], "input": train_data["SR"]})
                    diffusion.optimize_parameters()

                    if current_step % int(opt["train"]["print_freq"]) == 0:
                        logs = diffusion.get_current_log()
                        msg = "<epoch:{:3d}, iter:{:8,d}> ".format(current_epoch, current_step)
                        for k, v in logs.items():
                            msg += "{:s}: {:.4e} ".format(k, v)
                        logger.info(msg)
                        if wandb_logger:
                            wandb_logger.log_metrics(logs)

                    if current_step % int(opt["train"]["val_freq"]) == 0:
                        result_path = os.path.join(opt["path"]["results"], str(current_epoch))
                        os.makedirs(result_path, exist_ok=True)
                        diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                                         "val")
                        for idx in range(sample_sum):
                            diffusion.sample(continuous=False)
                            sample_img = tensor2img(
                                diffusion.get_current_visuals(sample=True)["SAM"])
                            save_img(hwc(sample_img),
                                     f"{result_path}/{current_step}_{idx}_sr.png")
                            if wandb_logger:
                                wandb_logger.log_image(f"validation_{idx}", sample_img)
                        diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                                         "train")

                    if current_step % int(opt["train"]["save_checkpoint_freq"]) == 0:
                        logger.info("Saving models and training states.")
                        diffusion.save_network(current_epoch, current_step)
                        if wandb_logger and opt.get("log_wandb_ckpt"):
                            wandb_logger.log_checkpoint(current_epoch, current_step)
            logger.info("End of training.")
            result_path = None
        else:
            logger.info("Begin Model Evaluation.")
            result_path = opt["path"]["results"]
            os.makedirs(result_path, exist_ok=True)
            sample_imgs = []
            for idx in range(1, sample_sum + 1):
                t0 = time.perf_counter()
                diffusion.sample(continuous=not accel)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                seconds.append(time.perf_counter() - t0)
                sam = diffusion.get_current_visuals(sample=True)["SAM"]
                if accel:
                    final = tensor2img(sam)
                else:
                    frames = sam  # (n_frames, B, H, W, C)
                    grid = tensor2img(frames.reshape((-1,) + frames.shape[2:]))
                    save_img(hwc(grid),
                             f"{result_path}/{current_step}_{idx}_sample_process.png")
                    final = tensor2img(frames[-1])
                save_img(hwc(final), f"{result_path}/{current_step}_{idx}_sample.png")
                sample_imgs.append(final)
            if wandb_logger:
                wandb_logger.log_images("eval_images", sample_imgs)
    return {"opt": opt, "model": diffusion, "results": result_path, "seconds": seconds}


if __name__ == "__main__":
    main()
