"""Training and evaluation CLI for the splitting models (indi, joint-InDI).

Counterpart: the repository's top-level split.py (`get_datasets`,
`unnormalize_for_psnr`, `run_validation`, `main`):

  python -m diffsplitting_tpu_torch.split -c configs/splitting_hagen_indi_joint.json \\
      [-p train|val] [-debug] [-rootdir DIR] [-enable_wandb] [--device cpu] [--check_data]

Train: iterate to `train.n_iter`; log every `print_freq` (the only place the
host reads the step's logs back from the device); every `val_freq` switch to
the val schedule, run at most 19 val items, un-normalize to uint16, log the
channel-wise PSNR and dump target/input/pred PNGs, then switch back; save a
checkpoint pair every `save_checkpoint_freq`. `path.resume_state` resumes
from a checkpoint prefix. Batches come from the host loader, or, when
`datasets.train.device_pool` says so (or, unset, when the frame stacks fit in
4 GB), from `data/device_pool.py` on the card.
Val: PSNR and SSIM over the whole val set, with PNG dumps.

The device is the card unless `--device` says otherwise; without CUDA the
CLI raises unless `--device cpu` is given. `-gpu` is accepted and ignored.
`--check_data` only validates the data layout (`data/check.py`) and exits 0
or 1, as JAX's split.py does.
"""

from __future__ import annotations

import argparse
import logging
import os
from collections import defaultdict
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from . import config as Logger
from .data import SplitDataset, SplitDatasetTiledPred, create_dataloader
from .data.check import run_check
from .data.device_pool import DevicePatchPool
from .data.split_dataset import DataLocation
from .device import resolve_device
from .models.precision import compute_dtype
from .train import create_model
from .utils import setup_logger
from .utils.metrics import calculate_psnr, calculate_ssim, save_img
from .utils.flops import config_forward_flops
from .utils.profiling import StepTimer, peak_flops
from .utils.psnr import PSNR

DEVICE_POOL_CAP_BYTES = 4 << 30


def train_flops_per_step(opt) -> Optional[float]:
    """3 × the forward FLOPs (forward and backward) of the configured UNet at
    the train patch and batch, times the nets (2 for joint_indi), as JAX's
    `_train_flops_per_step` counts; None where the config has no patch."""
    patch = opt["datasets"].get("patch_size")
    if patch is None:
        return None
    m = opt["model"]
    n_nets = 2 if m["which_model_G"] == "joint_indi" else 1
    fwd = config_forward_flops(m, patch, opt["datasets"]["train"]["batch_size"])
    return 3.0 * fwd * n_nets


def train_peak_flops(opt, device, logger) -> Optional[float]:
    """The card's peak for the config's compute dtype, None on the CPU or on
    a card `peak_flops` does not know (logged: no MFU then)."""
    if device.type != "cuda":
        return None
    try:
        return peak_flops(compute_dtype(opt["model"]), device)
    except ValueError as e:
        logger.warning("%s: MFU is not reported", e)
        return None


def device_pool_eligible(train_set, cap_bytes: int = DEVICE_POOL_CAP_BYTES) -> bool:
    """Whether the train dataset can ride the device pool: a random-patching
    SplitDataset whose frame stacks, as float32, fit in `cap_bytes`."""
    if not getattr(train_set, "_random_patching", False):
        return False
    dd = getattr(train_set, "_data_dict", None)
    if not dd or 0 not in dd or 1 not in dd:
        return False
    nbytes = 4 * sum(np.asarray(f).size for f in list(dd[0]) + list(dd[1]))
    return nbytes <= cap_bytes


def get_datasets(opt, tiled_pred: bool = False):
    """The (train, val) dataset pair of a config."""
    dsets = opt["datasets"]
    patch_size = dsets["patch_size"]
    target_channel_idx = dsets.get("target_channel_idx", None)
    upper_clip = bool(dsets.get("upper_clip", False))
    max_qval = dsets["max_qval"]
    channel_weights = dsets.get("channel_weights", None)

    data_type = dsets["train"]["name"]
    uncorrelated_channels = bool(dsets["train"]["uncorrelated_channels"])
    if data_type not in ("cifar10", "Hagen"):
        raise ValueError(f"datasets.train.name must be cifar10 or Hagen, got {data_type!r}")
    if data_type == "Hagen":
        train_loc = DataLocation(channelwise_fpath=(dsets["train"]["datapath"]["ch0"],
                                                    dsets["train"]["datapath"]["ch1"]))
        val_loc = DataLocation(channelwise_fpath=(dsets["val"]["datapath"]["ch0"],
                                                  dsets["val"]["datapath"]["ch1"]))
    else:
        train_loc = DataLocation(directory=dsets["train"]["datapath"])
        val_loc = DataLocation(directory=dsets["val"]["datapath"])

    input_from_normalized_target = opt["model"]["which_model_G"] == "joint_indi"
    train_set = SplitDataset(
        data_type, train_loc, patch_size,
        target_channel_idx=target_channel_idx,
        max_qval=max_qval, upper_clip=upper_clip,
        uncorrelated_channels=uncorrelated_channels,
        channel_weights=channel_weights,
        normalization_dict=None, enable_transforms=True, random_patching=True,
        input_from_normalized_target=input_from_normalized_target,
    )
    val_cls = SplitDatasetTiledPred if tiled_pred else SplitDataset
    val_set = val_cls(
        data_type, val_loc, patch_size,
        target_channel_idx=target_channel_idx,
        normalization_dict=train_set.get_normalization_dict(),
        max_qval=max_qval, upper_clip=upper_clip,
        channel_weights=channel_weights,
        enable_transforms=False, random_patching=False,
        input_from_normalized_target=input_from_normalized_target,
    )
    return train_set, val_set


def train_batches(opt, train_set, device, logger=None) -> Callable[[], Iterable]:
    """A callable that gives one epoch of training batches: numpy batches
    from the host loader, or device tensors drawn by a `DevicePatchPool`
    (`datasets.train.device_pool`; unset: on when `device_pool_eligible`).
    An epoch is len(train_set) // batch_size draws from the pool."""
    train_opt = opt["datasets"]["train"]
    use_pool = train_opt.get("device_pool")
    if use_pool is None:
        use_pool = device_pool_eligible(train_set)
    if not use_pool:
        loader = create_dataloader(train_set, train_opt, "train")
        return lambda: loader
    bsz = int(train_opt["batch_size"])
    pool = DevicePatchPool(train_set, bsz, seed=int(train_opt.get("pool_seed") or 0),
                           device=device)
    per_epoch = max(1, len(train_set) // bsz)
    if logger is not None:
        logger.info("device_pool: %d frames resident on %s, %d draws an epoch",
                    pool.frames, pool.device, per_epoch)
    return lambda: (pool.draw() for _ in range(per_epoch))


def unnormalize_for_psnr(visuals, norm_dict):
    """Normalized NHWC visuals -> uint16 images (input, target, prediction)
    of the first item."""
    inp = visuals["input"][0]
    target = visuals["target"][0]
    pred = visuals["prediction"]
    pred = pred[0] if pred.ndim == 4 else pred

    mean_t = np.asarray(norm_dict["mean_target"]).reshape(1, 1, -1)
    std_t = np.asarray(norm_dict["std_target"]).reshape(1, 1, -1)
    mean_i, std_i = norm_dict["mean_input"], norm_dict["std_input"]

    input_img = ((inp * std_i + mean_i) / 2).astype(np.uint16)
    target_img = (target * std_t + mean_t).astype(np.uint16)
    pred_img = pred * std_t + mean_t
    pred_img = np.clip(pred_img, 0, 65535).astype(np.uint16)
    return input_img, target_img, pred_img


def run_validation(diffusion, val_loader, val_set, opt, current_step, current_epoch,
                   logger, wandb_logger, val_step, max_items=20) -> float:
    """At most max_items - 1 val items through `test`; returns the mean over
    channels of the mean PSNR of each channel."""
    psnr_values = defaultdict(list)
    result_path = os.path.join(opt["path"]["results"], str(current_epoch))
    os.makedirs(result_path, exist_ok=True)

    diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    norm = val_set.get_normalization_dict()
    idx = 0
    for val_data in val_loader:
        idx += 1
        if idx == max_items:
            break
        diffusion.feed_data(val_data)
        diffusion.test(continuous=False)
        visuals = diffusion.get_current_visuals()
        input_img, target_img, pred_img = unnormalize_for_psnr(visuals, norm)

        n_ch = target_img.shape[-1]
        mode = "RGB" if input_img.shape[-1] == 3 else "L"
        ncols = 3 if mode == "RGB" else 1
        for ch_idx in range(0, n_ch, ncols):
            psnr_val = PSNR(
                np.moveaxis(target_img[..., ch_idx: ch_idx + ncols] * 1.0, -1, 0),
                np.moveaxis(pred_img[..., ch_idx: ch_idx + ncols] * 1.0, -1, 0),
            ).mean()
            psnr_values[ch_idx].append(float(psnr_val))

        if mode != "RGB":
            # uint16 to [0, 255] panels for the PNG dump
            minv = target_img.reshape(-1, n_ch).min(axis=0).reshape(1, 1, -1)
            t_img = target_img - minv
            maxv = t_img.reshape(-1, n_ch).max(axis=0).reshape(1, 1, -1)
            t_img = t_img / np.maximum(maxv, 1)
            i_img = input_img - input_img.min()
            i_img = i_img / max(i_img.max(), 1)
            p_img = np.clip((pred_img - minv) / np.maximum(maxv, 1), 0, 1)
            target_img, input_img, pred_img = t_img * 255, i_img * 255, p_img * 255

        save_img(target_img, f"{result_path}/{current_step}_{idx}_target.png", mode=mode)
        save_img(input_img, f"{result_path}/{current_step}_{idx}_input.png", mode=mode)
        save_img(pred_img, f"{result_path}/{current_step}_{idx}_pred.png", mode=mode)

    avg_psnr = float(np.mean([np.mean(v) for v in psnr_values.values()]))
    diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"], "train")

    logger.info("# Validation # PSNR: {:.4e}".format(avg_psnr))
    logging.getLogger("val").info(
        "<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}".format(current_epoch, current_step, avg_psnr))
    if wandb_logger:
        wandb_logger.log_metrics({"validation/val_psnr": avg_psnr, "validation/val_step": val_step})
    return avg_psnr


def train(opt, diffusion, train_set, val_set, logger, wandb_logger) -> list:
    """The train loop; returns the validation PSNRs in order."""
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    epoch_batches = train_batches(opt, train_set, diffusion.device, logger)
    current_step, current_epoch = diffusion.begin_step, diffusion.begin_epoch
    n_iter = int(opt["train"]["n_iter"])
    print_freq = int(opt["train"]["print_freq"])
    val_freq = int(opt["train"]["val_freq"])
    save_freq = int(opt["train"]["save_checkpoint_freq"])
    timer = StepTimer(flops_per_step=train_flops_per_step(opt),
                      peak=train_peak_flops(opt, diffusion.device, logger))
    val_psnrs, val_step = [], 0
    while current_step < n_iter:
        current_epoch += 1
        for train_data in epoch_batches():
            current_step += 1
            if current_step > n_iter:
                break
            with timer.step():
                diffusion.feed_data(train_data)
                diffusion.optimize_parameters()

            if current_step % print_freq == 0:
                logs = dict(diffusion.get_current_log())
                logs.update(timer.metrics())
                message = "<epoch:{:3d}, iter:{:8,d}> ".format(current_epoch, current_step)
                for k, v in logs.items():
                    message += "{:s}: {:.2e} ".format(k, v)
                logger.info(message)
                if wandb_logger:
                    wandb_logger.log_metrics(logs)

            if current_step % val_freq == 0:
                val_psnrs.append(run_validation(diffusion, val_loader, val_set, opt,
                                                current_step, current_epoch, logger,
                                                wandb_logger, val_step))
                val_step += 1

            if current_step % save_freq == 0:
                logger.info("Saving models and training states.")
                diffusion.save_network(current_epoch, current_step)
                if wandb_logger and opt.get("log_wandb_ckpt"):
                    wandb_logger.log_checkpoint(current_epoch, current_step)

        if wandb_logger:
            wandb_logger.log_metrics({"epoch": current_epoch - 1})
    logger.info("End of training.")
    return val_psnrs


def evaluate(opt, diffusion, val_set, logger, wandb_logger):
    """PSNR and SSIM over the whole val set; returns their means."""
    logger.info("Begin Model Evaluation.")
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    avg_psnr, avg_ssim, idx = 0.0, 0.0, 0
    result_path = opt["path"]["results"]
    os.makedirs(result_path, exist_ok=True)
    norm = val_set.get_normalization_dict()
    for val_data in val_loader:
        idx += 1
        diffusion.feed_data(val_data)
        diffusion.test(continuous=False)
        visuals = diffusion.get_current_visuals()
        input_img, target_img, pred_img = unnormalize_for_psnr(visuals, norm)

        mode = "RGB" if input_img.shape[-1] == 3 else "L"
        save_img(pred_img, f"{result_path}/{idx}_pred.png", mode=mode)
        save_img(target_img, f"{result_path}/{idx}_target.png", mode=mode)
        save_img(input_img, f"{result_path}/{idx}_input.png", mode=mode)

        scale = 255.0 / 65535.0
        eval_psnr = calculate_psnr(pred_img * scale, target_img * scale)
        eval_ssim = calculate_ssim((pred_img[..., :1] * scale).astype(np.uint8),
                                   (target_img[..., :1] * scale).astype(np.uint8))
        avg_psnr += eval_psnr
        avg_ssim += eval_ssim
        if wandb_logger and opt.get("log_eval"):
            wandb_logger.log_eval_data(input_img, pred_img, target_img, eval_psnr, eval_ssim)

    avg_psnr /= idx
    avg_ssim /= idx
    logger.info("# Validation # PSNR: {:.4e}".format(avg_psnr))
    logger.info("# Validation # SSIM: {:.4e}".format(avg_ssim))
    if wandb_logger:
        if opt.get("log_eval"):
            wandb_logger.log_eval_table()
        wandb_logger.log_metrics({"PSNR": float(avg_psnr), "SSIM": float(avg_ssim)})
    return avg_psnr, avg_ssim


def main(argv: Optional[list] = None) -> dict:
    """Runs the CLI; returns {'opt', 'model'} and, for train, 'val_psnrs',
    for val, 'psnr' and 'ssim'."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default="configs/splitting_hagen_indi.json")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "val"], default="train")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)  # accepted, ignored
    parser.add_argument("-debug", "-d", action="store_true", dest="debug")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_wandb_ckpt", action="store_true")
    parser.add_argument("-log_eval", action="store_true")
    parser.add_argument("-rootdir", type=str, default=None)
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--check_data", action="store_true",
                        help="validate the config's Hagen TIFF layout, print the parity-run "
                             "commands and exit 0 or 1 (no training, no experiment dir)")
    args = parser.parse_args(argv)

    if args.check_data:
        raise SystemExit(0 if run_check(args.config, Logger.dict_to_nonedict(
            Logger.load_json(args.config))) else 1)
    device = resolve_device(args.device)
    # the splitting configs compute in float32, as the JAX package does;
    # cuDNN would otherwise run the convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = Logger.parse(args)
    model_conf = opt["model"]
    if model_conf["unet"]["out_channel"] != model_conf["diffusion"]["channels"]:
        raise ValueError("model.unet.out_channel must equal model.diffusion.channels")

    root = logging.getLogger()
    handlers_before = list(root.handlers) + list(logging.getLogger("val").handlers)
    setup_logger(None, opt["path"]["log"], "train", level=logging.INFO, screen=True)
    setup_logger("val", opt["path"]["log"], "val", level=logging.INFO)
    logger = logging.getLogger("base")
    try:
        wandb_logger = None
        if opt["enable_wandb"]:
            from .utils.wandb_logger import WandbLogger

            wandb_logger = WandbLogger(opt, opt["path"]["experiment_root"],
                                       opt["experiment_name"])

        train_set, val_set = get_datasets(opt)
        logger.info("Initial Dataset Finished")
        diffusion = create_model(opt, device=device)
        logger.info("Initial Model Finished")
        if opt["path"]["resume_state"]:
            logger.info("Resuming training from epoch: %d, iter: %d.",
                        diffusion.begin_epoch, diffusion.begin_step)
        diffusion.set_new_noise_schedule(opt["model"]["beta_schedule"][opt["phase"]],
                                         schedule_phase=opt["phase"])
        out = {"opt": opt, "model": diffusion}
        if opt["phase"] == "train":
            out["val_psnrs"] = train(opt, diffusion, train_set, val_set, logger, wandb_logger)
        else:
            out["psnr"], out["ssim"] = evaluate(opt, diffusion, val_set, logger, wandb_logger)
        return out
    finally:
        # the handlers this run added (its log files), so that a second run in
        # one process logs once and leaves no file open
        for name in (None, "val"):
            lg = logging.getLogger(name)
            for h in list(lg.handlers):
                if h not in handlers_before:
                    lg.removeHandler(h)
                    h.close()


if __name__ == "__main__":
    main()
