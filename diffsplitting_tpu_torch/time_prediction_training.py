"""Training CLI of the time predictor (the mixing-fraction regressor).

Counterpart: the repository's top-level time_prediction_training.py
(`get_datasets`, `ReduceLROnPlateau`, `start_training`):

  python -m diffsplitting_tpu_torch.time_prediction_training \\
      [--config configs/splitting_hagen_time_predictor.json] [--rootdir ./experiments] \\
      [-enable_wandb] [--device cpu]

Adam with optax's defaults at `train.optimizer.lr`, halved by a
reduce-on-plateau rule (patience `train.lr_scheduler_patience`, default 15;
floor 1e-6) stepped on each epoch's mean train loss; the loss is the mean
squared (`loss_type` l2) or absolute (l1) error of the predicted t. After each
epoch a validation pass over the val set (batches of the train batch size,
the last partial one dropped); when that yields no batch, the train epoch
loss stands in. The best validation loss writes
`<experiment_root>/best_time_predictor_gen.pth` (the `TimePredictor` state
dict) and `_opt.pth` (epoch, iter, the Adam state, the lr) through
`train/checkpoints.py`.

Weights are seeded as the port's other nets (`serving.init_weights`). The
train forward applies the config's dropout, its masks drawn from one seeded
device generator; validation runs in eval mode. JAX's `train.dropout_prng`
(an `rbg` key, a choice of the TPU's RNG) has no counterpart here.

The device is the card unless `--device` (or `device=`) says otherwise;
without CUDA the CLI raises unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Mapping, Optional

import numpy as np
import torch

from .config import dict_to_nonedict, load_json
from .data import NumpyLoader, TimePredictorDataset
from .data.split_dataset import DataLocation
from .device import resolve_device
from .models import TimePredictor, set_dropout_generator
from .serving import init_weights
from .train.checkpoints import resolve_checkpoint, save_checkpoint
from .train.optim import optax_adam
from .utils import get_workdir, mkdirs

logger = logging.getLogger("base")

BEST_PREFIX = "best_time_predictor"


def get_datasets(opt):
    """The (train, val) TimePredictorDataset pair of a config."""
    dsets = opt["datasets"]
    patch_size = dsets["patch_size"]
    max_qval = dsets["max_qval"]
    channel_weights = dsets.get("channel_weights")
    upper_clip = bool(dsets.get("upper_clip", False))
    gaussian_noise = dsets["train"].get("gaussian_noise_std_factor")
    raw_mixture = bool(dsets["train"].get("raw_mixture_inputs", False))

    train_loc = DataLocation(
        channelwise_fpath=(dsets["train"]["datapath"]["ch0"], dsets["train"]["datapath"]["ch1"]))
    val_loc = DataLocation(
        channelwise_fpath=(dsets["val"]["datapath"]["ch0"], dsets["val"]["datapath"]["ch1"]))
    train_set = TimePredictorDataset(
        "Hagen", train_loc, patch_size,
        max_qval=max_qval, upper_clip=upper_clip,
        channel_weights=channel_weights,
        uncorrelated_channels=bool(dsets["train"].get("uncorrelated_channels", False)),
        enable_transforms=True, random_patching=True,
        gaussian_noise_std_factor=gaussian_noise,
        raw_mixture_inputs=raw_mixture,
    )
    val_set = TimePredictorDataset(
        "Hagen", val_loc, patch_size,
        normalization_dict=train_set.get_normalization_dict(),
        max_qval=max_qval, upper_clip=upper_clip,
        channel_weights=channel_weights,
        enable_transforms=False, random_patching=False,
        raw_mixture_inputs=raw_mixture,
    )
    return train_set, val_set


class ReduceLROnPlateau:
    """Halve the lr after more than `patience` epochs without improvement."""

    def __init__(self, lr, patience, factor=0.5, min_lr=1e-6):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad = 0

    def step(self, metric) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


def build_time_predictor(opt: Mapping, seed: int = 0) -> TimePredictor:
    """A TimePredictor from the config's `model.unet` and patch size with
    seeded weights (on the CPU)."""
    u = opt["model"]["unet"]
    # the modules' default init draws from the global RNG before init_weights
    # replaces it: fork it, so `seed` alone fixes the weights
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = TimePredictor(
            in_channel=u["in_channel"], out_channel=u["out_channel"],
            inner_channel=u["inner_channel"], norm_groups=u.get("norm_groups") or 32,
            channel_mults=tuple(u["channel_multiplier"]), attn_res=tuple(u.get("attn_res") or ()),
            res_blocks=u["res_blocks"], dropout=float(u.get("dropout") or 0.0),
            image_size=opt["datasets"]["patch_size"])
    init_weights(net, torch.Generator().manual_seed(seed))
    return net


def load_time_predictor(opt: Mapping, resume: str, device) -> TimePredictor:
    """The TimePredictor of `opt` in eval mode (so its dropout is the
    identity) on `device`, with the weights of a `.pth` file or of a
    checkpoint prefix's `_gen.pth`."""
    gen_path, _ = resolve_checkpoint(resume)
    net = build_time_predictor(opt)
    net.load_state_dict(torch.load(gen_path, map_location="cpu", weights_only=True),
                        strict=True)
    return net.to(device).eval()


def time_loss(pred, y, loss_type: str):
    if loss_type == "l1":
        return (pred - y).abs().mean()
    return ((pred - y) ** 2).mean()


def train_step(net, optimizer, x, y, loss_type: str):
    """One Adam step of `net` (in train mode) on a batch; returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = time_loss(net(x), y, loss_type)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_loss(net, x, y, loss_type: str):
    """The loss of the deterministic forward (eval mode) on a batch."""
    was_training = net.training
    net.eval()
    try:
        return time_loss(net(x), y, loss_type)
    finally:
        net.train(was_training)


def start_training(opt, max_epochs=None, steps_per_epoch=None, device=None, seed: int = 0):
    """Train as the config says; returns (net, best validation loss)."""
    device = resolve_device(device)
    wandb_logger = None
    if opt.get("enable_wandb"):
        from .utils.wandb_logger import WandbLogger

        wandb_logger = WandbLogger(opt, opt["path"]["experiment_root"], opt["experiment_name"])

    train_set, val_set = get_datasets(opt)
    model_opt = opt["model"]
    net = build_time_predictor(opt, seed).to(device).train()
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(net, generator)

    loss_type = model_opt["loss_type"]
    base_lr = float(opt["train"]["optimizer"]["lr"])
    lr_state = ReduceLROnPlateau(base_lr, int(opt["train"].get("lr_scheduler_patience") or 15))
    optimizer = optax_adam(net.parameters(), base_lr)

    bs = opt["datasets"]["train"]["batch_size"]
    train_loader = NumpyLoader(train_set, batch_size=bs, shuffle=True, drop_last=True)
    val_loader = NumpyLoader(val_set, batch_size=bs, shuffle=False, drop_last=True)

    def on_device(a):
        return torch.from_numpy(np.asarray(a)).to(device, torch.float32)

    num_epochs = int(max_epochs or opt["train"]["num_epochs"])
    best_val_loss = 1e6
    step = 0
    for epoch in range(num_epochs):
        losses = []
        for bi, (x, y) in enumerate(train_loader):
            if steps_per_epoch and bi >= steps_per_epoch:
                break
            step += 1
            losses.append(train_step(net, optimizer, on_device(x), on_device(y), loss_type))
            if wandb_logger is not None:
                wandb_logger.log_metrics({"train_loss_step": float(losses[-1])})
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

        val_losses = []
        for bi, (x, y) in enumerate(val_loader):
            if steps_per_epoch and bi >= steps_per_epoch:
                break
            val_losses.append(float(eval_loss(net, on_device(x), on_device(y), loss_type)))
        if val_losses:
            val_loss = float(np.mean(val_losses))
        else:
            # the val set is smaller than one batch (drop_last): the train
            # epoch loss stands in, so a best checkpoint is still written
            logger.warning("validation loader is empty (val set < batch size); using "
                           "train loss for best-model selection")
            val_loss = train_loss
        logger.info("Ep:%d loss %.5f val_loss %.5f lr %.2e", epoch, train_loss, val_loss,
                    lr_state.lr)
        if wandb_logger is not None:
            wandb_logger.log_metrics({"val_loss": val_loss})

        # reduce-on-plateau on the train epoch loss, read at the next update
        new_lr = lr_state.step(train_loss)
        for group in optimizer.param_groups:
            group["lr"] = new_lr

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            save_checkpoint(opt["path"]["experiment_root"], BEST_PREFIX, net.state_dict(),
                            {"epoch": epoch, "iter": step, "optimizer": optimizer.state_dict(),
                             "lr": lr_state.lr, "val_loss": val_loss})
            logger.info("Saved best model %s",
                        os.path.join(opt["path"]["experiment_root"], BEST_PREFIX + "_gen.pth"))
    return net, best_val_loss


def main(argv: Optional[list] = None) -> dict:
    """Runs the CLI; returns {'opt', 'net', 'best_val_loss', 'checkpoint'}
    (the best checkpoint's prefix)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="configs/splitting_hagen_time_predictor.json")
    parser.add_argument("--rootdir", type=str, default="./experiments")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    # f32 throughout, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = load_json(args.config)
    opt["enable_wandb"] = args.enable_wandb
    experiment_root, expname = get_workdir(opt, args.rootdir)
    opt["path"]["experiment_root"] = experiment_root
    opt["experiment_name"] = expname
    for key, path in list(opt["path"].items()):
        if "resume" not in key and "experiments" not in key and key != "experiment_root":
            opt["path"][key] = os.path.join(experiment_root, path)
            mkdirs(opt["path"][key])
    logging.basicConfig(level=logging.INFO)
    opt = dict_to_nonedict(opt)
    net, best = start_training(opt, device=device)
    return {"opt": opt, "net": net, "best_val_loss": best,
            "checkpoint": os.path.join(experiment_root, BEST_PREFIX)}


if __name__ == "__main__":
    main()
