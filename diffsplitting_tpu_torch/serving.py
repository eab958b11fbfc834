"""Serving surface for the splitting models (indi, joint_indi).

Counterparts: diffsplitting_tpu/train/factory.py `define_generator` (config ->
process and nets) and the serving part of
diffsplitting_tpu/train/trainer.py `DiffusionModel` (`test`). The nets are
held in the reference's diffusion-wrapper layout (`denoise_fn.*`, or
`indi1.denoise_fn.*` / `indi2.denoise_fn.*` plus three scalars), so one
`nets.load_state_dict(strict=True)` takes `utils.weights.state_dict_from_jax`, a
reference `*_gen.pth` or the JAX package's export.

The denoisers go through `models.apply_unet`: the UNet's own forward, or the
stat-carried fused forward when `fused` is True (None: as DSP_FUSED says,
the switch the JAX package reads).
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch
from torch import nn

from .device import resolve_device
from .diffusion import InDIProcess, JointInDIProcess
from .models import UNet, apply_unet


class InDINet(nn.Module):
    """The reference InDI wrapper's parameters: `denoise_fn.*`."""

    def __init__(self, unet: UNet):
        super().__init__()
        self.denoise_fn = unet


class JointInDINets(nn.Module):
    """The reference joint-InDI wrapper's parameters: two InDI nets and the
    logged-but-unused alpha/offset/scale scalars."""

    def __init__(self, unet_kw: Mapping):
        super().__init__()
        self.indi1 = InDINet(UNet(**unet_kw))
        self.indi2 = InDINet(UNet(**unet_kw))
        self.alpha_param = nn.Parameter(torch.zeros(()))
        self.offset_param = nn.Parameter(torch.zeros(()))
        self.scale_param = nn.Parameter(torch.ones(()))


def unet_kwargs(model_opt: Mapping) -> dict:
    unet = model_opt["unet"]
    return dict(
        in_channel=unet["in_channel"],
        out_channel=unet["out_channel"],
        inner_channel=unet["inner_channel"],
        norm_groups=unet.get("norm_groups") or 32,
        channel_mults=tuple(unet["channel_multiplier"]),
        attn_res=tuple(unet.get("attn_res") or ()),
        res_blocks=unet["res_blocks"],
        image_size=model_opt["diffusion"]["image_size"],
        cond_type="time",
        dropout=float(unet.get("dropout") or 0.0),
    )


def define_generator(opt: Mapping):
    """Config -> (process, nets module) for indi and joint_indi: the
    process carries the train T (`num_timesteps`) and the serving N
    (`val_num_timesteps`), the loss and the t-sampling strategy."""
    model_opt = opt["model"]
    which = model_opt["which_model_G"]
    if model_opt.get("compute_dtype") not in (None, "float32"):
        raise NotImplementedError(f"compute_dtype={model_opt['compute_dtype']!r} is not ported; "
                                  "the port computes in float32")
    indi_opt = model_opt.get("indi") or {}
    sched = model_opt["beta_schedule"]
    kw = dict(
        out_channel=model_opt["unet"]["out_channel"],
        e=indi_opt.get("e", 0.01),
        noise_mode=indi_opt.get("noise_mode", "gaussian"),
        num_timesteps=int(sched["train"]["n_timestep"]),
        val_num_timesteps=int(sched["val"]["n_timestep"]),
        loss_type=model_opt.get("loss_type") or "l1",
        lr_reduction=model_opt.get("lr_reduction"),
        conditional=bool((model_opt.get("diffusion") or {}).get("conditional")),
        t_sampling_mode=indi_opt.get("t_sampling_mode", "linear_indi"),
        linear_indi_a=indi_opt.get("linear_indi_a", 1.0),
    )
    if which == "indi":
        return InDIProcess(**kw), InDINet(UNet(**unet_kwargs(model_opt)))
    if which == "joint_indi":
        return (JointInDIProcess(**kw, w_input_loss=model_opt.get("w_input_loss") or 0.0,
                                 allow_full_translation=bool(
                                     model_opt.get("allow_full_translation", False))),
                JointInDINets(unet_kwargs(model_opt)))
    raise NotImplementedError(f"which_model_G={which!r} is not ported")


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights as the JAX package draws them
    (diffsplitting_tpu/models/blocks.py `conv_kwargs`): orthogonal
    matrices and kernels, zero conv and linear biases (torch's default would
    draw them uniform); norms (ones, zeros) and scalars keep their defaults."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                nn.init.orthogonal_(p, generator=generator)
            elif name.endswith(".bias"):
                p.zero_()


class SplittingModel:
    """Builds the nets from a config (random weights from `seed` until a state
    dict is loaded) and serves `test`. `fused` picks the UNet forward (see
    `models.apply_unet`); a call's own `fused` overrides it. `nets`, when
    given, is a nets module already on the device that is served as it is
    (the trainer's, or its EMA copy)."""

    def __init__(self, opt: Mapping, device=None, seed: int = 0,
                 fused: Optional[bool] = None, nets: Optional[nn.Module] = None):
        self.device = resolve_device(device)
        self.fused = fused
        self.which = opt["model"]["which_model_G"]
        self.process, built = define_generator(opt)
        if nets is None:
            init_weights(built, torch.Generator().manual_seed(seed))
            nets = built.to(self.device).eval()
        self.nets = nets
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.t_float_start = 0.5 if self.which == "joint_indi" else 1.0

    def unets(self):
        if self.which == "joint_indi":
            return self.nets.indi1.denoise_fn, self.nets.indi2.denoise_fn
        return (self.nets.denoise_fn,)

    def denoise_fns(self, fused: Optional[bool] = None):
        """(x, t) -> x̂0 for each UNet, through `apply_unet`."""
        fused = self.fused if fused is None else fused
        return tuple(functools.partial(apply_unet, net, fused=fused) for net in self.unets())

    @torch.inference_mode()
    def test(self, x_nhwc, t_float_start: Optional[float] = None,
             num_timesteps: Optional[int] = None, fused: Optional[bool] = None,
             continuous: bool = False) -> torch.Tensor:
        """Reverse process on an NHWC batch in `num_timesteps` steps (default:
        the config's serving N, `beta_schedule.val.n_timestep`); returns an
        NHWC tensor on the model's device (2 channels for joint_indi), or
        with `continuous` the trajectory (n_frames, B, H, W, C). The nets
        serve in eval mode (no dropout), as JAX's deterministic forward, and
        get their mode back after."""
        x = torch.as_tensor(x_nhwc, dtype=torch.float32).to(self.device)
        t0 = self.t_float_start if t_float_start is None else t_float_start
        n = self.process.val_num_timesteps if num_timesteps is None else num_timesteps
        was_training = self.nets.training
        self.nets.eval()
        try:
            return self.process.inference(*self.denoise_fns(fused), x, n, t0,
                                          generator=self.generator, continuous=continuous)
        finally:
            self.nets.train(was_training)
