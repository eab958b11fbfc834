"""Serving surface for the splitting models (indi, joint_indi), and the
config -> process and nets factory of every family.

Counterparts: diffsplitting_tpu/train/factory.py `define_generator` (config ->
process and nets, ddpm and sr3 included; their serving is the trainer's
`test` / `sample`, train/trainer.py) and the serving part of
diffsplitting_tpu/train/trainer.py `DiffusionModel` (`test`). The nets are
held in the reference's diffusion-wrapper layout (`denoise_fn.*`, or
`indi1.denoise_fn.*` / `indi2.denoise_fn.*` plus three scalars), so one
`nets.load_state_dict(strict=True)` takes `utils.weights.state_dict_from_jax`, a
reference `*_gen.pth` or the JAX package's export.

The denoisers go through `models.apply_unet`: the UNet's own forward, or the
stat-carried fused forward when `fused` is True (None: as DSP_FUSED says,
the switch the JAX package reads).

Two opt-in serving accelerators for InDI, as the JAX `DiffusionModel` offers
them (`AcceleratorSwitches`: `set_deepcache`, `set_sliding_window`, the config
keys `model.deepcache {interval, depth}` and `model.sliding_window {window,
tau}`; `model.ddim` is read and, as in JAX, ignored: InDI respaces through
`num_timesteps`):
  * DeepCache (diffusion/deepcache.py): the full UNet every `interval`-th
    step, the shallow levels in between; 'auto' picks the interval from the
    chain length. The cached walk runs the UNet's unfused modules whatever
    `fused` says, as JAX's cached apply does;
  * the sliding window (diffusion/parallel_sampling.py): W steps a sweep as
    one (W·B)-batch forward through `denoise_fns(fused)`; τ = 0 is the exact
    chain. `last_sliding_sweeps` holds the last call's sweeps.
They exclude each other; a trajectory request (`continuous`) serves the exact
chain, with one warning.

W8A8 quantized serving (`set_quant`, the config key `model.quant {bits,
calib, updown, shortcut, attn, clip}`; JAX's `set_quant`, `_calib_inputs`,
`_maybe_quantize`) swaps the nets, not the chain: a call serves the W8A8
copies of its UNets (models/quant_unet.py), built once per (nets, kind) after
one calibration forward (`indi_calib_inputs`, `sr_calib_inputs`), unfused
whatever `fused` says, and composes with both accelerators and DDIM.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .diffusion import DDPMProcess, InDIProcess, JointInDIProcess, SR3Process
from .diffusion.deepcache import (cached_indi_inference, cached_joint_indi_inference,
                                  make_cached_denoisers)
from .diffusion.parallel_sampling import (indi_inference_sliding_window,
                                          joint_indi_inference_sliding_window)
from .models import UNet, apply_unet, fused_enabled
from .models.precision import compute_dtype

logger = logging.getLogger("base")


class InDINet(nn.Module):
    """The reference one-UNet wrapper's parameters: `denoise_fn.*` (indi,
    ddpm, sr3; the ddpm / sr3 schedule buffers are not held)."""

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


def unet_kwargs(model_opt: Mapping, cond_type: str = "time",
                use_affine_level: bool = False) -> dict:
    """The UNet of a config's `model` section, conditioned by `cond_type`
    ('time' for ddpm / indi / joint_indi, 'noise_level' for sr3), with the
    compute dtype (`compute_dtype`), `remat` and `remat_min_res`, as JAX's
    factory reads them (train/factory.py `_unet_kwargs`). The JAX factory
    leaves `use_affine_level` at the module's default, False."""
    unet = model_opt["unet"]
    return dict(
        dtype=compute_dtype(model_opt),
        remat=bool(model_opt.get("remat", False)),
        remat_min_res=int(model_opt.get("remat_min_res") or 0),
        in_channel=unet["in_channel"],
        out_channel=unet["out_channel"],
        inner_channel=unet["inner_channel"],
        norm_groups=unet.get("norm_groups") or 32,
        channel_mults=tuple(unet["channel_multiplier"]),
        attn_res=tuple(unet.get("attn_res") or ()),
        res_blocks=unet["res_blocks"],
        image_size=model_opt["diffusion"]["image_size"],
        cond_type=cond_type,
        dropout=float(unet.get("dropout") or 0.0),
        use_affine_level=use_affine_level,
    )


def check_compute_dtype(model_opt: Mapping) -> None:
    """Raise on a `compute_dtype` the JAX package does not take (it takes
    float32, the default, and bfloat16)."""
    compute_dtype(model_opt)


def define_generator(opt: Mapping):
    """Config -> (process, nets module). ddpm (cond_type 'time') and sr3
    ('noise_level'): the process carries the image size, channels, loss
    (`loss_type`, default 'l1') and conditioning; its schedule is the
    trainer's. indi and joint_indi: the process carries the train T
    (`num_timesteps`) and the serving N (`val_num_timesteps`), the loss and
    the t-sampling strategy."""
    model_opt = opt["model"]
    which = model_opt["which_model_G"]
    check_compute_dtype(model_opt)
    if which in ("ddpm", "sr3"):
        diffusion_opt = model_opt["diffusion"]
        cls, cond_type = (DDPMProcess, "time") if which == "ddpm" else (SR3Process, "noise_level")
        process = cls(image_size=int(diffusion_opt["image_size"]),
                      channels=int(diffusion_opt["channels"]),
                      loss_type=model_opt.get("loss_type") or "l1",
                      lr_reduction=model_opt.get("lr_reduction"),
                      conditional=bool(diffusion_opt["conditional"]))
        return process, InDINet(UNet(**unet_kwargs(model_opt, cond_type)))
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


CALIB_SEED = 0xCA11B  # the calibration noise's seed (JAX's PRNGKey)


def calib_noise(shape, device, eps=None):
    """The calibration draw: `eps` when given (the tests inject JAX's), else
    a standard normal from a generator seeded `CALIB_SEED` (torch cannot
    replay JAX's threefry)."""
    if eps is not None:
        return torch.tensor(np.asarray(eps), dtype=torch.float32, device=device).reshape(shape)
    gen = torch.Generator(device=device).manual_seed(CALIB_SEED)
    return torch.randn(shape, generator=gen, device=device)


def indi_calib_inputs(process, in_channel: int, cond, K: int, device, eps=None):
    """The calibration batch of an InDI denoiser (JAX's `_calib_inputs`): the
    serving input `cond` (1, H, W, C), tiled on channels to `in_channel`,
    noised at the bridge's e(t) for K values of t in (0, 1] (t = k / K);
    returns (x, t), K rows; noise from `calib_noise`."""
    K = max(2, int(K))
    cond = cond.to(device, torch.float32)
    if cond.shape[-1] != in_channel:
        if in_channel % cond.shape[-1]:
            raise ValueError(f"input of {cond.shape[-1]} channels for a UNet of {in_channel}")
        cond = cond.repeat(1, 1, 1, in_channel // cond.shape[-1])
    tvals = np.linspace(1.0 / K, 1.0, K).astype(np.float32)
    scale = torch.tensor([float(process.get_t_times_e(t)) for t in tvals], device=device)
    eps = calib_noise((K,) + tuple(cond.shape[1:]), device, eps)
    return cond + eps * scale[:, None, None, None], torch.from_numpy(tvals).to(device)


def sr_calib_inputs(which: str, process, sched, kind: str, K: int, cond, device, eps=None):
    """The calibration batch of a DDPM / SR3 denoiser (JAX's
    `_calib_inputs`): x_t = γ·x0 + √(1−γ²)·ε at the steps linspace(0, T−1, K)
    of `sched` (γ = √ᾱ_{t+1}), x0 the condition `cond` (1, H, W, C) where it
    has the sample's channels, else zeros; a conditional 'test' call puts
    the condition before x_t, as the chain does. The net's t is γ (sr3) or
    the step (ddpm). Noise from `calib_noise`."""
    T = sched.num_timesteps
    ts = np.unique(np.linspace(0, T - 1, max(2, int(K))).astype(np.int64))
    gam = sched.sqrt_alphas_cumprod_prev.detach().cpu().numpy()[ts + 1]
    ch = process.channels
    use_cond = process.conditional and kind == "test" and cond is not None
    if use_cond:
        cond = cond.to(device, torch.float32)
        h, w = cond.shape[1], cond.shape[2]
    else:
        h = w = process.image_size
    x0 = cond if use_cond and cond.shape[-1] == ch else torch.zeros(1, h, w, ch, device=device)
    eps = calib_noise((len(ts), h, w, ch), device, eps)
    g = torch.from_numpy(gam.astype(np.float32)).to(device)
    x_t = g[:, None, None, None] * x0 + torch.sqrt(1.0 - g * g)[:, None, None, None] * eps
    net_in = torch.cat([cond.expand(len(ts), -1, -1, -1), x_t], dim=-1) if use_cond else x_t
    t = g if which == "sr3" else torch.from_numpy(ts.astype(np.float32)).to(device)
    return net_in, t


class AcceleratorSwitches:
    """The opt-in serving accelerators of a model, switched as JAX's
    `DiffusionModel` switches them: `set_deepcache(interval, depth)`,
    `set_sliding_window(window, tau)`, `set_ddim(steps, eta)`, `set_quant(bits,
    ...)` (None or 0 restores the exact chain), or the config keys
    `model.deepcache {interval, depth}`, `model.sliding_window {window,
    tau}`, `model.ddim {steps, eta}` and `model.quant {bits, calib, updown,
    shortcut, attn, clip}`. DDIM respaces only a DDPM / SR3 chain (InDI takes
    its step count from `num_timesteps`) and composes with DeepCache; the
    sliding window excludes both. A trajectory request (`continuous`) serves
    the exact chain, with one warning for each accelerator that is on.
    W8A8 (`quant`) changes the nets, not the chain, so it composes with all
    three and with trajectories. `last_sliding_sweeps` holds the last
    windowed chain's sweeps."""

    def __init__(self, model_opt: Mapping):
        dc_opt = model_opt.get("deepcache") or {}
        self.set_deepcache(dc_opt.get("interval"), dc_opt.get("depth") or 1)
        sw_opt = model_opt.get("sliding_window") or {}
        tau = sw_opt.get("tau")
        self.set_sliding_window(sw_opt.get("window"), 0.1 if tau is None else tau)
        dd_opt = model_opt.get("ddim") or {}
        eta = dd_opt.get("eta")
        self.set_ddim(dd_opt.get("steps"), 0.0 if eta is None else eta)
        q_opt = model_opt.get("quant") or {}
        self.set_quant(q_opt.get("bits"), int(q_opt.get("calib") or 8),
                       bool(q_opt.get("updown", False)), bool(q_opt.get("shortcut", False)),
                       bool(q_opt.get("attn", False)), float(q_opt.get("clip") or 1.0))
        self.last_sliding_sweeps = None
        self.last_calibration_s = None
        self._warned_continuous = set()
        self._warned_quant_fused = False

    def set_deepcache(self, interval, depth: int = 1):
        """DeepCache serving: the full UNet every `interval`-th step ('auto':
        from the chain length, `dc_interval`), split at `depth`; None or 0
        restores the exact chain."""
        if interval:
            self.deepcache = (interval if interval == "auto" else int(interval), int(depth))
        else:
            self.deepcache = None

    def set_sliding_window(self, window, tau: float = 0.1):
        """Sliding-window serving: `window` steps a sweep, advancing past
        steps that moved by at most tau·σ² (0: the exact chain); None or 0
        restores the exact chain."""
        self.sliding_window = (int(window), float(tau)) if window else None

    def set_ddim(self, steps, eta: float = 0.0):
        """Respaced DDIM serving of a DDPM / SR3 chain in `steps` steps at
        `eta`; None or 0 restores the exact chain."""
        self.ddim = (int(steps), float(eta)) if steps else None

    def set_quant(self, bits, calib: int = 8, updown: bool = False, shortcut: bool = False,
                  attn: bool = False, clip: float = 1.0):
        """W8A8 quantized serving (models/quant_unet.py): the nets of a
        `test` / `sample` call are quantized once, after a calibration
        forward of `calib` rows spanning the chain (`indi_calib_inputs`,
        `sr_calib_inputs`), at the
        ResnetBlocks' Block convs, plus the Down/Upsample and 1×1 shortcut
        convs (`updown`, `shortcut`) and the attention block's 1×1 convs
        (`attn`); `clip` scales the calibrated activation range. Only 8 bits;
        None or 0 restores the exact forward. Drops the quantized nets."""
        if bits:
            if int(bits) != 8:
                raise ValueError("set_quant: only 8-bit is supported")
            self.quant = dict(calib=int(calib), updown=bool(updown), shortcut=bool(shortcut),
                              attn=bool(attn), clip=float(clip))
        else:
            self.quant = None
        self.drop_quant_cache()

    def drop_quant_cache(self):
        """Forget the quantized nets: they are stale once the weights change
        (a train step, an EMA update, a load)."""
        self._quant_nets = {}

    def quantized_unets(self, unets, kind: str, calib):
        """The W8A8 copies of `unets` for a `kind` ('test' or 'sample') call,
        built once per (source nets, kind) as JAX's `_maybe_quantize` does:
        `calib(i)` gives UNet i's calibration batch (x, t);
        `last_calibration_s` the host seconds of the last build."""
        from .models.quant_unet import (collect_act_absmax, iter_quant_sites,
                                        quantize_unet)

        key = (kind,) + tuple(id(u) for u in unets)
        hit = self._quant_nets.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], unets)):
            return hit[1]
        q, t0, out = self.quant, time.perf_counter(), []
        for i, unet in enumerate(unets):
            x, t = calib(i)
            stats = collect_act_absmax(unet, x, t)
            out.append(quantize_unet(unet, stats, updown=q["updown"], shortcut=q["shortcut"],
                                     attn=q["attn"], clip_ratio=q["clip"]))
            logger.info("W8A8: quantized UNet %d of %d (%d int8 conv sites, calib batch %d)",
                        i + 1, len(unets), sum(1 for _ in iter_quant_sites(out[-1])),
                        x.shape[0])
        self.last_calibration_s = time.perf_counter() - t0
        self._quant_nets[key] = (tuple(unets), tuple(out))
        return tuple(out)

    def serving_fused(self, fused: Optional[bool]) -> Optional[bool]:
        """`fused` as served: a W8A8 net runs its own unfused forward (JAX's
        `_apply` takes the int8 walker before the fused switch), so with
        `quant` on a fused request (`fused`, or DSP_FUSED=1 when None) is
        served unfused, logged once."""
        if self.quant is None:
            return fused
        if (fused_enabled() if fused is None else fused) and not self._warned_quant_fused:
            logger.info("W8A8: the quantized nets serve through their own unfused forward; "
                        "the fused walk (DSP_FUSED=1 / fused=True) is not taken")
            self._warned_quant_fused = True
        return False

    def dc_interval(self, T: int) -> int:
        """The refresh interval of a T-step chain: 'auto' is
        clamp(round(0.4·T), 1, 5), as JAX's `_dc_interval` resolves it."""
        iv = self.deepcache[0]
        return max(1, min(5, round(0.4 * T))) if iv == "auto" else iv

    def accelerators(self, continuous: bool, respaces: bool) -> frozenset:
        """The accelerators a call runs: a subset of {'ddim', 'deepcache',
        'sliding_window'}, empty for the exact chain; 'ddim' only where the
        chain `respaces`."""
        on = [name for name in ("ddim", "deepcache", "sliding_window")
              if getattr(self, name) and (respaces or name != "ddim")]
        if on and continuous:
            for name in set(on) - self._warned_continuous:
                logger.warning("%s ignores continuous=True sampling; running the exact chain "
                               "for trajectory requests", name)
                self._warned_continuous.add(name)
            return frozenset()
        if "sliding_window" in on and len(on) > 1:
            raise ValueError("model.sliding_window is mutually exclusive with model.deepcache / "
                             "model.ddim (different chain semantics): unset all but one "
                             "(set_deepcache(None) / set_sliding_window(None) / set_ddim(None)); "
                             "DeepCache and DDIM do compose")
        return frozenset(on)


class SplittingModel(AcceleratorSwitches):
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
        super().__init__(opt["model"])

    def unets(self):
        if self.which == "joint_indi":
            return self.nets.indi1.denoise_fn, self.nets.indi2.denoise_fn
        return (self.nets.denoise_fn,)

    def served_unets(self, x):
        """The UNets a `test` on the NHWC batch x serves: their W8A8 copies
        when `quant` is on (calibrated on x's first tile), else `unets()`."""
        unets = self.unets()
        if self.quant is None:
            return unets
        process = self.process
        procs = (process.indi1, process.indi2) if self.which == "joint_indi" else (process,)
        return self.quantized_unets(unets, "test", lambda i: indi_calib_inputs(
            procs[i], unets[i].in_channel, x[:1], self.quant["calib"], self.device))

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
        get their mode back after. With DeepCache on, `fused` is not read.
        Raises ValueError when DeepCache and the sliding window are both on."""
        x = torch.as_tensor(x_nhwc, dtype=torch.float32).to(self.device)
        t0 = self.t_float_start if t_float_start is None else t_float_start
        n = self.process.val_num_timesteps if num_timesteps is None else num_timesteps
        on = self.accelerators(continuous, respaces=False)
        accelerator = next(iter(on)) if on else None
        joint = self.which == "joint_indi"
        was_training = self.nets.training
        self.nets.eval()
        try:
            unets = self.served_unets(x)
            fused = self.serving_fused(self.fused if fused is None else fused)
            fns = tuple(functools.partial(apply_unet, net, fused=fused) for net in unets)
            if accelerator == "deepcache":
                appliers = [make_cached_denoisers(net, self.deepcache[1]) for net in unets]
                kw = dict(interval=self.dc_interval(n), num_timesteps=n, t_float_start=t0,
                          generator=self.generator)
                if joint:
                    return cached_joint_indi_inference(self.process, x, *appliers, **kw)
                return cached_indi_inference(self.process, x, *appliers[0], **kw)
            if accelerator == "sliding_window":
                window, tau = self.sliding_window
                sampler = (joint_indi_inference_sliding_window if joint
                           else indi_inference_sliding_window)
                out, self.last_sliding_sweeps = sampler(
                    self.process, *fns, x, n, t0, window, tau, generator=self.generator)
                return out
            return self.process.inference(*fns, x, n, t0, generator=self.generator,
                                          continuous=continuous)
        finally:
            self.nets.train(was_training)
