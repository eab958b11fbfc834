"""The train step and serving of every family (indi, joint_indi, ddpm, sr3).

Counterpart: diffsplitting_tpu/train/trainer.py `DiffusionModel`
(construction, `set_new_noise_schedule`, `feed_data`, `optimize_parameters`,
`get_current_log`, `test`, `sample`, `get_current_visuals`).

One step: the process's `p_losses` through the UNet's own forward
(`net(x, t)`, whatever DSP_FUSED says: the JAX package trains through
`net.apply` and never through the fused walk), autograd (through the plain
versions of the GroupNorm+Swish and attention kernels, as the JAX custom VJPs
recompute through their jnp references), the pre-clip global gradient norm,
then, on an update: clipping, Adam with optax's defaults (betas 0.9 and
0.999, eps 1e-8) at the scheduled LR, and, when `train.ema_scheduler.enabled`,
the EMA of every parameter on every micro-step (exact tracking while the step
is below `step_start_ema`, `ema_decay` after).

t and the noise (and sr3's γ) come from one device `torch.Generator` seeded
by `seed`; `optimize_parameters(draws=...)` injects them instead, which the
parity tests use to replay the JAX draws. ddpm and sr3 train through their
process's `p_losses` on the schedule of the current phase
(`set_new_noise_schedule` builds it, as JAX rebuilds its schedule pytree).
With `unet.dropout` > 0 the train forward drops
out after the second GroupNorm+Swish of each ResnetBlock, as the JAX train
forward does (`deterministic=False`), with masks drawn from the same
generator in the order the forward reaches them; at rate 0 nothing more is
drawn. JAX's `train.dropout_prng` (an `rbg` key for the TPU's RNG) has no
counterpart here.

Checkpoints (`save_network`, `load_network`; `train/checkpoints.py`): the
`I{iter}_E{epoch}_gen.pth` / `_opt.pth` pair, resumed by prefix from
`path.resume_state` at construction, as JAX does. A `.pth` file, or a prefix
without `_opt.pth`, loads the weights only; outside the train phase only the
weights are read.

Serving (`test`, `inference`, `get_current_visuals`): the reverse process on
the fed input, with the trajectory when `continuous`; visuals are NHWC
numpy, as JAX gives them. indi and joint_indi serve through
`SplittingModel.test`. Conditional ddpm and sr3 serve `test` through their
process's `p_sample_loop` over the current phase's schedule, unconditional
ones `sample`; the nets serve in eval mode (no dropout), through
`models.apply_unet` (DSP_FUSED=1 or `fused=True`: the fused walk), with
noise from a generator of their own seeded by `seed`.

The serving accelerators switch as in JAX (`serving.AcceleratorSwitches`:
the config keys `model.deepcache`, `model.sliding_window`, `model.ddim`, or
`set_deepcache` / `set_sliding_window` / `set_ddim`), and the EMA nets, when
on, serve through them too. For ddpm / sr3 (`_sr_chain`): respaced DDIM
(diffusion/ddim.py), DeepCache over the T-step chain or over DDIM's S steps
('auto' resolved over that length), the sliding window
(diffusion/parallel_sampling.py; `last_sliding_sweeps`). DDIM and the window
go through `models.apply_unet`, so `fused` and DSP_FUSED apply; the cached
walks run the UNet's own unfused modules, as JAX's `_cached_apply` does.
DDIM is ignored for indi / joint_indi, which respace through
`num_timesteps`.

Compute dtype and remat (`model.compute_dtype`, `model.remat`,
`model.remat_min_res`): the UNet computes in bf16 where the config says so,
with its parameters, Adam's moments, the EMA and the gradients in float32
(the casts at each Conv/Linear carry the gradients back to the f32
parameters) and the loss in float32 on the UNet's f32 output, as in JAX;
remat rematerializes the UNet's blocks in the backward (models/unet.py).
DSP_PRECAST=1 serves from a copy whose Conv/Linear weights are cast once a
call (`_inference_nets`, JAX's `_inference_params`).

W8A8 quantized serving (`model.quant {bits, calib, updown, shortcut, attn,
clip}` or `set_quant`, `serving.AcceleratorSwitches`): a chain serves the
W8A8 copies of the inference nets (models/quant_unet.py; in place of the
DSP_PRECAST copy, as JAX's `_serving_params`), built once per nets and kind
('test', 'sample') after a calibration forward, and dropped after a train
step, an EMA update or a load. A quantized net serves through its own
unfused forward even at DSP_FUSED=1 or `fused=True` (logged once), as JAX's
`_apply` does; DDIM, DeepCache and the window compose with it.

On one device, `train.optimizer.zero` and `model.param_sharding` (JAX's
ZeRO-1 Adam moments and FSDP parameters over the 'data' mesh axis) are the
no-ops they are on a one-device mesh and are not read; sharding across cards
is ROADMAP item 1h.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import logging
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import JointInDIProcess, build_ddpm_schedule
from ..diffusion.ddim import ddim_sample_loop, ddim_timesteps
from ..diffusion.deepcache import (cached_ddim_sample_loop, cached_p_sample_loop,
                                   make_cached_denoisers)
from ..diffusion.parallel_sampling import ddpm_sample_sliding_window
from ..models import apply_unet
from ..models.blocks import set_dropout_generator
from ..models.precision import cast_unet_params_for_inference, precast_enabled
from ..serving import (AcceleratorSwitches, SplittingModel, define_generator, init_weights,
                       sr_calib_inputs)
from ..utils.weights import load_reference_checkpoint
from .checkpoints import load_trainer_state, resolve_checkpoint, save_checkpoint
from .clipping import global_norm, make_clip
from .optim import make_lr, optax_adam

logger = logging.getLogger("base")

SR_FAMILIES = ("ddpm", "sr3")


def create_model(opt: Mapping, **kwargs) -> "DiffusionModel":
    m = DiffusionModel(opt, **kwargs)
    logger.info("Model [%s] is created.", m.__class__.__name__)
    return m


class DiffusionModel:
    """Builds the nets from a config (seeded random weights, or `state_dict`
    in the port's layout, e.g. from `utils.weights.state_dict_from_jax`) and
    trains them."""

    def __init__(self, opt: Mapping, device=None, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.opt = opt
        self.device = resolve_device(device)
        self.phase = opt.get("phase") or "train"
        model_opt = opt["model"]
        self.which = model_opt["which_model_G"]
        if self.which not in ("indi", "joint_indi") + SR_FAMILIES:
            raise NotImplementedError(f"which_model_G={self.which!r} is not recognized")
        if model_opt.get("finetune_norm"):
            # the JAX package trains only the parameters whose path holds
            # 'transformer' and raises when none does; no UNet has one
            raise ValueError("finetune_norm matched no trainable parameters "
                             "(no param path contains 'transformer')")
        # the modules' default init draws from the global RNG before
        # init_weights replaces it: fork it, so building a model leaves the
        # caller's stream alone and `seed` alone fixes the weights
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.process, nets = define_generator(opt)
        init_weights(nets, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            nets.load_state_dict(state_dict, strict=True)
        self.nets = nets.to(self.device).train()
        self.params = [p for p in self.nets.parameters()]

        train_opt = opt.get("train") or {}
        opt_cfg = train_opt.get("optimizer") or {}
        self.lr = make_lr(float(opt_cfg.get("lr") or 1e-4), opt_cfg.get("schedule"),
                          int(train_opt.get("n_iter") or 0))
        self.optimizer = optax_adam(self.params, self.lr(0))
        self.clip = make_clip(opt_cfg)
        self.accum_steps = max(int(opt_cfg.get("accum_steps") or 1), 1)
        self._acc = None  # running mean of the micro-steps' gradients
        self._mini_step = 0
        self.updates = 0

        ema_opt = train_opt.get("ema_scheduler") or {}
        self.use_ema = bool(ema_opt.get("enabled", False))
        self.ema_decay = float(ema_opt.get("ema_decay", 0.9999))
        self.ema_start = int(ema_opt.get("step_start_ema", 5000))
        # seeded from the params as loaded (load_network reseeds or restores it)
        self.ema_nets = copy.deepcopy(self.nets).requires_grad_(False) if self.use_ema else None
        self.global_step = 0
        self.begin_step = 0
        self.begin_epoch = 0

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_dropout_generator(self.nets, self.generator)
        self.log_dict = OrderedDict()
        self.data = None
        self.prediction = None
        self.schedule_phase = None
        self.current_T = None
        self.current_sched = None
        self.set_new_noise_schedule(model_opt["beta_schedule"]["train"], "train")
        if self.which in SR_FAMILIES:
            self._server = None
            self.sample_generator = torch.Generator(device=self.device).manual_seed(seed)
            self.switches = AcceleratorSwitches(model_opt)
        else:
            self._server = SplittingModel(opt, self.device, seed, nets=self.nets)
            self.switches = self._server
        self.load_network()

    def set_new_noise_schedule(self, schedule_opt: Mapping, schedule_phase: str = "train"):
        """Switch to the phase's schedule: ddpm and sr3 build it on the
        device; InDI and joint-InDI only track its step count T."""
        if self.schedule_phase == schedule_phase:
            return
        self.schedule_phase = schedule_phase
        self.current_T = int(schedule_opt["n_timestep"])
        if self.which in SR_FAMILIES:
            self.current_sched = build_ddpm_schedule(schedule_opt).to(self.device)

    def feed_data(self, data: Mapping):
        """NHWC numpy arrays or tensors -> float32 tensors on the device (a
        tensor already there, e.g. a device-pool batch, is taken as it is)."""
        self.data = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
                     .to(self.device, torch.float32) for k, v in data.items()}

    def unets(self):
        if self.which == "joint_indi":
            return self.nets.indi1.denoise_fn, self.nets.indi2.denoise_fn
        return (self.nets.denoise_fn,)

    def _loss(self, draws):
        fns = self.unets()
        if self.which == "ddpm":
            t, noise = draws[0] if draws is not None else (None, None)
            return self.process.p_losses(fns[0], self.current_sched, self.data, self.generator,
                                         t, noise), {}
        if self.which == "sr3":
            t, gamma, noise = draws[0] if draws is not None else (None, None, None)
            return self.process.p_losses(fns[0], self.current_sched, self.data, self.generator,
                                         t, gamma, noise), {}
        if self.which == "joint_indi":
            loss, logs = self.process.p_losses(*fns, self.data, self.current_T, self.generator,
                                               draws)
            return loss, dict(logs, **JointInDIProcess.extra_param_logs(self.nets))
        t, noise = draws[0] if draws is not None else (None, None)
        return self.process.p_losses(fns[0], self.data, self.current_T, self.generator,
                                     t, noise), {}

    def optimize_parameters(self, draws=None):
        """One train step on the fed batch. `draws`, when given, injects each
        net's draws: [(t, noise)] for indi and ddpm, [(t1, n1), (t2, n2)] for
        joint_indi, [(t, gamma, noise)] for sr3."""
        self.global_step += 1
        for p in self.params:
            p.grad = None
        loss, logs = self._loss(draws)
        loss.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        logs["grad_norm"] = global_norm(grads).detach()  # pre-clip

        with torch.no_grad():
            if self.accum_steps > 1:
                if self._acc is None:
                    self._acc = [torch.zeros_like(g) for g in grads]
                n = self._mini_step
                for a, g in zip(self._acc, grads):
                    a.add_((g - a) / (n + 1))
                self._mini_step = (n + 1) % self.accum_steps
                if self._mini_step == 0:
                    for a, g in zip(self._acc, grads):
                        g.copy_(a)
                        a.zero_()
                    self._update(grads)
            else:
                self._update(grads)
            if self.use_ema:
                d = 0.0 if self.global_step < self.ema_start else self.ema_decay
                for e, p in zip(self.ema_nets.parameters(), self.params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self.switches.drop_quant_cache()  # the quantized nets are stale

        self.log_dict["l_pix"] = loss.detach()
        for k, v in logs.items():
            self.log_dict[k] = v

    def _update(self, grads):
        if self.clip is not None:
            self.clip(grads)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.updates)
        self.optimizer.step()
        self.updates += 1

    def get_current_log(self) -> OrderedDict:
        """The last step's logs as floats (read from the device here)."""
        return OrderedDict((k, float(v)) for k, v in self.log_dict.items())

    def _inference_nets(self):
        """The nets a chain serves from: the EMA copy when the EMA is on; with
        DSP_PRECAST=1 and a bf16 UNet, a copy of them whose Conv/Linear
        weights are cast to bf16 once for the call (bit-identical outputs),
        unless W8A8 is on: the quantized copies replace the precast one."""
        nets = self.ema_nets if self.use_ema else self.nets
        if (self.quant is None and precast_enabled()
                and any(u.compute_dtype == torch.bfloat16 for u in self.unets())):
            return cast_unet_params_for_inference(nets)
        return nets

    def set_deepcache(self, interval, depth: int = 1):
        """DeepCache serving (`AcceleratorSwitches.set_deepcache`)."""
        self.switches.set_deepcache(interval, depth)

    def set_sliding_window(self, window, tau: float = 0.1):
        """Sliding-window serving (`AcceleratorSwitches.set_sliding_window`)."""
        self.switches.set_sliding_window(window, tau)

    def set_ddim(self, steps, eta: float = 0.0):
        """Respaced DDIM serving of ddpm / sr3 (`AcceleratorSwitches.set_ddim`);
        indi / joint_indi ignore it."""
        self.switches.set_ddim(steps, eta)

    def set_quant(self, bits, calib: int = 8, updown: bool = False, shortcut: bool = False,
                  attn: bool = False, clip: float = 1.0):
        """W8A8 quantized serving (`AcceleratorSwitches.set_quant`)."""
        self.switches.set_quant(bits, calib, updown, shortcut, attn, clip)

    quant = property(lambda self: self.switches.quant)
    deepcache = property(lambda self: self.switches.deepcache)
    sliding_window = property(lambda self: self.switches.sliding_window)
    ddim = property(lambda self: self.switches.ddim)
    last_sliding_sweeps = property(lambda self: self.switches.last_sliding_sweeps,
                                   doc="The sweeps of the last sliding-window chain.")

    @contextlib.contextmanager
    def _serving_unet(self, kind: str, cond=None):
        """The UNet of a ddpm / sr3 `kind` ('test' or 'sample') chain: the
        inference nets' in eval mode (their W8A8 copy when `quant` is on,
        calibrated on `cond`'s first image), under inference_mode, their mode
        restored after."""
        nets = self._inference_nets()
        was_training = nets.training
        nets.eval()
        try:
            with torch.inference_mode():
                unet = nets.denoise_fn
                if self.quant is not None:
                    unet, = self.switches.quantized_unets((unet,), kind, lambda i: sr_calib_inputs(
                        self.which, self.process, self.current_sched, kind,
                        self.quant["calib"], None if cond is None else cond[:1], self.device))
                yield unet
        finally:
            nets.train(was_training)

    def _sr_chain(self, x_in, continuous: bool, fused: Optional[bool]):
        """The ddpm / sr3 reverse chain over the current phase's schedule, by
        the accelerators switched on: x_in the condition, or the sample's
        shape (unconditional)."""
        sw = self.switches
        on = sw.accelerators(continuous, respaces=True)
        sched = self.current_sched
        kw = dict(generator=self.sample_generator, device=self.device)
        kind = "sample" if isinstance(x_in, tuple) else "test"
        with self._serving_unet(kind, None if kind == "sample" else x_in) as unet:
            fn = functools.partial(apply_unet, unet, fused=sw.serving_fused(fused))
            if "sliding_window" in on:
                img, sw.last_sliding_sweeps = ddpm_sample_sliding_window(
                    self.process, fn, sched, x_in, *sw.sliding_window, **kw)
                return img
            if "deepcache" in on:
                appliers = make_cached_denoisers(unet, sw.deepcache[1])
                if "ddim" in on:
                    steps, eta = sw.ddim
                    interval = sw.dc_interval(len(ddim_timesteps(sched.num_timesteps, steps)))
                    return cached_ddim_sample_loop(self.process, sched, x_in, *appliers, steps,
                                                   eta, interval, **kw)
                return cached_p_sample_loop(self.process, sched, x_in, *appliers,
                                            sw.dc_interval(sched.num_timesteps), **kw)
            if "ddim" in on:
                return ddim_sample_loop(self.process, fn, sched, x_in, *sw.ddim, **kw)
            return self.process.p_sample_loop(fn, sched, x_in, continuous=continuous, **kw)

    def test(self, continuous: bool = False, t_float_start: Optional[float] = None,
             fused: Optional[bool] = None):
        """The reverse process on the fed batch's 'input', in the current
        phase's T steps, from the EMA weights when the EMA is on; with
        `continuous` the trajectory (n_frames, B, H, W, C). indi / joint_indi
        through `SplittingModel.test`; conditional ddpm / sr3 through
        `_sr_chain`, over the phase's whole schedule."""
        if self.which in SR_FAMILIES:
            if t_float_start is not None:
                raise ValueError(f"{self.which} has no t_float_start: its chain runs the "
                                 "phase's whole schedule")
            if not self.process.conditional:
                raise ValueError(f"an unconditional {self.which} model serves through sample()")
            self.prediction = self._sr_chain(self.data["input"], continuous, fused)
            return self.prediction
        self._server.nets = self._inference_nets()
        self.prediction = self._server.test(self.data["input"], t_float_start,
                                            self.current_T, fused, continuous)
        return self.prediction

    def inference(self, x_in, continuous: bool = False, num_timesteps: Optional[int] = None,
                  t_float_start: Optional[float] = None):
        """`test` on an explicit NHWC input batch, in `num_timesteps` steps
        when given (else the current phase's T). A ddpm / sr3 chain runs the
        phase's schedule: set another through `set_new_noise_schedule`."""
        if num_timesteps is not None and self.which in SR_FAMILIES:
            raise ValueError(f"{self.which} takes its steps from the noise schedule, "
                             "not num_timesteps: use set_new_noise_schedule")
        self.feed_data({"input": x_in})
        if num_timesteps is None:
            return self.test(continuous, t_float_start)
        old_T, self.current_T = self.current_T, int(num_timesteps)
        try:
            return self.test(continuous, t_float_start)
        finally:
            self.current_T = old_T

    def sample(self, batch_size: int = 1, continuous: bool = False,
               fused: Optional[bool] = None):
        """An unconditional ddpm / sr3 sample of `batch_size` images over the
        current phase's schedule (`_sr_chain`); with `continuous` the
        trajectory."""
        if self.which not in SR_FAMILIES or self.process.conditional:
            raise ValueError("sample() generates with an unconditional ddpm / sr3 model")
        p = self.process
        self.prediction = self._sr_chain((batch_size, p.image_size, p.image_size, p.channels),
                                         continuous, fused)
        return self.prediction

    def get_current_visuals(self, sample: bool = False) -> OrderedDict:
        """The last prediction and the fed batch, NHWC numpy; with `sample`,
        the last `sample()` alone, as 'SAM'."""
        if sample:
            return OrderedDict(SAM=self.prediction.detach().cpu().numpy())
        out = OrderedDict(prediction=self.prediction.detach().cpu().numpy(),
                          input=self.data["input"].cpu().numpy())
        if "target" in self.data:
            out["target"] = self.data["target"].cpu().numpy()
        return out

    def print_network(self):
        n = sum(p.numel() for p in self.params)
        logger.info("Network G structure: %s (%s), with parameters: %s",
                    self.__class__.__name__, self.which, f"{n:,d}")

    # ------------------------------------------------------------- checkpoints
    def save_network(self, epoch: int, iter_step: int):
        """Write `I{iter}_E{epoch}_gen.pth` / `_opt.pth` under the config's
        `path.checkpoint`."""
        payload = {
            "epoch": int(epoch),
            "iter": int(iter_step),
            "optimizer": self.optimizer.state_dict(),
            "updates": self.updates,
            "global_step": self.global_step,
            "mini_step": self._mini_step,
            "acc": None if self._acc is None else [a.detach().cpu() for a in self._acc],
            "generator": self.generator.get_state(),
        }
        if self.use_ema:
            payload["ema"] = {k: v.detach().cpu() for k, v in self.ema_nets.state_dict().items()}
        gen_path, _ = save_checkpoint(self.opt["path"]["checkpoint"], f"I{iter_step}_E{epoch}",
                                      self.nets.state_dict(), payload)
        logger.info("Saved model in [%s] ...", gen_path)

    def load_network(self):
        """Resume from `path.resume_state`: a prefix of a checkpoint pair, or a
        `.pth` file in the reference layout (weights only)."""
        load_path = (self.opt.get("path") or {}).get("resume_state")
        if not load_path:
            return
        gen_path, opt_path = resolve_checkpoint(load_path)
        logger.info("Loading pretrained model for G [%s] ...", gen_path)
        self.nets.load_state_dict(load_reference_checkpoint(gen_path, self.which), strict=True)
        self.switches.drop_quant_cache()
        state = (load_trainer_state(opt_path)
                 if opt_path is not None and self.phase == "train" else None)
        if self.use_ema:
            ema = state.get("ema") if state is not None else None
            self.ema_nets.load_state_dict(ema if ema is not None else self.nets.state_dict())
        if state is None:
            return
        self.optimizer.load_state_dict(state["optimizer"])
        self.begin_epoch = int(state["epoch"])
        self.begin_step = int(state["iter"])
        self.global_step = int(state.get("global_step", self.begin_step))
        self.updates = int(state.get("updates", self.global_step // self.accum_steps))
        self._mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self._acc = None if acc is None else [a.to(self.device) for a in acc]
        if state.get("generator") is not None:
            self.generator.set_state(state["generator"])
