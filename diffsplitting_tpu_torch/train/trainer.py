"""The train step of the splitting models (indi, joint_indi).

Counterpart: the training half of diffsplitting_tpu/train/trainer.py
`DiffusionModel` (construction, `set_new_noise_schedule`, `feed_data`,
`optimize_parameters`, `get_current_log`, `test`) for indi and joint_indi.

One step: the process's `p_losses` through the UNet's own forward
(`net(x, t)`, whatever DSP_FUSED says: the JAX package trains through
`net.apply` and never through the fused walk), autograd (through the plain
versions of the GroupNorm+Swish and attention kernels, as the JAX custom VJPs
recompute through their jnp references), the pre-clip global gradient norm,
then, on an update: clipping, Adam with optax's defaults (betas 0.9 and
0.999, eps 1e-8) at the scheduled LR, and, when `train.ema_scheduler.enabled`,
the EMA of every parameter on every micro-step (exact tracking while the step
is below `step_start_ema`, `ema_decay` after).

t and the noise come from one device `torch.Generator` seeded by `seed`;
`optimize_parameters(draws=...)` injects them instead, which the parity tests
use to replay the JAX draws.

Not ported: dropout (`unet.dropout` > 0 raises; the UNet's `block.2` is an
identity), `remat`, compute dtypes other than float32, checkpoints, the data
pool, sharding, and the ddpm/sr3 families.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import JointInDIProcess
from ..serving import SplittingModel, define_generator, init_weights
from .clipping import global_norm, make_clip
from .optim import make_lr


class DiffusionModel:
    """Builds the nets from a config (seeded random weights, or `state_dict`
    in the port's layout, e.g. from `utils.weights.state_dict_from_jax`) and
    trains them."""

    def __init__(self, opt: Mapping, device=None, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.opt = opt
        self.device = resolve_device(device)
        model_opt = opt["model"]
        self.which = model_opt["which_model_G"]
        if self.which not in ("indi", "joint_indi"):
            raise NotImplementedError(f"training which_model_G={self.which!r} is not ported")
        if float(model_opt["unet"].get("dropout") or 0.0) > 0:
            raise NotImplementedError(
                "unet.dropout > 0 is not ported (the UNet's Block has no dropout); it comes "
                "with the time predictor and SR3/DDPM (ROADMAP items 1c, 1d)")
        if model_opt.get("finetune_norm"):
            # the JAX package trains only the parameters whose path holds
            # 'transformer' and raises when none does; no UNet has one
            raise ValueError("finetune_norm matched no trainable parameters "
                             "(no param path contains 'transformer')")
        # biases and scalars take the modules' default init from the global
        # RNG: seed it here, so that `seed` alone fixes the weights
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
        self.optimizer = torch.optim.Adam(self.params, lr=self.lr(0), betas=(0.9, 0.999),
                                          eps=1e-8)
        self.clip = make_clip(opt_cfg)
        self.accum_steps = max(int(opt_cfg.get("accum_steps") or 1), 1)
        self._acc = None  # running mean of the micro-steps' gradients
        self._mini_step = 0
        self.updates = 0

        ema_opt = train_opt.get("ema_scheduler") or {}
        self.use_ema = bool(ema_opt.get("enabled", False))
        self.ema_decay = float(ema_opt.get("ema_decay", 0.9999))
        self.ema_start = int(ema_opt.get("step_start_ema", 5000))
        # seeded from the params as loaded
        self.ema_nets = copy.deepcopy(self.nets).requires_grad_(False) if self.use_ema else None
        self.global_step = 0

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.log_dict = OrderedDict()
        self.data = None
        self.prediction = None
        self.schedule_phase = None
        self.current_T = None
        self.set_new_noise_schedule(model_opt["beta_schedule"]["train"], "train")
        self._server = SplittingModel(opt, self.device, seed, nets=self.nets)

    def set_new_noise_schedule(self, schedule_opt: Mapping, schedule_phase: str = "train"):
        """InDI and joint-InDI only track the step count T of the phase."""
        if self.schedule_phase == schedule_phase:
            return
        self.schedule_phase = schedule_phase
        self.current_T = int(schedule_opt["n_timestep"])

    def feed_data(self, data: Mapping):
        """NHWC numpy arrays (or tensors) -> float32 tensors on the device."""
        self.data = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(self.device)
                     for k, v in data.items()}

    def unets(self):
        if self.which == "joint_indi":
            return self.nets.indi1.denoise_fn, self.nets.indi2.denoise_fn
        return (self.nets.denoise_fn,)

    def _loss(self, draws):
        fns = self.unets()
        if self.which == "joint_indi":
            loss, logs = self.process.p_losses(*fns, self.data, self.current_T, self.generator,
                                               draws)
            return loss, dict(logs, **JointInDIProcess.extra_param_logs(self.nets))
        t, noise = draws[0] if draws is not None else (None, None)
        return self.process.p_losses(fns[0], self.data, self.current_T, self.generator,
                                     t, noise), {}

    def optimize_parameters(self, draws=None):
        """One train step on the fed batch. `draws`, when given, injects each
        net's (t, noise): [(t, noise)] for indi, [(t1, n1), (t2, n2)] for
        joint_indi."""
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
        return self.ema_nets if self.use_ema else self.nets

    def test(self, t_float_start: Optional[float] = None, fused: Optional[bool] = None):
        """The reverse process on the fed batch's 'input', in the current
        phase's T steps, through `SplittingModel.test`, from the EMA weights
        when the EMA is on."""
        self._server.nets = self._inference_nets()
        self.prediction = self._server.test(self.data["input"], t_float_start,
                                            self.current_T, fused)
        return self.prediction
