"""Vanilla DDPM Gaussian diffusion: noise prediction, integer-step conditioning.

Counterpart: diffsplitting_tpu/diffusion/ddpm.py (`DDPMProcess`):

  * training: t ~ U{0, ..., T-1} a sample, eps-prediction, L1/L2 of the
    prediction against the noise (`lr_reduction`, default 'sum');
    conditional nets see concat(input, x_noisy) on the channels;
  * reverse: x̂0 from the predicted noise, optionally clipped to [-1, 1],
    the posterior mean, and the posterior noise except at t = 0;
  * `p_sample_loop` runs the T steps as a plain loop; with `continuous` it
    returns the trajectory: frame 0 the condition tiled to `channels` (or the
    initial noise, unconditional), then every `1 | (T // 10)`-th step.

The denoiser is a callable (x NHWC, t (B,) f32) -> eps. The noise of a chain
comes from an explicit `torch.Generator` (the initial draw, then one a step,
in that order) or from T + 1 injected tensors, which the parity tests use to
replay the JAX draws; in training, t and the noise may be injected the same
way.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .common import capture_plan, make_loss_fn, noise_source, scan_with_trajectory
from .schedules import DDPMSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] of each sample, shaped to broadcast against an image batch."""
    return a[t].reshape(t.shape[0], *([1] * (ndim - 1)))


@torch.no_grad()
def reverse_chain(process, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in,
                  clip_denoised: bool = True, continuous: bool = False,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None, device=None):
    """The T reverse steps of a DDPM or SR3 `process` from noise, step i =
    T-1 ... 0 through `process.p_sample` at `process.step_t(i, batch,
    device)`. x_in: the NHWC condition when the process is conditional, else
    the shape (B, H, W, C) of the sample (on `device`). Returns the final
    image, or with `continuous` the trajectory (n_frames, B, H, W, C):
    frame 0 the condition tiled to `channels` (or the initial noise), then
    every `1 | (T // 10)`-th step."""
    T = sched.num_timesteps
    if process.conditional:
        cond = x_in
        template = torch.empty(tuple(x_in.shape[:-1]) + (process.channels,), device=x_in.device,
                               dtype=x_in.dtype)
    else:
        cond = None
        template = torch.empty(tuple(x_in), device=device, dtype=torch.float32)
    draw = noise_source(template, T, generator, noise)
    img = draw(0)
    b = img.shape[0]

    def step(x, k):
        t = process.step_t(T - 1 - k, b, x.device)
        return process.p_sample(denoise_fn, sched, x, t, draw(k + 1), clip_denoised, cond)

    flags, _ = capture_plan(range(T - 1, -1, -1), 1 | (T // 10), include_last=False)
    if not continuous:
        flags = [0] * T
    first = img if cond is None else cond.repeat(1, 1, 1, process.channels // cond.shape[-1])
    final, frames = scan_with_trajectory(step, img, first, range(T), flags)
    return frames if continuous else final


class DDPMProcess:
    def __init__(self, image_size: int, channels: int = 3, loss_type: str = "l1",
                 lr_reduction: Optional[str] = None, conditional: bool = True):
        self.image_size = image_size
        self.channels = channels
        self.conditional = conditional
        self.loss_type = loss_type
        self.lr_reduction = lr_reduction if lr_reduction is not None else "sum"
        self.loss_fn = make_loss_fn(self.loss_type, self.lr_reduction)

    # ---------------------------------------------------------------- forward
    def q_sample(self, sched: DDPMSchedule, x_start, t, noise):
        return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)

    # ---------------------------------------------------------------- reverse
    def predict_start_from_noise(self, sched: DDPMSchedule, x_t, t, noise):
        return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)

    def q_posterior(self, sched: DDPMSchedule, x_start, x_t, t):
        mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
                + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
        variance = extract(sched.posterior_variance, t, x_t.ndim)
        log_variance = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
        return mean, variance, log_variance

    def p_mean_variance(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x, t,
                        clip_denoised: bool, condition_x=None):
        net_in = torch.cat([condition_x, x], dim=-1) if condition_x is not None else x
        x_recon = self.predict_start_from_noise(sched, x, t, denoise_fn(net_in, t.float()))
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        return self.q_posterior(sched, x_recon, x, t)

    def p_sample(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x, t, noise,
                 clip_denoised: bool = True, condition_x=None):
        """One ancestral step at the (B,) integer steps t, with the standard
        normal `noise` (unused where t = 0)."""
        mean, _, log_variance = self.p_mean_variance(denoise_fn, sched, x, t, clip_denoised,
                                                     condition_x)
        nonzero = (1.0 - (t == 0).to(x.dtype)).reshape(-1, *([1] * (x.ndim - 1)))
        return mean + nonzero * torch.exp(0.5 * log_variance) * noise

    @staticmethod
    def step_t(i: int, batch: int, device) -> torch.Tensor:
        """Step i of a chain as the (B,) integer steps `p_sample` takes."""
        return torch.full((batch,), i, device=device, dtype=torch.long)

    def p_sample_loop(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in,
                      clip_denoised: bool = True, continuous: bool = False, **kw):
        """The T reverse steps from noise (`reverse_chain`)."""
        return reverse_chain(self, denoise_fn, sched, x_in, clip_denoised, continuous, **kw)

    def sample(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, batch_size: int = 1,
               continuous: bool = False, **kw):
        """An unconditional sample of `batch_size` images."""
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        return reverse_chain(self, denoise_fn, sched, shape, continuous=continuous, **kw)

    @torch.no_grad()
    def interpolate(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x1, x2,
                    t: Optional[int] = None, lam: float = 0.5,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """Noise x1 and x2 to step t (default T − 1), mix them (1 − lam, lam)
        and denoise back in t steps. `noise`, when given: x1's and x2's draws,
        then one a step (t + 2 tensors)."""
        if x1.shape != x2.shape:
            raise ValueError(f"x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} differ in shape")
        t = sched.num_timesteps - 1 if t is None else int(t)
        draw = noise_source(x1, t + 1, generator, noise)
        b = x1.shape[0]
        t_vec = torch.full((b,), t, device=x1.device, dtype=torch.long)
        xt1 = self.q_sample(sched, x1, t_vec, draw(0))
        xt2 = self.q_sample(sched, x2, t_vec, draw(1))
        img = (1 - lam) * xt1 + lam * xt2
        for k, i in enumerate(range(t - 1, -1, -1)):
            t_vec = torch.full((b,), i, device=x1.device, dtype=torch.long)
            img = self.p_sample(denoise_fn, sched, img, t_vec, draw(k + 2))
        return img

    # ---------------------------------------------------------------- training
    def p_losses(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, batch,
                 generator: Optional[torch.Generator] = None, t=None, noise=None):
        """The training loss on batch {'target', 'input' (conditional)}; t
        ((B,) integers) and the noise are drawn from `generator` (t first)
        unless injected."""
        x_start = batch["target"]
        b = x_start.shape[0]
        if t is None:
            t = torch.randint(0, sched.num_timesteps, (b,), generator=generator,
                              device=x_start.device)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        t = torch.as_tensor(t, device=x_start.device).long()
        noise = noise.to(x_start.device)
        x_noisy = self.q_sample(sched, x_start, t, noise)
        net_in = torch.cat([batch["input"], x_noisy], dim=-1) if self.conditional else x_noisy
        return self.loss_fn(noise, denoise_fn(net_in, t.float()))
