"""SR3 Gaussian diffusion: continuous √ᾱ noise-level conditioning.

Counterpart: diffsplitting_tpu/diffusion/sr3.py (`SR3Process`):

  * training: one step t ~ U{1, ..., T} a batch, then a per-sample
    γ ~ U(√ᾱ_{t-1}, √ᾱ_t); x_noisy = γ·x0 + √(1 − γ²)·ε; the net is
    conditioned on γ; L1/L2 of the prediction against ε, summed;
  * reverse: one integer step t for the whole batch; the net sees the noise
    level √ᾱ_{t+1} (`sqrt_alphas_cumprod_prev[t + 1]`, in the sample's
    dtype); x̂0 clipped, the posterior step, no noise at t = 0;
  * `p_sample_loop` is ddpm.py's `reverse_chain`: a plain loop, frames
    every `1 | (T // 10)`-th step with `continuous`.

Noise, t and γ come from an explicit `torch.Generator` or are injected, as
in ddpm.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import make_loss_fn
from .ddpm import DenoiseFn, reverse_chain
from .schedules import DDPMSchedule


class SR3Process:
    def __init__(self, image_size: int, channels: int = 3, loss_type: str = "l1",
                 lr_reduction: Optional[str] = None, conditional: bool = True):
        # lr_reduction is accepted as the factory passes it; SR3 always sums
        self.image_size = image_size
        self.channels = channels
        self.conditional = conditional
        self.loss_type = loss_type
        self.loss_fn = make_loss_fn(loss_type, "sum")

    # ---------------------------------------------------------------- forward
    def q_sample(self, x_start, continuous_sqrt_alpha_cumprod, noise):
        gamma = continuous_sqrt_alpha_cumprod
        return gamma * x_start + torch.sqrt(1.0 - gamma ** 2) * noise

    # ---------------------------------------------------------------- reverse
    def predict_start_from_noise(self, sched: DDPMSchedule, x_t, t: int, noise):
        return sched.sqrt_recip_alphas_cumprod[t] * x_t - sched.sqrt_recipm1_alphas_cumprod[t] * noise

    def q_posterior(self, sched: DDPMSchedule, x_start, x_t, t: int):
        mean = sched.posterior_mean_coef1[t] * x_start + sched.posterior_mean_coef2[t] * x_t
        return mean, sched.posterior_log_variance_clipped[t]

    def noise_level(self, sched: DDPMSchedule, t: int, batch: int, dtype):
        """The net's conditioning at step t: √ᾱ_{t+1} for each sample."""
        return sched.sqrt_alphas_cumprod_prev[t + 1].to(dtype).expand(batch)

    def p_mean_variance(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x, t: int,
                        clip_denoised: bool, condition_x=None):
        level = self.noise_level(sched, t, x.shape[0], x.dtype)
        net_in = torch.cat([condition_x, x], dim=-1) if condition_x is not None else x
        x_recon = self.predict_start_from_noise(sched, x, t, denoise_fn(net_in, level))
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        return self.q_posterior(sched, x_recon, x, t)

    def p_sample(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x, t: int, noise,
                 clip_denoised: bool = True, condition_x=None):
        """One step at the integer step t, with the standard normal `noise`
        (unused at t = 0)."""
        mean, log_variance = self.p_mean_variance(denoise_fn, sched, x, t, clip_denoised,
                                                  condition_x)
        if t == 0:
            noise = torch.zeros_like(x)
        return mean + noise * torch.exp(0.5 * log_variance)

    @staticmethod
    def step_t(i: int, batch: int, device) -> int:
        """Step i of a chain as `p_sample` takes it: one integer."""
        return i

    def p_sample_loop(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in,
                      clip_denoised: bool = True, continuous: bool = False, **kw):
        """The T reverse steps from noise (`ddpm.reverse_chain`)."""
        return reverse_chain(self, denoise_fn, sched, x_in, clip_denoised, continuous, **kw)

    def sample(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, batch_size: int = 1,
               continuous: bool = False, **kw):
        """An unconditional sample of `batch_size` images."""
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        return reverse_chain(self, denoise_fn, sched, shape, continuous=continuous, **kw)

    # ---------------------------------------------------------------- training
    def p_losses(self, denoise_fn: DenoiseFn, sched: DDPMSchedule, batch,
                 generator: Optional[torch.Generator] = None, t=None, gamma=None, noise=None):
        """The training loss on batch {'target', 'input' (conditional)}. t
        (one integer in 1..T), γ ((B,)) and the noise are drawn from
        `generator` in that order unless injected; an injected γ makes t
        unused."""
        x_start = batch["target"]
        b, dev = x_start.shape[0], x_start.device
        if gamma is None:
            if t is None:
                t = torch.randint(1, sched.num_timesteps + 1, (), generator=generator,
                                  device=dev)
            t = torch.as_tensor(t, device=dev).long()  # indexes without a host sync
            lo = sched.sqrt_alphas_cumprod_prev[t - 1]
            hi = sched.sqrt_alphas_cumprod_prev[t]
            u = torch.rand((b,), generator=generator, device=dev, dtype=x_start.dtype)
            gamma = lo + u * (hi - lo)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev,
                                dtype=x_start.dtype)
        gamma = torch.as_tensor(gamma, device=dev, dtype=x_start.dtype)
        x_noisy = self.q_sample(x_start, gamma.reshape(-1, 1, 1, 1), noise.to(dev))
        net_in = torch.cat([batch["input"], x_noisy], dim=-1) if self.conditional else x_noisy
        return self.loss_fn(noise.to(dev), denoise_fn(net_in, gamma))
