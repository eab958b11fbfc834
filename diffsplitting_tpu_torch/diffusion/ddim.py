"""Respaced DDIM sampling for the DDPM / SR3 reverse chains.

Counterpart: diffsplitting_tpu/diffusion/ddim.py (`ddim_timesteps`,
`ddim_coefficients`, `ddim_sample_loop` with `_ddim_setup`, `_ddim_update`
and `_ddim_step`). A sub-sequence τ of S ≪ T steps of the trained chain is
traversed with

    x_τ' = √ᾱ_τ'·x̂0 + √(1 − ᾱ_τ' − σ²)·ε̂ + σ·z,
    σ = η·√((1 − ᾱ_τ')/(1 − ᾱ_τ))·√(1 − ᾱ_τ/ᾱ_τ'),

through the same denoiser: at η = 1 over the full sequence it is the
ancestral chain, at η = 0 the deterministic sampler. ε̂ is re-derived from
the clipped x̂0, so the step stays consistent with clipping.

The coefficients are computed in float64 from the schedule's float32 values,
then rounded to float32, as JAX computes them: `1 − ᾱ_τ/ᾱ_τ'` cancels near
τ = 0, which float32 arithmetic would not resolve. The loop is a plain
Python loop of S steps with no read from the device; JAX's
`ddim_sample_loop_chunked` splits its `lax.scan` only to bound the TPU
compiler's program and has no counterpart here.

Noise: the port's usual contract (`common.noise_source`): S + 1 standard
normal draws, the initial one, then one a step (even at η = 0, as JAX draws
them), from an explicit generator or injected. The denoiser sees raw t as
float32 for DDPM and the noise level √ᾱ_{τ+1} (`sqrt_alphas_cumprod_prev[τ +
1]`, `SR3Process.noise_level`) for SR3 (`step_conditioning`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .common import noise_source
from .schedules import DDPMSchedule
from .sr3 import SR3Process

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def host(sched: DDPMSchedule, name: str) -> np.ndarray:
    """One schedule constant as a numpy float32 array (read once a chain)."""
    return getattr(sched, name).cpu().numpy()


def step_conditioning(process, sched: DDPMSchedule, ts: np.ndarray) -> np.ndarray:
    """What the denoiser sees at the integer steps `ts`, float32: the noise
    level √ᾱ_{t+1} for SR3, raw t for DDPM."""
    if isinstance(process, SR3Process):
        return host(sched, "sqrt_alphas_cumprod_prev")[np.asarray(ts) + 1]
    return np.asarray(ts).astype(np.float32)


def ddim_timesteps(T: int, steps: int) -> np.ndarray:
    """The uniform respaced sub-sequence, descending; steps ≥ T gives the
    full sequence T − 1 ... 0, and both ends are always in it."""
    S = int(steps)
    if S >= T:
        return np.arange(T - 1, -1, -1, dtype=np.int64)
    if S < 1:
        raise ValueError(f"need at least one DDIM step, got {steps}")
    taus = np.unique(np.round(np.linspace(T - 1, 0, S)).astype(np.int64))
    return taus[::-1].copy()


def ddim_coefficients(sched: DDPMSchedule, steps: int, eta: float):
    """(taus, ᾱ_τ', σ, direction coefficient) of each step, float64 numpy
    from the float32 schedule; ᾱ_τ' of the last step is 1 (σ = 0 there)."""
    taus = ddim_timesteps(sched.num_timesteps, steps)
    ab = host(sched, "alphas_cumprod").astype(np.float64)
    ab_t = ab[taus]
    ab_prev = np.append(ab[taus[1:]], 1.0)
    sigma = (float(eta) * np.sqrt((1.0 - ab_prev) / (1.0 - ab_t))
             * np.sqrt(1.0 - ab_t / ab_prev))
    dir_coef = np.sqrt(np.maximum(1.0 - ab_prev - sigma ** 2, 0.0))
    return taus, ab_prev, sigma, dir_coef


def _ddim_setup(process, sched: DDPMSchedule, x_in, steps: int, eta: float,
                generator=None, noise=None, device=None):
    """(initial image, condition or None, noise draw, per-step inputs): each
    step's (conditioning, √(1/ᾱ_τ), √(1/ᾱ_τ − 1), √ᾱ_τ', σ, direction
    coefficient) as float32-valued Python floats."""
    taus, ab_prev, sigma, dir_coef = ddim_coefficients(sched, steps, eta)
    S = len(taus)
    if process.conditional:
        cond = x_in
        template = torch.empty(tuple(x_in.shape[:-1]) + (process.channels,),
                               device=x_in.device, dtype=x_in.dtype)
    else:
        cond = None
        template = torch.empty(tuple(x_in), device=device, dtype=torch.float32)
    draw = noise_source(template, S, generator, noise)
    img = draw(0)
    cols = (step_conditioning(process, sched, taus),
            host(sched, "sqrt_recip_alphas_cumprod")[taus],
            host(sched, "sqrt_recipm1_alphas_cumprod")[taus],
            np.sqrt(ab_prev), sigma, dir_coef)
    xs = [tuple(float(c) for c in row)
          for row in zip(*(np.asarray(c, np.float32) for c in cols))]
    return img, cond, draw, xs


def _ddim_update(x, eps, sr, srm1, sq_ab_prev, sig, dirc, noise, clip_denoised: bool):
    """x_τ → x_τ' given ε̂ (shared with the cached DDIM loop)."""
    x0 = sr * x - srm1 * eps
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    eps = (sr * x - x0) / srm1
    return sq_ab_prev * x0 + dirc * eps + sig * noise


def _ddim_step(denoise_fn: DenoiseFn, cond, x, inp, noise, clip_denoised: bool):
    """One respaced step: the denoiser at the step's conditioning, then the
    update."""
    tc, sr, srm1, sq_ab_prev, sig, dirc = inp
    net_in = x if cond is None else torch.cat([cond, x], dim=-1)
    eps = denoise_fn(net_in, torch.full((x.shape[0],), tc, device=x.device, dtype=x.dtype))
    return _ddim_update(x, eps, sr, srm1, sq_ab_prev, sig, dirc, noise, clip_denoised)


@torch.no_grad()
def ddim_sample_loop(process, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in, steps: int,
                     eta: float = 0.0, clip_denoised: bool = True,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None, device=None):
    """The S-step respaced chain of a DDPM or SR3 `process`. x_in: the NHWC
    condition when the process is conditional, else the shape (B, H, W, C)
    of the sample (on `device`). Returns the final image."""
    img, cond, draw, xs = _ddim_setup(process, sched, x_in, steps, eta, generator, noise,
                                      device)
    for k, inp in enumerate(xs):
        img = _ddim_step(denoise_fn, cond, img, inp, draw(k + 1), clip_denoised)
    return img
