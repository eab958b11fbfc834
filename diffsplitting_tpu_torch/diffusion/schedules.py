"""Beta schedules and the DDPM schedule.

Counterpart: diffsplitting_tpu/diffusion/schedules.py (`make_beta_schedule`,
`DDPMSchedule`, `build_ddpm_schedule`). The betas and every derived
quantity are computed in float64 numpy, as JAX computes them, then cast to
float32 tensors: the fields JAX holds as f32 arrays. `num_timesteps` is an
int. `to(device)` gives the same schedule on another device, where the
samplers index it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _warmup_beta(linear_start, linear_end, n_timestep, warmup_frac):
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(linear_start, linear_end, warmup_time, dtype=np.float64)
    return betas


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """The beta sequence (float64 numpy, length n_timestep): quad, linear,
    warmup10, warmup50, const, jsd (1/T, 1/(T-1), ..., 1) or cosine."""
    if schedule == "quad":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * math.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=None, a_max=0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Every per-timestep constant of the DDPM / SR3 processes, f32 tensors
    of length T, and `sqrt_alphas_cumprod_prev` of length T + 1 (a leading
    1, SR3's noise levels)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    num_timesteps: int

    def to(self, device) -> "DDPMSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if f.name != "num_timesteps"})


def build_ddpm_schedule(schedule_opt) -> DDPMSchedule:
    """The schedule of a config block {schedule, n_timestep, linear_start,
    linear_end}, on the CPU."""
    betas = make_beta_schedule(
        schedule=schedule_opt["schedule"],
        n_timestep=int(schedule_opt["n_timestep"]),
        linear_start=float(schedule_opt["linear_start"]),
        linear_end=float(schedule_opt["linear_end"]),
    )
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    return DDPMSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                 / (1.0 - alphas_cumprod)),
        sqrt_alphas_cumprod_prev=f32(np.sqrt(np.append(1.0, alphas_cumprod))),
        num_timesteps=int(schedule_opt["n_timestep"]),
    )
