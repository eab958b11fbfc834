"""Parallel-in-time (Picard) sampling: whole-trajectory sweeps and the
sliding window, for the InDI bridge and the DDPM / SR3 ancestral chain.

Counterpart: diffsplitting_tpu/diffusion/parallel_sampling.py
(`indi_inference_parallel`, `ddpm_sample_parallel`, `_sliding_window_loop`,
`ddpm_sample_sliding_window`, `indi_inference_sliding_window`). A reverse
chain x_{i+1} = F_i(x_i) with each step's noise frozen is treated as a fixed
point over the trajectory: a sweep applies every step of a window to the
current estimate of its input at once, as one batched denoiser call. After a
sweep the window's leading step is exact, so the iteration reaches the
sequential chain in at most N sweeps. For InDI F_i(x) = (δ/t_i)·D(x, t_i) +
(1 − δ/t_i)·x + ε_i·e(t_i − δ); for DDPM / SR3 it is the posterior step
μθ(x, t) + σ_t·ε_t at t = T − 1 − i, with the denoiser conditioned as the
exact chain conditions it (`ddim.step_conditioning`).

The frozen noises are the exact chain's draws: the initial draw, then step
i's, from the generator in the exact chain's order (or from its N + 1
injected tensors; the CPU tests inject JAX's split and fold_in draws). Each
step does the exact chain's arithmetic (`InDIProcess.step`, and for DDPM /
SR3 `p_sample`'s, elementwise in the same order), so a chain iterated to its
fixed point (τ = 0) computes the exact chain's function for the same seed,
bit for bit where the denoiser gives each sample the same bits at batch W·B
as at B. Freezing the draws costs a (N, B, H, W, C) float32 buffer: at
N = 2000 and one 512² RGB image, 6.3 GB (JAX regenerates each step's noise
from fold_in instead).

The loops read one number from the device a sweep (max |ΔX|, or the window's
advance `a`), as their exit conditions and slides need it on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .ddim import host, step_conditioning
from .indi import DenoiseFn, InDIProcess, noise_source
from .joint_indi import JointInDIProcess
from .schedules import DDPMSchedule


def _frozen_noise(x_in, N, generator, noise):
    """(initial draw, (N, *x_in.shape) per-step draws), in the exact chain's order."""
    draw = noise_source(x_in, N, generator, noise)
    first = draw(0)
    return first, torch.stack([draw(i + 1) for i in range(N)])


def _window_times(ts: np.ndarray, gidx: np.ndarray) -> np.ndarray:
    """The step times of a window, shaped (W, 1, 1, 1, 1) to broadcast over
    (W, B, H, W, C)."""
    return ts[gidx].reshape(-1, 1, 1, 1, 1)


@torch.no_grad()
def indi_inference_parallel(process: InDIProcess, denoise_fn: DenoiseFn, x_in,
                            num_timesteps: int, t_float_start: float = 1.0,
                            num_sweeps: Optional[int] = None, tol: float = 1e-4,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Picard sweeps over the whole N-step trajectory, each one (N·B)-batch
    denoiser call: `num_sweeps` of them, or (None) until max |ΔX| < tol,
    capped at N. Returns (B, H, W, C·out_channel)."""
    N = int(num_timesteps)
    x_in = process.tile_input(x_in)
    first, noises = _frozen_noise(x_in, N, generator, noise)
    x_t, delta, ts = process.start(x_in, first, t_float_start, N)
    b = x_in.shape[0]
    t_steps = _window_times(ts, np.arange(N))
    t_vec = torch.from_numpy(np.repeat(ts, b)).to(x_t.device)

    def sweep(X):
        xs = X[:-1]
        x0 = denoise_fn(xs.reshape((N * b,) + xs.shape[2:]), t_vec).reshape(xs.shape)
        return torch.cat([X[:1], process.step(x0, xs, noises, t_steps, delta)])

    X = x_t.unsqueeze(0).expand((N + 1,) + x_t.shape).contiguous()
    if num_sweeps is not None:
        for _ in range(int(num_sweeps)):
            X = sweep(X)
        return X[-1]
    change, k = float("inf"), 0
    while k < N and change > tol:
        Xn = sweep(X)
        change = float((Xn - X).abs().max())  # one read a sweep
        X, k = Xn, k + 1
    return X[-1]


def _sliding_window_loop(step_window: Callable[[torch.Tensor, np.ndarray], torch.Tensor],
                         noise_var: Callable[[np.ndarray], np.ndarray], T: int, W: int,
                         x0: torch.Tensor, tau: float) -> Tuple[torch.Tensor, int]:
    """Windowed Picard over T steps from x0 (B, ...), W steps a sweep.

    step_window(xs (W, B, ...), gidx (W,) step indices, clamped to T − 1) ->
    the W steps' outputs; noise_var(gidx) -> each step's per-pixel noise
    variance σ², the tolerance's scale. After a sweep the window slides past
    its leading steps whose update moved the estimate by a per-sample mean
    square of at most τ·σ² (the leading step always: it is exact), and its
    tail repeats the last estimate. τ = 0 advances only past exact steps.
    Returns (final state, sweeps)."""
    B = x0.shape[0]
    Xw = x0.unsqueeze(0).expand((W + 1,) + x0.shape).contiguous()
    j = np.arange(W)
    p = sweeps = 0
    while p < T:
        gidx = np.minimum(p + j, T - 1)
        new = step_window(Xw[:W], gidx)
        err = ((new - Xw[1:]).reshape(W, B, -1).float() ** 2).mean(dim=-1).amax(dim=-1)
        tol = torch.from_numpy(np.float32(tau) * noise_var(gidx).astype(np.float32))
        conv = err <= tol.to(err.device)
        conv[0] = True
        a = int(torch.cumprod(conv.int(), 0).sum())  # one read a sweep
        a = min(a, T - p)
        U = torch.cat([Xw[:1], new])
        Xw = torch.cat([U[a:], U[W:].expand((a,) + U.shape[1:])])
        p += a
        sweeps += 1
    return Xw[0], sweeps


@torch.no_grad()
def indi_inference_sliding_window(process: InDIProcess, denoise_fn: DenoiseFn, x_in,
                                  num_timesteps: int, t_float_start: float = 1.0,
                                  window: int = 16, tau: float = 0.1,
                                  generator: Optional[torch.Generator] = None,
                                  noise: Optional[Sequence[torch.Tensor]] = None
                                  ) -> Tuple[torch.Tensor, int]:
    """The InDI chain by `_sliding_window_loop`: each sweep one (W·B)-batch
    call of `denoise_fn`. Returns (img (B, H, W, C·out_channel), sweeps)."""
    N, W = int(num_timesteps), int(window)
    x_in = process.tile_input(x_in)
    first, noises = _frozen_noise(x_in, N, generator, noise)
    x0, delta, ts = process.start(x_in, first, t_float_start, N)
    b = x_in.shape[0]

    def step_window(xs, gidx):
        t_flat = torch.from_numpy(np.repeat(ts[gidx], b)).to(xs.device)
        pred = denoise_fn(xs.reshape((W * b,) + xs.shape[2:]), t_flat).reshape(xs.shape)
        return process.step(pred, xs, noises[torch.from_numpy(gidx).to(xs.device)],
                            _window_times(ts, gidx), delta)

    def noise_var(gidx):
        return process.get_t_times_e(ts[gidx] - delta) ** 2

    return _sliding_window_loop(step_window, noise_var, N, W, x0, tau)


def joint_indi_inference_sliding_window(joint_process: JointInDIProcess, denoise_fn_ch1,
                                        denoise_fn_ch2, x_in, num_timesteps: int,
                                        t_float_start: float = 0.5, window: int = 16,
                                        tau: float = 0.1,
                                        generator: Optional[torch.Generator] = None,
                                        noise=None) -> Tuple[torch.Tensor, int]:
    """Joint-InDI by the sliding window: net 1 from t_float_start, net 2 from
    1 − t_float_start (net 1 draws first; `noise` is (net 1's, net 2's)).
    Returns (img, the two chains' sweeps summed), as JAX's serving does."""
    n1, n2 = noise if noise is not None else (None, None)
    kw = dict(num_timesteps=num_timesteps, window=window, tau=tau, generator=generator)
    ch1, s1 = indi_inference_sliding_window(joint_process.indi1, denoise_fn_ch1, x_in,
                                            t_float_start=t_float_start, noise=n1, **kw)
    ch2, s2 = indi_inference_sliding_window(joint_process.indi2, denoise_fn_ch2, x_in,
                                            t_float_start=1 - t_float_start, noise=n2, **kw)
    return torch.cat([ch1, ch2], dim=-1), s1 + s2


def _ddpm_start(process, x_in, T: int, generator, noise, device):
    """(condition or None, initial image, (T, ...) frozen per-step draws) of
    a DDPM / SR3 chain, in `reverse_chain`'s order."""
    if process.conditional:
        cond = x_in
        template = torch.empty(tuple(x_in.shape[:-1]) + (process.channels,), device=x_in.device,
                               dtype=x_in.dtype)
    else:
        cond = None
        template = torch.empty(tuple(x_in), device=device, dtype=torch.float32)
    first, noises = _frozen_noise(template, T, generator, noise)
    return cond, first, noises


class _AncestralSteps:
    """The posterior steps of a DDPM / SR3 chain applied to K estimates at
    once: `__call__(xs (K, B, ...), ts (K,) steps on the device, noises)`,
    one (K·B)-batch denoiser call, with `p_sample`'s arithmetic."""

    def __init__(self, process, denoise_fn: DenoiseFn, sched: DDPMSchedule, cond, K: int,
                 clip_denoised: bool, device):
        self.denoise_fn, self.sched, self.clip = denoise_fn, sched, clip_denoised
        T = sched.num_timesteps
        self.level = torch.from_numpy(step_conditioning(process, sched, np.arange(T))).to(device)
        self.cond = None if cond is None else cond.repeat(K, 1, 1, 1)

    def __call__(self, xs, ts, noises):
        K, b = xs.shape[:2]
        sched = self.sched

        def r(a):
            return a[ts].reshape(K, 1, 1, 1, 1)

        flat = xs.reshape((K * b,) + xs.shape[2:])
        net_in = flat if self.cond is None else torch.cat([self.cond, flat], dim=-1)
        eps = self.denoise_fn(net_in, self.level[ts].repeat_interleave(b)).reshape(xs.shape)
        x0 = r(sched.sqrt_recip_alphas_cumprod) * xs - r(sched.sqrt_recipm1_alphas_cumprod) * eps
        if self.clip:
            x0 = x0.clamp(-1.0, 1.0)
        mean = r(sched.posterior_mean_coef1) * x0 + r(sched.posterior_mean_coef2) * xs
        sigma = (torch.exp(0.5 * r(sched.posterior_log_variance_clipped))
                 * (ts > 0).to(xs.dtype).reshape(K, 1, 1, 1, 1))
        return mean + sigma * noises


@torch.no_grad()
def ddpm_sample_parallel(process, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in,
                         clip_denoised: bool = True, num_sweeps: Optional[int] = None,
                         tol: float = 1e-3, generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None,
                         device=None) -> torch.Tensor:
    """Picard sweeps over the whole T-step DDPM / SR3 trajectory, each one
    (T·B)-batch denoiser call: `num_sweeps` of them, or (None) until
    max |ΔX| < tol, capped at T. x_in as `p_sample_loop` takes it. Returns
    the final image."""
    T = sched.num_timesteps
    cond, img0, noises = _ddpm_start(process, x_in, T, generator, noise, device)
    steps = _AncestralSteps(process, denoise_fn, sched, cond, T, clip_denoised, img0.device)
    ts = torch.arange(T - 1, -1, -1, device=img0.device)

    def sweep(X):
        return torch.cat([X[:1], steps(X[:-1], ts, noises)])

    X = img0.unsqueeze(0).expand((T + 1,) + img0.shape).contiguous()
    if num_sweeps is not None:
        for _ in range(int(num_sweeps)):
            X = sweep(X)
        return X[-1]
    change, k = float("inf"), 0
    while k < T and change > tol:
        Xn = sweep(X)
        change = float((Xn - X).abs().max())  # one read a sweep
        X, k = Xn, k + 1
    return X[-1]


@torch.no_grad()
def ddpm_sample_sliding_window(process, denoise_fn: DenoiseFn, sched: DDPMSchedule, x_in,
                               window: int = 64, tau: float = 0.1, clip_denoised: bool = True,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[Sequence[torch.Tensor]] = None,
                               device=None) -> Tuple[torch.Tensor, int]:
    """The DDPM / SR3 chain by `_sliding_window_loop`: each sweep one
    (W·B)-batch call of `denoise_fn`; the tolerance's scale is each step's
    posterior variance (0 at t = 0). x_in as `p_sample_loop` takes it.
    Returns (img, sweeps)."""
    T, W = sched.num_timesteps, int(window)
    cond, x0, noises = _ddpm_start(process, x_in, T, generator, noise, device)
    steps = _AncestralSteps(process, denoise_fn, sched, cond, W, clip_denoised, x0.device)
    ts_all = np.arange(T - 1, -1, -1)
    ts_dev = torch.from_numpy(ts_all).to(x0.device)
    logvar = host(sched, "posterior_log_variance_clipped")

    def step_window(xs, gidx):
        g = torch.from_numpy(gidx).to(xs.device)
        return steps(xs, ts_dev[g], noises[g])

    def noise_var(gidx):
        t = ts_all[gidx]
        return np.exp(logvar[t]) * (t > 0)

    return _sliding_window_loop(step_window, noise_var, T, W, x0, tau)
