"""Parallel-in-time (Picard) InDI sampling: whole-trajectory sweeps and the
sliding window.

Counterpart: the InDI part of diffsplitting_tpu/diffusion/parallel_sampling.py
(`indi_inference_parallel`, `_sliding_window_loop`,
`indi_inference_sliding_window`). The reverse chain
x_{i+1} = F_i(x_i) = (δ/t_i)·D(x_i, t_i) + (1 − δ/t_i)·x_i + ε_i·e(t_i − δ) is
treated as a fixed point over the trajectory: a sweep applies every step of
a window to the current estimate of its input at once, as one batched
denoiser call, with each step's noise ε_i frozen across sweeps. After a
sweep the window's leading step is exact, so the iteration reaches the
sequential chain in at most N sweeps.

The frozen noises are the exact chain's draws: the initial draw, then step
i's, from the generator in `InDIProcess.inference`'s order (or from its
N + 1 injected tensors; the CPU tests inject JAX's split and fold_in draws).
Each step does the exact chain's arithmetic (`InDIProcess.step`), so a chain
iterated to its fixed point (τ = 0) computes the exact chain's function for
the same seed, bit for bit where the denoiser gives each sample the same bits
at batch W·B as at B.

The loops read one number from the device a sweep (max |ΔX|, or the window's
advance `a`), as their exit conditions and slides need it on the host. The
DDPM / SR3 forms are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .indi import DenoiseFn, InDIProcess, noise_source
from .joint_indi import JointInDIProcess


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
