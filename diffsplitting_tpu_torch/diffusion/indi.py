"""InDI — Inversion by Direct Iteration: the deterministic-bridge process.

Counterpart: diffsplitting_tpu/diffusion/indi.py (`get_t_times_e`,
`q_sample`, `inference`):

  * forward bridge: x_t = (1-t)·x_start + t·x_end + ε·e(t), with
    e(t) = e·t (gaussian, none) or e·√t (brownian);
  * inference: N uniform steps down from t_start; with δ = t_start/N and
    step times t = t_start − δ·idx in f32,
    x ← (δ/t)·x̂0 + (1−δ/t)·x + ε·e(t−δ);
  * continuous=True returns the trajectory: frame 0 the noised input, then
    the steps of `capture_plan(range(N), 1 | (N // 20), include_last=True)`.

Training (`sample_t`, `_snap_to_max`, `get_prediction_during_training`,
`p_losses`): x0-prediction on the bridge at a per-sample t drawn by the
configured strategy, loss(x_start, net(x_t, t)).

Noise comes from an explicit `torch.Generator` on the device, or from an
injected list of N+1 tensors (the initial draw, then one per step), which the
parity tests use to replay the JAX draws; in training, t and the noise may be
injected the same way.

Two step counts, as in JAX: `num_timesteps` is the train T (t is drawn on its
grid) and `val_num_timesteps` the serving N.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .common import capture_plan, make_loss_fn, noise_source

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

T_SAMPLING_MODES = ("uniform", "uniform_in_range", "linear_ramp", "quadratic_ramp",
                    "linear_indi")
T_VARIANTS = ("base", "custom_t", "full_translation")


class InDIProcess:
    def __init__(self, out_channel: int = 2, e: float = 0.01, noise_mode: str = "gaussian",
                 num_timesteps: Optional[int] = None, val_num_timesteps: Optional[int] = None,
                 loss_type: str = "l1", lr_reduction: Optional[str] = None,
                 conditional: bool = False, t_sampling_mode: str = "linear_indi",
                 linear_indi_a: float = 1.0, t_variant: str = "base"):
        if noise_mode not in ("gaussian", "brownian", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        if t_sampling_mode not in T_SAMPLING_MODES:
            raise ValueError(f"t_sampling_mode {t_sampling_mode!r}")
        if t_variant not in T_VARIANTS:
            raise ValueError(f"t_variant {t_variant!r}")
        self.out_channel = out_channel
        self.e = 0.0 if noise_mode == "none" else e
        self.noise_mode = noise_mode
        self.num_timesteps = num_timesteps
        self.val_num_timesteps = val_num_timesteps
        self.loss_type = loss_type
        self.lr_reduction = lr_reduction if lr_reduction is not None else "sum"
        self.loss_fn = make_loss_fn(self.loss_type, self.lr_reduction)
        self.conditional = conditional
        self.t_sampling_mode = t_sampling_mode
        self.linear_indi_a = linear_indi_a
        self.t_variant = t_variant

    def get_t_times_e(self, t):
        """Noise scale at bridge time t (an f32 numpy scalar, or a tensor)."""
        e = np.float32(self.e)
        if isinstance(t, torch.Tensor):
            return (t if self.noise_mode != "brownian" else torch.sqrt(t)) * float(e)
        return e * (t if self.noise_mode != "brownian" else np.sqrt(t))

    def q_sample(self, x_start, x_end, t, noise):
        """Bridge mixture; t is (B,) or broadcastable, in (0, 1]."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x_start.device)
        if t.ndim == 1:
            t = t.reshape(-1, 1, 1, 1)
        return (1 - t) * x_start + t * x_end + noise * self.get_t_times_e(t)

    def sample_t(self, batch_size: int, num_timesteps: int,
                 generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """Per-sample t_float, (batch_size,) f32, by the configured strategy
        and variant: an integer on the grid of `num_timesteps` (T), over T."""
        T = num_timesteps
        mode = self.t_sampling_mode

        def randint(low, high):
            return torch.randint(low, high, (batch_size,), generator=generator, device=device)

        if self.t_variant in ("custom_t", "full_translation"):
            # joint-InDI: t in {1..T/2 - 1} (custom_t) or {1..T-1}, snapped to T/2
            if mode != "linear_indi":
                raise ValueError(f"t_variant {self.t_variant!r} needs t_sampling_mode "
                                 "'linear_indi'")
            if T % 2:
                raise ValueError(f"num_timesteps must be even for t_variant "
                                 f"{self.t_variant!r}, got {T}")
            maxv = T // 2
            t = randint(1, maxv if self.t_variant == "custom_t" else T)
            t = self._snap_to_max(t, maxv, generator)
        elif mode == "linear_indi":
            t = self._snap_to_max(randint(1, T), T, generator)
        elif mode == "uniform":
            t = randint(1, T + 1)
        elif mode == "uniform_in_range":
            t = randint((2 * T) // 3, T + 1)
        else:  # linear_ramp, quadratic_ramp: P(k) ∝ k or k², k in {0..T-1}
            p = torch.arange(T, dtype=torch.float32, device=device)
            if mode == "quadratic_ramp":
                p = p * p
            t = torch.multinomial(p / p.sum(), batch_size, replacement=True, generator=generator)
        return t.to(torch.float32) / num_timesteps

    def _snap_to_max(self, t, maxv: int, generator: Optional[torch.Generator] = None):
        """With probability 1 - 1/(a+1), replace t by maxv."""
        alpha = 1.0 / (self.linear_indi_a + 1.0)
        probab = torch.rand(t.shape, generator=generator, device=t.device)
        return torch.where(probab > alpha, torch.full_like(t, maxv), t)

    def get_prediction_during_training(self, denoise_fn: DenoiseFn, batch, num_timesteps: int,
                                       generator: Optional[torch.Generator] = None,
                                       t_float=None, noise=None):
        """net(x_t, t) for x_t on the bridge from batch['target'] (x_start) to
        batch['input'] tiled to its width (x_end, `tile_input`). t and the noise are
        drawn from `generator` (t first) unless injected."""
        if self.conditional:
            raise ValueError("InDI is an unconditional bridge: set diffusion.conditional false")
        x_start = batch["target"]
        x_end = self.tile_input(batch["input"])
        b = x_start.shape[0]
        if t_float is None:
            t_float = self.sample_t(b, num_timesteps, generator, x_start.device)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        t_float = torch.as_tensor(t_float, dtype=torch.float32, device=x_start.device)
        x_noisy = self.q_sample(x_start, x_end, t_float, noise.to(x_start.device))
        return denoise_fn(x_noisy, t_float)

    def p_losses(self, denoise_fn: DenoiseFn, batch, num_timesteps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, t_float=None, noise=None):
        """loss(batch['target'], net(x_t, t)) at the train T."""
        T = num_timesteps if num_timesteps is not None else self.num_timesteps
        x_recon = self.get_prediction_during_training(denoise_fn, batch, T, generator,
                                                      t_float, noise)
        return self.loss_fn(batch["target"], x_recon)

    @torch.no_grad()
    def inference(self, denoise_fn: DenoiseFn, x_in, num_timesteps: Optional[int] = None,
                  t_float_start: float = 1.0, generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None, continuous: bool = False):
        """Bridge inversion of NHWC `x_in` from t_float_start to 0 in N steps;
        returns (B, H, W, C·out_channel), or with `continuous` the trajectory
        (n_frames, B, H, W, C·out_channel)."""
        N = int(num_timesteps if num_timesteps is not None else self.num_timesteps)
        x_in = self.tile_input(x_in)
        draw = noise_source(x_in, N, generator, noise)
        x, delta, cur_ts = self.start(x_in, draw(0), t_float_start, N)
        b = x_in.shape[0]
        flags, _ = capture_plan(range(N), 1 | (N // 20), include_last=True)
        frames = [x] if continuous else None
        for idx, t_cur in enumerate(cur_ts):
            t_vec = torch.full((b,), float(t_cur), device=x.device, dtype=x.dtype)
            x = self.step(denoise_fn(x, t_vec), x, draw(idx + 1), t_cur, delta)
            if continuous and flags[idx]:
                frames.append(x)
        return torch.stack(frames) if continuous else x

    def tile_input(self, x):
        """The input tiled on channels to the target's width: `out_channel`
        times a one-channel input, as JAX tiles it; out_channel / C times a
        C-channel one. (JAX tiles every input `out_channel` times, so the
        3-channel CIFAR-10 input of configs/splitting_cifar10_indi.json gets 18
        channels against its 6-channel target, and its bridge fails to
        broadcast.)"""
        c = x.shape[-1]
        if self.out_channel % c:
            raise ValueError(f"out_channel {self.out_channel} is not a multiple of the "
                             f"input's {c} channels")
        return x.repeat(1, 1, 1, self.out_channel // c)

    def start(self, x_in, noise0, t_float_start: float, N: int):
        """(x at t_float_start, δ, the N step times) of an N-step chain, in f32
        as JAX computes them; `noise0` is the initial standard-normal draw."""
        x = x_in + noise0 * float(self.get_t_times_e(np.float32(t_float_start)))
        delta = np.float32(t_float_start / N)
        return x, delta, np.float32(t_float_start) - delta * np.arange(N, dtype=np.float32)

    def step(self, x0, x, noise, t_cur, delta):
        """One reverse step from step time t_cur: (δ/t)·x̂0 + (1−δ/t)·x + ε·e(t−δ).
        t_cur and δ may be f32 scalars, or (W, 1, …) f32 arrays for a window of
        steps; the arithmetic is the same element by element."""
        coef = delta / t_cur
        sigma = self.get_t_times_e(t_cur - delta)
        return x0 * _f32(coef, x) + x * _f32(np.float32(1) - coef, x) + noise * _f32(sigma, x)


def _f32(v, like):
    """A float for an f32 scalar, an f32 tensor on `like`'s device for an array."""
    if np.ndim(v) == 0:
        return float(v)
    return torch.from_numpy(np.asarray(v, np.float32)).to(like.device)
