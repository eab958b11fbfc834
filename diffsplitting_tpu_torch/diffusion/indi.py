"""InDI — Inversion by Direct Iteration: the deterministic-bridge process.

Counterpart: diffsplitting_tpu/diffusion/indi.py (`get_t_times_e`,
`q_sample`, and `inference` with continuous=False):

  * forward bridge: x_t = (1-t)·x_start + t·x_end + ε·e(t), with
    e(t) = e·t (gaussian, none) or e·√t (brownian);
  * inference: N uniform steps down from t_start; with δ = t_start/N and
    step times t = t_start − δ·idx in f32,
    x ← (δ/t)·x̂0 + (1−δ/t)·x + ε·e(t−δ).

Noise comes from an explicit `torch.Generator` on the device, or from an
injected list of N+1 tensors (the initial draw, then one per step), which the
parity tests use to replay the JAX draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class InDIProcess:
    def __init__(self, out_channel: int = 2, e: float = 0.01, noise_mode: str = "gaussian",
                 num_timesteps: Optional[int] = None):
        if noise_mode not in ("gaussian", "brownian", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        self.out_channel = out_channel
        self.e = 0.0 if noise_mode == "none" else e
        self.noise_mode = noise_mode
        self.num_timesteps = num_timesteps

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

    @torch.no_grad()
    def inference(self, denoise_fn: DenoiseFn, x_in, num_timesteps: Optional[int] = None,
                  t_float_start: float = 1.0, generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None):
        """Bridge inversion of NHWC `x_in` from t_float_start to 0 in N steps;
        returns (B, H, W, C·out_channel)."""
        N = int(num_timesteps if num_timesteps is not None else self.num_timesteps)
        if noise is not None and len(noise) != N + 1:
            raise ValueError(f"need {N + 1} injected noise tensors, got {len(noise)}")
        x_in = x_in.repeat(1, 1, 1, self.out_channel)

        def draw(i):
            if noise is not None:
                return noise[i].to(device=x_in.device, dtype=x_in.dtype)
            return torch.randn(x_in.shape, generator=generator, device=x_in.device,
                               dtype=x_in.dtype)

        x = x_in + draw(0) * float(self.get_t_times_e(np.float32(t_float_start)))
        delta = np.float32(t_float_start / N)
        cur_ts = np.float32(t_float_start) - delta * np.arange(N, dtype=np.float32)
        b = x_in.shape[0]
        for idx, t_cur in enumerate(cur_ts):
            t_vec = torch.full((b,), float(t_cur), device=x.device, dtype=x.dtype)
            x0 = denoise_fn(x, t_vec)
            coef = delta / t_cur
            sigma = self.get_t_times_e(t_cur - delta)
            x = x0 * float(coef) + x * float(np.float32(1) - coef) + draw(idx + 1) * float(sigma)
        return x
