"""Joint InDI — two bridge models, one per fluorescence channel.

Counterpart: diffsplitting_tpu/diffusion/joint_indi.py `inference`: net 1
inverts from t_float_start (default 0.5), net 2 from 1 − t_float_start, and
the two outputs are concatenated on channels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .indi import DenoiseFn, InDIProcess


class JointInDIProcess:
    def __init__(self, out_channel: int = 1, e: float = 0.01, noise_mode: str = "gaussian",
                 num_timesteps: Optional[int] = None):
        self.indi1 = InDIProcess(out_channel, e, noise_mode, num_timesteps)
        self.indi2 = InDIProcess(out_channel, e, noise_mode, num_timesteps)
        self.num_timesteps = num_timesteps

    def inference(self, denoise_fn_ch1: DenoiseFn, denoise_fn_ch2: DenoiseFn, x_in,
                  num_timesteps: Optional[int] = None, t_float_start: float = 0.5,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None):
        """`noise`, when given, is (noise for net 1, noise for net 2)."""
        n1, n2 = noise if noise is not None else (None, None)
        ch1 = self.indi1.inference(denoise_fn_ch1, x_in, num_timesteps, t_float_start,
                                   generator, n1)
        ch2 = self.indi2.inference(denoise_fn_ch2, x_in, num_timesteps, 1 - t_float_start,
                                   generator, n2)
        return torch.cat([ch1, ch2], dim=-1)
