"""Deep-feature-cached InDI and joint-InDI reverse chains (DeepCache).

Counterpart: the InDI part of diffsplitting_tpu/diffusion/deepcache.py
(`make_cached_denoisers`, `_refresh_flags`, `cached_indi_inference`,
`cached_joint_indi_inference`). The chain carries, besides x, the UNet's deep
feature from `models.deepcache.CachedUNet`: every `interval`-th step runs the
full UNet and refreshes it, the steps in between run only the shallow levels.

The noise is drawn exactly as `InDIProcess.inference` draws it (the initial
draw, then one draw a step, from the generator or from N + 1 injected
tensors), and each step does its arithmetic, so at interval 1 the cached chain
is the exact chain for the same generator state, bit for bit. The DDPM / SR3
cached loops are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.deepcache import CachedUNet
from .indi import InDIProcess, noise_source
from .joint_indi import JointInDIProcess

FullFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
ShallowFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]


def make_cached_denoisers(net, cache_depth: int) -> Tuple[FullFn, ShallowFn]:
    """(apply_full, apply_shallow) over a port UNet: apply_full(x, t) ->
    (x̂0, deep); apply_shallow(x, t, deep) -> (x̂0, deep)."""
    cnet = CachedUNet(net, cache_depth)

    def apply_full(x, t):
        return cnet(x, t)

    def apply_shallow(x, t, deep):
        return cnet(x, t, deep)

    return apply_full, apply_shallow


def _refresh_flags(N: int, interval: int, refresh_override=None) -> np.ndarray:
    """1 where step i runs the full UNet: every `interval`-th step from 0, or
    the given flags."""
    if refresh_override is not None:
        return np.asarray(refresh_override, np.int32)
    refresh = np.zeros(N, np.int32)
    refresh[::interval] = 1
    return refresh


@torch.no_grad()
def cached_indi_inference(process: InDIProcess, x_in, apply_full: FullFn,
                          apply_shallow: ShallowFn, interval: int = 1,
                          num_timesteps: Optional[int] = None, t_float_start: float = 1.0,
                          refresh_override=None, generator: Optional[torch.Generator] = None,
                          noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """`InDIProcess.inference(continuous=False)` with the deep feature cached
    between refreshes; returns (B, H, W, C·out_channel). The first step must
    refresh: there is no cache before it (JAX would start from zeros)."""
    N = int(num_timesteps if num_timesteps is not None else process.num_timesteps)
    refresh = _refresh_flags(N, interval, refresh_override)
    if refresh.shape != (N,) or not refresh[0]:
        raise ValueError(f"need {N} refresh flags starting with a refresh, got {refresh}")
    x_in = process.tile_input(x_in)
    draw = noise_source(x_in, N, generator, noise)
    x, delta, cur_ts = process.start(x_in, draw(0), t_float_start, N)
    b = x_in.shape[0]
    deep = None
    for idx, t_cur in enumerate(cur_ts):
        t_vec = torch.full((b,), float(t_cur), device=x.device, dtype=x.dtype)
        x0, deep = apply_full(x, t_vec) if refresh[idx] else apply_shallow(x, t_vec, deep)
        x = process.step(x0, x, draw(idx + 1), t_cur, delta)
    return x


def cached_joint_indi_inference(joint_process: JointInDIProcess, x_in, ch1_appliers,
                                ch2_appliers, interval: int = 1,
                                num_timesteps: Optional[int] = None,
                                t_float_start: float = 0.5,
                                generator: Optional[torch.Generator] = None,
                                noise=None) -> torch.Tensor:
    """Joint-InDI with a cache for each net: net 1 from t_float_start, net 2
    from 1 − t_float_start, concatenated on channels. `ch*_appliers` are the
    (apply_full, apply_shallow) pairs of `make_cached_denoisers`; `noise`,
    when given, is (noise for net 1, noise for net 2); from the generator,
    net 1 draws first, as `JointInDIProcess.inference` does."""
    n1, n2 = noise if noise is not None else (None, None)
    ch1 = cached_indi_inference(joint_process.indi1, x_in, *ch1_appliers, interval=interval,
                                num_timesteps=num_timesteps, t_float_start=t_float_start,
                                generator=generator, noise=n1)
    ch2 = cached_indi_inference(joint_process.indi2, x_in, *ch2_appliers, interval=interval,
                                num_timesteps=num_timesteps, t_float_start=1 - t_float_start,
                                generator=generator, noise=n2)
    return torch.cat([ch1, ch2], dim=-1)
