"""Deep-feature-cached reverse chains (DeepCache): InDI, joint-InDI, and the
DDPM / SR3 ancestral and respaced DDIM chains.

Counterpart: diffsplitting_tpu/diffusion/deepcache.py
(`make_cached_denoisers`, `_refresh_flags`, `cached_indi_inference`,
`cached_joint_indi_inference`, `cached_p_sample_loop`,
`cached_ddim_sample_loop`). The chain carries, besides x, the UNet's deep
feature from `models.deepcache.CachedUNet`: every `interval`-th step runs the
full UNet and refreshes it, the steps in between run only the shallow levels.
The first step must refresh: there is no cache before it (JAX would start
from zeros).

The noise is drawn exactly as the exact chain draws it (the initial draw,
then one draw a step, from the generator or from injected tensors), and each
step does its arithmetic: the DDPM / SR3 loops run the exact chain's own loop
(`ddpm.reverse_chain`, `ddim.ddim_sample_loop`) with a denoiser that keeps
the cache between its calls. So at interval 1 a cached chain is the exact
chain for the same generator state, bit for bit. JAX's `_chunked` forms
split one `lax.scan` only to bound the TPU compiler's program and have no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.deepcache import CachedUNet
from .ddim import ddim_sample_loop, ddim_timesteps
from .ddpm import reverse_chain
from .indi import InDIProcess, noise_source
from .joint_indi import JointInDIProcess

FullFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
ShallowFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]


def make_cached_denoisers(net, cache_depth: int) -> Tuple[FullFn, ShallowFn]:
    """(apply_full, apply_shallow) over a port UNet: apply_full(x, t) ->
    (out, deep); apply_shallow(x, t, deep) -> (out, deep), out the UNet's
    output (x̂0 for InDI, ε̂ for DDPM / SR3)."""
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


def _checked_flags(N: int, interval: int, refresh_override=None) -> np.ndarray:
    refresh = _refresh_flags(N, interval, refresh_override)
    if refresh.shape != (N,) or not refresh[0]:
        raise ValueError(f"need {N} refresh flags starting with a refresh, got {refresh}")
    return refresh


class _CachingDenoiser:
    """A (net_in, conditioning) -> ε̂ denoiser for a chain that calls it once
    a step, in order: the full UNet where the step's flag is set (keeping its
    deep feature), the shallow levels on the kept one elsewhere."""

    def __init__(self, apply_full: FullFn, apply_shallow: ShallowFn, refresh: np.ndarray):
        self.apply_full, self.apply_shallow = apply_full, apply_shallow
        self.refresh, self.step, self.deep = refresh, 0, None

    def __call__(self, net_in, level):
        if self.refresh[self.step]:
            eps, self.deep = self.apply_full(net_in, level)
        else:
            eps, self.deep = self.apply_shallow(net_in, level, self.deep)
        self.step += 1
        return eps

    def check_done(self):
        if self.step != len(self.refresh):
            raise AssertionError(f"the chain made {self.step} of {len(self.refresh)} steps")


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
    refresh = _checked_flags(N, interval, refresh_override)
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


@torch.no_grad()
def cached_p_sample_loop(process, sched, x_in, apply_full: FullFn, apply_shallow: ShallowFn,
                         interval: int = 1, clip_denoised: bool = True, refresh_override=None,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None,
                         device=None) -> torch.Tensor:
    """The T-step reverse chain of a DDPM or SR3 `process` (`p_sample_loop`,
    continuous=False) with the deep feature cached between refreshes. x_in:
    the NHWC condition when the process is conditional, else the shape
    (B, H, W, C) of the sample (on `device`). The appliers take the net's
    input (the condition and x on channels) and conditioning, and return
    (ε̂, deep). Returns the final image."""
    fn = _CachingDenoiser(apply_full, apply_shallow,
                          _checked_flags(sched.num_timesteps, interval, refresh_override))
    out = reverse_chain(process, fn, sched, x_in, clip_denoised, generator=generator,
                        noise=noise, device=device)
    fn.check_done()
    return out


@torch.no_grad()
def cached_ddim_sample_loop(process, sched, x_in, apply_full: FullFn, apply_shallow: ShallowFn,
                            steps: int, eta: float = 0.0, interval: int = 1,
                            clip_denoised: bool = True, refresh_override=None,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[Sequence[torch.Tensor]] = None,
                            device=None) -> torch.Tensor:
    """The respaced DDIM chain (`ddim.ddim_sample_loop`) with the deep
    feature cached between refreshes, `interval` counted over its S steps.
    Same x_in and appliers as `cached_p_sample_loop`."""
    S = len(ddim_timesteps(sched.num_timesteps, steps))
    fn = _CachingDenoiser(apply_full, apply_shallow, _checked_flags(S, interval, refresh_override))
    out = ddim_sample_loop(process, fn, sched, x_in, steps, eta, clip_denoised,
                           generator=generator, noise=noise, device=device)
    fn.check_done()
    return out
