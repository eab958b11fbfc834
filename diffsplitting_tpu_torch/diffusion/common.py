"""Training losses of the diffusion processes, which reverse steps a
trajectory records, the trajectory loop and the noise of a chain.

Counterpart: diffsplitting_tpu/diffusion/common.py `make_loss_fn`,
`capture_plan` and `scan_with_trajectory`. The on-device trajectory buffer
there exists for the JAX samplers' `lax.scan`; the port's reverse loops are
plain Python loops that keep the captured frames in a list. `ChunkRunner`
and `chunked_reverse_scan` split one `lax.scan` into jitted chunks only to
bound the TPU compiler's program size; the port's loop is the same loop
whatever `model.sampler_chunk` says, and gives the same result.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch


def make_loss_fn(loss_type: str, reduction: str) -> Callable[[torch.Tensor, torch.Tensor],
                                                             torch.Tensor]:
    """L1 or L2 loss with mean or sum reduction (the config's `model.loss_type`
    and `model.lr_reduction`)."""
    if loss_type == "l1":
        elem = lambda a, b: (a - b).abs()  # noqa: E731
    elif loss_type == "l2":
        elem = lambda a, b: (a - b) ** 2  # noqa: E731
    else:
        raise NotImplementedError(f"loss_type={loss_type}")
    if reduction == "mean":
        red = torch.mean
    elif reduction == "sum":
        red = torch.sum
    else:
        raise NotImplementedError(f"reduction={reduction}")
    return lambda a, b: red(elem(a, b))


def capture_plan(markers: Sequence[int], sample_inter: int, include_last: bool
                 ) -> Tuple[List[int], List[int]]:
    """Which loop steps a trajectory records.

    `markers[k]` is the loop variable at iteration k: it counts down for
    DDPM and SR3 (i = T-1..0) and up for InDI (idx = 0..N-1).
    A step is captured when `marker % sample_inter == 0`, plus the final
    iteration when `include_last`. Returns (flags, slots): flags[k] == 1 if
    iteration k is captured; slots[k] is its frame index (frame 0 is the
    pre-loop frame)."""
    flags, slots = [], []
    slot = 1
    n = len(markers)
    for k, m in enumerate(markers):
        hit = (m % sample_inter == 0) or (include_last and k == n - 1)
        flags.append(1 if hit else 0)
        slots.append(slot if hit else 0)
        if hit:
            slot += 1
    return flags, slots


def scan_with_trajectory(step_fn: Callable, init_x: torch.Tensor, init_frame: torch.Tensor,
                         xs: Sequence, flags: Sequence[int]):
    """x ← step_fn(x, xs[k]) for each k; returns (the final x, the
    trajectory): `init_frame`, then x after each step k with flags[k] set,
    stacked on a new leading axis."""
    x, frames = init_x, [init_frame]
    for inp, flag in zip(xs, flags):
        x = step_fn(x, inp)
        if flag:
            frames.append(x)
    return x, torch.stack(frames)


def noise_source(x, N: int, generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> Callable[[int], torch.Tensor]:
    """draw(i): the i-th standard-normal draw of x's shape of an N-step chain
    (0 the initial, i ≥ 1 step i − 1's), from `generator` in call order or
    from the N + 1 injected tensors."""
    if noise is not None and len(noise) != N + 1:
        raise ValueError(f"need {N + 1} injected noise tensors, got {len(noise)}")

    def draw(i):
        if noise is not None:
            return noise[i].to(device=x.device, dtype=x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    return draw
