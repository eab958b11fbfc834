"""Training losses of the diffusion processes, and which reverse steps a
trajectory records.

Counterpart: diffsplitting_tpu/diffusion/common.py `make_loss_fn` and
`capture_plan`. The on-device trajectory buffer and the chunked scans there
exist for the JAX samplers' `lax.scan`; the port's reverse loops are plain
Python loops that keep the captured frames in a list.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

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

    `markers[k]` is the loop variable at iteration k (idx = 0..N-1 for InDI).
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
