"""Training losses of the diffusion processes.

Counterpart: diffsplitting_tpu/diffusion/common.py `make_loss_fn`. The
trajectory capture and the chunked scans there exist for the JAX samplers and
are not ported.
"""

from __future__ import annotations

from typing import Callable

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
