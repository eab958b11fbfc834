"""Learning-rate schedules (and the accumulation the trainer does).

Counterpart: diffsplitting_tpu/train/optim.py (`make_lr`,
`maybe_accumulate`), which builds optax schedules and `optax.MultiSteps`;
`optax_adam` is the optimizer both train CLIs use.

``train.optimizer.schedule``, iteration-indexed::

    {"type": "cosine",  "warmup": 500, "decay_iters": N, "end_factor": 0.1}
    {"type": "linear",  "warmup": 0,   "decay_iters": N, "end_factor": 0.0}
    {"type": "constant","warmup": 500}

``decay_iters`` defaults to ``train.n_iter``; ``end_factor`` is the final LR
as a fraction of the peak; unset, the LR is fixed. The schedule is a function
of the count of optimizer updates made so far, as optax reads it: the first
update takes ``lr(0)`` (0 with a warmup).

``train.optimizer.accum_steps`` = k > 1: the trainer averages k
micro-steps' gradients (a running mean, as `optax.MultiSteps` keeps it) into
one update; params do not change between updates.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional

import torch


def optax_adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """torch's Adam with `optax.adam`'s defaults: betas 0.9 and 0.999, eps
    1e-8 added to the root of the second moment (optax's eps_root is 0)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init → end over `steps` updates, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr(lr: float, schedule_opt: Optional[Mapping], n_iter: Optional[int]
            ) -> Callable[[int], float]:
    """Update count -> learning rate."""
    sch = schedule_opt or {}
    kind = sch.get("type")
    if not kind:
        return lambda count: lr
    warmup = int(sch.get("warmup") or 0)
    decay_iters = int(sch.get("decay_iters") or n_iter or 0)
    end = float(sch.get("end_factor") or 0.0) * lr
    if kind == "constant":
        return _linear(0.0, lr, warmup) if warmup else (lambda count: lr)
    decay_len = max(decay_iters - warmup, 1)
    if kind == "cosine":
        warm = max(warmup, 1)
        alpha = 0.0 if lr == 0.0 else end / lr
        return _join(_linear(0.0 if warmup else lr, lr, warm),
                     _cosine(lr, warmup + decay_len - warm, alpha), warm)
    if kind == "linear":
        return _join(_linear(0.0 if warmup else lr, lr, max(warmup, 1)),
                     _linear(lr, end, decay_len), warmup)
    raise ValueError(f"unknown lr schedule type: {kind!r}")
