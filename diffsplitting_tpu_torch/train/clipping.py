"""Gradient clipping (`train.optimizer.grad_clip`), off unless configured.

Counterpart: diffsplitting_tpu/train/clipping.py (`maybe_clip`,
`clip_by_ema_norm`) and `optax.clip_by_global_norm`:

  * a float: scale every gradient by max_norm / norm when norm >= max_norm,
    as optax computes it ((g / norm) · max_norm). Not
    `torch.nn.utils.clip_grad_norm_`, whose max_norm / (norm + 1e-6) is
    another result;
  * "auto": clip to `grad_clip_factor` (default 2.5) × a bias-corrected EMA
    of the post-clip norm, nothing clipped in the first `warmup` (25) updates.

Each clipper works in place on the gradients of one update and keeps its
state on the gradients' device, so it forces no host sync.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


class ClipByGlobalNorm:
    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def __call__(self, grads: Sequence[torch.Tensor]) -> None:
        norm = global_norm(grads)
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))


class ClipByEmaNorm:
    """State (ema, count): ema is the f32 EMA of the post-clip norm, count
    the updates seen."""

    def __init__(self, factor: float = 2.5, decay: float = 0.98, warmup: int = 25,
                 eps: float = 1e-8):
        if warmup < 1:
            raise ValueError("clip_by_ema_norm needs >= 1 warmup step")
        self.factor, self.decay, self.warmup, self.eps = factor, decay, warmup, eps
        self.ema: Optional[torch.Tensor] = None
        self.count = 0

    def __call__(self, grads: Sequence[torch.Tensor]) -> None:
        norm = global_norm(grads)
        if self.ema is None:
            self.ema = torch.zeros((), dtype=torch.float32, device=norm.device)
        self.count += 1
        # ema holds count - 1 accumulations: bias-correct by 1 - decay^(count-1)
        corr = max(1.0 - self.decay ** (self.count - 1), self.eps)
        limit = self.factor * self.ema / corr
        if self.count <= self.warmup:
            tracked = norm
        else:
            scale = torch.where(norm > limit, limit / (norm + self.eps), torch.ones_like(norm))
            for g in grads:
                g.mul_(scale)
            tracked = torch.minimum(norm, limit)
        self.ema = self.decay * self.ema + (1.0 - self.decay) * tracked


def make_clip(optimizer_opt: Optional[Mapping]):
    """The configured clipper, or None (the default: no clipping)."""
    gc = (optimizer_opt or {}).get("grad_clip")
    if not gc:
        return None
    if gc == "auto":
        return ClipByEmaNorm(factor=float((optimizer_opt or {}).get("grad_clip_factor") or 2.5))
    return ClipByGlobalNorm(float(gc))
