"""The central UNet apply: the module's own forward, or the stat-carried fused
inference forward behind `DSP_FUSED=1`.

Counterpart: diffsplitting_tpu/models/forward_utils.py (`fused_enabled`,
`apply_unet`). The switch is the same environment variable, so `DSP_FUSED=1`
opts the port in exactly as it opts the JAX package in; a caller may also
pass `fused=True` or `fused=False`.
"""

from __future__ import annotations

import os
from typing import Optional

from .fused_forward import fused_unet_forward


def fused_enabled() -> bool:
    """The fused inference path, opt-in: DSP_FUSED=1."""
    return os.environ.get("DSP_FUSED") == "1"


def apply_unet(net, x, time=None, fused: Optional[bool] = None):
    """`net(x, time)`, or `fused_unet_forward(net, x, time)` when `fused` is
    True (None: as DSP_FUSED says). Both take and return NHWC."""
    if fused is None:
        fused = fused_enabled()
    if fused:
        return fused_unet_forward(net, x, time)
    return net(x, time)
