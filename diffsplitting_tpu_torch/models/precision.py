"""The UNet's compute dtype, and inference-time parameter precasting.

Counterpart: diffsplitting_tpu/models/precision.py
(`cast_unet_params_for_inference`) and the `compute_dtype` key that
diffsplitting_tpu/train/factory.py reads.

Parameters stay float32 at every compute dtype. At `compute_dtype:
bfloat16` each Conv/Linear casts its weight and bias to bf16 at the call
(`blocks.Conv2d`, `blocks.Linear`), as flax's `promote_dtype` does.
`cast_unet_params_for_inference` does those casts once: a copy of the module
whose Conv/Linear weights and biases are bf16 computes bit for bit what the
f32 module computes at bf16, since the weights go through the same f32 → bf16
rounding either way. GroupNorm affines (`block.0` of each Block, `norm` of the
attention block) are not cast: the statistics and the affine run in f32.
Serving opts in with DSP_PRECAST=1, as the JAX trainer does.
"""

from __future__ import annotations

import copy
import os
from typing import Mapping, Optional

import torch
from torch import nn

# config value -> the UNet's compute dtype (None: float32, the parameters' own)
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(model_opt: Mapping) -> Optional[torch.dtype]:
    """The compute dtype of a config's `model` section: None (float32) or
    torch.bfloat16. Raises on a value the JAX package does not take."""
    name = model_opt.get("compute_dtype")
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype={name!r}: the JAX package and its port take "
                                  "float32 or bfloat16")
    return COMPUTE_DTYPES[name]


def precast_enabled() -> bool:
    """Inference precasting, opt-in: DSP_PRECAST=1."""
    return os.environ.get("DSP_PRECAST") == "1"


def cast_unet_params_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A copy of `module` whose Conv2d / Linear weights and biases are `dtype`
    (frozen); every other parameter and buffer is copied as it is. The f32
    originals of the cast parameters are not copied."""
    memo = {}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            for p in m.parameters(recurse=False):
                memo[id(p)] = nn.Parameter(p.detach().to(dtype), requires_grad=False)
    return copy.deepcopy(module, memo)
