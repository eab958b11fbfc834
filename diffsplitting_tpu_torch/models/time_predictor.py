"""The time predictor: a regressor of the mixing fraction t of a micrograph.

Counterpart: diffsplitting_tpu/models/time_predictor.py (`ForegroundMask`,
`TimePredictor`). The backbone is the port's UNet with cond_type 'none'; a
7×7 conv and a sigmoid give a per-pixel foreground weight over the raw input;
the relu'd UNet output, times that weight, is pooled to one t per image by
the weighted mean (sum of out·mask over sum of mask).

Parameter names: the UNet's reference names under `unet.*`, the mask conv
under `foreground_mask.conv.*` (named after the JAX module; the reference's
own TimePredictor keys are not known here). `forward` takes NHWC, as the JAX
module does, and returns (B,) float32. Dropout in the backbone acts in
`train()` mode only, with masks from the generator that
`models.blocks.set_dropout_generator` sets.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .unet import UNet


class ForegroundMask(nn.Module):
    """sigmoid(conv7×7(x)), 'SAME' padding, on an NCHW tensor."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, out_channel, 7, padding=3)

    def forward(self, x):
        return torch.sigmoid(self.conv(x))


class TimePredictor(nn.Module):
    def __init__(
        self,
        in_channel: int = 6,
        out_channel: int = 3,
        inner_channel: int = 32,
        norm_groups: int = 32,
        channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
        attn_res: Sequence[int] = (8,),
        res_blocks: int = 3,
        dropout: float = 0.0,
        image_size: int = 128,
    ):
        super().__init__()
        self.unet = UNet(in_channel=in_channel, out_channel=out_channel,
                         inner_channel=inner_channel, norm_groups=norm_groups,
                         channel_mults=channel_mults, attn_res=attn_res,
                         res_blocks=res_blocks, image_size=image_size, cond_type="none",
                         dropout=dropout)
        self.foreground_mask = ForegroundMask(in_channel, out_channel)

    def forward(self, x):
        """x: (B, H, W, in_channel) -> (B,) predicted mixing fraction t."""
        x = x.float()
        out = torch.relu(self.unet(x))  # NHWC
        mask = self.foreground_mask(
            x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        ).permute(0, 2, 3, 1)
        b = out.shape[0]
        return (out * mask).reshape(b, -1).sum(dim=1) / mask.reshape(b, -1).sum(dim=1)

