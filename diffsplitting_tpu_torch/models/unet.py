"""The diffusion UNet, cond_type 'time' and 'none'.

Counterpart: diffsplitting_tpu/models/unet.py. The topology is the same:

  * encoder: 3×3 stem conv, then per channel mult `res_blocks` ResnetBlocks
    (+attention where the running resolution is in attn_res) and a stride-2
    Downsample except after the last stage; every layer's output is pushed
    onto the skip stack;
  * mid: ResnetBlock with attention (always), then one without;
  * decoder: per reversed stage `res_blocks + 1` ResnetBlocks, each taking
    one skip by channel concat, then Upsample except for the outermost stage;
  * head: Block to out_channel.

`dropout` goes to the second Block of every ResnetBlock (the head Block has
none), as in JAX; it acts in `train()` mode only (`blocks.Dropout`).
Submodule names give exactly the state-dict keys of the reference torch
UNet (`time_mlp.*`, `downs.*`, `mid.*`, `ups.*`, `final_conv.*`).
`forward(x, t)` takes NHWC like the JAX UNet and returns NHWC float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (
    Block,
    Downsample,
    ResnetBlockWithAttn,
    Swish,
    TimeEmbedding,
    Upsample,
)


class UNet(nn.Module):
    def __init__(
        self,
        in_channel: int = 6,
        out_channel: int = 3,
        inner_channel: int = 32,
        norm_groups: int = 32,
        channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
        attn_res: Sequence[int] = (8,),
        res_blocks: int = 3,
        image_size: int = 128,
        cond_type: str = "time",
        dropout: float = 0.0,
    ):
        super().__init__()
        if cond_type == "time":
            time_dim = inner_channel
            self.time_mlp = nn.Sequential(
                TimeEmbedding(inner_channel),
                nn.Linear(inner_channel, inner_channel * 4),
                Swish(),
                nn.Linear(inner_channel * 4, inner_channel),
            )
        elif cond_type == "none":
            time_dim = None
            self.time_mlp = None
        else:
            raise ValueError(f"cond_type {cond_type!r} is not ported")
        self.in_channel = in_channel

        def rb(dim, dim_out, with_attn):
            return ResnetBlockWithAttn(dim, dim_out, time_dim, norm_groups, cond_type,
                                       with_attn=with_attn, dropout=dropout)

        num_mults = len(channel_mults)
        now_res = image_size
        pre = inner_channel
        feat_channels = [pre]
        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for ind in range(num_mults):
            is_last = ind == num_mults - 1
            use_attn = now_res in attn_res
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(rb(pre, ch, use_attn))
                feat_channels.append(ch)
                pre = ch
            if not is_last:
                downs.append(Downsample(pre))
                feat_channels.append(pre)
                now_res //= 2
        self.downs = nn.ModuleList(downs)

        self.mid = nn.ModuleList([rb(pre, pre, True), rb(pre, pre, False)])

        ups = []
        for ind in reversed(range(num_mults)):
            is_last = ind < 1
            use_attn = now_res in attn_res
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(rb(pre + feat_channels.pop(), ch, use_attn))
                pre = ch
            if not is_last:
                ups.append(Upsample(pre))
                now_res *= 2
        self.ups = nn.ModuleList(ups)

        self.final_conv = Block(pre, out_channel, norm_groups)

    def forward(self, x, time=None):
        """x: (B, H, W, in_channel); time: (B,) -> (B, H, W, out_channel) f32."""
        if x.shape[-1] != self.in_channel:
            raise ValueError(f"expected {self.in_channel} input channels, got {x.shape[-1]}")
        h = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        t = self.time_mlp(time) if self.time_mlp is not None else None

        feats = []
        for layer in self.downs:
            h = layer(h, t) if isinstance(layer, ResnetBlockWithAttn) else layer(h)
            feats.append(h)
        for layer in self.mid:
            h = layer(h, t)
        for layer in self.ups:
            if isinstance(layer, ResnetBlockWithAttn):
                h = layer(torch.cat([h, feats.pop()], dim=1), t)
            else:
                h = layer(h)
        if feats:
            raise AssertionError("unconsumed skip connections")
        return self.final_conv(h).float().permute(0, 2, 3, 1)
