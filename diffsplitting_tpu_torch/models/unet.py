"""The diffusion UNet, cond_type 'time' (DDPM, InDI), 'noise_level' (SR3) and
'none' (the time predictor's backbone).

Counterpart: diffsplitting_tpu/models/unet.py. The topology is the same:

  * encoder: 3×3 stem conv, then per channel mult `res_blocks` ResnetBlocks
    (+attention where the running resolution is in attn_res) and a stride-2
    Downsample except after the last stage; every layer's output is pushed
    onto the skip stack;
  * mid: ResnetBlock with attention (always), then one without;
  * decoder: per reversed stage `res_blocks + 1` ResnetBlocks, each taking
    one skip by channel concat, then Upsample except for the outermost stage;
  * head: Block to out_channel.

Conditioning: 'time' embeds t sinusoidally (`time_mlp.0`), 'noise_level'
embeds the continuous √ᾱ with `PositionalEncoding` (`noise_level_mlp.0`);
both then run Linear(4×) → Swish → Linear (`.1`, `.3`), and each ResnetBlock
injects the result after its first Block: a channel bias of Linear(swish(t))
('time'), or `FeatureWiseAffine` ('noise_level'; a bias, or a scale and a
bias with `use_affine_level`).

`dropout` goes to the second Block of every ResnetBlock (the head Block has
none), as in JAX; it acts in `train()` mode only (`blocks.Dropout`).
Submodule names give exactly the state-dict keys of the reference torch
UNet (`time_mlp.*`, `downs.*`, `mid.*`, `ups.*`, `final_conv.*`).
`forward(x, t)` takes NHWC like the JAX UNet and returns NHWC float32.

`dtype` (torch.bfloat16 or None, float32) is the compute dtype, as JAX's
`dtype`: the parameters stay float32, every Conv/Linear computes in it
(`blocks.Conv2d`, `blocks.Linear`), the input is cast to it at the entry and
the output to float32 at the exit, and the conditioning is cast to it after
the embedding MLP.

`remat` rematerializes, in `train()` mode, each ResnetBlockWithAttn whose
resolution is at least `remat_min_res` (0: all), as JAX wraps them in
`nn.remat`: `torch.utils.checkpoint` keeps only the block's inputs and
recomputes the rest in the backward (`remat_block`), replaying the forward's
dropout masks. The parameter names do not change, so remat and plain
checkpoints are interchangeable.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (
    Block,
    Conv2d,
    Downsample,
    Dropout,
    Linear,
    PositionalEncoding,
    ResnetBlockWithAttn,
    Swish,
    TimeEmbedding,
    Upsample,
)


def remat_block(layer: ResnetBlockWithAttn, x, t):
    """`layer(x, t)` under activation checkpointing (non-reentrant): the
    forward keeps only x and t, and the backward runs the block again. Its
    Dropouts draw from explicit generators, which checkpoint's
    `preserve_rng_state` does not cover, so the recompute sets each generator
    back to its state at the block's entry, as `nn.remat` replays its keys,
    and afterwards to the state it had found (the recompute may stop early)."""
    gens = []
    for m in layer.modules():
        if (isinstance(m, Dropout) and m.training and m.p > 0 and m.generator is not None
                and all(m.generator is not g for g in gens)):
            gens.append(m.generator)
    entry = [g.get_state() for g in gens]
    calls = [0]

    def run(x, t):
        calls[0] += 1
        if calls[0] == 1:
            return layer(x, t)
        found = [g.get_state() for g in gens]
        for g, state in zip(gens, entry):
            g.set_state(state)
        try:
            return layer(x, t)
        finally:
            for g, state in zip(gens, found):
                g.set_state(state)

    return checkpoint(run, x, t, use_reentrant=False, preserve_rng_state=False)


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
        use_affine_level: bool = False,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        remat_min_res: int = 0,
    ):
        super().__init__()
        if cond_type not in ("time", "noise_level", "none"):
            raise ValueError(f"cond_type {cond_type!r}")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        self.compute_dtype = None if dtype == torch.float32 else dtype

        def mlp(embedding):
            return nn.Sequential(embedding, Linear(inner_channel, inner_channel * 4), Swish(),
                                 Linear(inner_channel * 4, inner_channel))

        self.time_mlp = mlp(TimeEmbedding(inner_channel)) if cond_type == "time" else None
        self.noise_level_mlp = (mlp(PositionalEncoding(inner_channel))
                                if cond_type == "noise_level" else None)
        time_dim = None if cond_type == "none" else inner_channel
        self.cond_type = cond_type
        self.in_channel = in_channel
        self.image_size = image_size

        def rb(dim, dim_out, with_attn):
            block = ResnetBlockWithAttn(dim, dim_out, time_dim, norm_groups, cond_type,
                                        with_attn=with_attn, dropout=dropout,
                                        use_affine_level=use_affine_level)
            # JAX's selective remat: blocks at a resolution >= remat_min_res
            block.remat = bool(remat) and now_res >= remat_min_res
            return block

        num_mults = len(channel_mults)
        now_res = image_size
        pre = inner_channel
        feat_channels = [pre]
        downs = [Conv2d(in_channel, inner_channel, 3, padding=1)]
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
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                m.compute_dtype = self.compute_dtype

    def embed(self, time):
        """The (B, inner_channel) conditioning of a (B,) step or noise level
        in the compute dtype, or None for cond_type 'none'."""
        mlp = self.time_mlp if self.time_mlp is not None else self.noise_level_mlp
        if mlp is None:
            return None
        t = mlp(time)
        return t if self.compute_dtype is None else t.to(self.compute_dtype)

    def entry(self, x):
        """An NHWC input, its channels checked, as the NCHW channels_last
        activation in the compute dtype (float32 when None)."""
        if x.shape[-1] != self.in_channel:
            raise ValueError(f"expected {self.in_channel} input channels, got {x.shape[-1]}")
        h = x.to(self.compute_dtype or torch.float32).permute(0, 3, 1, 2)
        return h.contiguous(memory_format=torch.channels_last)

    def block(self, layer: ResnetBlockWithAttn, h, t):
        """One ResnetBlockWithAttn, rematerialized when it is marked so and
        the forward records a graph in train mode."""
        if layer.remat and self.training and torch.is_grad_enabled():
            return remat_block(layer, h, t)
        return layer(h, t)

    def forward(self, x, time=None):
        """x: (B, H, W, in_channel); time: (B,) step or noise level ->
        (B, H, W, out_channel) f32."""
        h = self.entry(x)
        t = self.embed(time)

        feats = []
        for layer in self.downs:
            h = self.block(layer, h, t) if isinstance(layer, ResnetBlockWithAttn) else layer(h)
            feats.append(h)
        for layer in self.mid:
            h = self.block(layer, h, t)
        for layer in self.ups:
            if isinstance(layer, ResnetBlockWithAttn):
                h = self.block(layer, torch.cat([h, feats.pop()], dim=1), t)
            else:
                h = layer(h)
        if feats:
            raise AssertionError("unconsumed skip connections")
        return self.final_conv(h).float().permute(0, 2, 3, 1)
