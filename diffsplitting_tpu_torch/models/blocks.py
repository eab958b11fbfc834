"""UNet building blocks.

Counterpart: diffsplitting_tpu/models/blocks.py (TimeEmbedding, Block,
ResnetBlock for cond_type 'time' and 'none', SelfAttention,
ResnetBlockWithAttn, Downsample, Upsample). Submodule names follow the
reference torch naming that utils/torch_export.py emits, so reference
`*_gen.pth` files and exported JAX weights load with strict=True.

Activations are logical NCHW tensors in `torch.channels_last` memory, so the
NHWC view the kernels take is contiguous. Convolutions and linears stay
F.conv2d / F.linear: the JAX package leaves them to XLA, outside any Pallas
kernel. Dropout sits after the GroupNorm+Swish of each ResnetBlock's second
Block, as in JAX (`Dropout`, `block.2`): a plain op on the kernel's output,
active only in `train()` mode, with its mask drawn from an explicit generator
(`set_dropout_generator`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import fused_attention
from ..ops.groupnorm import fused_group_norm_swish

GN_EPS = 1e-5


def swish(x):
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class TimeEmbedding(nn.Module):
    """Sinusoidal embedding of a (B,) time vector -> (B, dim); the
    frequencies are a buffer, as in the reference (`time_mlp.0.inv_freq`)."""

    def __init__(self, dim: int):
        super().__init__()
        inv_freq = torch.exp(
            torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
        self.register_buffer("inv_freq", inv_freq)

    def forward(self, t):
        args = t.reshape(-1, 1).float() * self.inv_freq[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class GroupNormSwish(nn.Module):
    """GroupNorm with learned weight/bias followed by swish, through the
    fused op on the NHWC view. Sits at `block.0` of a Block (the reference's
    GroupNorm); the reference's Swish at `block.1` has no parameters."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # a no-op copy-free view for channels_last activations
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        y = fused_group_norm_swish(nhwc, self.weight, self.bias, self.num_groups, GN_EPS)
        return y.permute(0, 3, 1, 2)


class Dropout(nn.Module):
    """Inverted dropout as flax's `nn.Dropout`: in `train()` mode with p > 0,
    keep each element where a uniform draw is below 1 − p and scale it by
    1/(1 − p); otherwise the identity. The mask comes from `generator` (set
    by `set_dropout_generator`), never from the global RNG, and is drawn in
    the tensor's NHWC order."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode needs a generator: call "
                               "set_dropout_generator(module, generator) first")
        nhwc = x.permute(0, 2, 3, 1)
        u = torch.rand(nhwc.shape, generator=self.generator, device=x.device, dtype=x.dtype)
        keep_prob = 1.0 - self.p
        return torch.where(u < keep_prob, nhwc / keep_prob, 0.0).permute(0, 3, 1, 2)


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Every `Dropout` under `module` draws its masks from `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Block(nn.Module):
    """GroupNorm → Swish → Dropout → 3×3 conv; `block.{0,3}` carry the
    parameters, `block.2` is the dropout (an identity at rate 0)."""

    def __init__(self, dim: int, dim_out: int, groups: int, dropout: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(
            GroupNormSwish(groups, dim), nn.Identity(),
            Dropout(dropout) if dropout > 0 else nn.Identity(),
            nn.Conv2d(dim, dim_out, 3, padding=1))

    def forward(self, x):
        return self.block(x)


class ResnetBlock(nn.Module):
    """Two Blocks, the dropout in the second; cond_type 'time' adds
    Linear(swish(t)) as a channel bias after block1; a 1×1 `res_conv` when the
    widths differ."""

    def __init__(self, dim: int, dim_out: int, time_dim, norm_groups: int,
                 cond_type: str = "time", dropout: float = 0.0):
        super().__init__()
        if cond_type not in ("time", "none"):
            raise ValueError(f"cond_type {cond_type!r} is not ported")
        self.mlp = (nn.Sequential(Swish(), nn.Linear(time_dim, dim_out))
                    if cond_type == "time" else None)
        self.block1 = Block(dim, dim_out, norm_groups)
        self.block2 = Block(dim_out, dim_out, norm_groups, dropout)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None):
        h = self.block1(x)
        if self.mlp is not None:
            h = h + self.mlp(time_emb)[:, :, None, None]
        h = self.block2(h)
        return h + self.res_conv(x)


class SelfAttention(nn.Module):
    """Full spatial self-attention over H·W tokens, scale 1/√C (the full
    channel count). qkv channels per head are laid out [q | k | v]. Its own
    GroupNorm has learned weight and bias and no swish."""

    def __init__(self, channels: int, norm_groups: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.norm = nn.GroupNorm(norm_groups, channels, eps=GN_EPS)
        self.qkv = nn.Conv2d(channels, channels * 3, 1, bias=False)
        self.out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        head_dim = C // self.n_head
        qkv = self.qkv(self.norm(x))
        # NHWC, contiguous (a no-op view when the conv kept channels_last), so
        # that q, k and v are unit-stride views of one tensor
        qkv = qkv.permute(0, 2, 3, 1).contiguous().reshape(B, H * W, self.n_head, 3, head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        out = fused_attention(q, k, v, 1.0 / math.sqrt(C))
        out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.out(out) + x


class ResnetBlockWithAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_dim, norm_groups: int,
                 cond_type: str = "time", with_attn: bool = False, dropout: float = 0.0):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, time_dim, norm_groups, cond_type, dropout)
        self.attn = SelfAttention(dim_out, norm_groups) if with_attn else None

    def forward(self, x, time_emb=None):
        x = self.res_block(x, time_emb)
        if self.attn is not None:
            x = self.attn(x)
        return x


class Downsample(nn.Module):
    """Stride-2 3×3 conv, padding 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
