"""Stat-carried fused UNet inference forward.

Counterpart: diffsplitting_tpu/experimental/fused_forward.py
(`fused_unet_apply`). It runs the same weights as `models.unet.UNet`, read in
place from the module, as a chain of fused conv+GroupNorm convolutions
(ops/conv_gn.py): every ResnetBlock is two conv sites. No
normalized tensor is written; each conv's epilogue emits the per-(B, C) sums
and sums of squares that the next GroupNorm folds into its prologue
(`fold_gn_affine`); the conditioning of a ResnetBlock (the time bias, or
SR3's noise-level FiLM: a bias from `FeatureWiseAffine`'s linear with no
swish, or the scale 1 + γ and bias β with `use_affine_level`) is absorbed
into the carried statistics and the next conv's prologue
(`st_add_channel_affine`);
the residual is added in the conv's epilogue.

Stem and downsampling convs run through `F.conv2d` with `channel_stats`, as
the JAX walk leaves them to XLA; attention launches the attention kernel; each
upsample is nearest ×2 then a conv without a prologue; the head runs the
GroupNorm+Swish kernel on its input, then `F.conv2d`.

Every ResnetBlock and upsample conv site is planned by its widths before
anything is launched, as JAX's `_plan_conv` plans them: a site the conv_gn
kernel takes (`ops.conv_gn.conv_gn_takes`) launches it; any other runs what
JAX's `_xla_block` runs, out of library ops: the pending GroupNorm folded
into a per-(B, C) scale and shift, swish, `F.conv2d`, the residual or its 1×1
projection, and the channel sums the next GroupNorm needs. `ConvSitePlan`
counts the sites planned each way.

Activations are NHWC-contiguous tensors, as `ST.data` is in JAX. The pair
layout and its lane maps exist only for the TPU and are not ported.

Deliberate departure from the JAX walk: the JAX walk drops the bias of the
ResnetBlock's 1×1 `res_conv` (it takes only its kernel as W_skip), so it
disagrees with `net.apply` whenever that bias is not zero. Here the bias is
added to the second conv's bias (b + b_skip), which matches the UNet.

Compute dtype: the walk runs at the UNet's, as JAX's runs at `cfg.dtype`.
At bfloat16 it follows JAX's cast points (`fused_unet_apply`): the input is
cast to bf16 and the stem and downsampling convs run in bf16; activations are
carried in bf16 with f32 statistics (`channel_stats` sums bf16 data in f32);
the FiLM scale and bias are f32 (the linear's bf16 output made f32 before
1 + γ); `materialize` applies a pending affine cast to the data's dtype;
conv sites on the kernel run the bf16 conv_gn kernel (f32 prologue rounded
to bf16, bf16 products, f32 sums and statistics, y rounded once), and
library sites compute the same thing out of library ops: the prologue in
f32 rounded to bf16, `F.conv2d` in bf16, the bias and the residual (or its
projection, `@` in bf16) added in f32, the statistics of that f32 sum, y
rounded once. cuDNN and cuBLAS round their bf16 outputs before the bias and
the residual are added, one rounding more than JAX's f32 accumulation: that
is the reason for the tolerance of `tests/test_torch_port_fused_bf16.py`.
Attention's normalized input is rounded to bf16 before its qkv linear, the
attention kernel runs at bf16 and `out + x` is a bf16 add. The head runs
the bf16 GroupNorm+Swish kernel, which recomputes the statistics from the
bf16 data where JAX folds the carried ones, then its conv in bf16; the
output is f32. Conv biases are rounded to bf16 at bf16 (as each `Conv2d`
rounds its own, and as DSP_PRECAST's bf16 copies hold them), where JAX adds
its f32 biases as they are: so the walk gives the same bits with and without
DSP_PRECAST=1. At float32 every cast is the identity.

Inference only: it runs without autograd, and the conv kernels have no
backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..ops.conv_gn import channel_stats, conv_gn_fused, conv_gn_takes, fold_gn_affine
from ..ops.groupnorm import fused_group_norm_swish
from .blocks import GN_EPS, ResnetBlockWithAttn, swish


class ConvSitePlan:
    """Counts of the conv sites planned to the conv_gn kernel (`kernel`) and
    to library ops (`library`), one per site as the walk reaches it."""

    kernel = 0
    library = 0


@dataclasses.dataclass
class ST:
    """An activation with its carried statistics and a pending channel affine.

    data: (B, H, W, C) NHWC-contiguous, in the compute dtype. The true tensor is
    data·cscale + cbias (per (B, C), never materialized: absorbed into the next
    conv's prologue). sums and sumsqs: (B, C) f32 sums of the TRUE tensor and
    its square over H and W."""

    data: torch.Tensor
    sums: torch.Tensor
    sumsqs: torch.Tensor
    cbias: Optional[torch.Tensor] = None
    cscale: Optional[torch.Tensor] = None

    @property
    def channels(self) -> int:
        return int(self.sums.shape[-1])

    @property
    def hw(self) -> int:
        return self.data.shape[1] * self.data.shape[2]


def st_from(data, sums=None, sumsqs=None) -> ST:
    if sums is None:
        sums, sumsqs = channel_stats(data)
    return ST(data, sums, sumsqs)


def materialize(st: ST) -> torch.Tensor:
    """The true tensor, with any pending affine applied in the data's dtype
    (the f32 affine cast to it, as JAX's `materialize` does)."""
    d = st.data
    if st.cscale is not None:
        d = d * st.cscale[:, None, None, :].to(d.dtype)
    if st.cbias is not None:
        d = d + st.cbias[:, None, None, :].to(d.dtype)
    return d


def st_concat(a: ST, b: ST) -> ST:
    """Channel concat of two tensors without a pending affine."""
    if any(v is not None for v in (a.cbias, a.cscale, b.cbias, b.cscale)):
        raise ValueError("st_concat takes tensors without a pending affine")
    return ST(torch.cat([a.data, b.data], dim=-1), torch.cat([a.sums, b.sums], dim=-1),
              torch.cat([a.sumsqs, b.sumsqs], dim=-1))


def st_add_channel_affine(st: ST, bias=None, scale=None) -> ST:
    """Pending per-(B, C) affine: true' = true·scale + bias. The statistics
    are updated exactly; the data is untouched (absorbed downstream).

    Composition with an existing pending (cs, cb): true = d·cs + cb, so
    true' = d·(cs·a) + (cb·a + b)."""
    n = st.hw
    s, q = st.sums, st.sumsqs
    cs, cb = st.cscale, st.cbias
    if scale is not None:
        q = scale * scale * q
        s = scale * s
        cs = scale if cs is None else cs * scale
        cb = None if cb is None else cb * scale
    if bias is not None:
        q = q + 2 * bias * s + n * bias * bias
        s = s + n * bias
        cb = bias if cb is None else cb + bias
    return ST(st.data, s, q, cb, cs)


def gn_conv(st: ST, gn_scale, gn_bias, groups: int, K, bias, *, residual: Optional[ST],
            w_skip=None) -> ST:
    """GroupNorm from st's statistics → swish → conv3×3 (K HWIO) →
    [+ residual, projected by w_skip when given], with the statistics of the
    output. A pending affine on st is folded into the prologue; the residual
    must have none."""
    scale_raw, shift = fold_gn_affine(st.sums, st.sumsqs, st.hw, gn_scale, gn_bias, groups,
                                      GN_EPS)
    # normalize(d·cs + cb) = d·(cs·s_raw) + (cb·s_raw + shift)
    scale = scale_raw if st.cscale is None else scale_raw * st.cscale
    if st.cbias is not None:
        shift = shift + st.cbias * scale_raw
    if residual is not None and (residual.cbias is not None or residual.cscale is not None):
        raise ValueError("gn_conv takes a residual without a pending affine")
    r = residual.data if residual is not None else None
    return ST(*conv_site(st.data, K, bias, scale, shift, r, w_skip))


def conv_site(x, K, bias, scale=None, shift=None, residual=None, w_skip=None):
    """[affine + swish] → conv3×3 (K HWIO) → [+ residual, projected by w_skip
    when given] → (y in x's dtype, per-(B, C) f32 sums, sums of squares):
    through the conv_gn kernel when it takes these widths, else through
    library ops (at bf16 x: the prologue in f32 rounded to bf16, the conv and
    the projection in bf16, the bias and the residual added in f32, the
    statistics of that sum, y rounded once)."""
    Cres = residual.shape[-1] if residual is not None else 0
    if conv_gn_takes(x.shape[-1], K.shape[-1], Cres):
        ConvSitePlan.kernel += 1
        return conv_gn_fused(x, K, bias, scale, shift, residual, w_skip)
    ConvSitePlan.library += 1
    dt = x.dtype
    xa = x
    if scale is not None:
        xa = swish(x.float() * scale[:, None, None, :] + shift[:, None, None, :]).to(dt)
    f32 = dt == torch.float32
    y = F.conv2d(xa.permute(0, 3, 1, 2), K.to(dt).permute(3, 2, 0, 1), bias if f32 else None,
                 padding=1)
    y = y.permute(0, 2, 3, 1)
    if not f32:
        y = y.float() + bias.float()
    if residual is not None:
        y = y + (residual @ w_skip.to(dt) if w_skip is not None else residual).float()
    y = y.contiguous()
    return (y.to(dt), *channel_stats(y))


def _hwio(conv: nn.Conv2d):
    """The conv's OIHW weight as an HWIO view (no copy)."""
    return conv.weight.permute(2, 3, 1, 0)


def _conv_nhwc(conv: nn.Conv2d, x):
    """A torch conv on an NHWC tensor; returns an NHWC-contiguous tensor
    (cuDNN may hand back either memory format)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def _bias(conv: nn.Conv2d, dtype):
    """The conv's bias rounded to the compute dtype, as f32 (as the conv
    itself and DSP_PRECAST's bf16 copy hold it)."""
    return conv.bias.to(dtype).float()


def resnet_block(st: ST, layer: ResnetBlockWithAttn, t) -> ST:
    rb = layer.res_block
    b1, b2 = rb.block1.block, rb.block2.block
    groups = b1[0].num_groups
    dt = st.data.dtype
    h = gn_conv(st, b1[0].weight, b1[0].bias, groups, _hwio(b1[3]), _bias(b1[3], dt),
                residual=None)
    if t is not None:
        scale, bias = rb.film(t, torch.float32)
        h = st_add_channel_affine(h, bias=bias, scale=scale)
    bias2, w_skip = _bias(b2[3], dt), None
    if isinstance(rb.res_conv, nn.Conv2d):
        w_skip = rb.res_conv.weight[:, :, 0, 0].t()  # (Cin, Cout) view
        bias2 = bias2 + _bias(rb.res_conv, dt)  # the JAX walk drops this bias
    return gn_conv(h, b2[0].weight, b2[0].bias, groups, _hwio(b2[3]), bias2,
                   residual=st, w_skip=w_skip)


def attention(st: ST, attn) -> ST:
    """GroupNorm from the carried statistics (f32, rounded to the data's
    dtype), 1×1 qkv, the attention kernel, 1×1 out + the block's input."""
    B, H, W, C = st.data.shape
    dt = st.data.dtype
    scale, shift = fold_gn_affine(st.sums, st.sumsqs, st.hw, attn.norm.weight,
                                  attn.norm.bias, attn.norm.num_groups, attn.norm.eps)
    xd = materialize(st)
    hn = (xd.float() * scale[:, None, None, :] + shift[:, None, None, :]).to(dt)
    qkv = F.linear(hn, attn.qkv.weight[:, :, 0, 0].to(dt))
    qkv = qkv.reshape(B, H * W, attn.n_head, 3, C // attn.n_head)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    out = fused_attention(q, k, v, 1.0 / math.sqrt(C)).reshape(B, H, W, C)
    return st_from(F.linear(out, attn.out.weight[:, :, 0, 0].to(dt), attn.out.bias.to(dt)) + xd)


def rb_with_attn(st: ST, layer: ResnetBlockWithAttn, t) -> ST:
    st = resnet_block(st, layer, t)
    if layer.attn is not None:
        st = attention(st, layer.attn)
    return st


@torch.no_grad()
def fused_unet_forward(unet, x, time=None):
    """Inference forward of `models.unet.UNet` through fused conv+GroupNorm
    chaining, at the UNet's compute dtype. x: (B, H, W, in_channel); time:
    (B,) step or noise level. Returns (B, H, W, out_channel) f32, as
    `unet(x, time)` does."""
    if x.shape[-1] != unet.in_channel:
        raise ValueError(f"expected {unet.in_channel} input channels, got {x.shape[-1]}")
    t = unet.embed(time)

    h = st_from(_conv_nhwc(unet.downs[0], x.to(unet.compute_dtype or torch.float32).contiguous()))
    feats = [h]
    for layer in unet.downs[1:]:
        if isinstance(layer, ResnetBlockWithAttn):
            h = rb_with_attn(h, layer, t)
        else:  # Downsample
            h = st_from(_conv_nhwc(layer.conv, materialize(h)))
        feats.append(h)
    for layer in unet.mid:
        h = rb_with_attn(h, layer, t)
    for layer in unet.ups:
        if isinstance(layer, ResnetBlockWithAttn):
            h = rb_with_attn(st_concat(h, feats.pop()), layer, t)
        else:  # Upsample: nearest ×2, then the conv without a prologue
            d = materialize(h)
            B, H, W, C = d.shape
            up = d[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
            h = ST(*conv_site(up, _hwio(layer.conv), _bias(layer.conv, up.dtype)))
    if feats:
        raise AssertionError("unconsumed skip connections")

    head = unet.final_conv.block
    hn = fused_group_norm_swish(materialize(h), head[0].weight, head[0].bias,
                                head[0].num_groups, GN_EPS)
    return head[3](hn.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)
