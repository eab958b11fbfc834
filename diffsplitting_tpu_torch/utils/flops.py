"""Analytic FLOP count of the diffusion UNet (for MFU).

Counterpart: diffsplitting_tpu/utils/flops.py, the same count to the FLOP.
It follows the assembly of models/unet.py (stage loop, skip concatenation,
attention placement, the mid block's attention) and counts 2·K²·Cin·Cout·H·W
a conv, 2·N²·C a matmul of the attention pair, 2·Cin·Cout a dense layer.
Elementwise work (GroupNorm, swish, adds, softmax) is not counted.
"""

from __future__ import annotations

from typing import Sequence


def conv_flops(k, cin, cout, h, w):
    return 2 * k * k * cin * cout * h * w


def unet_forward_flops(
    image_size: int,
    in_channel: int,
    out_channel: int,
    inner_channel: int,
    channel_mults: Sequence[int],
    attn_res: Sequence[int],
    res_blocks: int,
    cond: bool = True,
    batch: int = 1,
) -> float:
    """FLOPs of one UNet forward at `image_size`², per `batch` images."""
    total = 0.0

    def resnet(cin, cout, r):
        f = conv_flops(3, cin, cout, r, r)  # block1
        f += conv_flops(3, cout, cout, r, r)  # block2
        if cin != cout:
            f += conv_flops(1, cin, cout, r, r)  # res conv
        if cond:
            f += 2 * inner_channel * cout  # time/noise dense
        return f

    def attention(c, r):
        n = r * r
        f = conv_flops(1, c, 3 * c, r, r)  # qkv
        f += 2 * 2 * n * n * c  # scores + weighted sum
        f += conv_flops(1, c, c, r, r)  # out proj
        return f

    num_mults = len(channel_mults)
    now_res = image_size
    pre = inner_channel
    feat_channels = [pre]

    total += conv_flops(3, in_channel, inner_channel, now_res, now_res)  # stem
    if cond:
        total += 2 * (inner_channel * inner_channel * 4) * 2  # time MLP (tiny)

    for ind in range(num_mults):
        is_last = ind == num_mults - 1
        use_attn = now_res in attn_res
        cout = inner_channel * channel_mults[ind]
        for _ in range(res_blocks):
            total += resnet(pre, cout, now_res)
            if use_attn:
                total += attention(cout, now_res)
            feat_channels.append(cout)
            pre = cout
        if not is_last:
            total += conv_flops(3, pre, pre, now_res // 2, now_res // 2)  # downsample
            feat_channels.append(pre)
            now_res //= 2

    # mid
    total += resnet(pre, pre, now_res) + attention(pre, now_res)
    total += resnet(pre, pre, now_res)

    # decoder
    for ind in reversed(range(num_mults)):
        is_last = ind < 1
        use_attn = now_res in attn_res
        cout = inner_channel * channel_mults[ind]
        for _ in range(res_blocks + 1):
            skip = feat_channels.pop()
            total += resnet(pre + skip, cout, now_res)
            if use_attn:
                total += attention(cout, now_res)
            pre = cout
        if not is_last:
            total += conv_flops(3, pre, pre, now_res * 2, now_res * 2)  # upsample conv
            now_res *= 2

    total += conv_flops(3, pre, out_channel, now_res, now_res)  # head
    return total * batch


def config_forward_flops(model_opt, image_size: int, batch: int = 1) -> float:
    """`unet_forward_flops` of a config's `model` section at `image_size`²,
    per `batch` images. It counts the time MLP and the conditioning dense
    layers for every cond_type, 'none' included, as JAX's
    `_train_flops_per_step` does."""
    unet = model_opt["unet"]
    return unet_forward_flops(
        image_size=int(image_size),
        in_channel=unet["in_channel"],
        out_channel=unet["out_channel"],
        inner_channel=unet["inner_channel"],
        channel_mults=tuple(unet["channel_multiplier"]),
        attn_res=tuple(unet.get("attn_res") or ()),
        res_blocks=unet["res_blocks"],
        batch=batch,
    )
