"""DeepCache: the UNet split into a shallow part and a cached deep part.

Counterpart: diffsplitting_tpu/models/deepcache.py (`CachedUNet`). Across
adjacent reverse steps the deep UNet features change slowly, so every
`interval`-th step runs the full forward and keeps the deep feature, and the
steps in between run only the shallow levels and reuse it
(diffusion/deepcache.py).

At split depth d (1 ≤ d ≤ len(channel_mults) − 1, in encoder stages):
  * shallow = the stem, encoder stages 0..d−1 (and their skips; stage d−1's
    Downsample runs only in the full pass, since only the deep part reads
    it), decoder stages d−1..0 and the head;
  * deep = stage d−1's Downsample, encoder stages d.., the mid block, decoder
    stages ..d and stage d's Upsample; its output, the tensor that enters
    decoder stage d−1, is the cache.

`CachedUNet` walks a port `UNet`'s own `downs` / `mid` / `ups` /
`final_conv` in place, so it copies no weights and any state dict the UNet
loads serves it. The port's lists differ from JAX's block names: `downs[0]`
is the stem conv and the Downsamples sit inside `downs`, the Upsamples inside
`ups`; the split points are found once, from the positions of those modules,
and each part's skips are checked to be consumed exactly. The full pass runs
the same modules in the same order as `UNet.forward`, so its output is the
UNet's, bit for bit.

The cached walk always runs the UNet's own (unfused) modules, whatever
`fused` or DSP_FUSED say: JAX's cached apply (`train/trainer.py`
`_cached_apply`) likewise takes the flax re-assembly and never the fused walk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .blocks import Downsample, ResnetBlockWithAttn, Upsample
from .unet import UNet


class CachedUNet:
    """`__call__(x, time, cached_deep=None)` -> (out, deep): with no cache a
    full forward, which returns the new deep feature; with a cache only the
    shallow levels, which return the cache unchanged. x is NHWC, out NHWC
    float32; the cache stays in the UNet's internal layout (NCHW shape,
    channels_last memory)."""

    def __init__(self, net: UNet, cache_depth: int = 1):
        downs, ups = list(net.downs), list(net.ups)
        down_at = [i for i, m in enumerate(downs) if isinstance(m, Downsample)]
        up_at = [i for i, m in enumerate(ups) if isinstance(m, Upsample)]
        levels = len(down_at) + 1
        if not 1 <= cache_depth <= levels - 1:
            raise ValueError(f"cache_depth must be in [1, {levels - 1}], got {cache_depth}")
        self.net, self.cache_depth = net, int(cache_depth)
        # stage d-1's Downsample opens the deep encoder; ups visits stages
        # M-1..0, so its (M-1-d)-th Upsample, stage d's, closes the deep decoder
        enc = down_at[cache_depth - 1]
        dec = up_at[levels - 1 - cache_depth] + 1
        self.shallow_down, self.deep_down = downs[:enc], downs[enc:]
        self.deep_up, self.shallow_up = ups[:dec], ups[dec:]
        for part, pushed, popped in (("shallow", self.shallow_down, self.shallow_up),
                                     ("deep", self.deep_down, self.deep_up)):
            pops = sum(isinstance(m, ResnetBlockWithAttn) for m in popped)
            if pops != len(pushed):
                raise AssertionError(f"{part} part: {len(pushed)} skips, {pops} consumed")
        self.deep_channels = ups[dec - 1].conv.out_channels

    def deep_shape(self, batch: int) -> Tuple[int, int, int, int]:
        """(B, C, H, W) of the cache for the UNet's image_size: the resolution
        of encoder stage d−1, the channels of decoder stage d."""
        res = self.net.image_size // 2 ** (self.cache_depth - 1)
        return (batch, self.deep_channels, res, res)

    def __call__(self, x, time=None, cached_deep: Optional[torch.Tensor] = None):
        net = self.net
        h = net.entry(x)
        t = net.embed(time)

        def run(layers, h, skips, push):
            for layer in layers:
                if not isinstance(layer, ResnetBlockWithAttn):
                    h = layer(h)
                elif push:
                    h = layer(h, t)
                else:
                    h = layer(torch.cat([h, skips.pop()], dim=1), t)
                if push:
                    skips.append(h)
            return h

        feats = []
        h = run(self.shallow_down, h, feats, push=True)
        if cached_deep is None:
            deep_feats = []
            h = run(self.deep_down, h, deep_feats, push=True)
            for layer in net.mid:
                h = layer(h, t)
            deep = run(self.deep_up, h, deep_feats, push=False)
            if deep_feats:
                raise AssertionError("unconsumed deep skip connections")
        else:
            deep = cached_deep
        h = run(self.shallow_up, deep, feats, push=False)
        if feats:
            raise AssertionError("unconsumed skip connections")
        return net.final_conv(h).float().permute(0, 2, 3, 1), deep
