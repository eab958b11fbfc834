"""W8A8 quantized UNet for serving.

Counterpart: diffsplitting_tpu/models/quant_unet.py (`collect_act_absmax`,
`quantize_unet_params`, `quant_unet_apply`, `cached_unet_apply`,
`iter_quant_sites`, `is_quantized_tree`). JAX re-walks the UNet's topology as
a pure function with a pluggable conv; here the UNet's modules are kept and
only the chosen `blocks.Conv2d`s are swapped:

  * `collect_act_absmax(unet, x, t)` runs one forward of the UNet as it is,
    with forward pre-hooks on every `Conv2d`, and gives each site's input
    absmax (f32, the input in the compute dtype, as the conv computes);
  * `quantize_unet(unet, act_absmax, ...)` returns a copy of the UNet whose
    chosen `Conv2d`s are `W8A8Conv2d`s (int8 weight, per-channel scale,
    static activation scale, f32 bias: ops/quant.py). The copy shares every
    other parameter and buffer with the source, so it costs only the int8
    weights, and is stale once the source's weights change;
  * `iter_quant_sites`, `is_quantized`.

The copy keeps the UNet's own `forward` and modules, so everything that walks
them serves W8A8 as it is: `models.deepcache.CachedUNet` runs its full and
shallow passes with the swapped convs, with no counterpart of JAX's
`cached_unet_apply`. GroupNorm+Swish, attention, the time MLP and the convs
left out stay on the float path (the kernels on the card). The fused walk
(models/fused_forward.py) reads each conv's float weight and is not served
W8A8 (serving.AcceleratorSwitches serves a quantized net unfused).

Sites are classified from the port's module paths as JAX's `_classify` does
from its flax names: 'block' (`res_block.block1.block.3`, `block2.block.3`),
'shortcut' (`res_conv`), 'updown' (`Downsample.conv`, `Upsample.conv`),
'stem' (`downs.0`), 'head' (`final_conv.block.3`), 'attn' (`attn.qkv`,
`attn.out`). The defaults are JAX's: only the ResnetBlocks' Block convs.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.quant import INT8_MAX, int8_matrix, quant_conv_apply, quantize_weight
from .blocks import Conv2d


class W8A8Conv2d(nn.Module):
    """A `Conv2d` served W8A8: its input quantized with the static
    `a_scale`, the int8 conv (`ops.quant.int8_conv`), then the f32 dequantize
    and bias, in the conv's compute dtype (None: the input's, at least f32).
    Buffers: `weight_i8` (OIHW int8), `w_scale` (O,) f32, `bias` (O,) f32 or
    None, and `weight_mat`, the (O, K) int8 matrix the card route multiplies
    (not saved)."""

    def __init__(self, conv: Conv2d, a_scale):
        super().__init__()
        w_i8, w_scale = quantize_weight(conv.weight)
        dev = conv.weight.device
        self.register_buffer("weight_i8", torch.from_numpy(w_i8).to(dev))
        self.register_buffer("w_scale", torch.from_numpy(w_scale).to(dev))
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().float().clone())
        self.register_buffer("weight_mat", int8_matrix(self.weight_i8), persistent=False)
        self.a_scale = np.float32(a_scale)
        self.stride = conv.stride[0]
        self.compute_dtype = conv.compute_dtype
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size = conv.kernel_size

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        return quant_conv_apply(x.to(dt), self.weight_i8, self.w_scale, self.a_scale, self.bias,
                                self.stride, dt, self.weight_mat)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, a_scale={float(self.a_scale):.6g}")


def classify(name: str) -> str:
    """The site kind of a UNet conv at module path `name`: 'block',
    'shortcut', 'updown', 'stem', 'head', 'attn' or 'other'."""
    parts = name.split(".")
    if "attn" in parts:
        return "attn"
    if name == "downs.0":
        return "stem"
    if parts[0] == "final_conv":
        return "head"
    if parts[-1] == "res_conv":
        return "shortcut"
    if "res_block" in parts and parts[-2] == "block":
        return "block"
    if parts[-1] == "conv":
        return "updown"
    return "other"


def conv_sites(unet: nn.Module) -> Iterator[Tuple[str, Conv2d]]:
    """(path, module) of every float `Conv2d` of the UNet."""
    return ((n, m) for n, m in unet.named_modules() if isinstance(m, Conv2d))


def collect_act_absmax(unet: nn.Module, x, time=None) -> Dict[str, float]:
    """One forward of `unet` on the NHWC batch x (eval mode, no grad) with
    every conv's input absmax recorded: path -> f32 max |input| in the
    conv's compute dtype. The rows of x should span the chain's steps."""
    stats = {}

    def hook(name, m):
        def record(_, args):
            h = args[0]
            a = h.to(m.compute_dtype or h.dtype).float().abs().max()
            stats[name] = a if name not in stats else torch.maximum(stats[name], a)
        return record

    handles = [m.register_forward_pre_hook(hook(n, m)) for n, m in conv_sites(unet)]
    was_training = unet.training
    unet.eval()
    try:
        with torch.no_grad():
            unet(x, time)
    finally:
        unet.train(was_training)
        for h in handles:
            h.remove()
    return {n: float(a) for n, a in stats.items()}


def quantize_unet(unet: nn.Module, act_absmax: Dict[str, float], *, updown: bool = False,
                  shortcut: bool = False, stem: bool = False, head: bool = False,
                  attn: bool = False, clip_ratio: float = 1.0) -> nn.Module:
    """A copy of `unet` (eval mode, sharing its other parameters and
    buffers) whose chosen `Conv2d` sites with a calibrated absmax are
    `W8A8Conv2d`s, a_scale = f32(max(absmax, 1e-8) · clip_ratio / 127) as in
    JAX's `quantize_unet_params`. Only the ResnetBlock Block convs by
    default; the flags add the Down/Upsample convs, the 1×1 shortcuts, the
    stem, the head and the attention block's qkv and output 1×1 convs."""
    want = {"block": True, "updown": updown, "shortcut": shortcut, "stem": stem,
            "head": head, "attn": attn}
    memo = {id(t): t for t in list(unet.parameters()) + list(unet.buffers())}
    for m in unet.modules():  # dropout generators are shared, not copied
        gen = getattr(m, "generator", None)
        if gen is not None:
            memo[id(gen)] = gen
    with torch.no_grad():
        q = copy.deepcopy(unet, memo)
        for name, conv in list(conv_sites(q)):
            amax = act_absmax.get(name)
            if not want.get(classify(name), False) or amax is None:
                continue
            a_scale = np.float32(max(float(amax), 1e-8) * clip_ratio / INT8_MAX)
            parent, _, child = name.rpartition(".")
            setattr(q.get_submodule(parent), child, W8A8Conv2d(conv, a_scale))
    return q.eval()


def iter_quant_sites(unet: nn.Module) -> Iterator[Tuple[str, W8A8Conv2d]]:
    """(path, module) of every W8A8 conv of a quantized UNet."""
    return ((n, m) for n, m in unet.named_modules() if isinstance(m, W8A8Conv2d))


def is_quantized(unet: nn.Module) -> bool:
    return any(True for _ in iter_quant_sites(unet))
