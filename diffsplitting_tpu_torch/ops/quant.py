"""W8A8 quantization primitives of the serving path.

Counterpart: diffsplitting_tpu/ops/quant.py (`quantize_weight`,
`quantize_act`, `int8_conv`, `quant_conv_apply`). The scheme is JAX's:
  * weights: per-output-channel symmetric int8, scale[c] = max|W[c]| / 127,
    computed once on the host in numpy (the port's weights are OIHW, so the
    absmax runs over (I, H, W));
  * activations: per-tensor symmetric int8 with a static, calibrated scale:
    round(x · f32(1 / a_scale)), half to even as `jnp.round`, clipped to ±127;
  * accumulation: int32, exact (|acc| ≤ 9 · 2048 · 127² < 2³¹);
  * dequantize: int32 → f32 × (a_scale · w_scale[c]), + f32 bias, then the
    compute dtype, in that order.

JAX's int8 conv is an XLA op (`lax.conv_general_dilated` with
`preferred_element_type=int32`), not a Pallas kernel, so its counterpart here
is a library product too. `int8_conv` on a CUDA tensor gathers the int8
input NHWC into its 9 shifted views (1 for a 1×1 conv) and multiplies them
with the int8 weight through `torch._int_mm` (cuBLASLt s8×s8→s32); it raises
on a shape that product does not take, and never falls back to a float conv.
On a CPU tensor it runs the plain version: `F.conv2d` in float64 on the int8
values, exact since every partial sum is an integer below 2⁵³.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INT8_MAX = 127.0
# torch._int_mm on CUDA: more than 16 rows, inner and output widths that are
# multiples of 8 (aten/src/ATen/native/cuda/Blas.cpp `_int_mm_out_cuda`)
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def quantize_weight(weight):
    """OIHW conv weight (tensor or array) -> (int8 OIHW array, f32 (O,)
    scale) with weight ≈ int8 · scale[o]: JAX's f32 division and `rint` on
    the host."""
    if isinstance(weight, torch.Tensor):
        weight = weight.detach().cpu().numpy()
    w = np.asarray(weight, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))  # (O,)
    w_scale = np.maximum(absmax, 1e-12) / INT8_MAX
    scale = w_scale.reshape((-1,) + (1,) * (w.ndim - 1))
    w_i8 = np.clip(np.rint(w / scale), -INT8_MAX, INT8_MAX).astype(np.int8)
    return w_i8, w_scale.astype(np.float32)


def act_inverse(a_scale) -> float:
    """f32(1 / a_scale), the multiplier `quantize_act` takes, as JAX computes
    it from its f32 scale."""
    return float(np.float32(1.0) / np.float32(a_scale))


def quantize_act(x, inv_scale: float):
    """Per-tensor symmetric int8 of x with the static multiplier
    `inv_scale` (`act_inverse`): round half to even of x in f32 times it,
    clipped to ±127."""
    xi = torch.round(x.float() * inv_scale)
    return xi.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def int8_conv_reference(x_i8, w_i8, stride: int = 1):
    """Plain version: the exact int32 conv of int8 NCHW x and int8 OIHW w,
    padding k // 2 on each side (JAX's "SAME" for k = 1 and 3 at stride 1
    and 2), through float64."""
    pad = w_i8.shape[-1] // 2
    y = F.conv2d(x_i8.double(), w_i8.double(), stride=stride, padding=pad)
    return y.to(torch.int32)


class Int8Conv:
    """The card route's call counter, as the kernel wrappers keep theirs."""

    launches = 0  # torch._int_mm products launched by `int8_conv` on the card


def int8_matrix(w_i8):
    """OIHW int8 weight -> the (O, kh·kw·I) matrix whose rows the card route
    multiplies, tap-major as the input's shifted views are gathered."""
    O = w_i8.shape[0]
    return w_i8.permute(0, 2, 3, 1).reshape(O, -1).contiguous()


def _im2col_nhwc(x_nhwc, k: int, stride: int):
    """(B·Ho·Wo, k·k·C) int8: the k² shifted views of the padded NHWC input,
    tap-major (dy, dx), each C wide."""
    B, H, W, C = x_nhwc.shape
    pad = k // 2
    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    if k == 1 and stride == 1:
        return x_nhwc.reshape(B * H * W, C), (B, Ho, Wo)
    xp = F.pad(x_nhwc, (0, 0, pad, pad, pad, pad))
    views = [xp[:, dy:dy + stride * (Ho - 1) + 1:stride, dx:dx + stride * (Wo - 1) + 1:stride]
             for dy in range(k) for dx in range(k)]
    return torch.cat(views, dim=-1).reshape(B * Ho * Wo, k * k * C), (B, Ho, Wo)


def _int8_conv_cuda(x_i8, w_mat, k: int, stride: int):
    """The card route: im2col of x (NCHW int8) then one `torch._int_mm`
    with the (O, K) weight matrix; int32 NCHW out, channels_last memory."""
    O, K = w_mat.shape
    if K % INT_MM_MULTIPLE or O % INT_MM_MULTIPLE:
        raise ValueError(f"int8 conv on the card: inner width {K} (k²·Cin) and output width "
                         f"{O} must be multiples of {INT_MM_MULTIPLE} (torch._int_mm)")
    cols, (B, Ho, Wo) = _im2col_nhwc(x_i8.permute(0, 2, 3, 1).contiguous(), k, stride)
    rows = cols.shape[0]
    if rows < INT_MM_MIN_ROWS:  # zero rows give zero products, sliced off below
        cols = torch.cat([cols, cols.new_zeros(INT_MM_MIN_ROWS - rows, K)])
    y = torch._int_mm(cols, w_mat.t())
    Int8Conv.launches += 1
    return y[:rows].reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def int8_conv(x_i8, w_i8, stride: int = 1, w_mat=None):
    """int8 NCHW x × int8 OIHW w -> int32 NCHW, stride 1 or 2, padding k // 2.
    A CUDA tensor takes the card route (`w_mat`: the weight's `int8_matrix`,
    made here when not given), a CPU tensor the plain version."""
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {x_i8.dtype} and {w_i8.dtype}")
    k = w_i8.shape[-1]
    if w_i8.shape[-2] != k or k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"int8_conv takes 1x1 or 3x3 kernels at stride 1 or 2, got "
                         f"{tuple(w_i8.shape[-2:])} at stride {stride}")
    if not x_i8.is_cuda:
        return int8_conv_reference(x_i8, w_i8, stride)
    return _int8_conv_cuda(x_i8, int8_matrix(w_i8) if w_mat is None else w_mat, k, stride)


def quant_conv_apply(x, w_i8, w_scale, a_scale, bias=None, stride: int = 1, out_dtype=None,
                     w_mat=None):
    """One W8A8 conv site (JAX's `quant_conv_apply`): x (NCHW) quantized with
    the static `a_scale`, the int8 conv with `w_i8` (OIHW), the int32 result
    times f32 (a_scale · w_scale[c]), plus the f32 bias, cast to `out_dtype`
    (None: x's dtype). w_scale and bias are f32 (O,) tensors on x's device."""
    y = int8_conv(quantize_act(x, act_inverse(a_scale)), w_i8, stride, w_mat)
    y = y.float() * (float(np.float32(a_scale)) * w_scale)[:, None, None]
    if bias is not None:
        y = y + bias[:, None, None]
    return y.to(out_dtype or x.dtype)
