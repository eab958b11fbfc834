"""Fused [GroupNorm affine → swish] → 3×3 conv → [+ residual] → statistics.

Counterpart: diffsplitting_tpu/experimental/conv_gn.py (`fold_gn_affine`,
`channel_stats`, `conv_gn_reference`, and `conv_gn_fused`, which launches the
Pallas `_kernel_rows`). NHWC activations and HWIO kernels at the public
functions, as in the JAX package.

`conv_gn_fused` launches the CUDA kernel of csrc/conv_gn.cu for a CUDA tensor
and runs the plain version for a CPU tensor. Inference only: there is no
backward, as the JAX kernel has none. Not ported: the pair layout
(`pair_pack`, `pair_weights`, …), `pick_tile_h` and the channels ≡ 0 mod 128
rule, which exist only for the TPU's lanes; the Hopper kernel takes the
widths of the splitting UNet as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.build import check, library

# csrc/conv_gn.cu: output channels a block (BN >= Cout) -> (tile rows, tile
# columns), its `launch<BN, NW, WN, TR, TW, TPS>` lines; K steps of 16 channels
_TILES = {16: (16, 16), 32: (8, 16), 64: (8, 16), 128: (8, 16)}
_KC = 16
MAX_CIN = 256
MAX_COUT = 128


def fold_gn_affine(sums, sumsqs, count: int, gamma, beta, num_groups: int,
                   eps: float = 1e-5):
    """Per-(B, C) scale and shift with x·scale + shift ≡ GroupNorm(x)·γ + β,
    from carried f32 per-channel sums of x and x² over `count` = H·W
    elements a channel."""
    B, C = sums.shape
    G = num_groups
    cs = C // G
    n = count * cs
    mean_g = sums.reshape(B, G, cs).sum(-1) / n
    sq_g = sumsqs.reshape(B, G, cs).sum(-1) / n
    var_g = torch.clamp(sq_g - mean_g * mean_g, min=0.0)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cs, dim=-1)
    mean_c = mean_g.repeat_interleave(cs, dim=-1)
    scale = inv_c * gamma[None, :].float()
    shift = beta[None, :].float() - mean_c * scale
    return scale, shift


def channel_stats(x):
    """Per-(B, C) f32 sums of x and x² over H and W, for tensors made outside
    the fused convs (stem, downsampling, attention)."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def conv_gn_reference(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
    """Plain version, the contract of the kernel.

    x (B, H, W, Cin); w (3, 3, Cin, Cout) HWIO; b (Cout,); scale/shift
    optional (B, Cin) prologue affine, swish applied iff given, and the zero
    padding is of the activated input; residual optional (B, H, W, Cres),
    projected by w_skip (Cres, Cout) when given. Returns (y, sums, sumsqs):
    y (B, H, W, Cout) f32 and its per-(B, Cout) sums and sums of squares.
    """
    xa = x.float()
    if scale is not None:
        xa = xa * scale[:, None, None, :] + shift[:, None, None, :]
        xa = xa * torch.sigmoid(xa)
    y = F.conv2d(xa.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if residual is not None:
        r = residual.float()
        if w_skip is not None:
            r = r @ w_skip.float()
        y = y + r
    y = y.contiguous()
    return y, y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


def _block_channels(Cout: int) -> int:
    return next(bn for bn in _TILES if bn >= Cout)


def conv_gn_tiling(H: int, W: int, Cout: int):
    """The kernel's block geometry for an H×W map and Cout channels: (tile
    rows, tile columns, tiles per batch element). A block covers all Cout
    (rounded up to 16, 32, 64 or 128) and a fixed tr×tw tile of one batch
    element for that width: 16×16 pixels on 8 warps at 16 channels, 8×16 on
    4 warps at 32 and 64, 8×16 on 8 warps at 128 (a 64² map at batch 8
    still gives 256 blocks); ragged edges are masked."""
    tr, tw = _TILES[_block_channels(Cout)]
    return tr, tw, -(-H // tr) * -(-W // tw)


def conv_gn_split_floats(Cin: int, Cout: int, Cres_skip: int) -> int:
    """Floats of the kernel's scratch for the split weights: a big and a
    small plane of BN×16 for each K step (9 taps × Cin/16 chunks, plus
    Cres/16 chunks of a projected residual, `Cres_skip` 0 without one)."""
    steps = 9 * -(-Cin // _KC) + -(-Cres_skip // _KC)
    return steps * 2 * _block_channels(Cout) * _KC


def conv_gn_takes(Cin: int, Cout: int, Cres: int = 0) -> bool:
    """Whether the kernel takes a site of these widths (Cres 0: no residual):
    Cin and Cres multiples of 4 up to MAX_CIN, Cout a multiple of 4 up to
    MAX_COUT. The fused walk plans its conv sites by it."""
    return (all(c % 4 == 0 for c in (Cin, Cout, Cres)) and 0 < Cin <= MAX_CIN
            and 0 < Cout <= MAX_COUT and Cres <= MAX_CIN)


def _check(x, w, b, scale, shift, residual, w_skip):
    """Raise on anything the kernel does not take; return Cres (0 without a
    residual)."""
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv_gn: x {tuple(x.shape)} and w {tuple(w.shape)} must be NHWC "
                         "and HWIO (3, 3, Cin, Cout)")
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    tensors = [t for t in (x, w, b, scale, shift, residual, w_skip) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("conv_gn takes float32 tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv_gn: all tensors must be on one device")
    if not x.is_contiguous():
        raise ValueError("conv_gn takes a contiguous NHWC x")
    if (scale is None) != (shift is None):
        raise ValueError("conv_gn: scale and shift come together")
    if w_skip is not None and residual is None:
        raise ValueError("conv_gn: w_skip needs a residual")
    if Cin % 4 or Cin > MAX_CIN:
        raise ValueError(f"conv_gn: Cin={Cin} must be a multiple of 4, at most {MAX_CIN}")
    if Cout % 4 or Cout > MAX_COUT:
        raise ValueError(f"conv_gn: Cout={Cout} must be a multiple of 4, at most {MAX_COUT}")
    if tuple(b.shape) != (Cout,):
        raise ValueError(f"conv_gn: bias {tuple(b.shape)} must be ({Cout},)")
    if scale is not None and not all(tuple(t.shape) == (B, Cin) and t.is_contiguous()
                                     for t in (scale, shift)):
        raise ValueError(f"conv_gn: scale and shift must be contiguous ({B}, {Cin})")
    if residual is None:
        return 0
    Cres = residual.shape[-1]
    if tuple(residual.shape[:3]) != (B, H, W) or not residual.is_contiguous():
        raise ValueError(f"conv_gn: residual {tuple(residual.shape)} must be a contiguous "
                         f"NHWC ({B}, {H}, {W}, Cres)")
    if w_skip is None and Cres != Cout:
        raise ValueError(f"conv_gn: an identity residual needs Cres == Cout, got {Cres}")
    if w_skip is not None and tuple(w_skip.shape) != (Cres, Cout):
        raise ValueError(f"conv_gn: w_skip {tuple(w_skip.shape)} must be ({Cres}, {Cout})")
    if Cres % 4 or Cres > MAX_CIN:
        raise ValueError(f"conv_gn: Cres={Cres} must be a multiple of 4, at most {MAX_CIN}")
    return Cres


def _launch(x, w, b, scale, shift, residual, w_skip, Cres: int):
    """Run csrc/conv_gn.cu on CUDA tensors (already checked)."""
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    b = b.contiguous()
    if any(t is not None and t.data_ptr() % 16 for t in (x, b, scale, shift, residual)):
        raise ValueError("conv_gn kernel needs 16-byte aligned tensors")
    tr, tw, tiles = conv_gn_tiling(H, W, Cout)
    y = torch.empty((B, H, W, Cout), device=x.device, dtype=torch.float32)
    partials = torch.empty((B, tiles, 2, Cout), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, B, Cout), device=x.device, dtype=torch.float32)
    wsplit = torch.empty(conv_gn_split_floats(Cin, Cout, Cres if w_skip is not None else 0),
                         device=x.device, dtype=torch.float32)
    ws = w.stride()
    ks = w_skip.stride() if w_skip is not None else (0, 0)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().conv_gn_f32(
        x.data_ptr(), w.data_ptr(), *ws, b.data_ptr(), ptr(scale), ptr(shift), ptr(residual),
        ptr(w_skip), *ks, y.data_ptr(), partials.data_ptr(), stats.data_ptr(), wsplit.data_ptr(),
        B, H, W, Cin, Cout, Cres, int(scale is not None), int(residual is not None),
        int(w_skip is not None), tr, tw, stream)
    check(err, "conv_gn_f32")
    FusedConvGN.launches += 1
    return y, stats[0], stats[1]


class FusedConvGN:
    """Holds the count of kernel launches (one per `conv_gn_fused` call on a
    CUDA tensor, counted where the kernel is launched)."""

    launches = 0


@torch.no_grad()
def conv_gn_fused(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
    """Fused [affine + swish] → conv3×3 → [+ residual] → statistics, the
    contract of `conv_gn_reference`; returns (y, sums, sumsqs).

    Takes float32, x and residual contiguous NHWC, w any (3, 3, Cin, Cout)
    view (an OIHW parameter's `permute(2, 3, 1, 0)` is read in place), Cin
    and Cres multiples of 4 up to 256, Cout a multiple of 4 up to 128; raises
    on anything else. A CUDA tensor launches the kernel; a CPU tensor runs
    the plain version."""
    Cres = _check(x, w, b, scale, shift, residual, w_skip)
    if x.is_cuda:
        return _launch(x, w, b, scale, shift, residual, w_skip, Cres)
    return conv_gn_reference(x, w, b, scale, shift, residual, w_skip)
