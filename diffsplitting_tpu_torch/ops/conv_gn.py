"""Fused [GroupNorm affine → swish] → 3×3 conv → [+ residual] → statistics.

Counterpart: diffsplitting_tpu/experimental/conv_gn.py (`fold_gn_affine`,
`channel_stats`, `conv_gn_reference`, and `conv_gn_fused`, which launches the
Pallas `_kernel_rows`). NHWC activations and HWIO kernels at the public
functions, as in the JAX package.

`conv_gn_fused` launches a CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor: csrc/conv_gn.cu at float32 x (3xTF32 tensor-core
products, f32 accuracy), csrc/conv_gn_bf16.cu at bfloat16 x, as JAX's kernel
computes at `x.dtype` bf16 (the fused walk of a UNet at `compute_dtype:
bfloat16`): the prologue in f32 rounded to bf16, bf16 tensor-core products
with f32 sums, f32 statistics, y rounded once to bf16. Both kernels take the
same widths, so the fused walk's plan does not depend on the dtype.
Inference only: there is no backward, as the JAX kernel has none. Not
ported: the pair layout (`pair_pack`, `pair_weights`, …), `pick_tile_h` and
the channels ≡ 0 mod 128 rule, which exist only for the TPU's lanes; the
Hopper kernels take the widths of the splitting UNet as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.build import check, library

# csrc/conv_gn.cu: output channels a block (BN >= Cout) -> (tile rows, tile
# columns), its `launch<BN, NW, WN, TR, TW, TPS>` lines; K steps of 16 channels
_TILES = {16: (16, 16), 32: (8, 16), 64: (8, 16), 128: (8, 16)}
# csrc/conv_gn_bf16.cu: BN (a wgmma width) -> (tile rows, tile columns), its
# `launch<BN, MT>` lines (8·MT rows); a projected residual's K steps go in
# stages of kResGroup chunks, the last one zero-padded
_TILES_BF16 = {8: (16, 16), 16: (16, 16), 32: (16, 16), 64: (16, 16), 128: (8, 16)}
_RES_GROUP_BF16 = 4
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
    """Plain version, the contract of the kernels.

    x (B, H, W, Cin); w (3, 3, Cin, Cout) HWIO; b (Cout,); scale/shift
    optional (B, Cin) prologue affine, swish applied iff given, and the zero
    padding is of the activated input; residual optional (B, H, W, Cres),
    projected by w_skip (Cres, Cout) when given. Returns (y, sums, sumsqs):
    y (B, H, W, Cout) in x's dtype and its per-(B, Cout) f32 sums and sums
    of squares.

    At bfloat16 x, JAX's `conv_gn_reference` at bf16: the prologue in f32,
    rounded to bf16; bf16 operands (w and w_skip rounded to bf16) with f32
    sums, computed here as the f32 conv of the bf16-rounded operands, which
    is exact per product; + b in f32; the residual added in f32 (a projected
    one as its bf16 × bf16 product summed in f32); the statistics of the f32
    y; y rounded once to bf16. At float32 every rounding is the identity.
    """
    dt = x.dtype
    xa = x.float()
    if scale is not None:
        xa = xa * scale[:, None, None, :] + shift[:, None, None, :]
        xa = (xa * torch.sigmoid(xa)).to(dt).float()
    wf = w.to(dt).float()
    y = F.conv2d(xa.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if residual is not None:
        r = residual.float()
        if w_skip is not None:
            r = r @ w_skip.to(dt).float()
        y = y + r
    y = y.contiguous()
    return y.to(dt), y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


def _block_channels(Cout: int, bf16: bool = False) -> int:
    return next(bn for bn in (_TILES_BF16 if bf16 else _TILES) if bn >= Cout)


def conv_gn_tiling(H: int, W: int, Cout: int, bf16: bool = False):
    """The kernel's block geometry for an H×W map and Cout channels: (tile
    rows, tile columns, tiles per batch element). A block covers all Cout
    and a fixed tr×tw tile of one batch element for that width. The f32
    kernel (Cout rounded up to 16, 32, 64 or 128): 16×16 pixels on 8 warps at
    16 channels, 8×16 on 4 warps at 32 and 64, 8×16 on 8 warps at 128 (a 64²
    map at batch 8 still gives 256 blocks). The bf16 kernel (`bf16`; Cout
    rounded up to 8, 16, 32, 64 or 128): two warpgroups on 16×16 pixels, two
    m64 tiles each, up to 64 channels, and on 8×16, an m64 tile each, at
    128. Ragged edges are masked."""
    tr, tw = (_TILES_BF16 if bf16 else _TILES)[_block_channels(Cout, bf16)]
    return tr, tw, -(-H // tr) * -(-W // tw)


def conv_gn_weight_elems(Cin: int, Cout: int, Cres_skip: int, bf16: bool = False) -> int:
    """Elements of one plane of the kernels' weight scratch: BN×16 for each
    K step (9 taps × Cin/16 chunks, plus Cres/16 chunks of a projected
    residual, `Cres_skip` 0 without one). The bf16 kernel (`bf16`) packs one
    bf16 plane, its residual chunks padded to whole stages; the f32 kernel
    splits into a big and a small f32 plane."""
    res = -(-Cres_skip // _KC)
    if bf16:
        res = -(-res // _RES_GROUP_BF16) * _RES_GROUP_BF16
    return (9 * -(-Cin // _KC) + res) * _block_channels(Cout, bf16) * _KC


def conv_gn_split_floats(Cin: int, Cout: int, Cres_skip: int) -> int:
    """Floats of the f32 kernel's scratch for the split weights: a big and a
    small plane (`conv_gn_weight_elems`)."""
    return 2 * conv_gn_weight_elems(Cin, Cout, Cres_skip)


def conv_gn_takes(Cin: int, Cout: int, Cres: int = 0) -> bool:
    """Whether the kernels take a site of these widths (Cres 0: no residual):
    Cin and Cres multiples of 4 up to MAX_CIN, Cout a multiple of 4 up to
    MAX_COUT, in either dtype (the bf16 kernel copies a pixel's channels in
    8-byte pieces, so a ragged width that is a multiple of 4 and not of 8
    needs no other route). The fused walk plans its conv sites by it."""
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
    if x.dtype == torch.bfloat16:
        low = (torch.float32, torch.bfloat16)
        ok = ((residual is None or residual.dtype == torch.bfloat16)
              and all(t.dtype == torch.float32 for t in (scale, shift) if t is not None)
              and all(t.dtype in low for t in (w, b, w_skip) if t is not None))
        if not ok:
            raise TypeError("conv_gn at bfloat16 x takes a bfloat16 residual, float32 scale "
                            "and shift, and float32 or bfloat16 w, b and w_skip")
    elif any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("conv_gn takes float32 tensors, or bfloat16 x and residual")
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
    """Run csrc/conv_gn.cu (float32 x) or csrc/conv_gn_bf16.cu (bfloat16 x)
    on CUDA tensors (already checked)."""
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    # the bf16 kernel reads the bias as f32 and copies x and the residual in
    # 16-byte pieces where they allow it, else in 8-byte ones; the f32 kernel
    # copies them in 16-byte pieces
    b = b.float().contiguous()
    align = 8 if bf16 else 16
    if (any(t is not None and t.data_ptr() % align for t in (x, residual))
            or any(t is not None and t.data_ptr() % 16 for t in (b, scale, shift))):
        raise ValueError(f"conv_gn kernel needs {align}-byte aligned x and residual, 16-byte "
                         "aligned b, scale and shift")
    tr, tw, tiles = conv_gn_tiling(H, W, Cout, bf16)
    y = torch.empty((B, H, W, Cout), device=x.device, dtype=x.dtype)
    partials = torch.empty((B, tiles, 2, Cout), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, B, Cout), device=x.device, dtype=torch.float32)
    elems = conv_gn_weight_elems(Cin, Cout, Cres if w_skip is not None else 0, bf16)
    wscratch = (torch.empty(elems, device=x.device, dtype=torch.bfloat16) if bf16 else
                torch.empty(2 * elems, device=x.device, dtype=torch.float32))
    ws = w.stride()
    ks = w_skip.stride() if w_skip is not None else (0, 0)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = library()
    if bf16:
        err = lib.conv_gn_bf16(
            x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), *ws, b.data_ptr(),
            ptr(scale), ptr(shift), ptr(residual), ptr(w_skip),
            int(w_skip is not None and w_skip.dtype == torch.bfloat16), *ks, y.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), wscratch.data_ptr(), B, H, W, Cin, Cout, Cres,
            int(scale is not None), int(residual is not None), int(w_skip is not None), tr, tw,
            stream)
        check(err, "conv_gn_bf16")
        FusedConvGN.launches_bf16 += 1
    else:
        err = lib.conv_gn_f32(
            x.data_ptr(), w.data_ptr(), *ws, b.data_ptr(), ptr(scale), ptr(shift),
            ptr(residual), ptr(w_skip), *ks, y.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), wscratch.data_ptr(), B, H, W, Cin, Cout, Cres,
            int(scale is not None), int(residual is not None), int(w_skip is not None), tr, tw,
            stream)
        check(err, "conv_gn_f32")
        FusedConvGN.launches += 1
    return y, stats[0], stats[1]


class FusedConvGN:
    """Holds the counts of kernel launches (one per `conv_gn_fused` call on a
    CUDA tensor, counted where the kernel is launched): `launches` of the
    float32 kernel, `launches_bf16` of the bfloat16 one."""

    launches = 0
    launches_bf16 = 0


@torch.no_grad()
def conv_gn_fused(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
    """Fused [affine + swish] → conv3×3 → [+ residual] → statistics, the
    contract of `conv_gn_reference`; returns (y, sums, sumsqs), y in x's
    dtype, the statistics f32.

    Takes float32 tensors, or bfloat16 x and residual with float32 scale and
    shift and float32 or bfloat16 w, b and w_skip (the UNet's parameters, or
    their bf16 copies under DSP_PRECAST=1; the kernel rounds f32 weights to
    bf16 once a call); x and residual contiguous NHWC, w any (3, 3, Cin,
    Cout) view (an OIHW parameter's `permute(2, 3, 1, 0)` is read in place),
    Cin and Cres multiples of 4 up to 256, Cout a multiple of 4 up to 128;
    raises on anything else. A CUDA tensor launches the kernel of its dtype;
    a CPU tensor runs the plain version."""
    Cres = _check(x, w, b, scale, shift, residual, w_skip)
    if x.is_cuda:
        return _launch(x, w, b, scale, shift, residual, w_skip, Cres)
    return conv_gn_reference(x, w, b, scale, shift, residual, w_skip)
