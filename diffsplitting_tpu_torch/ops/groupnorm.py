"""Fused GroupNorm(+affine)+Swish over NHWC activations.

Counterparts: diffsplitting_tpu/ops/groupnorm.py (`group_norm_swish_reference`,
`fused_group_norm_swish` with its custom VJP) and
diffsplitting_tpu/experimental/groupnorm_pallas.py (the Pallas kernels).

`fused_group_norm_swish` launches the CUDA kernel of csrc/groupnorm_swish.cu
for a CUDA tensor and runs the plain version for a CPU tensor. It takes
float32 or bfloat16 x (the UNet at `compute_dtype: bfloat16`), with float32
statistics, scale and bias, and returns x's dtype, as JAX's kernels write
`out_ref.dtype`; C up to 2048. Backward runs autograd through the plain
version, as the JAX custom VJP recomputes through its jnp reference.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.build import check, library


def group_norm_swish_reference(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """Plain version: NHWC GroupNorm (contiguous channel groups, statistics
    over (H, W, C/G) per sample from f32 sums of x and x², the variance
    clamped at 0), then scale/bias, then swish. Returns x.dtype."""
    B, H, W, C = x.shape
    G = num_groups
    cs = C // G
    xf = x.float()
    s = xf.sum(dim=(1, 2))  # (B, C)
    ss = (xf * xf).sum(dim=(1, 2))  # f32 before squaring
    n = H * W * cs
    gmean = s.view(B, G, cs).sum(-1) / n  # (B, G)
    gsq = ss.view(B, G, cs).sum(-1) / n
    gvar = torch.clamp(gsq - gmean * gmean, min=0.0)  # fp cancellation guard
    mean_c = gmean.repeat_interleave(cs, dim=-1)  # (B, C)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(cs, dim=-1)
    norm = (xf - mean_c[:, None, None, :]) * inv_c[:, None, None, :]
    norm = norm * scale + bias
    return (norm * torch.sigmoid(norm)).to(x.dtype)


# 256-thread blocks a pass keeps resident on each SM (the kernels'
# __launch_bounds__ minimum), and 16-byte loads in flight a thread (kUnroll)
_BLOCKS_PER_SM = 4
_THREADS = 256
_UNROLL = 4
MAX_CHANNELS = 2048
# the kernel's C entry point and channels a 16-byte vector, by dtype
_ENTRY = {torch.float32: ("gn_swish_f32", 4), torch.bfloat16: ("gn_swish_bf16", 8)}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _threads_a_row(C: int, per_vector: int) -> int:
    """Threads that cover a row of C channels: one a 16-byte vector, or one
    for two vectors past _THREADS vectors (f32 at C > 1024)."""
    vectors = C // per_vector
    return vectors if vectors <= _THREADS else vectors // 2


def _chunking(B: int, hw: int, C: int, sms: int, per_vector: int = 4):
    """(chunks, rows a chunk) of each batch element's H*W rows: one wave of
    _BLOCKS_PER_SM blocks an SM over the B * chunks blocks, but no chunk
    shorter than one unrolled step of its block's threads."""
    rows_per_step = max(1, _THREADS // _threads_a_row(C, per_vector)) * _UNROLL
    chunks = max(1, min(sms * _BLOCKS_PER_SM // B, hw // rows_per_step))
    rows = -(-hw // chunks)
    return -(-hw // rows), rows


def _launch(x, scale, bias, num_groups: int, eps: float):
    """Run csrc/groupnorm_swish.cu on a CUDA tensor; raises on what it does
    not take."""
    B, H, W, C = x.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"group_norm_swish kernel takes float32 or bfloat16, got {x.dtype}")
    entry, per_vector = _ENTRY[x.dtype]
    if not x.is_contiguous():
        raise ValueError("group_norm_swish kernel takes a contiguous NHWC tensor")
    # a thread covers one or two whole 16-byte vectors of a row
    multiple = 2 * per_vector if C > _THREADS * per_vector else per_vector
    if C % multiple or C > MAX_CHANNELS or C % num_groups:
        raise ValueError(f"group_norm_swish kernel ({x.dtype}): C={C} must be a multiple of "
                         f"{multiple} and of num_groups={num_groups}, at most {MAX_CHANNELS}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_swish kernel needs a 16-byte aligned tensor")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.numel() != C or bias.numel() != C:
        raise ValueError("scale and bias must have C elements")
    hw = H * W
    chunks, rows = _chunking(B, hw, C, _sm_count(x.device.index), per_vector)
    partials = torch.empty((B, chunks, 2, C), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(library(), entry)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), partials.data_ptr(),
        y.data_ptr(), B, hw, C, num_groups, chunks, rows, float(eps), stream)
    check(err, entry)
    if x.dtype == torch.float32:
        FusedGroupNormSwish.launches += 1
    else:
        FusedGroupNormSwish.launches_bf16 += 1
    return y


class FusedGroupNormSwish(torch.autograd.Function):
    """Forward: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor. Backward: autograd through the plain version."""

    launches = 0  # float32 kernel launches, counted by _launch
    launches_bf16 = 0  # bfloat16 kernel launches, counted by _launch

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        if x.is_cuda:
            return _launch(x, scale, bias, num_groups, eps)
        return group_norm_swish_reference(x, scale, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (x, scale, bias)]
            y = group_norm_swish_reference(*args, ctx.num_groups, ctx.eps)
        gx, gs, gb = torch.autograd.grad(y, args, g)
        return gx, gs, gb, None, None


def fused_group_norm_swish(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """NHWC GroupNorm+affine+Swish; see FusedGroupNormSwish."""
    return FusedGroupNormSwish.apply(x, scale, bias, num_groups, eps)
