"""Spatial self-attention over (B, N, heads, D) tokens.

Counterpart: diffsplitting_tpu/ops/attention.py (`attention_reference`,
`fused_attention` with its custom VJP; the Pallas `_kernel`).

`fused_attention` launches a CUDA kernel for CUDA tensors, picked by the
dtype and then by the head dim D (`head_dim_route`). float32, csrc/attention.cu,
all three on the tensor cores at f32 accuracy: the D = 128 kernel; the wide
kernel, in 128-wide head-dim slices (the last one zero-filled past D), at any
other multiple of 4 above 128 up to 1024; the narrow kernel, at D padded to a
multiple of 16, at any multiple of 4 below 128. bfloat16 (the UNet at
`compute_dtype: bfloat16`), csrc/attention_bf16.cu: one bf16 tensor-core
kernel at any multiple of 8 up to 1024 (f32 scores and softmax, P rounded to
bf16, f32 sums, a bf16 result). It raises on any other D or dtype. CPU
tensors run the plain version. Backward runs autograd through the plain
version, as the JAX custom VJP does.
"""

from __future__ import annotations

import torch

from ..kernels.build import check, library

D128_HEAD_DIM = 128  # attention_tf32x3_d128_kernel; the narrow kernel below it
MAX_HEAD_DIM = 1024  # attention_tf32x3_wide_kernel: from 132 up to this


def attention_reference(q, k, v, scale: float):
    """Plain version: q, k, v (B, N, H, D) -> (B, N, H, D); f32 scores and
    softmax over keys, scores scaled by `scale`."""
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    attn = attn.softmax(dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn.to(q.dtype), v)


def head_dim_route(D: int, dtype=torch.float32) -> str:
    """The kernel that takes head dim D at `dtype`: "d128", "wide" or
    "narrow" (float32), "bf16" (bfloat16); raises on a D or dtype that none
    takes."""
    if dtype == torch.bfloat16:
        if D % 8 or not 0 < D <= MAX_HEAD_DIM:
            raise ValueError(f"the bf16 attention kernel takes a head dim that is a multiple "
                             f"of 8 up to {MAX_HEAD_DIM}, got {D}")
        return "bf16"
    if dtype != torch.float32:
        raise TypeError(f"attention kernels take float32 or bfloat16, got {dtype}")
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernels take a head dim that is a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if D == D128_HEAD_DIM:
        return "d128"
    return "wide" if D > D128_HEAD_DIM else "narrow"


def _launch(q, k, v, scale: float):
    """Run csrc/attention.cu on CUDA tensors; raises on what it does not take."""
    B, N, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    route = head_dim_route(D, q.dtype)
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[3] != 1:
        raise ValueError("attention kernel takes q, k, v with one set of strides "
                         "and a unit stride on the head dim")
    per_16_bytes = 16 // q.element_size()
    if any(s % per_16_bytes for s in strides[:3]) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention kernel needs 16-byte aligned rows")
    out = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if route == "bf16":
        err = library().attention_bf16(*ptrs, B, N, H, D, *strides[:3], float(scale), stream)
        check(err, "attention_bf16")
        FusedAttention.launches_bf16 += 1
    elif route == "d128":
        err = library().attention_f32_d128(*ptrs, B, N, H, *strides[:3], float(scale), stream)
        check(err, "attention_f32_d128")
        FusedAttention.launches += 1
    elif route == "wide":
        err = library().attention_f32_wide(*ptrs, B, N, H, D, *strides[:3], float(scale), stream)
        check(err, "attention_f32_wide")
        FusedAttention.launches_wide += 1
    else:
        err = library().attention_f32_narrow(*ptrs, B, N, H, D, *strides[:3], float(scale),
                                             stream)
        check(err, "attention_f32_narrow")
        FusedAttention.launches_narrow += 1
    return out


class FusedAttention(torch.autograd.Function):
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Backward: autograd through the plain version."""

    launches = 0  # D = 128 kernel launches, counted by _launch
    launches_wide = 0  # wide kernel launches (D above 128), counted by _launch
    launches_narrow = 0  # narrow kernel launches (D below 128), counted by _launch
    launches_bf16 = 0  # bf16 kernel launches (any D), counted by _launch

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.is_cuda:
            return _launch(q, k, v, scale)
        return attention_reference(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*args, ctx.scale)
        gq, gk, gv = torch.autograd.grad(out, args, g)
        return gq, gk, gv, None


def fused_attention(q, k, v, scale: float):
    """(B, N, heads, D) attention; see FusedAttention."""
    return FusedAttention.apply(q, k, v, scale)
