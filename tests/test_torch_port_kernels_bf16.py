"""The port's bfloat16 kernels, and the float32 GroupNorm+Swish kernel past
1024 channels, against their plain versions on the card.

Marked `gpu`; each test asks the `cuda` fixture, which skips without a card
(decided at run time, so every worker collects the same tests). On the card:
`python -m pytest tests/test_torch_port_kernels_bf16.py -m gpu --noconftest`.

The bf16 check, as chip_smoke.py makes it: from the same bf16 inputs, an f32
reference (the plain version on the inputs made f32); the kernel's max abs
error against it must be at most 2x the plain bf16 version's. Both round the
result to bf16; the plain attention also rounds the scores and P to bf16.
"""

import math

import pytest
import torch

from diffsplitting_tpu_torch.ops import (
    FusedAttention,
    FusedGroupNormSwish,
    attention_reference,
    fused_attention,
    fused_group_norm_swish,
    group_norm_swish_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


# every (H, C) of configs/sr_sr3_64_512.json's GroupNorm+Swish calls (16
# groups; 1536 and 2048 the concatenated up-path inputs), ragged H*W, and
# C = 8 (one vector a row)
GN_BF16_CASES = [(1, 512, 64), (1, 512, 128), (1, 256, 64), (1, 256, 128), (1, 256, 256),
                 (1, 128, 128), (1, 128, 256), (1, 128, 512), (1, 64, 256), (1, 64, 512),
                 (1, 64, 1024), (1, 64, 1536), (1, 32, 512), (1, 32, 1024), (1, 32, 1536),
                 (1, 32, 2048), (2, 32, 2048), (2, 512, 64), (3, 13, 48), (1, 7, 8)]


@pytest.mark.parametrize("B,H,C", GN_BF16_CASES)
def test_group_norm_swish_bf16_kernel(cuda, B, H, C):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(B, H, H, C, device=cuda, generator=g) * 2 + 0.5).bfloat16()
    scale = torch.randn(C, device=cuda, generator=g)
    bias = torch.randn(C, device=cuda, generator=g)
    groups = 16 if C % 16 == 0 else 4
    before = FusedGroupNormSwish.launches, FusedGroupNormSwish.launches_bf16
    got = fused_group_norm_swish(x, scale, bias, groups)
    again = fused_group_norm_swish(x, scale, bias, groups)
    torch.cuda.synchronize()
    assert (FusedGroupNormSwish.launches, FusedGroupNormSwish.launches_bf16) == (
        before[0], before[1] + 2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again)
    ref = group_norm_swish_reference(x.float(), scale, bias, groups)
    plain = group_norm_swish_reference(x, scale, bias, groups)
    assert _err(got, ref) <= 2 * _err(plain, ref)


# the float32 kernel past 1024 channels: two vectors a thread
@pytest.mark.parametrize("B,H,C", [(1, 32, 1536), (1, 64, 1536), (2, 32, 2048), (1, 9, 1032)])
def test_group_norm_swish_f32_kernel_wide(cuda, B, H, C):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, H, H, C, device=cuda, generator=g) * 2 + 0.5
    scale = torch.randn(C, device=cuda, generator=g)
    bias = torch.randn(C, device=cuda, generator=g)
    before = FusedGroupNormSwish.launches
    got = fused_group_norm_swish(x, scale, bias, 8)
    again = fused_group_norm_swish(x, scale, bias, 8)
    torch.cuda.synchronize()
    assert FusedGroupNormSwish.launches == before + 2
    want = group_norm_swish_reference(x, scale, bias, 8)
    # f32 on both sides, sums in another order: the f32 kernel's tolerance
    assert _err(got, want) <= 1e-4 * (1 + want.abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 2056), (torch.bfloat16, 44),
                                     (torch.float32, 2052), (torch.float32, 1028),
                                     (torch.float16, 64)])
def test_group_norm_swish_kernel_refuses(cuda, dtype, C):
    x = torch.zeros(1, 4, 4, C, device=cuda, dtype=dtype)
    w = torch.ones(C, device=cuda)
    with pytest.raises((ValueError, TypeError)):
        fused_group_norm_swish(x, w, w, 4)


# the config's mid block (N = 1024 tokens of 32², D = 1024, one head) at its
# serving batch 1 and train batch 2, and D = 512, 128, 64; every slice width
# below 128 (8 ... 120), padded slices above it (136, 200, 520, 1000), masked
# N (1, 17, 100, 1023), 1-2 heads, scores x8 so that the running max moves
ATTN_BF16_CASES = [(1, 1024, 1, 1024, False), (2, 1024, 1, 1024, False),
                   (1, 1024, 1, 512, False), (1, 1024, 1, 128, False), (1, 1024, 1, 64, False),
                   (2, 100, 1, 1024, True), (1, 17, 2, 768, False), (2, 1, 1, 256, False),
                   (1, 100, 1, 8, True), (2, 65, 1, 24, False), (1, 100, 2, 40, True),
                   (1, 1023, 1, 56, False), (2, 33, 1, 72, True), (1, 129, 1, 88, False),
                   (1, 100, 1, 104, True), (2, 64, 2, 120, False), (1, 100, 1, 136, True),
                   (2, 1023, 1, 200, False), (1, 257, 1, 384, True), (1, 100, 1, 520, False),
                   (2, 300, 1, 640, True), (1, 31, 1, 896, False), (1, 100, 1, 1000, True)]


@pytest.mark.parametrize("B,N,heads,D,big", ATTN_BF16_CASES)
def test_attention_bf16_kernel(cuda, B, N, heads, D, big):
    g = torch.Generator(device=cuda).manual_seed(2)
    # q, k, v as the attention block hands them over: views of one qkv tensor
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g).bfloat16()
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = (8 if big else 1) / math.sqrt(D * heads)
    before = FusedAttention.launches_bf16
    got = fused_attention(q, k, v, scale)
    again = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert FusedAttention.launches_bf16 == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, heads, D)
    assert torch.equal(got, again)
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    plain = attention_reference(q, k, v, scale)
    assert _err(got, ref) <= 2 * _err(plain, ref)


def test_attention_bf16_kernel_reads_nothing_past_d_or_n(cuda):
    """Columns past D and rows past N hold NaN in the tensor the views cut."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(1, 128, 1, 3, 160, device=cuda, generator=g).bfloat16()
    qkv[..., 136:] = float("nan")
    qkv[:, 100:] = float("nan")
    q, k, v = (qkv[:, :100, :, i, :136] for i in range(3))
    got = fused_attention(q, k, v, 1 / math.sqrt(136))
    assert torch.isfinite(got.float()).all()
    ref = attention_reference(q.float(), k.float(), v.float(), 1 / math.sqrt(136))
    plain = attention_reference(q, k, v, 1 / math.sqrt(136))
    assert _err(got, ref) <= 2 * _err(plain, ref)


@pytest.mark.parametrize("D", [12, 1032])
def test_attention_bf16_kernel_refuses_other_head_dims(cuda, D):
    q = torch.randn(1, 64, 1, D, device=cuda).bfloat16()
    before = FusedAttention.launches_bf16
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q, q, q, 0.1)
    assert FusedAttention.launches_bf16 == before
