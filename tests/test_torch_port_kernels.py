"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test asks the `cuda` fixture, which skips without a card
(decided at run time, so every worker collects the same tests). On the card:
`python -m pytest tests/test_torch_port_kernels.py -m gpu`. TF32 is off, so
both sides compute in f32; tolerances cover the order of the sums.
"""

import math

import pytest
import torch

from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.models import blocks
from diffsplitting_tpu_torch.ops import (
    FusedAttention,
    FusedGroupNormSwish,
    attention_reference,
    fused_attention,
    fused_group_norm_swish,
    group_norm_swish_reference,
)
from diffsplitting_tpu_torch.serving import init_weights

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("B,H,C,G", [(2, 64, 16, 16), (2, 32, 48, 16), (1, 16, 96, 16),
                                     (2, 8, 256, 16), (1, 7, 12, 4)])
def test_group_norm_swish_kernel(cuda, B, H, C, G):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, H, H, C, device=cuda, generator=g) * 2 + 0.5
    scale = torch.randn(C, device=cuda, generator=g)
    bias = torch.randn(C, device=cuda, generator=g)
    before = FusedGroupNormSwish.launches
    got = fused_group_norm_swish(x, scale, bias, G)
    torch.cuda.synchronize()
    assert FusedGroupNormSwish.launches == before + 1
    want = group_norm_swish_reference(x, scale, bias, G)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,N,heads", [(2, 64, 1), (1, 256, 2)])
def test_attention_kernel(cuda, B, N, heads):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(B, N, heads, 3, 128, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    before = FusedAttention.launches
    got = fused_attention(q, k, v, 1 / math.sqrt(128 * heads))
    torch.cuda.synchronize()
    assert FusedAttention.launches == before + 1
    want = attention_reference(q, k, v, 1 / math.sqrt(128 * heads))
    assert (got - want).abs().max().item() <= 1e-4


def test_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.randn(1, 64, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q, q, q, 0.1)


def test_unet_forward_kernels_match_plain_versions(cuda, monkeypatch):
    net = UNet(in_channel=1, out_channel=1, inner_channel=16, norm_groups=16,
               channel_mults=(1, 2, 4, 8), attn_res=(), res_blocks=1, image_size=64)
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 64, 64, 1, device=cuda, generator=g)
    t = torch.full((2,), 0.5, device=cuda)
    with torch.no_grad():
        got = net(x, t)
        monkeypatch.setattr(blocks, "fused_group_norm_swish", group_norm_swish_reference)
        monkeypatch.setattr(blocks, "fused_attention", attention_reference)
        want = net(x, t)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-4
