"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test asks the `cuda` fixture, which skips without a card
(decided at run time, so every worker collects the same tests). On the card:
`python -m pytest tests/test_torch_port_kernels.py -m gpu`. TF32 is off, so
both sides compute in f32; tolerances cover the order of the sums.
"""

import math

import pytest
import torch

from diffsplitting_tpu_torch.models import UNet, fused_unet_forward
from diffsplitting_tpu_torch.models import blocks
from diffsplitting_tpu_torch.ops import (
    FusedAttention,
    FusedConvGN,
    FusedGroupNormSwish,
    attention_reference,
    conv_gn_fused,
    conv_gn_reference,
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


# the last two: sr_sr3_16_128's 128² maps at C = 64 with 32 groups (2 channels
# a group) and its widest GroupNorm, C = 1024 (the kernel's limit), at batch 1
@pytest.mark.parametrize("B,H,C,G", [(2, 64, 16, 16), (2, 32, 48, 16), (1, 16, 96, 16),
                                     (2, 8, 256, 16), (1, 7, 12, 4), (1, 128, 64, 32),
                                     (1, 16, 1024, 32)])
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


# every distinct (C, H) of an unfused forward of the splitting UNet on 512²
# patches at batch 8 (C/G = 3 at C = 48, 6 at 96, 12 at 192; 403 MB of x at
# C = 48, H = 512), the 4 x 4 mid-block maps of 32² patches, and ragged H*W
# with C/G = 3
GN_SLICE_CASES = [(8, 512, 512, 16), (8, 512, 512, 32), (8, 512, 512, 48), (8, 256, 256, 16),
                  (8, 256, 256, 32), (8, 256, 256, 48), (8, 256, 256, 96), (8, 128, 128, 32),
                  (8, 128, 128, 64), (8, 128, 128, 96), (8, 128, 128, 192), (8, 64, 64, 64),
                  (8, 64, 64, 128), (8, 64, 64, 192), (8, 64, 64, 256), (8, 4, 4, 128),
                  (8, 4, 4, 256), (3, 33, 17, 48), (5, 13, 20, 48)]


@pytest.mark.parametrize("B,H,W,C", GN_SLICE_CASES)
def test_group_norm_swish_kernel_at_slice_shapes(cuda, B, H, W, C):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, H, W, C, device=cuda, generator=g) * 2 + 0.5
    scale = torch.randn(C, device=cuda, generator=g)
    bias = torch.randn(C, device=cuda, generator=g)
    got = fused_group_norm_swish(x, scale, bias, 16)
    want = group_norm_swish_reference(x, scale, bias, 16)
    # chip_smoke.py's tolerance: f32 group sums over up to 786K values in
    # another order
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())


# q, k, v are strided views of one (B, N, heads, 3, 128) qkv tensor, as the mid
# block hands them over. N = 64 is two 32-key tiles and half a query block;
# 192 is six key tiles and a last block with rows for half its warps; "big"
# scales the scores by 8 so that the running max moves across key tiles. N = 16
# (the 4 x 4 mid block of a 32² patch) fills half of one key tile and one
# warp; 100 three tiles and 4 keys of a fourth, with warp 6 holding rows
# 96-111; 4095 leaves one key slot and one query row of the last warp empty.
@pytest.mark.parametrize("B,N,heads,big", [(2, 64, 1, False), (1, 256, 2, False),
                                           (1, 192, 1, False), (1, 4096, 1, False),
                                           (2, 64, 2, True), (1, 256, 1, True),
                                           (1, 4096, 2, True), (8, 16, 1, False),
                                           (2, 16, 2, True), (2, 100, 1, False),
                                           (1, 100, 2, True), (1, 4095, 1, False),
                                           (1, 4095, 2, True)])
def test_attention_kernel(cuda, B, N, heads, big):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(B, N, heads, 3, 128, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = (8 if big else 1) / math.sqrt(128 * heads)
    before = FusedAttention.launches
    got = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert FusedAttention.launches == before + 1
    want = attention_reference(q, k, v, scale)
    # 3xTF32 keeps f32 accuracy; the sums run in another order than cuBLAS's.
    # Scores 8x larger carry 8x the absolute score error into exp, on both
    # sides, so those cases take the chip check's 1e-4 * (1 + max|ref|).
    tol = 1e-4 * (1 + want.abs().max().item()) if big else 1e-4
    assert (got - want).abs().max().item() <= tol


def test_attention_kernel_leaves_no_trace_past_n(cuda):
    """Rows past N are not written, and keys past N take no weight: the
    kernel on the first 100 tokens of a tensor with NaN past them."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(1, 128, 1, 3, 128, device=cuda, generator=g)
    qkv[:, 100:] = float("nan")
    q, k, v = (qkv[:, :100, :, i, :] for i in range(3))
    got = fused_attention(q, k, v, 1 / math.sqrt(128))
    want = attention_reference(q, k, v, 1 / math.sqrt(128))
    assert got.shape == (1, 100, 1, 128) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


# the SIMT kernel at every tile class (R = 4 up to D = 256, 2 up to 512, 1 up
# to 1024) at head dims it still serves (the multiples of 128 from 256 go to
# the wide kernel), and ragged D (12, 20, 68: part-filled O chunks), with
# masked N (100 leaves 28 keys of a 64-key tile empty, 1023 one key of the
# last 16-key tile), 1-2 heads, and scores x8 so that the running max moves
ANY_D_CASES = [(2, 16, 1, 16, False), (2, 100, 1, 16, True), (1, 1024, 1, 16, False),
               (2, 64, 2, 64, False), (1, 100, 1, 64, True), (1, 1024, 1, 64, False),
               (2, 16, 1, 192, False), (1, 100, 2, 252, True), (1, 1024, 1, 192, False),
               (8, 256, 1, 320, False), (1, 100, 1, 500, True), (2, 1023, 1, 1020, False),
               (1, 100, 1, 900, True), (3, 37, 1, 12, False), (1, 50, 2, 20, True),
               (1, 70, 1, 68, False)]


def _counts():
    return FusedAttention.launches, FusedAttention.launches_wide, FusedAttention.launches_any_d


@pytest.mark.parametrize("B,N,heads,D,big", ANY_D_CASES)
def test_attention_kernel_at_any_head_dim(cuda, B, N, heads, D, big):
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = (8 if big else 1) / math.sqrt(D * heads)
    before = _counts()
    got = fused_attention(q, k, v, scale)
    again = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2)
    want = attention_reference(q, k, v, scale)
    # f32 FMA on both sides, sums over D and N in another order; the chip
    # check's tolerance
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())
    assert torch.equal(got, again)


# the wide tensor-core kernel at every head dim it takes: D = 256, 384, 512,
# 768 and 1024 at N = 1 (one key, 15 rows of a row group empty), 17 (a last
# key tile of one or two keys, at 16- and 32-key tiles), 100 and 1023
# (a key slot of the last tile empty), with 640 and 896 at two N; 1-2 heads
# as strided views of one qkv tensor, and scores x8 so that the running max
# moves across key tiles; sr_sr3_16_128's two sites at its serving batch 1
# (the 16² maps, N = 256, and the 8² mid block, N = 64, at D = 512)
WIDE_CASES = ([(2, n, 1 + i % 2, d, bool(i % 2)) for d in (256, 384, 512, 768, 1024)
               for i, n in enumerate((1, 17, 100, 1023))]
              + [(2, 100, 1, 640, True), (1, 1023, 2, 640, False), (1, 17, 2, 896, False),
                 (2, 1023, 1, 896, True), (1, 256, 1, 512, False), (1, 64, 1, 512, False)])


@pytest.mark.parametrize("B,N,heads,D,big", WIDE_CASES)
def test_attention_wide_kernel(cuda, B, N, heads, D, big):
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = (8 if big else 1) / math.sqrt(D * heads)
    before = _counts()
    got = fused_attention(q, k, v, scale)
    again = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 2, before[2])
    want = attention_reference(q, k, v, scale)
    # 3xTF32 keeps f32 accuracy; S is added across 128-wide slices and the
    # sums run in another order than cuBLAS's; the chip check's tolerance
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())
    assert torch.equal(got, again)


def test_attention_routes_by_head_dim(cuda):
    """D = 128 to the tensor-core kernel, 256 ... 1024 in steps of 128 to the
    wide one, and any other multiple of 4 to the SIMT kernel."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for D, which in [(128, 0), (256, 1), (384, 1), (512, 1), (768, 1), (1024, 1), (12, 2),
                     (16, 2), (64, 2), (68, 2), (192, 2), (1020, 2)]:
        q = torch.randn(1, 40, 1, D, device=cuda, generator=g)
        before = list(_counts())
        fused_attention(q, q, q, 0.1)
        before[which] += 1
        assert list(_counts()) == before, D


def _conv_gn_run(dev):
    args = _conv_gn_inputs(dev, 2, 13, 20, 48, 128, True, "identity")
    return lambda: conv_gn_fused(*args)


def _gn_run(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x, scale, bias = (torch.randn(*s, device=dev, generator=g) for s in ((8, 64, 64, 48), (48,),
                                                                         (48,)))
    return lambda: fused_group_norm_swish(x, scale, bias, 16)


def _attention_run(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(2, 1000, 1, 3, 128, device=dev, generator=g)
    return lambda: fused_attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], 0.1)


# no atomics: the partial sums are folded in a fixed order
@pytest.mark.parametrize("make", [_gn_run, _attention_run, _conv_gn_run],
                         ids=["group_norm_swish", "attention", "conv_gn"])
def test_kernel_gives_the_same_bits_on_two_launches(cuda, make):
    run = make(cuda)
    first = run()
    second = run()
    torch.cuda.synchronize()
    for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (first, second))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [66, 1028])
def test_attention_kernel_refuses_other_head_dims(cuda, D):
    q = torch.randn(1, 64, 1, D, device=cuda)
    before = _counts()
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q, q, q, 0.1)
    assert _counts() == before


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


# (B, H, W, Cin, Cout, prologue, residual, Cres, gain): residual None,
# "identity" or "projected" (Cres channels); H = 13 and W = 20 leave the
# block's rows and columns ragged; the two longest K (Cin 128 with a projected
# Cres 256, Cin 256 alone) run 160 and 144 K steps of 16 channels; widths of
# 12 and 20 leave a K step and the block's channels part filled; gain scales x
# and the residual
CONV_GN_CASES = [
    (2, 16, 16, 48, 16, True, "projected", 48, 1),
    (2, 16, 16, 96, 32, True, "projected", 96, 1),
    (1, 8, 8, 192, 64, True, "projected", 192, 1),
    (2, 8, 8, 256, 128, True, "projected", 256, 1),
    (2, 16, 16, 64, 64, True, "identity", 64, 1),
    (1, 32, 32, 32, 32, False, None, 0, 1),
    (1, 13, 20, 48, 128, True, "identity", 128, 1),
    (3, 13, 20, 96, 16, True, "projected", 96, 1),
    (2, 16, 16, 128, 128, True, "projected", 256, 1),
    (2, 8, 16, 256, 128, True, None, 0, 1),
    (1, 13, 20, 12, 12, True, "identity", 12, 1),
    (2, 9, 17, 12, 12, True, "projected", 20, 1),
    (2, 16, 16, 96, 32, True, "projected", 96, 8),
    (1, 8, 16, 128, 128, False, "identity", 128, 8),
]


def _conv_gn_inputs(dev, B, H, W, Cin, Cout, act, res, Cres=None, gain=1, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    x = rand(B, H, W, Cin) * gain
    w = rand(3, 3, Cin, Cout) / math.sqrt(9 * Cin)
    b = rand(Cout)
    scale = rand(B, Cin) * 0.2 + 1 if act else None
    shift = rand(B, Cin) * 0.5 if act else None
    if Cres is None:
        Cres = Cin if res == "projected" else Cout
    r = rand(B, H, W, Cres) * gain if res else None
    ws = rand(Cres, Cout) / math.sqrt(Cres) if res == "projected" else None
    return x, w, b, scale, shift, r, ws


@pytest.mark.parametrize("B,H,W,Cin,Cout,act,res,Cres,gain", CONV_GN_CASES)
def test_conv_gn_kernel(cuda, B, H, W, Cin, Cout, act, res, Cres, gain):
    args = _conv_gn_inputs(cuda, B, H, W, Cin, Cout, act, res, Cres, gain)
    before = FusedConvGN.launches
    y, s, q = conv_gn_fused(*args)
    torch.cuda.synchronize()
    assert FusedConvGN.launches == before + 1
    y_ref, s_ref, q_ref = conv_gn_reference(*args)
    # 3xTF32 keeps f32 accuracy; sums over up to 9*256 + 256 terms in another
    # order
    assert (y - y_ref).abs().max().item() <= 1e-4 * (1 + y_ref.abs().max().item())
    # the statistics sum H*W values per channel in another order
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-3 * gain * gain)
    torch.testing.assert_close(q, q_ref, rtol=1e-4, atol=1e-3 * gain * gain)


def test_conv_gn_kernel_reads_an_oihw_parameter_in_place(cuda):
    """The HWIO view of an OIHW weight and a transposed 1x1 weight go in as
    they are (strided), without a copy."""
    x, _, b, scale, shift, r, _ = _conv_gn_inputs(cuda, 2, 16, 16, 48, 16, True, "projected")
    conv = torch.nn.Conv2d(48, 16, 3, padding=1).to(cuda)
    skip = torch.nn.Conv2d(48, 16, 1).to(cuda)
    w, ws = conv.weight.permute(2, 3, 1, 0), skip.weight[:, :, 0, 0].t()
    with torch.no_grad():
        y, s, _ = conv_gn_fused(x, w, b, scale, shift, r, ws)
        y_ref, s_ref, _ = conv_gn_reference(x, w.contiguous(), b, scale, shift, r,
                                            ws.contiguous())
    assert (y - y_ref).abs().max().item() <= 1e-4 * (1 + y_ref.abs().max().item())
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("Cin,Cout", [(18, 16), (16, 136), (260, 16)])
def test_conv_gn_kernel_refuses_other_widths(cuda, Cin, Cout):
    x = torch.randn(1, 8, 8, Cin, device=cuda)
    w = torch.randn(3, 3, Cin, Cout, device=cuda)
    before = FusedConvGN.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        conv_gn_fused(x, w, torch.zeros(Cout, device=cuda))
    assert FusedConvGN.launches == before


def test_fused_unet_forward_matches_unfused(cuda):
    net = UNet(in_channel=1, out_channel=1, inner_channel=16, norm_groups=16,
               channel_mults=(1, 2, 4, 8), attn_res=(), res_blocks=1, image_size=64)
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero biases, the res_conv's included
        for p in net.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    net = net.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 64, 64, 1, device=cuda, generator=g)
    t = torch.full((2,), 0.5, device=cuda)
    before = FusedConvGN.launches
    with torch.no_grad():
        got = fused_unet_forward(net, x, t)
        want = net(x, t)
    assert FusedConvGN.launches == before + 31  # 14 ResnetBlocks x 2 + 3 upsamples
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-4


@pytest.mark.parametrize("affine", [False, True], ids=["additive", "affine"])
def test_noise_level_fused_forward_matches_unfused(cuda, affine):
    """SR3's noise-level FiLM in the fused walk (a bias, or 1 + γ and β) on
    the card, at inner 64 (the conv_gn kernel takes the 64- and 128-channel
    sites) with 32 groups, against the unfused forward."""
    net = UNet(in_channel=6, out_channel=3, inner_channel=64, norm_groups=32,
               channel_mults=(1, 2, 4), attn_res=(16,), res_blocks=1, image_size=64,
               cond_type="noise_level", use_affine_level=affine)
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero biases, the FiLM's and res_conv's included
        for p in net.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    net = net.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 64, 64, 6, device=cuda, generator=g)
    level = torch.rand(2, device=cuda, generator=g)
    before = FusedConvGN.launches
    with torch.no_grad():
        got = fused_unet_forward(net, x, level)
        want = net(x, level)
    assert FusedConvGN.launches > before
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-4
