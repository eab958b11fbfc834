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
# a group) and its widest GroupNorm, C = 1024, at batch 1 (C up to 2048:
# tests/test_torch_port_kernels_bf16.py)
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
# block hands them over. N = 64 is two 32-key tiles and the rows of one of a
# block's two warpgroups; 192 is six key tiles and a second 128-query block
# with rows for one of its warpgroups; "big" scales the scores by 8 so that
# the running max moves across key tiles. N = 16 (the 4 x 4 mid block of a
# 32² patch) fills half of one key tile and a quarter of a warpgroup's rows;
# 100 three tiles and 4 keys of a fourth, split across blocks by the plan;
# 4095 leaves one key slot and one query row of the last warpgroup empty.
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


@pytest.mark.parametrize("D,width", [(60, 64), (12, 16), (100, 128), (192, 256), (900, 1024)])
def test_attention_kernel_reads_nothing_past_d(cuda, D, width):
    """The padded routes zero-fill columns D ... DP - 1 in shared memory and
    store none of them: q, k, v are the first D columns of rows `width` wide
    whose other columns, and rows past N = 100, hold NaN."""
    g = torch.Generator(device=cuda).manual_seed(13)
    qkv = torch.randn(1, 128, 1, 3, width, device=cuda, generator=g)
    qkv[..., D:] = float("nan")
    qkv[:, 100:] = float("nan")
    q, k, v = (qkv[:, :100, :, i, :D] for i in range(3))
    got = fused_attention(q, k, v, 1 / math.sqrt(D))
    want = attention_reference(q, k, v, 1 / math.sqrt(D))
    assert got.shape == (1, 100, 1, D) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())


# head dims that are not multiples of 128: the narrow kernel below 128 at
# every padded width DP (16: D = 4, 12, 16; 32: 20, 28; 48: 44; 64; 80: 68;
# 96; 128: 100, 124), with the zero-filled columns D ... DP - 1, and the wide
# kernel's padded last slice above 128 (132 ... 252 at two slices, 320, 500,
# 900 and 1020); masked N (100 leaves 28 keys of a 64-key tile empty, 1023 one
# key of the last 16-key tile, 4095 one query row and one key), 1-2 heads,
# and scores x8 so that the running max moves
ANY_D_CASES = [(2, 16, 1, 16, False), (2, 100, 1, 16, True), (1, 1024, 1, 16, False),
               (2, 64, 2, 64, False), (1, 100, 1, 64, True), (1, 1024, 1, 64, False),
               (2, 16, 1, 192, False), (1, 100, 2, 252, True), (1, 1024, 1, 192, False),
               (8, 256, 1, 320, False), (1, 100, 1, 500, True), (2, 1023, 1, 1020, False),
               (1, 100, 1, 900, True), (3, 37, 1, 12, False), (1, 50, 2, 20, True),
               (1, 70, 1, 68, False), (2, 100, 1, 4, True), (1, 1000, 1, 28, False),
               (2, 65, 1, 44, True), (1, 129, 2, 96, False), (1, 100, 1, 124, True),
               (2, 33, 1, 100, False), (1, 4095, 1, 64, True), (1, 17, 1, 132, False)]


def _counts():
    return FusedAttention.launches, FusedAttention.launches_wide, FusedAttention.launches_narrow


@pytest.mark.parametrize("B,N,heads,D,big", ANY_D_CASES)
def test_attention_kernel_at_any_head_dim(cuda, B, N, heads, D, big):
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = (8 if big else 1) / math.sqrt(D * heads)
    before = list(_counts())
    got = fused_attention(q, k, v, scale)
    again = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    before[1 if D > 128 else 2] += 2
    assert list(_counts()) == before
    want = attention_reference(q, k, v, scale)
    # 3xTF32 keeps f32 accuracy; sums over D and N in another order; the chip
    # check's tolerance
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())
    assert torch.equal(got, again)


# the wide tensor-core kernel at every head dim it takes: D = 256, 384, 512,
# 768 and 1024 at N = 1 (one key, 63 query rows of the tile empty), 17 (a
# last key tile of 17 keys), 100 and 1023 (a key slot of the last tile
# empty), with 640 and 896 at two N; ragged D (192, 320 and 1020: a panel or
# chunk past D zero-filled), at N = 1 too; 1-2 heads as strided views of one
# qkv tensor, and scores x8 so that the running max moves across key tiles;
# sr_sr3_16_128's two sites at its serving batch 1 (the 16² maps, N = 256,
# and the 8² mid block, N = 64, at D = 512) and sample_ddpm_128's mid block
# (B = 12, N = 16, D = 256)
WIDE_CASES = ([(2, n, 1 + i % 2, d, bool(i % 2)) for d in (256, 384, 512, 768, 1024)
               for i, n in enumerate((1, 17, 100, 1023))]
              + [(2, 100, 1, 640, True), (1, 1023, 2, 640, False), (1, 17, 2, 896, False),
                 (2, 1023, 1, 896, True), (1, 256, 1, 512, False), (1, 64, 1, 512, False),
                 (12, 16, 1, 256, False), (8, 100, 1, 192, True), (1, 1, 1, 192, False),
                 (2, 300, 1, 320, False), (1, 1, 2, 320, True), (1, 257, 1, 1020, True),
                 (3, 1, 1, 1020, False)])


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
    # 3xTF32 keeps f32 accuracy; S is added across 32-wide panels and the
    # sums run in another order than cuBLAS's; the chip check's tolerance
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())
    assert torch.equal(got, again)


# the plan forced: key splits that leave the last split with no key (N = 256
# at 64-key tiles: 4 tiles, 3 splits of 2; N = 1023: 16 tiles, 5 splits of
# 4), one split and one slice (a split of 4 or 16 key tiles), every key tile
# its own split at 32-key tiles, one chunk a slice, slices of 2 chunks;
# 16-key tiles (N = 100: 7 of them in 4 splits; N = 9 below one tile)
WIDE_FORCED_CASES = [(1, 256, 1, 512, 3, 1, 64), (1, 256, 1, 512, 1, 1, 64),
                     (1, 256, 1, 512, 8, 8, 32), (1, 256, 1, 512, 2, 3, 32),
                     (2, 1023, 1, 896, 5, 2, 64), (2, 1023, 1, 896, 1, 2, 64),
                     (2, 1023, 1, 896, 32, 7, 32), (1, 100, 2, 1020, 3, 16, 32),
                     (1, 100, 1, 512, 4, 2, 16), (3, 9, 2, 256, 1, 4, 16)]


@pytest.mark.parametrize("B,N,heads,D,splits,slices,key_tile", WIDE_FORCED_CASES)
def test_attention_wide_kernel_forced_plan(cuda, B, N, heads, D, splits, slices, key_tile):
    from diffsplitting_tpu_torch.ops.attention import _launch_wide, wide_plan

    how = wide_plan(B * heads, N, D, torch.cuda.get_device_properties(cuda).multi_processor_count,
                    splits, slices, key_tile)
    assert (how.splits, how.key_tile) == (splits, key_tile)
    g = torch.Generator(device=cuda).manual_seed(14)
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = 8 / math.sqrt(D * heads)
    got = _launch_wide(q, k, v, torch.empty(B, N, heads, D, device=cuda), scale, splits, slices,
                       key_tile)
    again = _launch_wide(q, k, v, torch.empty(B, N, heads, D, device=cuda), scale, splits,
                         slices, key_tile)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    want = attention_reference(q, k, v, scale)
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())


# a CUDA-graph replay gives the eager launch's bits: the wide plan's splits
# with their combine launch (N = 256, 64, 100), one split (N = 16, 1024)
@pytest.mark.parametrize("B,N,D", [(1, 256, 512), (1, 64, 512), (12, 16, 256), (8, 100, 256),
                                   (2, 1024, 1024), (8, 1024, 192)])
def test_attention_wide_graph_replay_equals_eager(cuda, B, N, D):
    _graph_replay_equals_eager(cuda, B, N, D)


# the D = 128 kernel's plan forced: key splits that leave the last split with
# no key (N = 256: 4 tiles, 3 splits of 2), one split over all of N = 4096, 5
# splits of 13 tiles (the last of 12), N = 1000 (16 tiles) in 4 or 3 splits,
# N = 4095 in 7 splits of 10 tiles (the last of 4, with a key slot empty), N
# = 9 below one tile, two heads
D128_FORCED_CASES = [(1, 256, 1, 3), (1, 4096, 1, 1), (1, 4096, 1, 5), (2, 1000, 1, 4),
                     (2, 1000, 2, 3), (3, 9, 2, 1), (1, 4095, 1, 7)]


@pytest.mark.parametrize("B,N,heads,splits", D128_FORCED_CASES)
def test_attention_d128_kernel_forced_plan(cuda, B, N, heads, splits):
    from diffsplitting_tpu_torch.ops.attention import _launch_d128, d128_plan

    how = d128_plan(B * heads, N, torch.cuda.get_device_properties(cuda).multi_processor_count,
                    splits)
    assert how.splits == splits
    g = torch.Generator(device=cuda).manual_seed(16)
    qkv = torch.randn(B, N, heads, 3, 128, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = 8 / math.sqrt(128 * heads)
    got, again = (torch.empty(B, N, heads, 128, device=cuda) for _ in range(2))
    assert _launch_d128(q, k, v, got, scale, splits) == how
    _launch_d128(q, k, v, again, scale, splits)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    want = attention_reference(q, k, v, scale)
    assert (got - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())


# the D = 128 kernel's plan with its combine launch (N = 4096 at batch 1 and
# 2, N = 100) and one split (N = 16, batch 8)
@pytest.mark.parametrize("B,N", [(1, 4096), (2, 4096), (8, 16), (2, 100)])
def test_attention_d128_graph_replay_equals_eager(cuda, B, N):
    _graph_replay_equals_eager(cuda, B, N, 128)


def _graph_replay_equals_eager(cuda, B, N, D):
    g = torch.Generator(device=cuda).manual_seed(15)
    qkv = torch.randn(B, N, 1, 3, D, device=cuda, generator=g)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = 1 / math.sqrt(D)
    eager = fused_attention(q, k, v, scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_attention(q, k, v, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fused_attention(q, k, v, scale)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


def test_attention_routes_by_head_dim(cuda):
    """D = 128 to the D = 128 kernel, any other multiple of 4 above it up to
    1024 to the wide kernel, and below it to the narrow kernel."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for D, which in [(128, 0), (256, 1), (384, 1), (512, 1), (768, 1), (1024, 1), (12, 2),
                     (16, 2), (64, 2), (68, 2), (192, 1), (1020, 1), (4, 2), (124, 2),
                     (132, 1)]:
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


# each block width (16, 32, 64, 128 channels) on a ragged 13 x 20 map, with
# a projected residual of 256 channels, an identity one, or none; items
# fewer and more than the card's SMs (the grid is persistent)
CONV_GN_WIDTH_CASES = [
    (2, 13, 20, 48, 16, "projected", 256),
    (3, 13, 20, 96, 32, "identity", 32),
    (1, 13, 20, 64, 64, "projected", 256),
    (2, 13, 20, 128, 128, "projected", 256),
    (4, 13, 20, 256, 128, None, 0),
    (12, 64, 64, 32, 16, None, 0),
    (24, 32, 32, 64, 128, "identity", 128),
]


@pytest.mark.parametrize("B,H,W,Cin,Cout,res,Cres", CONV_GN_WIDTH_CASES)
def test_conv_gn_kernel_at_each_block_width(cuda, B, H, W, Cin, Cout, res, Cres):
    """Against the plain version and f64 with chip_smoke.py's tolerances;
    two launches and a CUDA-graph replay give the same bits."""
    args = _conv_gn_inputs(cuda, B, H, W, Cin, Cout, True, res, Cres)
    y, s, q = conv_gn_fused(*args)
    again = conv_gn_fused(*args)
    y_ref, _, _ = conv_gn_reference(*args)
    x, w, b, scale, shift, r, ws = (t.double() if t is not None else None for t in args)
    xa = x * scale[:, None, None, :] + shift[:, None, None, :]
    xa = xa * torch.sigmoid(xa)
    y64 = torch.nn.functional.conv2d(xa.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y64 = y64.permute(0, 2, 3, 1) + b
    if r is not None:
        y64 = y64 + (r @ ws if ws is not None else r)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= 1e-4 * (1 + y_ref.abs().max().item())
    assert ((s.double() - y64.sum(dim=(1, 2))).abs()
            <= 1e-5 * y64.abs().sum(dim=(1, 2)) + 1e-3).all()
    assert ((q.double() - (y64 * y64).sum(dim=(1, 2))).abs()
            <= 1e-5 * (y64 * y64).sum(dim=(1, 2)) + 1e-3).all()
    assert all(torch.equal(a, c) for a, c in zip((y, s, q), again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv_gn_fused(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = conv_gn_fused(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip((y, s, q), replayed))


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
