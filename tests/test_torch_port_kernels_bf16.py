"""The port's bfloat16 kernels (GroupNorm+Swish, attention, conv_gn), and the
float32 GroupNorm+Swish kernel past 1024 channels, against their plain
versions on the card.

Marked `gpu`; each test asks the `cuda` fixture, which skips without a card
(decided at run time, so every worker collects the same tests). On the card:
`python -m pytest tests/test_torch_port_kernels_bf16.py -m gpu --noconftest`.

The bf16 check, as chip_smoke.py makes it: from the same bf16 inputs, an f32
reference (the plain version on the inputs made f32); the kernel's max abs
error against it must be at most 2x the plain bf16 version's. Both round the
result to bf16; the plain attention also rounds the scores and P to bf16.

The bf16 conv_gn kernel computes what its plain version computes (bf16
operands, exact products, f32 sums, y rounded once), in another order of the
sums: y within one bf16 step (2^-7·|y|, a rounding that the order flips) plus
1e-4·max|y| (values near 0, where the f32 sums' own difference exceeds their
bf16 step); the statistics within 1e-5 of Σ|y| (sums over H·W pixels in
another order), as chip_smoke.py holds them.
"""

import math

import pytest
import torch

from diffsplitting_tpu_torch.models import UNet, fused_unet_forward
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
    groupnorm,
)
from diffsplitting_tpu_torch.kernels.groupnorm_variants import plan_with
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


def _gn_route(dev, B, H, W, C, G, dtype, route, seed=2, constants=None):
    """The kernel on the route `route` (`ops.groupnorm.plan` with its tuning
    `constants` set, as kernels/groupnorm_variants.py sets them): launched twice (the same bits, one count a launch) and held
    against the plain version, f32 at 1e-4·(1 + max|ref|), bf16 within 2x
    the plain bf16 version's error against f32 of the same inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 2 + 0.5).to(dtype)
    scale = torch.randn(C, device=dev, generator=g)
    bias = torch.randn(C, device=dev, generator=g)
    pv = groupnorm._ENTRY[dtype][1]
    how = plan_with(constants or {}, B, H * W, C, G, pv, groupnorm._sm_count(dev.index),
                    route=route)
    assert how.route == route
    before = FusedGroupNormSwish.launches + FusedGroupNormSwish.launches_bf16
    got = groupnorm._launch(x, scale, bias, G, 1e-5, how)
    again = groupnorm._launch(x, scale, bias, G, 1e-5, how)
    torch.cuda.synchronize()
    assert FusedGroupNormSwish.launches + FusedGroupNormSwish.launches_bf16 == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    ref = group_norm_swish_reference(x.float(), scale, bias, G)
    if dtype == torch.bfloat16:
        assert _err(got, ref) <= 2 * _err(group_norm_swish_reference(x, scale, bias, G), ref)
    else:
        assert _err(got, ref) <= 1e-4 * (1 + ref.abs().max().item())
    return how


# each route at its edges: the largest on-chip slabs of the slice (bf16 128²
# at C = 768, 214 KB a block; f32 64² at C = 192 with batch 8 on the widest
# slab, 215 KB), a cluster of 16 (256² at C = 128, bf16), the smallest maps on
# the stream route (one chunk, and one cluster of 8 chunks) and its largest
# (512² at C = 192, bf16, clusters of 8); C/G of 3, 6 and 12 on both routes;
# C = 2048 in both dtypes; ragged H*W
WIDE, K16, CLUSTERED = {"_TWO_SLAB_BYTES": 1 << 30}, {"PLAN_CLUSTER": 16}, {"_FOLD_ALONE": 0}
GN_ROUTE_CASES = [
    (1, 128, 128, 768, 16, torch.bfloat16, "cluster", {}),
    (8, 64, 64, 192, 16, torch.float32, "cluster", WIDE),
    (1, 256, 256, 128, 16, torch.bfloat16, "cluster", K16),
    (1, 4, 4, 64, 16, torch.bfloat16, "stream", {}),
    (1, 32, 32, 64, 16, torch.float32, "stream", CLUSTERED),
    (1, 512, 512, 192, 16, torch.bfloat16, "stream", {}),
    (2, 32, 32, 48, 16, torch.float32, "cluster", {}),
    (2, 32, 32, 48, 16, torch.float32, "stream", {}),
    (2, 32, 32, 96, 16, torch.float32, "cluster", {}),
    (2, 32, 32, 96, 16, torch.bfloat16, "stream", {}),
    (2, 32, 32, 192, 16, torch.bfloat16, "cluster", {}),
    (2, 32, 32, 192, 16, torch.float32, "stream", {}),
    (1, 32, 32, 2048, 16, torch.float32, "cluster", {}),
    (1, 32, 32, 2048, 16, torch.float32, "stream", {}),
    (1, 32, 32, 2048, 16, torch.bfloat16, "cluster", {}),
    (1, 32, 32, 2048, 16, torch.bfloat16, "stream", {}),
    (3, 33, 17, 48, 16, torch.float32, "cluster", {}),
    (3, 33, 17, 48, 16, torch.float32, "stream", {}),
    (1, 13, 11, 64, 16, torch.bfloat16, "cluster", {}),
    (1, 13, 11, 64, 16, torch.bfloat16, "stream", {}),
]


@pytest.mark.parametrize("B,H,W,C,G,dtype,route,constants", GN_ROUTE_CASES)
def test_group_norm_swish_routes(cuda, B, H, W, C, G, dtype, route, constants):
    how = _gn_route(cuda, B, H, W, C, G, dtype, route, constants=constants)
    # the edge each case is for
    if constants is K16:
        assert how.cluster == 16
    if constants is CLUSTERED:
        assert how.cluster == 8
    if constants is WIDE:
        assert how.smem > groupnorm.SMEM_MAX // 2


# batch 1 ... 8 on the cluster route (a cluster a slab and element)
@pytest.mark.parametrize("B", range(1, 9))
def test_group_norm_swish_cluster_route_at_each_batch(cuda, B):
    how = _gn_route(cuda, B, 32, 32, 512, 16, torch.bfloat16, "cluster", seed=B)
    assert how.blocks == B * how.chunks * how.cluster


# a CUDA-graph replay gives the eager launch's bits, on both routes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,C", [(64, 1536), (256, 64)])
def test_group_norm_swish_graph_replay_equals_eager(cuda, dtype, H, C):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(1, H, H, C, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    scale = torch.randn(C, device=cuda, generator=g)
    bias = torch.randn(C, device=cuda, generator=g)
    eager = fused_group_norm_swish(x, scale, bias, 16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_group_norm_swish(x, scale, bias, 16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fused_group_norm_swish(x, scale, bias, 16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


# stream-route calls on two streams at once give the bits each gives alone
# (the kernels keep no state between calls: each call's statistics live in
# its own scratch)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_swish_calls_on_two_streams_equal_one_by_one(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    xs = [(torch.randn(1, 256, 256, 64, device=cuda, generator=g) * 2 + k).to(dtype)
          for k in (0.5, -1.0)]
    scale = torch.randn(64, device=cuda, generator=g)
    bias = torch.randn(64, device=cuda, generator=g)
    assert groupnorm.plan(1, 256 * 256, 64, 16, groupnorm._ENTRY[dtype][1],
                          groupnorm._sm_count(cuda.index)).route == "stream"
    alone = [fused_group_norm_swish(x, scale, bias, 16) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(fused_group_norm_swish(xs[k], scale, bias, 16))
    torch.cuda.synchronize()
    for k in range(2):
        assert all(torch.equal(y, alone[k]) for y in outs[k])


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


def _replays_as_eager(fn, eager) -> None:
    """A CUDA-graph capture of fn (one call on the current stream), replayed
    three times, gives the eager call's bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


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
    _replays_as_eager(lambda: fused_attention(q, k, v, scale), got)


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


def _qkv_bf16(cuda, B, N, heads, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, N, heads, 3, D, device=cuda, generator=g).bfloat16()
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


# key splits forced so that the last split holds no key (N = 256: 4 key tiles,
# 3 splits of 2; N = 1024 at 5 splits of 4, two softmax groups each on the
# wide kernel, which carries O across them through its scratch; N = 300: 5
# tiles, 4 splits of 2; N = 200 with two heads, 3 splits of 2)
ATTN_BF16_EMPTY_SPLIT_CASES = [(1, 256, 1, 128, 3), (1, 1024, 1, 1024, 5), (2, 300, 1, 640, 4),
                               (1, 200, 2, 64, 3)]


@pytest.mark.parametrize("B,N,heads,D,splits", ATTN_BF16_EMPTY_SPLIT_CASES)
def test_attention_bf16_kernel_with_an_empty_split(cuda, B, N, heads, D, splits):
    from diffsplitting_tpu_torch.ops.attention import _launch, plan

    how = plan(B * heads, N, D, torch.cuda.get_device_properties(cuda).multi_processor_count,
               splits)
    assert (how.splits - 1) * how.tiles_per_split >= -(-N // 64)  # the last split: no key
    q, k, v = _qkv_bf16(cuda, B, N, heads, D, 5)
    scale = 8 / math.sqrt(D * heads)
    got = _launch(q, k, v, scale, splits)
    again = _launch(q, k, v, scale, splits)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    plain = attention_reference(q, k, v, scale)
    assert _err(got, ref) <= 2 * _err(plain, ref)


# N below one 64-query tile (and one 64-key tile) with B·heads > 1, in and
# out of clusters
@pytest.mark.parametrize("B,N,heads,D", [(3, 40, 2, 1024), (2, 17, 3, 128), (4, 1, 2, 512),
                                         (2, 63, 2, 64)])
def test_attention_bf16_kernel_below_one_tile(cuda, B, N, heads, D):
    q, k, v = _qkv_bf16(cuda, B, N, heads, D, 6)
    scale = 1 / math.sqrt(D * heads)
    got = fused_attention(q, k, v, scale)
    again = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    plain = attention_reference(q, k, v, scale)
    assert _err(got, ref) <= 2 * _err(plain, ref)


# a CUDA-graph replay gives the eager launch's bits: one split, the plan's
# splits with their combine launch, clusters of head-dim slices
@pytest.mark.parametrize("B,N,D", [(1, 1024, 1024), (2, 1024, 1024), (1, 1024, 512),
                                   (1, 1024, 128), (1, 100, 64)])
def test_attention_bf16_graph_replay_equals_eager(cuda, B, N, D):
    q, k, v = _qkv_bf16(cuda, B, N, 1, D, 7)
    scale = 1 / math.sqrt(D)
    _replays_as_eager(lambda: fused_attention(q, k, v, scale), fused_attention(q, k, v, scale))


@pytest.mark.parametrize("D", [12, 1032])
def test_attention_bf16_kernel_refuses_other_head_dims(cuda, D):
    q = torch.randn(1, 64, 1, D, device=cuda).bfloat16()
    before = FusedAttention.launches_bf16
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q, q, q, 0.1)
    assert FusedAttention.launches_bf16 == before


# the 11 sites of an sr_sr3_64_512 forward that the fused walk plans to the
# kernel, at batch 1: (B, H, W, Cin, Cout, prologue, residual, Cres, gain);
# then ragged widths (12, 20: a pixel 8-byte aligned, a K step part filled),
# ragged maps (13 x 20, 9 x 17), no prologue, batch 2 and 3, inputs x8; then
# the wgmma kernel's edges: an 11 x 7 map (the second warpgroup's m64 tile
# empty, the first's rows part filled), Cout 4, 8 and 12 (wgmma n8 and n16,
# y in 8-byte pieces at 4 and 12), Cin 20 at Cout 128 (a last chunk with 4
# valid channels), a projected residual of 44 channels (a residual stage
# zero-padded past its chunks), and the 512² upsample site at batch 2
CONV_GN_BF16_SITES = [
    (1, 512, 512, 64, 64, True, None, 0, 1), (1, 512, 512, 64, 64, True, "identity", 64, 1),
    (1, 512, 512, 128, 128, False, None, 0, 1), (1, 512, 512, 192, 64, True, None, 0, 1),
    (1, 512, 512, 64, 64, True, "projected", 192, 1), (1, 512, 512, 128, 64, True, None, 0, 1),
    (1, 512, 512, 64, 64, True, "projected", 128, 1), (1, 256, 256, 64, 128, True, None, 0, 1),
    (1, 256, 256, 128, 128, True, "projected", 64, 1), (1, 256, 256, 192, 128, True, None, 0, 1),
    (1, 256, 256, 128, 128, True, "projected", 192, 1),
]
CONV_GN_BF16_CASES = CONV_GN_BF16_SITES + [
    (1, 13, 20, 12, 12, True, "identity", 12, 1), (2, 9, 17, 12, 20, True, "projected", 20, 1),
    (2, 16, 16, 20, 16, True, "projected", 12, 1), (3, 13, 20, 96, 32, True, "projected", 96, 1),
    (2, 8, 16, 256, 128, True, None, 0, 1), (2, 16, 16, 128, 128, True, "projected", 256, 1),
    (1, 32, 32, 32, 32, False, None, 0, 1), (2, 16, 16, 96, 32, True, "projected", 96, 8),
    (1, 8, 16, 128, 128, False, "identity", 128, 8),
    (2, 11, 7, 64, 64, True, None, 0, 1), (1, 16, 16, 16, 4, True, None, 0, 1),
    (2, 9, 17, 20, 8, True, "identity", 8, 1), (2, 16, 24, 32, 12, True, "projected", 44, 1),
    (1, 10, 33, 20, 128, True, None, 0, 1), (2, 512, 512, 128, 128, False, None, 0, 1),
]


def _conv_gn_bf16_inputs(dev, B, H, W, Cin, Cout, act, res, Cres, gain=1, seed=0):
    """bf16 x and residual; f32 w, b, w_skip (the UNet's parameters), scale
    and shift."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    x = (rand(B, H, W, Cin) * gain).bfloat16()
    w = rand(3, 3, Cin, Cout) / math.sqrt(9 * Cin)
    b = rand(Cout) * 0.1
    scale = rand(B, Cin) * 0.2 + 1 if act else None
    shift = rand(B, Cin) * 0.5 if act else None
    r = (rand(B, H, W, Cres) * gain).bfloat16() if res else None
    ws = rand(Cres, Cout) / math.sqrt(Cres) if res == "projected" else None
    return x, w, b, scale, shift, r, ws


def _assert_conv_gn_bf16_close(got, want):
    (y, s, q), (y_ref, s_ref, q_ref) = got, want
    assert y.dtype == y_ref.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    yf, rf = y.float(), y_ref.float()
    tol = 2.0 ** -7 * rf.abs() + 1e-4 * rf.abs().max()
    assert ((yf - rf).abs() <= tol).all(), (yf - rf).abs().max().item()
    assert ((s - s_ref).abs() <= 1e-5 * rf.abs().sum(dim=(1, 2)) + 1e-4).all()
    assert ((q - q_ref).abs() <= 1e-5 * q_ref + 1e-4).all()


@pytest.mark.parametrize("B,H,W,Cin,Cout,act,res,Cres,gain", CONV_GN_BF16_CASES)
def test_conv_gn_bf16_kernel(cuda, B, H, W, Cin, Cout, act, res, Cres, gain):
    args = _conv_gn_bf16_inputs(cuda, B, H, W, Cin, Cout, act, res, Cres, gain)
    before = FusedConvGN.launches, FusedConvGN.launches_bf16
    got = conv_gn_fused(*args)
    again = conv_gn_fused(*args)
    torch.cuda.synchronize()
    assert (FusedConvGN.launches, FusedConvGN.launches_bf16) == (before[0], before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_conv_gn_bf16_close(got, conv_gn_reference(*args))


def test_conv_gn_bf16_kernel_takes_precast_weights_and_oihw_views(cuda):
    """bf16 copies of the weights and bias (DSP_PRECAST=1) give the bits the
    f32 parameters give; the HWIO view of an OIHW weight and a transposed 1x1
    weight are read in place."""
    x, _, b, scale, shift, r, _ = _conv_gn_bf16_inputs(cuda, 2, 16, 16, 48, 16, True,
                                                        "projected", 48)
    conv = torch.nn.Conv2d(48, 16, 3, padding=1).to(cuda)
    skip = torch.nn.Conv2d(48, 16, 1).to(cuda)
    w, ws = conv.weight.permute(2, 3, 1, 0), skip.weight[:, :, 0, 0].t()
    b = b.bfloat16().float()  # a bias that bf16 holds exactly
    with torch.no_grad():
        got = conv_gn_fused(x, w, b, scale, shift, r, ws)
        cast = conv_gn_fused(x, w.bfloat16(), b.bfloat16(), scale, shift, r, ws.bfloat16())
        want = conv_gn_reference(x, w.contiguous(), b, scale, shift, r, ws.contiguous())
    assert all(torch.equal(a, c) for a, c in zip(got, cast))
    _assert_conv_gn_bf16_close(got, want)


def test_conv_gn_bf16_kernel_takes_8_byte_aligned_inputs(cuda):
    """x and the residual 8 bytes past a 16-byte boundary (views into larger
    buffers) are copied in 8-byte pieces at widths that are multiples of 8,
    and give the bits of 16-byte aligned copies of the same values."""
    args = list(_conv_gn_bf16_inputs(cuda, 2, 16, 24, 32, 64, True, "projected", 48))
    shifted = list(args)
    for k in (0, 5):
        buf = torch.empty(args[k].numel() + 4, device=cuda, dtype=torch.bfloat16)
        shifted[k] = buf[4:].view_as(args[k])
        shifted[k].copy_(args[k])
        assert shifted[k].data_ptr() % 16 == 8 and args[k].data_ptr() % 16 == 0
    got = conv_gn_fused(*shifted)
    want = conv_gn_fused(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    _assert_conv_gn_bf16_close(got, conv_gn_reference(*args))


@pytest.mark.parametrize("what", ["float16", "f32_residual", "bf16_scale", "width"])
def test_conv_gn_bf16_kernel_refuses(cuda, what):
    x, w, b, scale, shift, r, _ = _conv_gn_bf16_inputs(cuda, 1, 8, 8, 16, 16, True,
                                                        "identity", 16)
    if what == "float16":
        x = x.half()
    elif what == "f32_residual":
        r = r.float()
    elif what == "bf16_scale":
        scale = scale.bfloat16()
    else:
        x, w = x[..., :14].contiguous(), w[:, :, :14]
    before = FusedConvGN.launches_bf16
    with pytest.raises((TypeError, ValueError)):
        conv_gn_fused(x, w, b, scale, shift, r)
    assert FusedConvGN.launches_bf16 == before


def test_fused_unet_forward_bf16_on_the_card(cuda):
    """A bf16 noise-level UNet (inner 64, 16 groups, affine FiLM, attention at
    16²): the fused walk through the bf16 kernels against the same walk
    through the plain versions, and against the unfused bf16 forward."""
    net = UNet(in_channel=6, out_channel=3, inner_channel=64, norm_groups=16,
               channel_mults=(1, 2, 4), attn_res=(16,), res_blocks=1, image_size=64,
               cond_type="noise_level", use_affine_level=True, dtype=torch.bfloat16)
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero biases, the FiLM's and res_conv's included
        for p in net.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    net = net.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 64, 64, 6, device=cuda, generator=g)
    level = torch.rand(2, device=cuda, generator=g)
    before = FusedConvGN.launches, FusedConvGN.launches_bf16
    with torch.no_grad():
        got = fused_unet_forward(net, x, level)
        launched = FusedConvGN.launches - before[0], FusedConvGN.launches_bf16 - before[1]
        unfused = net(x, level)
    assert launched[0] == 0 and launched[1] > 0
    assert got.dtype == torch.float32 and got.shape == unfused.shape == (2, 64, 64, 3)
    assert torch.isfinite(got).all()
    m = unfused.abs().max().item()
    # bf16 rounds at other places in the two walks (TOL_FUSED_BF16 of
    # tests/test_torch_port_fused_bf16.py)
    assert (got - unfused).abs().max().item() <= 3e-2 * m
