"""The GroupNorm+Swish kernel's routes and grids, chosen in plain Python.

csrc/groupnorm_swish.cu runs only on the card; the kernel itself is held
against the plain version in tests/test_torch_port_kernels*.py (marked `gpu`)
and in chip_smoke.py. Its launch is chosen here, in `ops.groupnorm.plan`:
the cluster route (clusters of blocks over slabs of whole groups, each block
holding its rows in shared memory) or the stream route (chunks of rows, one
block each, in one wave, their partials folded by every normalize block).
"""

import pytest

from diffsplitting_tpu_torch.kernels.groupnorm_variants import plan_with
from diffsplitting_tpu_torch.ops import groupnorm

H100_SMS = 132

# (B, H, W, C, G) of every GroupNorm+Swish call of one unfused forward of the
# three configs the port serves (configs/splitting_hagen_indi_joint.json at
# batch 8 on 512² patches, sr_sr3_16_128 and sr_sr3_64_512 at batch 1), as
# `kernels.groupnorm_variants.set_shapes` finds them
HAGEN = [(8, h, h, c, 16) for c, h in [(16, 256), (16, 512), (32, 128), (32, 256), (32, 512),
                                       (48, 256), (48, 512), (64, 64), (64, 128), (96, 128),
                                       (96, 256), (128, 64), (192, 64), (192, 128), (256, 64)]]
SR3_16_128 = [(1, h, h, c, 32) for c, h in [(64, 64), (64, 128), (128, 32), (128, 64), (128, 128),
                                            (192, 64), (192, 128), (256, 16), (256, 32),
                                            (256, 64), (384, 32), (384, 64), (512, 8), (512, 16),
                                            (512, 32), (768, 16), (768, 32), (1024, 8),
                                            (1024, 16)]]
SR3_64_512 = [(1, h, h, c, 16) for c, h in [(64, 256), (64, 512), (128, 128), (128, 256),
                                            (128, 512), (192, 256), (192, 512), (256, 64),
                                            (256, 128), (384, 128), (384, 256), (512, 32),
                                            (512, 64), (768, 64), (768, 128), (1024, 32),
                                            (1536, 32), (1536, 64), (2048, 32)]]
# ragged and tiny maps, a batch past the SM count, C = 2048 in f32
OTHER = [(8, 4, 4, 128, 16), (8, 4, 4, 256, 16), (3, 33, 17, 48, 16), (1, 7, 7, 1024, 32),
         (600, 8, 8, 16, 16), (1, 7, 7, 8, 4), (5, 13, 20, 48, 16), (2, 32, 32, 2048, 16)]
SHAPES = HAGEN + SR3_16_128 + SR3_64_512 + OTHER


def _per_vector(C, bf16):
    return 8 if bf16 or C > 1024 else 4


def _check(p, B, hw, C, G, per_vector, sms, max_cluster=groupnorm.PLAN_CLUSTER):
    esize = 16 // per_vector
    if p.route == "stream":
        assert p.slab == 0 and p.chunks % p.cluster == 0
        assert 1 <= p.cluster <= groupnorm.STREAM_CLUSTER
        # every row once; empty chunks only to round up to whole clusters
        assert (p.chunks - p.cluster) * p.rows < hw <= p.chunks * p.rows
        # one wave of the resident blocks, unless B alone exceeds it
        assert B * p.chunks <= max(B * p.cluster, sms * groupnorm._BLOCKS_PER_SM)
        assert p.blocks == B * p.chunks
        assert p.scratch == B * (p.chunks // p.cluster) * 2 * C  # a partial a cluster
        # no chunk shorter than one unrolled step of its block, unless one
        step = max(1, groupnorm._THREADS // groupnorm._threads_a_row(C, per_vector))
        step *= groupnorm._UNROLL[per_vector]
        assert p.chunks == 1 or p.rows >= step
        if hw >= step * sms * groupnorm._BLOCKS_PER_SM:
            assert p.blocks > sms * groupnorm._BLOCKS_PER_SM // 2  # big maps fill the card
    else:
        cs = C // G
        # slabs of whole groups, a multiple of 16 bytes, at least 32 or the row
        assert p.slab % cs == 0 and C % p.slab == 0 and p.chunks == C // p.slab
        assert (p.slab * esize) % 16 == 0 and p.slab * esize >= min(32, C * esize)
        # every row once, every block with rows
        assert 1 <= p.cluster <= max_cluster and p.cluster & (p.cluster - 1) == 0
        assert (p.cluster - 1) * p.rows < hw <= p.cluster * p.rows
        # threads and shared memory within the card's
        threads, smem = groupnorm.cluster_block(p.slab, p.rows, per_vector)
        assert (p.threads, p.smem) == (threads, smem)
        assert 1 <= p.threads <= 512 and p.threads % (p.slab // per_vector) == 0
        assert p.rows * p.slab * esize < p.smem <= groupnorm.SMEM_MAX
        assert p.blocks == B * p.chunks * p.cluster and p.scratch == 0


@pytest.mark.parametrize("sms", [H100_SMS, 78])
@pytest.mark.parametrize("B,H,W,C,G", SHAPES)
def test_plan_covers_every_row_once_within_the_card(sms, B, H, W, C, G):
    for bf16 in (False, True):
        pv = _per_vector(C, bf16)
        _check(groupnorm.plan(B, H * W, C, G, pv, sms), B, H * W, C, G, pv, sms)
        for fold_alone in (0, groupnorm._FOLD_ALONE):
            _check(plan_with({"_FOLD_ALONE": fold_alone}, B, H * W, C, G, pv, sms,
                             route="stream"), B, H * W, C, G, pv, sms)
        for k in (4, 16):
            p = plan_with({"PLAN_CLUSTER": k}, B, H * W, C, G, pv, sms)
            _check(p, B, H * W, C, G, pv, sms, max_cluster=k)


@pytest.mark.parametrize("B,H,W,C,G", SR3_64_512 + SR3_16_128)
def test_forced_cluster_route_or_refusal(B, H, W, C, G):
    """route="cluster" gives a valid cluster launch, or raises where no slab
    of whole groups fits the cluster's shared memory."""
    for bf16 in (False, True):
        pv = _per_vector(C, bf16)
        try:
            p = groupnorm.plan(B, H * W, C, G, pv, H100_SMS, route="cluster")
        except ValueError:
            # the smallest slab of 32 bytes does not fit 8 blocks
            cs = C // G
            gs = next(d for d in range(1, G + 1) if G % d == 0 and (d * cs * 16 // pv) % 16 == 0
                      and d * cs * 16 // pv >= 32)
            assert H * W * gs * cs * (16 // pv) > 8 * groupnorm.SMEM_MAX
            continue
        assert p.route == "cluster"
        _check(p, B, H * W, C, G, pv, H100_SMS)


def test_plan_routes_at_sr_sr3_64_512():
    """bf16 at batch 1: the 512² maps and the 256² maps past one cluster stay
    on the stream route; every map of 64² and below and the wide-C 128²
    maps are held on chip in clusters."""
    routes = {(H, C): groupnorm.plan(B, H * W, C, G, 8, H100_SMS).route
              for B, H, W, C, G in SR3_64_512}
    assert all(routes[(512, c)] == "stream" for c in (64, 128, 192))
    assert all(r == "cluster" for (h, c), r in routes.items() if h <= 64)
    assert routes[(128, 768)] == routes[(128, 384)] == "cluster"


def test_blocks_alone_on_their_sms_give_way_to_the_stream_route_on_narrow_rows():
    """Hagen's (128², 32) f32 at batch 8 (a cluster block of 148 KB alone on
    each SM, rows of 128 bytes) takes the stream route; sr_sr3_64_512's
    (128², 768) and (64², 1536) bf16 (blocks as alone, rows of 1.5 and 3 KB)
    stay on the cluster route, as they do with the rule off."""
    hagen = dict(B=8, hw=128 * 128, C=32, G=16, per_vector=4, sms=H100_SMS)
    assert groupnorm.plan(*hagen.values()).route == "stream"
    alone = plan_with({"_STREAM_ROW_BYTES": 0}, *hagen.values())
    assert alone.route == "cluster" and alone.blocks <= H100_SMS
    assert 2 * alone.smem > groupnorm.SMEM_MAX
    for hw, C in ((128 * 128, 768), (64 * 64, 1536)):
        p = groupnorm.plan(1, hw, C, 16, 8, H100_SMS)
        assert p.route == "cluster" and p.blocks <= H100_SMS and 2 * p.smem > groupnorm.SMEM_MAX
        assert p == plan_with({"_STREAM_ROW_BYTES": 0}, 1, hw, C, 16, 8, H100_SMS)


def test_plan_with_restores_the_planners_constants():
    before = (groupnorm.PLAN_CLUSTER, groupnorm._FOLD_ALONE)
    plan_with({"PLAN_CLUSTER": 16, "_FOLD_ALONE": 0}, 1, 64 * 64, 512, 16, 8, H100_SMS)
    assert (groupnorm.PLAN_CLUSTER, groupnorm._FOLD_ALONE) == before
    with pytest.raises(AttributeError):
        plan_with({"NO_SUCH_CONSTANT": 1}, 1, 64 * 64, 512, 16, 8, H100_SMS)


def test_stream_route_clusters_its_chunks_only_where_an_element_has_many():
    """Hagen's maps at batch 8 (66 chunks an element) fold each chunk's
    partial; sr_sr3_64_512's 256² and 512² maps at batch 1 (512 or 528)
    add them in clusters of 8 first."""
    for B, H, W, C, G in HAGEN:
        p = groupnorm.plan(B, H * W, C, G, 4, H100_SMS, route="stream")
        assert p.chunks <= groupnorm._FOLD_ALONE and p.cluster == 1
    for B, H, W, C, G in SR3_64_512:
        p = groupnorm.plan(B, H * W, C, G, 8, H100_SMS, route="stream")
        many = p.chunks > groupnorm._FOLD_ALONE
        assert p.cluster == (groupnorm.STREAM_CLUSTER if many else 1)
        assert many or H < 256


def test_plan_refuses_an_unknown_route():
    with pytest.raises(ValueError):
        groupnorm.plan(1, 64, 64, 16, 4, H100_SMS, route="fused")
