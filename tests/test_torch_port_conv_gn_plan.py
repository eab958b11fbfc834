"""The f32 conv_gn kernel's plan, in plain Python: its tiles, its shared
memory and its scratch at every conv site the fused walk gives it.

ops/conv_gn.py mirrors csrc/conv_gn.cu's launch lines (`_PLAN`): the block
geometry (`conv_gn_tiling`), the dynamic shared memory of a block
(`conv_gn_smem_bytes`, the kernel's `Smem`), the partial statistics a batch
element (`conv_gn_partial_rows`, a row a tile and consumer warpgroup) and the
split weights the producer streams (`conv_gn_split_floats`). Held here at
the sites of one fused forward (found on the meta device) of
configs/splitting_hagen_indi_joint.json at batch 8 on 512² patches (31
sites), configs/splitting_cifar10_indi.json at inner 32 and batch 8 (18 of
its 31 sites on the kernel) and configs/sr_sr3_16_128.json at batch 1 (19
sites).
"""

import re
from pathlib import Path

import pytest

from diffsplitting_tpu_torch.kernels.conv_gn_variants import meta_sites
from diffsplitting_tpu_torch.ops import conv_gn
from diffsplitting_tpu_torch.ops.conv_gn import (
    SMEM_LIMIT,
    conv_gn_partial_rows,
    conv_gn_smem_bytes,
    conv_gn_split_floats,
    conv_gn_tiling,
)

SOURCE = Path(__file__).resolve().parents[1] / "diffsplitting_tpu_torch" / "csrc" / "conv_gn.cu"
SITE_SETS = {
    "hagen": (("configs/splitting_hagen_indi_joint.json", 8, 512, "time"), {}, 31),
    "cifar_inner32": (("configs/splitting_cifar10_indi.json", 8, 32, "time"),
                      {"inner_channel": 32}, 18),
    "sr3": (("configs/sr_sr3_16_128.json", 1, 128, "noise_level"), {}, 19),
}


@pytest.fixture(scope="module", params=sorted(SITE_SETS))
def sites(request):
    args, unet, calls = SITE_SETS[request.param]
    found = meta_sites(*args, **unet)
    assert sum(found.values()) == calls
    return found


def test_plan_mirrors_the_kernels_launch_lines():
    """`_PLAN` holds, for each block width, the MT, NWG, TPS and NS of the
    kernel's `launch<BN, MT, NWG, TPS, NS, NB, TG>` lines."""
    lines = re.findall(r"launch<(\d+), (\d+), (\d+), (\d+), (\d+), \d+, \d+>\(p",
                       SOURCE.read_text())
    assert {int(bn): tuple(map(int, rest)) for bn, *rest in lines} == conv_gn._PLAN


def test_the_grid_covers_every_site(sites):
    """Each site's tiles cover its map and none lies wholly outside it; a
    tile is 16 pixels wide and as many rows as its warpgroups hold."""
    for (H, W, Cin, Cout, *_), _ in sites.items():
        tr, tw, tiles = conv_gn_tiling(H, W, Cout)
        rows, cols = -(-H // tr), -(-W // tw)
        assert tiles == rows * cols and tw == 16
        assert rows * tr >= H > (rows - 1) * tr and cols * tw >= W > (cols - 1) * tw


def test_shared_memory_fits_a_block_at_every_site(sites):
    for (H, W, Cin, Cout, *_), _ in sites.items():
        assert conv_gn_smem_bytes(Cout) <= SMEM_LIMIT


def test_scratch_is_sized_at_every_site(sites):
    """The split weights: two planes of (9 ceil(Cin / 16) + ceil(Cres / 16))
    K steps of BN x 16 floats, what the producer streams (BN * 128 bytes a K
    step); the partial statistics: a row a tile and consumer warpgroup."""
    for (H, W, Cin, Cout, act, res, Cres), _ in sites.items():
        bn = next(b for b in sorted(conv_gn._PLAN) if b >= Cout)
        mt, nwg, tps, ns = conv_gn._PLAN[bn]
        skip = Cres if res == "projected" else 0
        steps = 9 * -(-Cin // 16) + -(-skip // 16)
        assert conv_gn_split_floats(Cin, Cout, skip) * 4 == steps * bn * 128
        assert conv_gn_partial_rows(H, W, Cout) == nwg * conv_gn_tiling(H, W, Cout)[2]
        assert conv_gn_partial_rows(H, W, Cout, bf16=True) == conv_gn_tiling(H, W, Cout, True)[2]
