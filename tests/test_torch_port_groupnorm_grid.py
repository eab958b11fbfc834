"""The GroupNorm+Swish kernel's grid, chosen in plain Python.

csrc/groupnorm_swish.cu runs only on the card; the kernel itself is held
against the plain version in tests/test_torch_port_kernels.py (marked `gpu`)
and in chip_smoke.py. Its grid is chosen here, in `ops.groupnorm._chunking`:
each batch element's H*W rows are cut into chunks, one block each, so that
the B * chunks blocks make one wave of the blocks the card keeps resident.
"""

import pytest

from diffsplitting_tpu_torch.ops import groupnorm

H100_SMS = 132


# the unfused forward's (C, H) at batch 8 on 512² patches, a 4 x 4 map,
# ragged maps, and another SM count
@pytest.mark.parametrize("sms", [H100_SMS, 78])
@pytest.mark.parametrize("B,H,W,C", [(8, 512, 512, 48), (8, 512, 512, 16), (8, 256, 256, 96),
                                     (8, 128, 128, 192), (8, 64, 64, 128), (8, 64, 64, 256),
                                     (8, 4, 4, 256), (3, 33, 17, 48), (1, 7, 7, 1024),
                                     (600, 8, 8, 16)])
def test_chunking_covers_every_row_once_in_one_wave(sms, B, H, W, C):
    hw = H * W
    chunks, rows = groupnorm._chunking(B, hw, C, sms)
    assert (chunks - 1) * rows < hw <= chunks * rows  # every row once, no empty chunk
    # one wave of the resident blocks, unless B alone exceeds it
    assert B * chunks <= max(B, sms * groupnorm._BLOCKS_PER_SM)
    # no chunk shorter than one unrolled step of its block, unless one chunk
    step = max(1, groupnorm._THREADS // (C // 4)) * groupnorm._UNROLL
    assert chunks == 1 or rows >= step
    if hw >= step * sms * groupnorm._BLOCKS_PER_SM:
        assert B * chunks > sms * groupnorm._BLOCKS_PER_SM // 2  # the big maps fill the card
