"""Spatial self-attention over (B, N, heads, D) tokens.

Counterpart: diffsplitting_tpu/ops/attention.py (`attention_reference`,
`fused_attention` with its custom VJP; the Pallas `_kernel`).

`fused_attention` launches a CUDA kernel for CUDA tensors, picked by the
dtype and then by the head dim D (`head_dim_route`). float32, on the tensor
cores at f32 accuracy (3xTF32) through tf32 `wgmma` fed by TMA: up to D = 128
one kernel in csrc/attention.cu, a template over the head dim padded to a
multiple of 32 (its D = 128 instance 128 queries a block with its keys split
across blocks by `d128_plan`; below 128 the narrow route, 64 or 128 queries
a block and 16-, 32- or 64-key tiles by N, its keys split by `narrow_plan`), and
in csrc/attention_wide.cu the wide kernel at any multiple of 4 above 128 up
to 1024 (64 queries a block, its keys split across blocks and O's head dims
sliced across them by `wide_plan`); the splits combined by a second launch
in split order. bfloat16 (the UNet at `compute_dtype: bfloat16`),
csrc/attention_bf16.cu: bf16 `wgmma` kernels at any multiple of 8 up to
1024 (f32 scores and softmax, P rounded to bf16, f32 sums, a bf16 result),
64 queries a block; up to D = 256 a block holds its queries' O, above it
(the wide kernel) a block sums S over all of D itself and takes O in
256-wide chunks one after another. The keys are split across blocks: `plan`
chooses the split count in plain Python, and a split count above 1 adds a
second launch that combines the splits' f32 partials (scratch allocated
here) in split order. It raises on any other D or dtype. CPU tensors run
the plain version. Backward runs autograd through the plain version, as the
JAX custom VJP does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.build import check, library
from .groupnorm import _sm_count

D128_HEAD_DIM = 128  # attention_f32_kernel's D = 128 instance; the narrow route below it
MAX_HEAD_DIM = 1024  # attention_wide_kernel: from 132 up to this


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


# the bf16 kernels' tiling (csrc/attention_bf16.cu)
BF16_ROWS = 64  # queries a block
BF16_TILE_KEYS = 64  # keys a tile
BF16_PANEL = 64  # head dims a panel
BF16_MAX_PANELS = 4  # panels of O a block holds: above, the wide kernel
BF16_WIDE_GROUP = 2  # key tiles the wide kernel takes a softmax over at once


class AttnPlan(NamedTuple):
    """A bf16 attention launch: `splits` key splits of `tiles_per_split` key
    tiles each (the last may hold fewer, or none), over a grid of
    `query_tiles` x splits x B·heads blocks, on the wide kernel (D > 256) or
    not."""

    splits: int
    tiles_per_split: int
    query_tiles: int
    wide: bool

    @property
    def blocks(self) -> int:
        return self.query_tiles * self.splits


# The wide kernel stores O's chunks to the scratch and reloads them for each
# group of two key tiles after a split's first, so its plan takes one group a
# split (128 keys) where the grid then stays within _WIDE_WAVES blocks an SM
# (the mid block of sr_sr3_64_512: 16 query tiles x 8 splits)
_WIDE_WAVES = 4


def plan(BH: int, N: int, D: int, sms: int, splits: int = None) -> AttnPlan:
    """The bf16 kernels' launch for B·heads = BH, N tokens, head dim D on a
    card of `sms` SMs, each split a whole number of key tiles and none
    empty: up to D = 256, as many key splits as keep the grid within one
    block an SM (at most one a key tile); above, one group of two key tiles a
    split within _WIDE_WAVES blocks an SM, else fewer, longer splits.
    `splits` forces a count (a split may then hold no key)."""
    wide = -(-D // BF16_PANEL) > BF16_MAX_PANELS
    query_tiles = -(-N // BF16_ROWS)
    tiles = -(-N // BF16_TILE_KEYS)
    if splits is None:
        if wide:
            room = _WIDE_WAVES * sms // (query_tiles * BH)
            splits = max(1, min(-(-tiles // BF16_WIDE_GROUP), room))
        else:
            splits = max(1, min(tiles, sms // (query_tiles * BH)))
        splits = -(-tiles // -(-tiles // splits))  # no split left empty
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} key splits of {tiles} key tiles")
    return AttnPlan(splits, -(-tiles // splits), query_tiles, wide)


def _launch_bf16(q, k, v, out, scale: float, splits: int = None, entry=None):
    """csrc/attention_bf16.cu on (B, N, heads, D) bf16 views into `out`:
    `splits` forces the plan's split count; `entry` is another library's
    `attention_bf16` (the variants)."""
    B, N, H, D = q.shape
    how = plan(B * H, N, D, _sm_count(q.device.index), splits)
    f32 = dict(device=q.device, dtype=torch.float32)
    # the splits' partials: O (the wide kernel's also for a split of more
    # than one group of key tiles), then each row's m and l
    several = how.splits > 1
    opart = ml = None
    if several or (how.wide and how.tiles_per_split > BF16_WIDE_GROUP):
        opart = torch.empty(how.splits * B * H * N * D, **f32)
    if several:
        ml = torch.empty(how.splits * B * H * N * 2, **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = entry if entry is not None else library().attention_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in (opart, ml)),
             B, N, H, D, *q.stride()[:3], float(scale), how.splits, stream)
    check(err, "attention_bf16")
    return out


# the f32 wide kernel's tiling (csrc/attention_wide.cu)
WIDE_ROWS = 64  # queries a block
WIDE_CHUNK = 64  # head dims a chunk of O
WIDE_MAX_CHUNKS = 8  # chunks of O a block holds in shared memory
WIDE_KEY_TILES = (16, 32, 64)  # keys a tile
# 64-key tiles where one 64-key tile a split, with the fewest slices, gives at
# least a quarter of the SMs blocks; else 32-key tiles, whose more, shorter
# splits fill the card better (16 up to N = 16). By attention_variants --wide
# on the H100: N = 256 at B·heads 1 32-key tiles (0.0147 ms against 0.0168),
# at 4 and 8 64-key tiles (0.0226 against 0.0249, 0.0316 against 0.0371); N =
# 100 at 8, 32 (0.0113 against 0.0125); N = 64, 32
_WIDE_LONG_SHARE = 4


class WidePlan(NamedTuple):
    """A wide f32 attention launch: keys in tiles of `key_tile`, `splits`
    key splits of `tiles_per_split` tiles (the last may hold fewer, or
    none), O's head dims in `slices` slices of `chunks_per_slice` 64-wide
    chunks, over a grid of slices x `query_tiles` x B·heads·splits blocks."""

    key_tile: int
    splits: int
    tiles_per_split: int
    slices: int
    chunks_per_slice: int
    query_tiles: int

    @property
    def blocks(self) -> int:
        """Blocks a (batch, head)."""
        return self.query_tiles * self.splits * self.slices


@functools.lru_cache(maxsize=256)
def wide_plan(BH: int, N: int, D: int, sms: int, splits: int = None, slices: int = None,
              key_tile: int = None) -> WidePlan:
    """The wide f32 kernel's launch for B·heads = BH, N tokens, head dim D
    on a card of `sms` SMs (memoised). 16-key tiles up to N = 16; above, 64
    where the 64-key splits alone give a quarter of the SMs blocks, else 32.
    The fewest slices that hold O (8 chunks of 64 head dims a block), then
    as many key splits as keep the grid within one block an SM (at most one
    a key tile, none empty), then more slices, each recomputing S over all of
    D, while the grid stays within one block an SM (at most one a chunk,
    none empty). `splits`, `slices` and `key_tile` force those."""
    query_tiles = -(-N // WIDE_ROWS)
    chunks = -(-D // WIDE_CHUNK)
    least = -(-chunks // WIDE_MAX_CHUNKS)
    base = query_tiles * BH
    if key_tile is None:
        long_splits = -(-N // WIDE_KEY_TILES[2])
        key_tile = (WIDE_KEY_TILES[0] if N <= WIDE_KEY_TILES[0] else
                    WIDE_KEY_TILES[2] if base * long_splits * least >= sms // _WIDE_LONG_SHARE
                    else WIDE_KEY_TILES[1])
    if key_tile not in WIDE_KEY_TILES:
        raise ValueError(f"the wide attention kernel takes key tiles of {WIDE_KEY_TILES}, "
                         f"got {key_tile}")
    tiles = -(-N // key_tile)
    if splits is None:
        splits = max(1, min(tiles, sms // (base * least)))
        splits = -(-tiles // -(-tiles // splits))  # no split left empty
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} key splits of {tiles} key tiles")
    if slices is None:
        slices = max(least, min(chunks, sms // (base * splits)))
    if not least <= slices <= chunks:
        raise ValueError(f"{slices} slices of {chunks} head-dim chunks")
    per_slice = -(-chunks // slices)
    return WidePlan(key_tile, splits, -(-tiles // splits), -(-chunks // per_slice), per_slice,
                    query_tiles)


def _launch_wide(q, k, v, out, scale: float, splits: int = None, slices: int = None,
                 key_tile: int = None, entry=None):
    """csrc/attention_wide.cu on (B, N, heads, D) f32 views into `out`:
    `splits`, `slices` and `key_tile` force the plan's; `entry` is another
    library's `attention_f32_wide` (the variants)."""
    B, N, H, D = q.shape
    how = wide_plan(B * H, N, D, _sm_count(q.device.index), splits, slices, key_tile)
    opart = ml = 0
    if how.splits > 1:  # the splits' unnormalised O, then each row's m and l
        rows = how.splits * B * H * N
        scratch = torch.empty(rows * (D + 2), device=q.device, dtype=torch.float32)
        opart = scratch.data_ptr()
        ml = opart + rows * D * 4
    fn = entry if entry is not None else library().attention_f32_wide
    # the current stream's handle (torch.cuda.current_stream(...).cuda_stream
    # builds a Stream object: 5 us of host time a call on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), opart, ml, B, N, H, D,
             *q.stride()[:3], float(scale), how.key_tile, how.splits, how.slices, stream)
    check(err, "attention_f32_wide")
    return out


# the f32 kernel's tiling at D = 128 (csrc/attention.cu, attention_f32_kernel<128, 64, 2>)
D128_ROWS = 128  # queries a block: two consumer warpgroups of 64
D128_KEY_TILE = 64  # keys a tile


class D128Plan(NamedTuple):
    """An f32 D = 128 attention launch: `splits` key splits of
    `tiles_per_split` 64-key tiles (the last may hold fewer, or none), over
    a grid of `query_tiles` (of 128 queries) x B·heads·splits blocks, one an
    SM."""

    splits: int
    tiles_per_split: int
    query_tiles: int

    @property
    def blocks(self) -> int:
        """Blocks a (batch, head)."""
        return self.query_tiles * self.splits


@functools.lru_cache(maxsize=256)
def d128_plan(BH: int, N: int, sms: int, splits: int = None) -> D128Plan:
    """The f32 D = 128 kernel's launch for B·heads = BH, N tokens on a card
    of `sms` SMs (memoised): as many key splits as keep the grid within one
    block an SM (at most one a key tile, none empty). `splits` forces the
    count."""
    query_tiles = -(-N // D128_ROWS)
    tiles = -(-N // D128_KEY_TILE)
    if splits is None:
        splits = max(1, min(tiles, sms // (query_tiles * BH)))
        splits = -(-tiles // -(-tiles // splits))  # no split left empty
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} key splits of {tiles} key tiles")
    return D128Plan(splits, -(-tiles // splits), query_tiles)


def _launch_d128(q, k, v, out, scale: float, splits: int = None, entry=None) -> D128Plan:
    """attention_f32_kernel (csrc/attention.cu) at D = 128 on (B, N, heads, 128)
    f32 views into `out`: `splits` forces the plan's key-split count;
    `entry` is another library's `attention_f32_d128` (the variants).
    Returns the plan it launched."""
    B, N, H, _ = q.shape
    how = d128_plan(B * H, N, _sm_count(q.device.index), splits)
    opart = ml = 0
    if how.splits > 1:  # the splits' unnormalised O, then each row's m and l
        n = how.splits * B * H * N
        scratch = torch.empty(n * (D128_HEAD_DIM + 2), device=q.device, dtype=torch.float32)
        opart = scratch.data_ptr()
        ml = opart + n * D128_HEAD_DIM * 4
    fn = entry if entry is not None else library().attention_f32_d128
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), opart, ml, B, N, H,
             *q.stride()[:3], float(scale), how.splits, stream)
    check(err, "attention_f32_d128")
    return how


# the f32 kernel below D = 128 (csrc/attention.cu, attention_f32_kernel<DP,
# TK, NG> at DP < 128 or D in (96, 128)): the (key tile, consumer warpgroups)
# pairs it is built at, as its launch_tiling lists them
NARROW_TILINGS = ((16, 1), (32, 1), (64, 1), (64, 2))
NARROW_ROWS = 64  # queries a consumer warpgroup
_NARROW_SHORT = 128  # N up to which the plan takes 32-key tiles and one warpgroup


class NarrowPlan(NamedTuple):
    """An f32 attention launch below D = 128: keys in tiles of `key_tile`,
    `groups` consumer warpgroups of 64 queries a block, `splits` key splits
    of `tiles_per_split` tiles (the last may hold fewer, or none), over a
    grid of `query_tiles` x B·heads·splits blocks."""

    key_tile: int
    groups: int
    splits: int
    tiles_per_split: int
    query_tiles: int

    @property
    def blocks(self) -> int:
        """Blocks a (batch, head)."""
        return self.query_tiles * self.splits


@functools.lru_cache(maxsize=256)
def narrow_plan(BH: int, N: int, sms: int, splits: int = None, key_tile: int = None,
                groups: int = None) -> NarrowPlan:
    """The f32 kernel's launch below D = 128 for B·heads = BH, N tokens on a
    card of `sms` SMs (memoised): up to N = 16 one 16-key tile and one
    consumer warpgroup (a 64-key tile would be three quarters zeros, a
    second warpgroup would hold no query); up to N = 128 32-key tiles and
    one warpgroup (twice the blocks of 128-query ones); above, 64-key tiles
    and two warpgroups. Then as many key splits as keep the grid within one
    block an SM (at most one a key tile, none empty). By attention_variants
    --narrow on the H100 at B = 8: N = 100 at (32, 1) 0.0054 ms (D = 16)
    and 0.0062 (D = 64) against 0.0067 and 0.0086 at (64, 2); N = 1024 at
    (64, 2) 0.0298 (D = 64) against 0.0340 at (64, 1). `splits`, `key_tile`
    and `groups` force those (the library is built at NARROW_TILINGS; its
    entry refuses other pairs, which variants of it build)."""
    if groups is None:
        groups = 1 if N <= _NARROW_SHORT else 2
    if key_tile is None:
        key_tile = 16 if N <= 16 else 32 if N <= _NARROW_SHORT else 64
    if key_tile not in (16, 32, 64) or groups not in (1, 2, 3):
        raise ValueError(f"the f32 attention kernel below D = 128 takes key tiles of 16, 32 or "
                         f"64 and 1 to 3 warpgroups, got {(key_tile, groups)}")
    query_tiles = -(-N // (NARROW_ROWS * groups))
    tiles = -(-N // key_tile)
    if splits is None:
        splits = max(1, min(tiles, sms // (query_tiles * BH)))
        splits = -(-tiles // -(-tiles // splits))  # no split left empty
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} key splits of {tiles} key tiles")
    return NarrowPlan(key_tile, groups, splits, -(-tiles // splits), query_tiles)


def _launch_narrow(q, k, v, out, scale: float, splits: int = None, key_tile: int = None,
                   groups: int = None, entry=None) -> NarrowPlan:
    """attention_f32_kernel (csrc/attention.cu) below D = 128 on (B, N,
    heads, D) f32 views into `out`: `splits`, `key_tile` and `groups` force
    the plan's; `entry` is another library's `attention_f32_narrow` (the
    variants). Returns the plan it launched."""
    B, N, H, D = q.shape
    how = narrow_plan(B * H, N, _sm_count(q.device.index), splits, key_tile, groups)
    opart = ml = 0
    if how.splits > 1:  # the splits' unnormalised O, then each row's m and l
        n = how.splits * B * H * N
        scratch = torch.empty(n * (D + 2), device=q.device, dtype=torch.float32)
        opart = scratch.data_ptr()
        ml = opart + n * D * 4
    fn = entry if entry is not None else library().attention_f32_narrow
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), opart, ml, B, N, H, D,
             *q.stride()[:3], float(scale), how.key_tile, how.groups, how.splits, stream)
    check(err, "attention_f32_narrow")
    return how


def _launch(q, k, v, scale: float, splits: int = None):
    """Run csrc/attention.cu, csrc/attention_wide.cu or
    csrc/attention_bf16.cu on CUDA tensors; raises on what they do not take.
    `splits` forces the key split count of the kernel D and the dtype route
    to (tests)."""
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
    # both divisors are powers of two: one test on the or of the values
    if ((strides[0] | strides[1] | strides[2]) % (16 // q.element_size())
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        raise ValueError("attention kernel needs 16-byte aligned rows")
    out = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype)
    if route == "bf16":
        _launch_bf16(q, k, v, out, scale, splits)
        FusedAttention.launches_bf16 += 1
        return out
    if route == "wide":
        _launch_wide(q, k, v, out, scale, splits)
        FusedAttention.launches_wide += 1
        return out
    if route == "d128":
        FusedAttention.last_d128_plan = _launch_d128(q, k, v, out, scale, splits)
        FusedAttention.launches += 1
        return out
    _launch_narrow(q, k, v, out, scale, splits)
    FusedAttention.launches_narrow += 1
    return out


class FusedAttention(torch.autograd.Function):
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Backward: autograd through the plain version."""

    launches = 0  # D = 128 kernel launches (with its combine), counted by _launch
    last_d128_plan = None  # the D = 128 kernel's plan at its last launch, set by _launch
    launches_wide = 0  # wide kernel launches (D above 128, with its combine), by _launch
    launches_narrow = 0  # launches below D = 128 (with the combine), counted by _launch
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
