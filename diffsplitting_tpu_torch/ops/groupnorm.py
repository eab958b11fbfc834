"""Fused GroupNorm(+affine)+Swish over NHWC activations.

Counterparts: diffsplitting_tpu/ops/groupnorm.py (`group_norm_swish_reference`,
`fused_group_norm_swish` with its custom VJP) and
diffsplitting_tpu/experimental/groupnorm_pallas.py (the Pallas kernels).

`fused_group_norm_swish` launches the CUDA kernel of csrc/groupnorm_swish.cu
for a CUDA tensor and runs the plain version for a CPU tensor. It takes
float32 or bfloat16 x (the UNet at `compute_dtype: bfloat16`), with float32
statistics, scale and bias, and returns x's dtype, as JAX's kernels write
`out_ref.dtype`; C up to 2048. Backward runs autograd through the plain
version, as the JAX custom VJP recomputes through its jnp reference.

The kernel's launch is chosen here, in plain Python, by `plan`: the cluster
route (one launch; a thread-block cluster holds a slab of whole groups of
one batch element in shared memory) where a slab fits and loads the SMs
evenly enough, else the stream route (a statistics pass, then a normalize
pass whose blocks fold the statistics).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.build import check, library


def group_norm_swish_reference(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """Plain version: NHWC GroupNorm (contiguous channel groups, statistics
    over (H, W, C/G) per sample from f32 sums of x and x², the variance
    clamped at 0), then scale/bias, then swish. Returns x.dtype."""
    B, H, W, C = x.shape
    G = num_groups
    cs = C // G
    xf = x.float()
    s = xf.sum(dim=(1, 2))  # (B, C)
    ss = (xf * xf).sum(dim=(1, 2))  # f32 before squaring
    n = H * W * cs
    gmean = s.view(B, G, cs).sum(-1) / n  # (B, G)
    gsq = ss.view(B, G, cs).sum(-1) / n
    gvar = torch.clamp(gsq - gmean * gmean, min=0.0)  # fp cancellation guard
    mean_c = gmean.repeat_interleave(cs, dim=-1)  # (B, C)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(cs, dim=-1)
    norm = (xf - mean_c[:, None, None, :]) * inv_c[:, None, None, :]
    norm = norm * scale + bias
    return (norm * torch.sigmoid(norm)).to(x.dtype)


# the kernels' constants (csrc/groupnorm_swish.cu)
_THREADS = 256  # stream route: threads a block (at most)
_BLOCKS_PER_SM = 4  # stream route: blocks an SM in one wave (__launch_bounds__)
_UNROLL = {4: 8, 8: 4}  # stream route: 16-byte loads in flight a thread, by channels a load
_CLUSTER_THREADS = 512  # cluster route: threads a block (at most)
_PART_FLOATS = 4096  # cluster route: the threads' sums
SMEM_MAX = 232448  # dynamic shared memory a block may have (227 KB)
MAX_CLUSTER = 16  # blocks a cluster the kernel takes (above 8: non-portable)
STREAM_CLUSTER = 8  # stream route: blocks a cluster along the chunks
MAX_CHANNELS = 2048
# the kernel's C entry point and channels a 16-byte vector, by dtype
_ENTRY = {torch.float32: ("gn_swish_f32", 4), torch.bfloat16: ("gn_swish_bf16", 8)}

# The planner's tuning values, each chosen by kernels/groupnorm_variants.py
# (which times other values of them; PERF.md):
# blocks a cluster the planner takes at most (the portable size)
PLAN_CLUSTER = 8
# the cluster route is taken where its busiest SM loads at most this much
# more than an even share of x, or at most _CLUSTER_SMALL bytes (the stream
# route's second launch and fold cost more than an uneven small load there)
_CLUSTER_SLACK = 1.25
_CLUSTER_SMALL = 64 * 1024
# a slab row of fewer bytes would read part of each 32-byte DRAM sector
_MIN_SLAB_BYTES = 32
# blocks that two fit an SM are taken first where their slab rows have at
# least this many bytes
_TWO_SLAB_BYTES = 64
# a cluster launch whose blocks sit alone on their SMs in one wave (no
# block's stores overlap another's loads) gives way to the stream route
# where a row of x has at most this many bytes: the stream route then
# covers 32 or more whole rows a block and step, near the copy rate
_STREAM_ROW_BYTES = 128
# the stream route folds up to this many partials an element without
# clustering its chunks (the cluster's barriers cost more than the fold)
_FOLD_ALONE = 128


class Plan(NamedTuple):
    """One call's launch: `route` "cluster" (one launch; clusters of `cluster`
    blocks over slabs of `slab` channels, `rows` rows a block, `chunks` slabs
    an element) or "stream" (two launches; `chunks` chunks of `rows` rows an
    element in clusters of `cluster`, slab 0). `threads` and `smem` (bytes of
    dynamic shared memory; the stream route's statistics pass) are a
    block's, `blocks` the grid's, `scratch` the f32 elements of scratch the
    call needs."""

    route: str
    slab: int
    cluster: int
    chunks: int
    rows: int
    threads: int
    smem: int
    blocks: int
    scratch: int


@functools.cache
@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _threads_a_row(C: int, per_vector: int) -> int:
    """Threads that cover a row of C channels on the stream route: one a
    16-byte vector, or one for two vectors past _THREADS vectors (f32 at
    C > 1024)."""
    vectors = C // per_vector
    return vectors if vectors <= _THREADS else vectors // 2


def cluster_block(S: int, rows: int, per_vector: int) -> tuple:
    """(threads, bytes of dynamic shared memory) of a cluster-route block
    holding `rows` rows of S channels, as the kernel sizes them: the rows,
    128 bytes of mbarriers, and 6S + 2S floats a step of rows."""
    vs = S // per_vector
    rpi = min(_CLUSTER_THREADS // vs, _PART_FLOATS // (2 * S))
    return rpi * vs, 128 + rows * S * (16 // per_vector) + (6 + 2 * rpi) * S * 4


def _cluster_plans(B: int, hw: int, C: int, G: int, per_vector: int, max_cluster: int):
    """Every cluster-route launch of the shape: slabs of whole groups, a
    multiple of 16 bytes and at least _MIN_SLAB_BYTES wide (or the whole
    row), clusters of 1 ... max_cluster blocks (powers of two) whose rows fit
    in shared memory, each block with rows."""
    esize = 16 // per_vector
    cs = C // G
    for gs in (d for d in range(1, G + 1) if G % d == 0):
        S = gs * cs
        if ((S * esize) % 16 or S * esize < min(_MIN_SLAB_BYTES, C * esize)
                or S // per_vector > _CLUSTER_THREADS):
            continue
        K = 1
        while K <= min(max_cluster, hw):
            rows = -(-hw // K)
            threads, smem = cluster_block(S, rows, per_vector)
            if threads >= 1 and smem <= SMEM_MAX and (K - 1) * rows < hw:
                blocks = B * (C // S) * K
                yield Plan("cluster", S, K, C // S, rows, threads, smem, blocks, 0)
            K *= 2


def _busiest_sm_bytes(p: Plan, per_vector: int, sms: int) -> int:
    """Bytes of x the busiest SM loads on the cluster route, the grid dealt
    evenly over the SMs."""
    return -(-p.blocks // sms) * p.rows * p.slab * (16 // per_vector)


def _stream_plan(B: int, hw: int, C: int, per_vector: int, sms: int) -> Plan:
    """The stream route: one wave of _BLOCKS_PER_SM blocks an SM over the
    B * chunks blocks, no chunk shorter than one unrolled step of its
    block's threads; where an element has more than _FOLD_ALONE chunks, in
    clusters of the most chunks (up to STREAM_CLUSTER) that round the
    chunks with rows up to whole clusters within that wave."""
    tpr = _threads_a_row(C, per_vector)
    rows_per_step = max(1, _THREADS // tpr) * _UNROLL[per_vector]
    wave = max(1, min(sms * _BLOCKS_PER_SM // B, hw // rows_per_step))
    rows = -(-hw // wave)
    with_rows = -(-hw // rows)
    most = 1 if with_rows <= _FOLD_ALONE else min(STREAM_CLUSTER, with_rows)
    ks = next(k for k in range(most, 0, -1)
              if -(-with_rows // k) * k <= wave)
    chunks = -(-with_rows // ks) * ks
    threads = max(1, _THREADS // tpr) * tpr
    smem = (max(1, _THREADS // tpr) + 1) * 2 * C * 4
    return Plan("stream", 0, ks, chunks, rows, threads, smem, B * chunks,
                B * (chunks // ks) * 2 * C)


@functools.cache  # called once a GroupNorm+Swish call: the shapes of a model are few
def plan(B: int, hw: int, C: int, G: int, per_vector: int, sms: int, route=None) -> Plan:
    """The launch of one call on a card of `sms` SMs (per_vector channels a
    16-byte vector: 4 f32, 8 bf16). The cluster route's launch (clusters of
    up to PLAN_CLUSTER blocks) puts the least load on the busiest SM; then
    takes blocks that two fit an SM with slab rows of at least
    _TWO_SLAB_BYTES, so that an SM overlaps one block's loads with
    another's stores; then the widest slab and the smallest cluster. The
    route is the cluster one where that load is within _CLUSTER_SLACK of an
    even share of x, or at most _CLUSTER_SMALL bytes, and its blocks do not
    sit alone on their SMs in one wave over rows of at most
    _STREAM_ROW_BYTES; unless `route` names one. Raises where `route` is
    "cluster" and no slab fits."""
    if route not in (None, "cluster", "stream"):
        raise ValueError(f"route must be 'cluster' or 'stream', got {route!r}")
    esize = 16 // per_vector

    def key(p):
        one_an_sm = not (2 * p.smem <= SMEM_MAX and p.slab * esize >= _TWO_SLAB_BYTES)
        return _busiest_sm_bytes(p, per_vector, sms), one_an_sm, -p.slab, p.cluster

    if route != "stream":
        best = min(_cluster_plans(B, hw, C, G, per_vector, PLAN_CLUSTER), key=key, default=None)
        if best is None and route == "cluster":
            raise ValueError(f"no slab of B={B} H*W={hw} C={C} G={G} fits a cluster of "
                             f"{PLAN_CLUSTER}")
        if route == "cluster":
            return best
        if best is not None:
            even = B * hw * C * esize / sms
            alone = best.blocks <= sms and 2 * best.smem > SMEM_MAX
            if (_busiest_sm_bytes(best, per_vector, sms) <= max(_CLUSTER_SLACK * even,
                                                                  _CLUSTER_SMALL)
                    and not (alone and C * esize <= _STREAM_ROW_BYTES)):
                return best
    return _stream_plan(B, hw, C, per_vector, sms)


def _launch(x, scale, bias, num_groups: int, eps: float, how: Plan = None):
    """Run csrc/groupnorm_swish.cu on a CUDA tensor, on `plan`'s launch or
    the given one (`how`); raises on what it does not take."""
    B, H, W, C = x.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"group_norm_swish kernel takes float32 or bfloat16, got {x.dtype}")
    entry, per_vector = _ENTRY[x.dtype]
    if not x.is_contiguous():
        raise ValueError("group_norm_swish kernel takes a contiguous NHWC tensor")
    # a thread covers one or two whole 16-byte vectors of a row
    multiple = 2 * per_vector if C > _THREADS * per_vector else per_vector
    if C % multiple or C > MAX_CHANNELS or C % num_groups:
        raise ValueError(f"group_norm_swish kernel ({x.dtype}): C={C} must be a multiple of "
                         f"{multiple} and of num_groups={num_groups}, at most {MAX_CHANNELS}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_swish kernel needs a 16-byte aligned tensor")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.numel() != C or bias.numel() != C:
        raise ValueError("scale and bias must have C elements")
    hw = H * W
    if how is None:
        how = plan(B, hw, C, num_groups, per_vector, _sm_count(x.device.index))
    scratch = torch.empty(max(how.scratch, 1), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(library(), entry)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), scratch.data_ptr(), y.data_ptr(), B, hw,
        C, num_groups, how.slab, how.cluster, how.chunks, how.rows, float(eps), stream)
    check(err, entry)
    if x.dtype == torch.float32:
        FusedGroupNormSwish.launches += 1
    else:
        FusedGroupNormSwish.launches_bf16 += 1
    return y


class FusedGroupNormSwish(torch.autograd.Function):
    """Forward: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor. Backward: autograd through the plain version."""

    launches = 0  # float32 kernel launches, counted by _launch
    launches_bf16 = 0  # bfloat16 kernel launches, counted by _launch

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        if x.is_cuda:
            return _launch(x, scale, bias, num_groups, eps)
        return group_norm_swish_reference(x, scale, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (x, scale, bias)]
            y = group_norm_swish_reference(*args, ctx.num_groups, ctx.eps)
        gx, gs, gb = torch.autograd.grad(y, args, g)
        return gx, gs, gb, None, None


def fused_group_norm_swish(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """NHWC GroupNorm+affine+Swish; see FusedGroupNormSwish."""
    return FusedGroupNormSwish.apply(x, scale, bias, num_groups, eps)
