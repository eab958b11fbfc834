// Spatial self-attention softmax(q k^T * scale) v in bfloat16, for sm_90a:
// the UNet's attention at `compute_dtype: bfloat16`, on the bf16 tensor
// cores through wgmma with f32 accumulators, at any head dim D that is a
// multiple of 8 up to 1024 and any N >= 1.
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`, :60) at bf16 q, k and v: f32 scores and softmax, P
//   normalised and cast to bf16, P V summed in f32, a bf16 result
//   (`out_ref.dtype`). The f32 kernels of attention.cu take the float32 UNet.
//
// Bound: operations. The two products take 4 * N^2 * D flops a (batch,
//   head): 4.29 GFLOP at sr_sr3_64_512's mid block (B = 1, N = 1024, D =
//   1024), 0.0043 ms at 989 TFLOP/s dense bf16, against 8.4 MB of q, k, v and
//   out (0.0025 ms at 3.35 TB/s).
//
// Design (a Hopper redesign of PR 14's mma.sync kernel, which ran the mid
// block in 0.1355 ms on an H100 80GB HBM3 at 700 W: 3.2 % of its bound).
// Times below are device times by CUDA-graph replay on an H100 80GB HBM3 at
// 700 W (PERF.md row 4d). PR 14's four faults and what this design does
// about each:
//   1. Too few blocks (64 of 16 queries at the mid block, one an SM): the
//      keys are split across blocks, flash-decoding style. Split s of a
//      (batch * head, 64-query tile) walks key tiles [s * tps, (s + 1) *
//      tps); each split writes its f32 running max m, row sum l and
//      unnormalised O to scratch the wrapper allocates, and a second launch
//      (attention_bf16_combine) adds the splits in split order. A split with
//      no key (a forced split count may leave the last one empty) writes m =
//      -inf, l = 0 and O = 0, and the combine gives it weight 0 without
//      computing -inf - (-inf). The split count is chosen in Python
//      (ops/attention.py `plan`) from (B * heads, N, D, SM count); with one
//      split the kernel writes the bf16 result itself.
//   2. K and V read again by every 16 queries: a block takes 64 queries (one
//      wgmma m64 tile), so each K and V tile read from L2 serves 64.
//   3. One stage in flight and two block-wide barriers a stage: Q, K and V
//      come by TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past D
//      and N) into a ring of slots, filled by one producer thread and handed
//      over on mbarriers (full: transaction bytes; empty: the consumer
//      warpgroup's release once its wgmma that read the slot have
//      completed). No __syncthreads() in the key loop.
//   4. mma.sync: S = Q K^T runs as wgmma.m64n64k16 with Q and K both read
//      from shared memory through 128-byte-swizzle K-major descriptors; O +=
//      P V as wgmma.m64n64k16 with P from registers (S's accumulator layout
//      is P's A fragment, rounded to bf16) and V read transposed (an MN-major
//      descriptor: V stays row-major, as TMA lands it). The waits on
//      mbarriers loop inside their asm, and the role of a warp is read
//      through a shuffle, so that ptxas sees no divergent path around the
//      wgmma (it serialized them otherwise).
// Two kernels, by D:
//   * D <= 256, attention_bf16_kernel<PB>: a block holds its 64 queries' Q
//     (PB 64-wide panels) and O (64 x 64 PB f32, at most 128 registers a
//     thread) and walks its split's 64-key tiles with an online softmax, K
//     and V of a tile in ring slots of their own.
//   * D > 256, attention_bf16_wide_kernel: O (64 x D f32, 256 KB at D =
//     1024) fits neither a warpgroup's registers nor an SM's. A block takes
//     its split's keys in groups of two 64-key tiles. For a group it sums S
//     over all of D itself in the accumulator (Q and the two K tiles
//     streamed a 64-wide panel at a time), takes the group's softmax in one
//     pass (online across groups), then O in 256-wide chunks one after
//     another (P stays in registers: 32 bf16 pairs a thread), each chunk
//     stored in f32 to the splits' scratch, from which a later group of the
//     same split reloads and rescales it. The plan splits the keys 128 a
//     split where the grid stays within 4 waves, so at the mid block each
//     chunk is stored once: 0.0346-0.0352 ms there (1 split: 0.1689-0.1708;
//     16 splits of one tile: 0.0735-0.0739; a ring of 4 slots: 0.0360). The
//     first design held O across the blocks of a thread-block cluster, 256
//     head dims a block, and added the blocks' S partials over distributed
//     shared memory every key tile: its warpgroups waited most of a tile for
//     that exchange (0.0550-0.0560 ms at the mid block). Recomputing S for
//     each 256-wide slice of O would read all of K once a slice.
// Softmax: f32 in the exp2 domain; keys past N at -inf. The row sum is
//   taken on the f32 P, and O is divided by it once, at the end (the Pallas
//   kernel divides P first, then rounds it to bf16). Both products sum in
//   the wgmma accumulator, which rounds toward zero: S over at most 256
//   head dims (D <= 256) or all of D (at most 64 steps of 2^-23 relative
//   each), O over a split's keys (D <= 256) or a group's 128 keys, far
//   below bf16's 2^-8 step of the result;
//   tests/test_torch_port_attention_bf16_sums.py emulates the sums.
// Nothing is read past D or N: TMA boxes are clipped by the tensor map's
//   extents (D, N, heads, B) and zero-filled; query rows past N are not
//   stored, nor head dims past D. No atomics and no state kept between
//   calls: two launches, and a CUDA-graph replay, give the same bits.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;        // queries a block: one wgmma m64 tile
constexpr int kTileK = 64;       // keys a tile
constexpr int kPanel = 64;       // head dims a panel: one 128-byte swizzled row
constexpr int kMaxPanels = 4;    // panels of O a block holds (256 head dims)
constexpr int kRing = 4;         // D <= 256: ring slots (K and V of a tile take one each)
constexpr int kWideRing = 6;     // D > 256: ring slots
constexpr int kConsumers = 128;  // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kPanelBytes = kTileK * kPanel * 2;  // a K or V panel of a tile
constexpr int kQPanelBytes = kRows * kPanel * 2;
constexpr int kWideStage = 4 * kPanelBytes;  // D > 256: Q and two K panels, or 4 V panels
constexpr int kNT = kTileK / 8;  // n8 blocks of S a tile

template <int PB>
struct Smem {
    static constexpr int Q = 0;                          // [PB][64 rows][128 B]
    static constexpr int STAGE = PB * kPanelBytes;       // a ring slot
    static constexpr int RING = Q + PB * kQPanelBytes;
    static constexpr int BARS = RING + kRing * STAGE;    // q, full, empty
    static constexpr int BYTES = BARS + (1 + 2 * kRing) * 8 + 1024;  // + the alignment
    static_assert(BYTES <= 232448, "227 KB of shared memory a block");
    static_assert(STAGE % 1024 == 0 && kQPanelBytes % 1024 == 0, "swizzle atoms aligned");
};

struct WideSmem {
    static constexpr int BARS = kWideRing * kWideStage;  // full, empty
    static constexpr int BYTES = BARS + 2 * kWideRing * 8 + 1024;
    static_assert(BYTES <= 232448, "227 KB of shared memory a block");
};

struct Params {
    bf16* out;        // (B, N, heads, D), written where splits == 1
    float* opart;     // [splits][B * heads][N][D] unnormalised O (see attention_bf16)
    float* ml;        // [splits][B * heads][N][2] running max and row sum, where splits > 1
    int n_tokens, heads, d;
    int panels;       // 64-wide head-dim panels of D
    int splits, tps;  // key splits and key tiles a split
    float c2;         // scale * log2(e)
};

// V read MN-major in the 128-byte swizzle (desc_kmajor in hopper.cuh for Q
// and K): the leading byte offset would step to a second 64-wide MN atom,
// which an n of 64 never reaches, and is set to the same 1024 as the stride.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define DSP_WGMMA_D32                                                                         \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DSP_WGMMA_REGS32                                                                  \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// d (+)= a b, 64 x 64 f32: a 64 x 16 bf16 by descriptor (K-major), b 16 x 64
// bf16 by descriptor (K-major); d zeroed first iff !scale_d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DSP_WGMMA_REGS32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DSP_WGMMA_D32
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b, 64 x 64 f32: a 64 x 16 bf16 from registers (mma.m16n8k16's A
// layout, a warp's 16 rows each), b 16 x 64 bf16 by descriptor, MN-major
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint4& a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DSP_WGMMA_REGS32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : DSP_WGMMA_D32
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}

// two floats as a bf16 pair (to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// P's A fragment for the 64 keys of an accumulator s: keys 16 kk ... are
// s's n8 blocks 2 kk and 2 kk + 1, rounded to bf16
__device__ __forceinline__ void pack_p(const float (&s)[32], uint4 (&pa)[kTileK / 16]) {
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
        pa[kk] = make_uint4(pack_bf16(s[8 * kk], s[8 * kk + 1]),
                            pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                            pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                            pack_bf16(s[8 * kk + 6], s[8 * kk + 7]));
}

// ------------------------------------------------------------ D <= 256
// PB: 64-wide head-dim panels of D (at most kMaxPanels). Grid (query tiles,
// splits, B * heads).
template <int PB>
__global__ void __launch_bounds__(kThreads, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, Params p) {
    typedef Smem<PB> S;
    constexpr int R = kRing;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BARS);
    uint64_t* full = qbar + 1;
    uint64_t* empty = full + R;

    const int q0 = blockIdx.x * kRows;
    const int split = blockIdx.y;
    const int bh = blockIdx.z;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int n_tiles = (p.n_tokens + kTileK - 1) / kTileK;
    const int t0 = split * p.tps;
    const int nt = max(0, min(n_tiles, t0 + p.tps) - t0);  // its key tiles (0: an empty split)
    const int tid = threadIdx.x;
    // 0: the consumer warpgroup, 1: the producer warp (warp-uniform, as the
    // compiler sees it)
    const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);

    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int i = 0; i < R; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (role == 1) {
        // ---- producer: one thread issues every TMA load of the block
        if (tid == kConsumers && nt > 0) {
            mbar_expect_tx(qbar, PB * kQPanelBytes);
            for (int j = 0; j < PB; ++j)
                tma_load(smem + S::Q + j * kQPanelBytes, &tmq, j * kPanel, q0, h, b, qbar);
            for (int i = 0; i < 2 * nt; ++i) {  // K of tile i / 2, then its V
                const int slot = i % R;
                if (i >= R) mbar_wait(&empty[slot], (i / R - 1) & 1);
                const CUtensorMap* map = (i & 1) ? &tmv : &tmk;
                const int key0 = (t0 + i / 2) * kTileK;
                mbar_expect_tx(&full[slot], PB * kPanelBytes);
                for (int j = 0; j < PB; ++j)
                    tma_load(smem + S::RING + slot * S::STAGE + j * kPanelBytes, map, j * kPanel,
                             key0, h, b, &full[slot]);
            }
        }
        __syncwarp();
        return;
    }

    // ---- consumers: one warpgroup, 64 query rows
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // columns 2t, 2t + 1 of each n8 block
    const uint32_t q_sm = smem_addr(smem + S::Q);
    const uint32_t ring_sm = smem_addr(smem + S::RING);

    float o[PB][32];
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    if (nt > 0) mbar_wait(qbar, 0);

#pragma unroll 1
    for (int it = 0; it < nt; ++it) {
        const int ik = 2 * it, iv = 2 * it + 1;
        // S = Q K^T over the panels, in the accumulator
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        mbar_wait(&full[ik % R], (ik / R) & 1);
        const uint32_t k_sm = ring_sm + (ik % R) * S::STAGE;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
            for (int kk = 0; kk < kPanel / 16; ++kk)
                wgmma_ss(s, desc_kmajor(q_sm + j * kQPanelBytes + 32 * kk),
                         desc_kmajor(k_sm + j * kPanelBytes + 32 * kk), j + kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        mbar_arrive_if(&empty[ik % R], tid == 0);  // K's slot is read

        // keys past N take no weight; s[4n + 2r + c] is row g + 8r, key 8n + 2t + c
        const int keys_left = p.n_tokens - (t0 + it) * kTileK;
        if (keys_left < kTileK) {
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                    if (8 * n + 2 * t + c >= keys_left)
                        s[4 * n + c] = s[4 * n + 2 + c] = -INFINITY;
        }

        // online softmax, f32, in the exp2 domain
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * n + e] *= p.c2;
            mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
            corr[r] = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * n + e] = exp2f(s[4 * n + e] - m_run[e / 2]);
            l_run[0] += s[4 * n] + s[4 * n + 1];
            l_run[1] += s[4 * n + 2] + s[4 * n + 3];
        }
        uint4 pa[kTileK / 16];
        pack_p(s, pa);
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) o[j][e] *= corr[(e / 2) % 2];

        // O += P V: V's panel j, keys 16 kk ..., by an MN-major descriptor
        // (two 8-key groups 1024 bytes apart)
        mbar_wait(&full[iv % R], (iv / R) & 1);
        const uint32_t v_sm = ring_sm + (iv % R) * S::STAGE;
#pragma unroll
        for (int j = 0; j < PB; ++j) fence_regs(o[j]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
            for (int j = 0; j < PB; ++j)
                wgmma_rs_t(o[j], pa[kk], desc_mnmajor(v_sm + j * kPanelBytes + 2048 * kk));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int j = 0; j < PB; ++j) fence_regs(o[j]);
        mbar_arrive_if(&empty[iv % R], tid == 0);  // V's slot is read
    }

    // ---- epilogue: o[j][4n + 2r + c] is row 16 warp + g + 8r, head dim
    // 64 j + 8n + 2t + c
    const long long BH = (long long)gridDim.z;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        const int row = q0 + 16 * warp + g + 8 * r;
        if (row >= p.n_tokens) continue;
        if (p.splits == 1) {
            const float inv = 1.0f / l;
            bf16* dst = p.out + (((long long)b * p.n_tokens + row) * p.heads + h) * p.d;
#pragma unroll
            for (int j = 0; j < PB; ++j)
#pragma unroll
                for (int n = 0; n < kNT; ++n) {
                    const int col = j * kPanel + 8 * n + 2 * t;
                    if (col < p.d)
                        *reinterpret_cast<uint32_t*>(dst + col) =
                            pack_bf16(o[j][4 * n + 2 * r] * inv, o[j][4 * n + 2 * r + 1] * inv);
                }
        } else {
            const long long prow = ((long long)split * BH + bh) * p.n_tokens + row;
            float* dst = p.opart + prow * p.d;
#pragma unroll
            for (int j = 0; j < PB; ++j)
#pragma unroll
                for (int n = 0; n < kNT; ++n) {
                    const int col = j * kPanel + 8 * n + 2 * t;
                    if (col < p.d)
                        *reinterpret_cast<float2*>(dst + col) =
                            make_float2(o[j][4 * n + 2 * r], o[j][4 * n + 2 * r + 1]);
                }
            if (t == 0) *reinterpret_cast<float2*>(p.ml + 2 * prow) = make_float2(m_run[r], l);
        }
    }
}

// ------------------------------------------------------------- D > 256
// Grid (query tiles, splits, B * heads). A split's keys in groups of two
// tiles; for each group the ring takes panels 0 ... panels - 1 of Q and of
// the group's two K tiles, then for each 256-wide chunk of O the two tiles'
// V panels of that chunk (those past D or N are zeros). The second tile of a
// group of one (a split of an odd number of tiles) is loaded all the same
// and its keys masked.
__global__ void __launch_bounds__(kThreads, 1)
attention_bf16_wide_kernel(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv, Params p) {
    constexpr int R = kWideRing;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + WideSmem::BARS);
    uint64_t* empty = full + R;
    const int q0 = blockIdx.x * kRows;
    const int split = blockIdx.y;
    const int bh = blockIdx.z;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int n_tiles = (p.n_tokens + kTileK - 1) / kTileK;
    const int t0 = split * p.tps;
    const int nt = max(0, min(n_tiles, t0 + p.tps) - t0);  // its key tiles (0: an empty split)
    const int groups = (nt + 1) / 2;
    const int chunks = (p.panels + kMaxPanels - 1) / kMaxPanels;
    const int tid = threadIdx.x;
    const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);
    if (tid == 0) {
        for (int i = 0; i < R; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (role == 1) {
        // ---- producer: one thread issues every TMA load of the block
        if (tid == kConsumers) {
            int i = 0;
            for (int gi = 0; gi < groups; ++gi) {
                const int key0 = (t0 + 2 * gi) * kTileK;
                for (int pn = 0; pn < p.panels + 2 * chunks; ++pn, ++i) {
                    const int slot = i % R;
                    if (i >= R) mbar_wait(&empty[slot], (i / R - 1) & 1);
                    unsigned char* st = smem + slot * kWideStage;
                    if (pn < p.panels) {  // Q's panel pn and the two K tiles'
                        mbar_expect_tx(&full[slot], 3 * kPanelBytes);
                        tma_load(st, &tmq, pn * kPanel, q0, h, b, &full[slot]);
                        for (int u = 0; u < 2; ++u)
                            tma_load(st + (1 + u) * kPanelBytes, &tmk, pn * kPanel,
                                     key0 + u * kTileK, h, b, &full[slot]);
                    } else {  // chunk c of V, tile u
                        const int c = (pn - p.panels) / 2, u = (pn - p.panels) % 2;
                        mbar_expect_tx(&full[slot], kMaxPanels * kPanelBytes);
                        for (int j = 0; j < kMaxPanels; ++j)
                            tma_load(st + j * kPanelBytes, &tmv, (kMaxPanels * c + j) * kPanel,
                                     key0 + u * kTileK, h, b, &full[slot]);
                    }
                }
            }
        }
        __syncwarp();
        return;
    }

    // ---- consumers: one warpgroup, 64 query rows
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t ring_sm = smem_addr(smem);
    const long long BH = (long long)gridDim.z;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    int i = 0;
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
        // S = Q K^T for the group's two tiles over all of D, in the accumulator
        float s[2][32];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 32; ++e) s[u][e] = 0.f;
#pragma unroll 1
        for (int pn = 0; pn < p.panels; ++pn, ++i) {
            mbar_wait(&full[i % R], (i / R) & 1);
            const uint32_t st = ring_sm + (i % R) * kWideStage;
            wgmma_fence();
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int kk = 0; kk < kPanel / 16; ++kk)
                    wgmma_ss(s[u], desc_kmajor(st + 32 * kk),
                             desc_kmajor(st + (1 + u) * kPanelBytes + 32 * kk), pn + kk > 0);
            wgmma_commit();
            wgmma_wait0();
            fence_regs(s[0]);
            fence_regs(s[1]);
            mbar_arrive_if(&empty[i % R], tid == 0);
        }

        // the group's softmax, f32, in the exp2 domain, online across groups;
        // s[u][4n + 2r + c] is row g + 8r, key 64 (t0 + 2 gi + u) + 8n + 2t + c,
        // at -inf past N and past the split
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = (t0 + 2 * gi + u) * kTileK + 8 * n + 2 * t + (e & 1);
                    s[u][4 * n + e] = 2 * gi + u < nt && key < p.n_tokens
                                          ? s[u][4 * n + e] * p.c2
                                          : -INFINITY;
                    mx[e / 2] = fmaxf(mx[e / 2], s[u][4 * n + e]);
                }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
            corr[r] = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
        uint4 pa[2][kTileK / 16];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[u][4 * n + e] = exp2f(s[u][4 * n + e] - m_run[e / 2]);
                l_run[0] += s[u][4 * n] + s[u][4 * n + 1];
                l_run[1] += s[u][4 * n + 2] + s[u][4 * n + 3];
            }
            pack_p(s[u], pa[u]);
        }
        // the last group of a lone split stores the bf16 result
        const bool direct = gi == groups - 1 && p.splits == 1;
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = 1.0f / quad_sum(l_run[r]);

        // O, a 256-wide chunk at a time: the earlier groups' sum reloaded from
        // the scratch and rescaled, plus this group's P V
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) {
            float o[kMaxPanels][32];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = q0 + 16 * warp + g + 8 * r;
                const float* src =
                    p.opart + (((long long)split * BH + bh) * p.n_tokens + row) * p.d;
#pragma unroll
                for (int j = 0; j < kMaxPanels; ++j)
#pragma unroll
                    for (int n = 0; n < kNT; ++n) {
                        const int col = (kMaxPanels * c + j) * kPanel + 8 * n + 2 * t;
                        float2 x = make_float2(0.f, 0.f);
                        if (gi > 0 && row < p.n_tokens && col < p.d)
                            x = *reinterpret_cast<const float2*>(src + col);
                        o[j][4 * n + 2 * r] = x.x * corr[r];
                        o[j][4 * n + 2 * r + 1] = x.y * corr[r];
                    }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u, ++i) {
                mbar_wait(&full[i % R], (i / R) & 1);
                const uint32_t st = ring_sm + (i % R) * kWideStage;
#pragma unroll
                for (int j = 0; j < kMaxPanels; ++j) fence_regs(o[j]);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
                    for (int j = 0; j < kMaxPanels; ++j)
                        wgmma_rs_t(o[j], pa[u][kk],
                                   desc_mnmajor(st + j * kPanelBytes + 2048 * kk));
                wgmma_commit();
                wgmma_wait0();
#pragma unroll
                for (int j = 0; j < kMaxPanels; ++j) fence_regs(o[j]);
                mbar_arrive_if(&empty[i % R], tid == 0);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = q0 + 16 * warp + g + 8 * r;
                if (row >= p.n_tokens) continue;
                const long long prow = ((long long)split * BH + bh) * p.n_tokens + row;
                bf16* out = p.out + (((long long)b * p.n_tokens + row) * p.heads + h) * p.d;
#pragma unroll
                for (int j = 0; j < kMaxPanels; ++j)
#pragma unroll
                    for (int n = 0; n < kNT; ++n) {
                        const int col = (kMaxPanels * c + j) * kPanel + 8 * n + 2 * t;
                        if (col >= p.d) continue;
                        const float x0 = o[j][4 * n + 2 * r], x1 = o[j][4 * n + 2 * r + 1];
                        if (direct)
                            *reinterpret_cast<uint32_t*>(out + col) =
                                pack_bf16(x0 * inv[r], x1 * inv[r]);
                        else
                            *reinterpret_cast<float2*>(p.opart + prow * p.d + col) =
                                make_float2(x0, x1);
                    }
            }
        }
    }
    if (p.splits > 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float l = quad_sum(l_run[r]);
            const int row = q0 + 16 * warp + g + 8 * r;
            if (row >= p.n_tokens) continue;
            const long long prow = ((long long)split * BH + bh) * p.n_tokens + row;
            if (nt == 0)  // an empty split: O = 0 for the combine's weight 0
                for (int col = 2 * t; col < p.d; col += 8)
                    *reinterpret_cast<float2*>(p.opart + prow * p.d + col) = make_float2(0.f, 0.f);
            if (t == 0) *reinterpret_cast<float2*>(p.ml + 2 * prow) = make_float2(m_run[r], l);
        }
    }
}

// out = sum_s w_s O_s / sum_s w_s l_s over the splits in split order, w_s =
// exp2(m_s - max m); a split with no key (m_s = -inf, O_s = 0) has weight 0.
// A thread takes 8 head dims of a row.
__global__ void attention_bf16_combine(const float* __restrict__ opart,
                                       const float* __restrict__ ml, bf16* __restrict__ out,
                                       int splits, int n_tokens, int heads, int d) {
    const int bh = blockIdx.y;
    const int per_row = d / 8;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = e / per_row;
    if (row >= n_tokens) return;
    const int col = (e % per_row) * 8;
    const long long BH = (long long)gridDim.y;
    float m_max = -INFINITY;
    for (int s = 0; s < splits; ++s)
        m_max = fmaxf(m_max, ml[2 * ((s * BH + bh) * n_tokens + row)]);
    float L = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < splits; ++s) {
        const long long prow = (s * BH + bh) * n_tokens + row;
        const float2 m_l = *reinterpret_cast<const float2*>(ml + 2 * prow);
        const float w = m_l.x == -INFINITY ? 0.f : exp2f(m_l.x - m_max);
        L = __fmaf_rn(w, m_l.y, L);
        const float4* src = reinterpret_cast<const float4*>(opart + prow * d + col);
        const float4 x0 = src[0], x1 = src[1];
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fmaf_rn(w, xs[i], acc[i]);
    }
    const float inv = 1.0f / L;
    const int b = bh / heads, h = bh % heads;
    bf16* dst = out + (((long long)b * n_tokens + row) * heads + h) * d + col;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv), pack_bf16(acc[2] * inv, acc[3] * inv),
                   pack_bf16(acc[4] * inv, acc[5] * inv), pack_bf16(acc[6] * inv, acc[7] * inv));
}

template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, int B, cudaStream_t st) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.n_tokens + kRows - 1) / kRows, p.splits, B * p.heads);
    kernel<<<grid, kThreads, smem_bytes, st>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, heads, D) bf16 views sharing the element strides (sb, sn,
// sh), unit stride on the last dim, strides multiples of 8, 16-byte aligned;
// out: (B, N, heads, D) contiguous bf16. D a multiple of 8 up to 1024, any N
// >= 1. `splits` key splits (1 ... ceil(N / 64)). Scratch: where splits > 1,
// opart holds splits * B * heads * N * D floats and ml splits * B * heads * N
// * 2; above D = 256 opart is needed also where a split has more than two key
// tiles; else both may be null. Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int attention_bf16(const void* q, const void* k, const void* v, void* out, void* opart,
                              void* ml, int B, int n_tokens, int heads, int d, long long sb,
                              long long sn, long long sh, float scale, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (n_tokens + kTileK - 1) / kTileK;
    if (d <= 0 || d > 1024 || d % 8 || n_tokens < 1 || splits < 1 || splits > n_tiles)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.out = static_cast<bf16*>(out);
    p.opart = static_cast<float*>(opart);
    p.ml = static_cast<float*>(ml);
    p.n_tokens = n_tokens;
    p.heads = heads;
    p.d = d;
    p.panels = (d + kPanel - 1) / kPanel;
    p.splits = splits;
    p.tps = (n_tiles + splits - 1) / splits;
    p.c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    const bool wide = p.panels > kMaxPanels;
    if ((splits > 1 && (!opart || !ml)) || (wide && p.tps > 2 && !opart))
        return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    const CUtensorMapDataType t16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode_qkv(&tq, t16, 2, q, B, n_tokens, heads, d, sb, sn, sh, kRows) ||
        !encode_qkv(&tk, t16, 2, k, B, n_tokens, heads, d, sb, sn, sh, kTileK) ||
        !encode_qkv(&tv, t16, 2, v, B, n_tokens, heads, d, sb, sn, sh, kTileK))
        return (int)cudaErrorInvalidValue;
    int err;
    if (wide)
        err = launch(attention_bf16_wide_kernel, WideSmem::BYTES, tq, tk, tv, p, B, st);
    else if (p.panels == 1)
        err = launch(attention_bf16_kernel<1>, Smem<1>::BYTES, tq, tk, tv, p, B, st);
    else if (p.panels == 2)
        err = launch(attention_bf16_kernel<2>, Smem<2>::BYTES, tq, tk, tv, p, B, st);
    else if (p.panels == 3)
        err = launch(attention_bf16_kernel<3>, Smem<3>::BYTES, tq, tk, tv, p, B, st);
    else
        err = launch(attention_bf16_kernel<4>, Smem<4>::BYTES, tq, tk, tv, p, B, st);
    if (err != 0 || splits == 1) return err;
    const int threads = 128;
    const dim3 grid((n_tokens * (d / 8) + threads - 1) / threads, B * heads);
    attention_bf16_combine<<<grid, threads, 0, st>>>(p.opart, p.ml, p.out, splits, n_tokens,
                                                     heads, d);
    return (int)cudaGetLastError();
}
