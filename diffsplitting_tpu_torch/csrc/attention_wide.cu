// Spatial self-attention softmax(q k^T * scale) v in float32 at D = 128 and
// at wide head dims, for sm_90a, on the TF32 tensor cores through wgmma at
// float32 accuracy (3xTF32, below): attention_d128_kernel at D = 128 (design
// at the end of these notes), attention_wide_kernel at D a multiple of 4 in
// (128, 1024]; any N >= 1. attention.cu takes D below 128; attention_bf16.cu
// takes bf16.
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`, :60): at D = 128 the mid block of the splitting UNet
//   (Hagen configs: N = 4096 at a 512² patch, batch 1 in the t-refinement's
//   one-step inversions, 4 in training, 8 in serving; N = 16 in
//   splitting_cifar10_indi) and of the time predictor; above 128 the mid
//   block and 16² sites of sr_sr3_16_128 and sr_ddpm_16_128 (D = 512),
//   sample_ddpm_128's mid block (D = 256), sr_sr3_64_512's mid block in f32
//   (D = 1024), and any other D (192 at inner 24 x 8, 320 at inner 40 x 8,
//   ...).
//
// Bound: operations. Each f32 product is three TF32 tensor-core products, so
//   the two products take 3 * 4 * N^2 * D TF32 flops a (batch, head) at 495
//   TFLOP/s dense, against 16 * N * D bytes of q, k, v and out at 3.35 TB/s:
//   0.0521 ms at the Hagen mid block at batch 1 (N = 4096, D = 128), 0.4165
//   at batch 8; 0.0008 ms at sr_sr3_16_128's 16² sites at batch 1 (N = 256,
//   D = 512). At such small shapes a kernel is bound by its latency and by
//   how many SMs it keeps busy, not by either rate.
//
// Design (a Hopper redesign of the first wide kernel, mma.sync in 128-wide
// head-dim slices, which ran N = 256, D = 512 at batch 1 in 0.0445 ms on 16
// blocks, 1.8 % of its bound):
//   * Blocks. A block takes 64 queries (one wgmma m64 tile), one key split
//     and one slice of O's head dims: grid (slices, query tiles, B * heads *
//     splits). Split s walks key tiles [s * tps, (s + 1) * tps) of TK keys
//     (16, 32 or 64); a slice is up to 8 chunks of 64 head dims of O. Every
//     slice block of a (query tile, split) computes the same S over all of
//     D and so the same softmax bits; the S costs microseconds at the shapes
//     where the plan takes more than one slice. The split and slice counts
//     and TK are chosen in Python (ops/attention.py `wide_plan`) from (B *
//     heads, N, D, SM count). With more than one split each split writes
//     its f32 running max m, row sum l (slice 0) and unnormalised O to
//     scratch the wrapper allocates, and a second launch
//     (attention_wide_combine) adds the splits in split order; a split with
//     no key (a forced count may leave the last one empty) writes m = -inf,
//     l = 0, O = 0 and gets weight 0. With one split the block writes out.
//   * Loads. Q, K and V come by TMA (cp.async.bulk.tensor, f32, 128-byte
//     swizzle, boxes of 32 head dims: one 128-byte row) into a ring of
//     stages filled by one producer thread and handed over on mbarriers
//     (full: transaction bytes; empty: the consumer warpgroup's release once
//     the wgmma that read the stage have completed). For each key tile the
//     ring takes, for each 32-wide panel of D, Q's and K's panel; then, for
//     each 64-wide chunk of the slice, V's two panels. The maps' zero fill
//     past N and past D replaces every bounds predicate on the loads (Q's
//     and K's boxes stop at N rounded up to 8 rows where N is below a tile:
//     the stale rows past them reach only queries past N and keys at -inf).
//     The C entry encodes the three maps, through a small per-thread cache.
//   * 3xTF32 on wgmma.m64nNk8.f32.tf32.tf32, A from registers, B from
//     shared memory (K-major: a tf32 wgmma reads no transposed B). Each
//     operand x is split as big + small. An A operand (Q, P) in registers:
//     big = x rounded to TF32 (to nearest, ties away, as cvt.rna rounds),
//     small = x - big. A B operand (K, V) in shared memory: big is the raw
//     f32 tile, which the tensor core reads truncated to its top 19 bits,
//     and small = x - trunc(x), a plane written once a tile beside it and
//     read by the whole warpgroup. A product sums small*big, big*small and
//     big*big a k8 step (the small*small term, about 2^-20 of the product,
//     is dropped).
//     - S = Q K^T: K's panel is a K-major B as TMA lands it; the consumers
//       write its remainders into a plane of the same layout. Q's A
//       fragments are read from its panel and split in registers.
//     - O += P V: P is the S accumulator after the softmax, split in
//       registers (the accumulator gives a thread keys 2t and 2t + 1 of an
//       8-key block, which the A fragment takes as its k indices t and t +
//       4). V's chunk is written once a tile into two planes, raw and
//       remainder, transposed to head dims x keys (K-major), its keys in
//       the same order (key 8j + 2a + b at k position 8j + a + 4b).
//   * Sums (the accumulator rounds toward zero, PERF.md PRs 1-6): each
//     panel's 12 wgmma of S start from 0 and the panels are added in f32 in
//     order; while a panel's chain runs, the next panel's operands are
//     loaded and split (no accumulator is read while a chain is in flight:
//     ptxas serializes every wgmma otherwise). Each chunk's P V over the tile's keys
//     (TK / 8 k8 steps, 3 wgmma each) starts from 0 and is added to O in
//     f32 with O's rescale (one fused multiply-add). O lives in shared
//     memory (16 KB a chunk), each thread's elements where its accumulator
//     holds them, so a block can hold 512 head dims of O.
//   * Softmax: f32, online across the split's key tiles, in the exp2 domain;
//     keys past N at -inf after the scale. The row sum is divided out once,
//     at the end (or by the combine).
//   * No atomics and no state kept between calls: two launches, and a
//     CUDA-graph replay, give the same bits.
//   * What bounds it at the small served shapes (development clock64()
//     stamps and timing probes on the H100, PERF.md §6 row 4b): a block's
//     serial walk over its S panels, several times their tensor work; no
//     single step of it (the loads, the box sizes, the remainders, the
//     barrier, the chain) dominates, and deeper rings, bigger stages or two
//     chains a step did not shorten it.
//   tests/test_torch_port_attention_split.py emulates the order of sums and
//   the split of the operands on the CPU.
//
// The D = 128 kernel (a Hopper redesign of the 3xTF32 mma.sync kernel that
// attention.cu held until commit 1e56b1a, 8 warps of 16 queries a block,
// which ran the Hagen mid block in 0.6081 ms at batch 1 on 32 blocks and
// 1.2204 at batch 8 on an H100 80GB HBM3 at 700 W: 8.6 % and 34 % of its
// bound). The wide kernel's arithmetic, TMA maps, combine
// and emulation; what it does at this size that the wide kernel's serial
// walk, one warpgroup a block, does not:
//   * Blocks. Two consumer warpgroups of 64 queries share one stream of K
//     and V tiles (128 queries a block: half the K and V bytes a query of a
//     64-query block), so that one warpgroup's softmax and splits run while
//     the other's wgmma do. Keys split across blocks by ops/attention.py
//     `d128_plan` as the wide plan splits them (one block an SM: B = 1 takes
//     4 splits, 128 blocks), combined by attention_wide_combine in split
//     order.
//   * A producer warpgroup prepares each key tile once for both: one thread
//     issues the TMA loads (Q once a block; K and V tiles of 4 boxes into
//     rings of one tile each), and all 128 write K's remainder plane and
//     V's transposed planes (raw, remainders), then hand them over on mbarriers (kready, vready; kfree and vfree back once
//     both consumers' wgmma that read them completed). The planes are
//     single-buffered: K's of the next tile is written while the consumers
//     run P V, V's while they run S. setmaxnreg gives its registers to the
//     consumers (56 / 224 beside 168 at launch).
//   * Q loaded once a block, not once a key tile; each panel's A fragments
//     are read from it and split while the last panel's chain runs.
//   * 64-key tiles: S a chain of 12 wgmma m64n64k8 a 32-wide panel, the
//     panels added in f32 in order, as in the wide kernel; O in registers
//     (64 f32 a thread, a wgmma m64n128 accumulator), each tile's P V one
//     chain of 24 wgmma m64n128k8 from 0, added to O with its rescale in one
//     rounding. Against 32-key tiles (a variant in
//     kernels/attention_variants.py, with one or two K tiles in flight) a
//     tile's fixed costs (the Q fragments, the barriers, the softmax's
//     rescale of O) serve twice the keys, and a wgmma's B operand twice the
//     width.
//   * Shared memory at 64-key tiles: Q 64 KB, K's remainders 32 KB, V's
//     planes 64 KB, the rings 64 KB: 225 KB of the 227.
//   Two earlier arrangements of the same two warpgroups at 32-key tiles
//   (development runs on the H100, not kept): each warpgroup writing its own
//   remainder and transposed planes; and Q split once into two planes read
//   by descriptor, all four S chains in flight at once. Neither ran faster
//   than this design at 32-key tiles, though the second issued far fewer
//   instructions; 64-key tiles did (kernels/attention_variants.py, PERF.md
//   §6 row 4).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kRows = 64;         // queries a block: one wgmma m64 tile
constexpr int kPanel = 32;        // head dims a panel: one 128-byte swizzled f32 row
constexpr int kChunk = 64;        // head dims a chunk of O: one wgmma n64
constexpr int kMaxChunks = 8;     // chunks of O a block holds (512 head dims)
constexpr int kMaxRing = 6;       // ring stages, where they fit
constexpr int kConsumers = 128;   // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kQPanelBytes = kRows * 128;
constexpr int kOChunkBytes = kRows * kChunk * 4;
constexpr int kSmemLimit = 232448;  // 227 KB a block

// Shared memory at a key tile of TK keys, from a 1024-byte boundary: K's
// remainder planes (one a panel parity), V's transposed planes (raw, then
// remainders), the ring, then O (chunks x 16 KB) and the barriers.
template <int TK>
struct Layout {
    static constexpr int KPANEL = TK * 128;               // TK keys x 32 head dims
    static constexpr int STAGE = kQPanelBytes + KPANEL;   // Q and K panels, or a V chunk
    static constexpr int KSMALL = 0;
    // 64 head dims x TK keys, rows of at least 128 bytes (the swizzle's)
    static constexpr int VT_PLANE = kChunk * (TK < 32 ? 32 : TK) * 4;
    static constexpr int VT = KSMALL + 2 * KPANEL;
    static constexpr int RING = VT + 2 * VT_PLANE;
    static_assert(2 * KPANEL <= STAGE, "a V chunk fits a stage");
    static_assert(KPANEL % 1024 == 0 && STAGE % 1024 == 0 && VT_PLANE % 1024 == 0,
                  "swizzle atoms aligned");

    static int ring(int cps) {  // stages that fit beside cps chunks of O
        const int room = kSmemLimit - 1024 - 16 * kMaxRing - RING - cps * kOChunkBytes;
        return room / STAGE < kMaxRing ? room / STAGE : kMaxRing;
    }
    static int bytes(int cps, int ring) {
        return RING + ring * STAGE + cps * kOChunkBytes + 16 * ring + 1024;
    }
};

struct Params {
    float* out;       // (B, N, heads, D), written where splits == 1
    float* opart;     // [splits][B * heads][N][D] unnormalised O, where splits > 1
    float* ml;        // [splits][B * heads][N][2] running max and row sum, where splits > 1
    int n_tokens, heads, d;
    int panels;       // 32-wide panels of D, rounded up to an even count
    int chunks;       // 64-wide chunks of D
    int cps;          // chunks a slice
    int splits, tps;  // key splits and key tiles a split
    int ring;         // ring stages
    int qk_bytes;     // bytes of a Q and a K panel: their boxes stop at N rounded up to 8 rows
    float c2;         // scale * log2(e)
};

// x - trunc(x): what the tensor core does not read of x (exact in f32)
__device__ __forceinline__ float remainder_of(float x) {
    return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float4 remainder_of(float4 x) {
    return make_float4(remainder_of(x.x), remainder_of(x.y), remainder_of(x.z), remainder_of(x.w));
}

// generic-proxy stores to shared memory made visible to wgmma, then
// warpgroup w's barrier (named barrier 1 + w)
__device__ __forceinline__ void group_sync(int w) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kConsumers) : "memory");
}

template <int N>
struct Par {
    static constexpr int value = N;
};

template <int TK>
__global__ void __launch_bounds__(kThreads, 1)
attention_wide_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, Params p) {
    typedef Layout<TK> L;
    constexpr int SN = TK / 2;  // S accumulator floats a thread
    constexpr int KK = TK / 8;  // k8 steps of P V (and n8 blocks of S)
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const int R = p.ring;
    unsigned char* ring = smem + L::RING;
    float* osm = reinterpret_cast<float*>(ring + R * L::STAGE);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * L::STAGE + p.cps * kOChunkBytes);
    uint64_t* empty = full + R;

    const int slice = blockIdx.x;
    const int q0 = blockIdx.y * kRows;
    const int sp = blockIdx.z % p.splits;  // the key split
    const int bh = blockIdx.z / p.splits;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int n_tiles = (p.n_tokens + TK - 1) / TK;
    const int t0 = sp * p.tps;
    const int nt = max(0, min(n_tiles, t0 + p.tps) - t0);  // its key tiles (0: an empty split)
    const int c0 = slice * p.cps;
    const int nc = min(p.cps, p.chunks - c0);  // its chunks of O
    const int tid = threadIdx.x;
    // 0: the consumer warpgroup, 1: the producer warp (warp-uniform, as the
    // compiler sees it)
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
            for (int it = 0; it < nt; ++it) {
                const int key0 = (t0 + it) * TK;
                for (int pn = 0; pn < p.panels + nc; ++pn, ++i) {
                    const int slot = i % R;
                    if (i >= R) mbar_wait(&empty[slot], (i / R - 1) & 1);
                    unsigned char* st = ring + slot * L::STAGE;
                    if (pn < p.panels) {  // Q's and K's panel pn
                        mbar_expect_tx(&full[slot], p.qk_bytes);
                        tma_load(st, &tmq, pn * kPanel, q0, h, b, &full[slot]);
                        tma_load(st + kQPanelBytes, &tmk, pn * kPanel, key0, h, b, &full[slot]);
                    } else {  // V's two panels of chunk c
                        const int c = c0 + pn - p.panels;
                        mbar_expect_tx(&full[slot], 2 * L::KPANEL);
                        for (int j = 0; j < 2; ++j)
                            tma_load(st + j * L::KPANEL, &tmv, c * kChunk + j * kPanel, key0, h,
                                     b, &full[slot]);
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
    const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // columns 2t, 2t + 1 of each n8 block
    const uint32_t ring_sm = smem_addr(ring);
    const uint32_t ksmall_sm = smem_addr(smem + L::KSMALL);
    const uint32_t vt_sm = smem_addr(smem + L::VT);
    // this thread's O elements of chunk c: osm_t[c * 4096 + 32 e]
    float* osm_t = osm + warp * 32 * 32 + lane;
    for (int c = 0; c < nc; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) osm_t[c * 4096 + 32 * e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    int i = 0;  // ring item

#pragma unroll 1
    for (int it = 0; it < nt; ++it) {
        // ---- S = Q K^T over all of D: a chain of 12 wgmma a panel from 0,
        // the panels added in f32 in order. While a panel's chain runs, the
        // next panel's Q fragments are split into the other register set and
        // K's remainders written into the other plane; no accumulator is
        // touched while a chain is in flight (ptxas serializes the wgmma
        // otherwise).
        float s[SN];
#pragma unroll
        for (int e = 0; e < SN; ++e) s[e] = 0.f;
        float acc[SN];
        uint32_t qb[2][4][4], qs[2][4][4];
        auto load = [&](auto par, int pn) {  // panel pn's operands into set P
            constexpr int P = decltype(par)::value;
            const int slot = (i + pn) % R;
            mbar_wait(&full[slot], ((i + pn) / R) & 1);
            const unsigned char* st = ring + slot * L::STAGE;
            // Q's A fragments (rows 16 warp + g, + 8; head dims 8 kk + t, + 4
            // of the panel), split in registers
            const float* qp = reinterpret_cast<const float*>(st);
            const int r0 = 16 * warp + g;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int lo = (((2 * kk) ^ g) << 2) + t, hi = (((2 * kk + 1) ^ g) << 2) + t;
                split(qp[r0 * 32 + lo], qb[P][kk][0], qs[P][kk][0]);
                split(qp[(r0 + 8) * 32 + lo], qb[P][kk][1], qs[P][kk][1]);
                split(qp[r0 * 32 + hi], qb[P][kk][2], qs[P][kk][2]);
                split(qp[(r0 + 8) * 32 + hi], qb[P][kk][3], qs[P][kk][3]);
            }
            // K's remainders, at the raw panel's (swizzled) offsets
            const float4* kraw = reinterpret_cast<const float4*>(st + kQPanelBytes);
            float4* ksm = reinterpret_cast<float4*>(smem + L::KSMALL + P * L::KPANEL);
#pragma unroll
            for (int u = 0; u < L::KPANEL / 16 / kConsumers; ++u)
                ksm[tid + u * kConsumers] = remainder_of(kraw[tid + u * kConsumers]);
        };
        auto run = [&](auto par, int pn) {  // panel pn's chain, from set P
            constexpr int P = decltype(par)::value;
            group_sync(0);
            const uint32_t kr = ring_sm + ((i + pn) % R) * L::STAGE + kQPanelBytes;
            const uint32_t ks = ksmall_sm + P * L::KPANEL;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                wgmma_tf32(acc, qs[P][kk], desc_kmajor(kr + 32 * kk), kk > 0);
                wgmma_tf32(acc, qb[P][kk], desc_kmajor(ks + 32 * kk), 1);
                wgmma_tf32(acc, qb[P][kk], desc_kmajor(kr + 32 * kk), 1);
            }
            wgmma_commit();
        };
        auto retire = [&](int pn) {  // panel pn's chain added to S; its stage released
            wgmma_wait0();
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < SN; ++e) s[e] += acc[e];
            mbar_arrive_if(&empty[(i + pn) % R], tid == 0);
        };
        load(Par<0>(), 0);
#pragma unroll 1
        for (int pn = 0; pn < p.panels; pn += 2) {
            run(Par<0>(), pn);
            load(Par<1>(), pn + 1);
            retire(pn);
            run(Par<1>(), pn + 1);
            if (pn + 2 < p.panels) load(Par<0>(), pn + 2);
            retire(pn + 1);
        }
        i += p.panels;

        // ---- online softmax, f32, in the exp2 domain; s[4n + 2r + c] is
        // row g + 8r, key TK (t0 + it) + 8n + 2t + c, at -inf past N
        const int key0 = (t0 + it) * TK;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < SN; ++e) {
            const int key = key0 + 8 * (e / 4) + 2 * t + (e & 1);
            s[e] = key < p.n_tokens ? s[e] * p.c2 : -INFINITY;
            mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[e]);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
            corr[r] = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
        // P's A fragments: k index t <-> key 8kk + 2t, t + 4 <-> 8kk + 2t + 1
        uint32_t pb[KK][4], ps[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = exp2f(s[4 * kk + e] - m_run[e / 2]);
            l_run[0] += x[0] + x[1];
            l_run[1] += x[2] + x[3];
            split(x[0], pb[kk][0], ps[kk][0]);
            split(x[2], pb[kk][1], ps[kk][1]);
            split(x[1], pb[kk][2], ps[kk][2]);
            split(x[3], pb[kk][3], ps[kk][3]);
        }

        // ---- O += P V, a 64-wide chunk of the slice at a time
#pragma unroll 1
        for (int c = 0; c < nc; ++c, ++i) {
            const int slot = i % R;
            mbar_wait(&full[slot], (i / R) & 1);
            // V's chunk (two panels of TK keys x 32 head dims, swizzled) into
            // Vt: rows of head dims n, keys along the row in the order of P's
            // k indices (key 8j + 2a + b at 8j + a + 4b), raw and remainders
            const float* vraw = reinterpret_cast<const float*>(ring + slot * L::STAGE);
#pragma unroll
            for (int u = 0; u < kChunk * TK / 4 / kConsumers; ++u) {
                const int task = tid + u * kConsumers;
                const int n = task % kChunk;    // a warp's lanes take 32 head dims
                const int j = task / kChunk / 2, bb = (task / kChunk) & 1;
                const int col = n & 31;
                const float* src = vraw + (n >> 5) * TK * 32;
                float xs[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const int key = 8 * j + 2 * a + bb;
                    xs[a] = src[key * 32 + (((col >> 2) ^ (key & 7)) << 2) + (col & 3)];
                }
                const float4 x = make_float4(xs[0], xs[1], xs[2], xs[3]);
                const int kpos = 8 * j + 4 * bb;
                const int off = (kpos >> 5) * kChunk * 128 + n * 128 +
                                ((((kpos & 31) >> 2) ^ (n & 7)) << 4);
                *reinterpret_cast<float4*>(smem + L::VT + off) = x;
                *reinterpret_cast<float4*>(smem + L::VT + L::VT_PLANE + off) = remainder_of(x);
            }
            group_sync(0);
            mbar_arrive_if(&empty[slot], tid == 0);  // the raw chunk is read
            float pv[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
                const uint32_t vr = vt_sm + (kk / 4) * kChunk * 128 + 32 * (kk % 4);
                wgmma_tf32(pv, ps[kk], desc_kmajor(vr), kk > 0);
                wgmma_tf32(pv, pb[kk], desc_kmajor(vr + L::VT_PLANE), 1);
                wgmma_tf32(pv, pb[kk], desc_kmajor(vr), 1);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(pv);
            // O = O corr + this tile's P V, one rounding
            float* oc = osm_t + c * 4096;
#pragma unroll
            for (int e = 0; e < 32; ++e) oc[32 * e] = fmaf(oc[32 * e], corr[(e / 2) & 1], pv[e]);
        }
    }

    // ---- epilogue: O element e of chunk c is row 16 warp + g + 8 ((e / 2) &
    // 1), head dim 64 (c0 + c) + 8 (e / 4) + 2t + (e & 1)
    const long long BH = (long long)gridDim.z / p.splits;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        const int row = q0 + 16 * warp + g + 8 * r;
        if (row >= p.n_tokens) continue;
        const long long prow = ((long long)sp * BH + bh) * p.n_tokens + row;
        const float inv = 1.0f / l;
        float* dst = p.splits == 1
                         ? p.out + (((long long)b * p.n_tokens + row) * p.heads + h) * p.d
                         : p.opart + prow * p.d;
        for (int c = 0; c < nc; ++c)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const int col = (c0 + c) * kChunk + 8 * n + 2 * t;
                if (col >= p.d) continue;
                const float x0 = osm_t[c * 4096 + 32 * (4 * n + 2 * r)];
                const float x1 = osm_t[c * 4096 + 32 * (4 * n + 2 * r + 1)];
                *reinterpret_cast<float2*>(dst + col) =
                    p.splits == 1 ? make_float2(x0 * inv, x1 * inv) : make_float2(x0, x1);
            }
        if (p.splits > 1 && slice == 0 && t == 0)
            *reinterpret_cast<float2*>(p.ml + 2 * prow) = make_float2(m_run[r], l);
    }
}

// out = sum_s w_s O_s / sum_s w_s l_s over the splits in split order, w_s =
// exp2(m_s - max m); a split with no key (m_s = -inf, O_s = 0) has weight 0.
// A thread takes 4 head dims of a row.
__global__ void attention_wide_combine(const float* __restrict__ opart,
                                       const float* __restrict__ ml, float* __restrict__ out,
                                       int splits, int n_tokens, int heads, int d) {
    const int bh = blockIdx.y;
    const int per_row = d / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = e / per_row;
    if (row >= n_tokens) return;
    const int col = (e % per_row) * 4;
    const long long BH = (long long)gridDim.y;
    float m_max = -INFINITY;
    for (int s = 0; s < splits; ++s)
        m_max = fmaxf(m_max, ml[2 * ((s * BH + bh) * n_tokens + row)]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
        const long long prow = (s * BH + bh) * n_tokens + row;
        const float2 m_l = *reinterpret_cast<const float2*>(ml + 2 * prow);
        const float w = m_l.x == -INFINITY ? 0.f : exp2f(m_l.x - m_max);
        L = __fmaf_rn(w, m_l.y, L);
        const float4 x = *reinterpret_cast<const float4*>(opart + prow * d + col);
        acc = make_float4(__fmaf_rn(w, x.x, acc.x), __fmaf_rn(w, x.y, acc.y),
                          __fmaf_rn(w, x.z, acc.z), __fmaf_rn(w, x.w, acc.w));
    }
    const float inv = 1.0f / L;
    const int b = bh / heads, h = bh % heads;
    *reinterpret_cast<float4*>(out + (((long long)b * n_tokens + row) * heads + h) * d + col) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// encode_qkv through a small per-thread cache keyed by every argument: a
// map is a function of them alone, and a UNet forward meets the same
// pointers, shapes and strides at every step (the caching allocator hands
// the same addresses back), so most calls skip the driver's encoding.
bool encode_cached(CUtensorMap* map, const void* base, int B, int n_tokens, int heads, int d,
                   long long sb, long long sn, long long sh, int rows) {
    struct Key {
        const void* base;
        long long sb, sn, sh;
        int B, n_tokens, heads, d, rows;
        bool operator==(const Key& o) const {
            return base == o.base && sb == o.sb && sn == o.sn && sh == o.sh && B == o.B &&
                   n_tokens == o.n_tokens && heads == o.heads && d == o.d && rows == o.rows;
        }
    };
    struct Entry {
        Key key;
        CUtensorMap map;
        bool valid;
    };
    constexpr int kEntries = 8;
    thread_local Entry cache[kEntries] = {};
    thread_local int next = 0;
    const Key key = {base, sb, sn, sh, B, n_tokens, heads, d, rows};
    for (int e = 0; e < kEntries; ++e)
        if (cache[e].valid && cache[e].key == key) {
            *map = cache[e].map;
            return true;
        }
    if (!encode_qkv(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, n_tokens, heads, d, sb, sn,
                    sh, rows))
        return false;
    cache[next] = {key, *map, true};
    next = (next + 1) % kEntries;
    return true;
}

template <int TK>
int launch(const void* q, const void* k, const void* v, Params p, int B, int slices,
           long long sb, long long sn, long long sh, cudaStream_t st) {
    typedef Layout<TK> L;
    p.ring = L::ring(p.cps);
    if (p.ring < 2) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_wide_kernel<TK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (attr != cudaSuccess) return (int)attr;
    // Q's and K's boxes stop at N rounded up to 8 rows, where N is below a
    // tile: the rows past them hold stale data, which reaches only queries
    // past N (not stored) and keys past N (at -inf before the softmax). V's
    // box stays whole: its zeros past N meet P's zeros there.
    const int n8 = (p.n_tokens + 7) / 8 * 8;
    const int q_rows = n8 < kRows ? n8 : kRows, k_rows = n8 < TK ? n8 : TK;
    p.qk_bytes = (q_rows + k_rows) * 128;
    CUtensorMap tq, tk, tv;
    if (!encode_cached(&tq, q, B, p.n_tokens, p.heads, p.d, sb, sn, sh, q_rows) ||
        !encode_cached(&tk, k, B, p.n_tokens, p.heads, p.d, sb, sn, sh, k_rows) ||
        !encode_cached(&tv, v, B, p.n_tokens, p.heads, p.d, sb, sn, sh, TK))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(slices, (p.n_tokens + kRows - 1) / kRows, B * p.heads * p.splits);
    attention_wide_kernel<TK><<<grid, kThreads, L::bytes(p.cps, p.ring), st>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}


// ---- The D = 128 kernel (attention_d128_kernel; design at the top of this
// file): two consumer warpgroups of 64 queries each share one stream of K and
// V tiles, which the producer warpgroup loads and prepares for both.

constexpr int kD128 = 128;
constexpr int kD128Panels = kD128 / kPanel;  // 32-wide panels of S (4)
constexpr int kD128Keys = 64;                // keys a tile
constexpr int kD128Groups = 2;               // consumer warpgroups: 128 queries a block
constexpr int kD128Threads = (kD128Groups + 1) * kConsumers;  // and the producer warpgroup
constexpr int kD128KRing = 1;                // K tiles in flight
constexpr int kD128VRing = 1;                // V tiles in flight
// setmaxnreg: 168 a thread at launch; the producer's 56 leave the consumers 224
constexpr int kD128ProducerRegs = 56;
constexpr int kD128ConsumerRegs = 224;
static_assert(kD128ProducerRegs * kConsumers + kD128ConsumerRegs * kD128Groups * kConsumers <=
                  168 * kD128Threads,
              "the consumers take only what the producer gives");

// Shared memory of a block, from a 1024-byte boundary: each consumer
// warpgroup's Q (4 panels, as TMA lands them); K's remainder plane and V's
// transposed planes (raw, then remainders) of the tile in flight, written by
// the producer warpgroup for both; the rings of raw K and V tiles; the
// barriers.
struct D128Layout {
    static constexpr int KPANEL = kD128Keys * 128;      // a tile's keys x 32 head dims
    static constexpr int TILE = kD128Panels * KPANEL;   // a K or a V tile
    static constexpr int QPLANE = kD128Panels * kQPanelBytes;  // 64 queries x 128 head dims
    static constexpr int Q = 0;                         // [group]
    static constexpr int KSMALL = Q + kD128Groups * QPLANE;
    static constexpr int VT_PLANE = kD128 * kD128Keys * 4;  // 128 head dims x a tile's keys
    static constexpr int VT = KSMALL + TILE;
    static constexpr int KRING = VT + 2 * VT_PLANE;
    static constexpr int VRING = KRING + kD128KRing * TILE;
    static constexpr int BARS = VRING + kD128VRing * TILE;
    // qbar, kfull[kD128KRing], vfull[kD128VRing], kready, vready, kfree, vfree
    static constexpr int BYTES = BARS + 8 * (5 + kD128KRing + kD128VRing) + 1024;
    static_assert(BYTES <= kSmemLimit, "227 KB of shared memory a block");
    static_assert(KPANEL % 1024 == 0 && VT % 1024 == 0 && KRING % 1024 == 0,
                  "swizzle atoms aligned");
};

struct D128Params {
    float* out;       // (B, N, heads, 128), written where splits == 1
    float* opart;     // [splits][B * heads][N][128] unnormalised O, where splits > 1
    float* ml;        // [splits][B * heads][N][2] running max and row sum, where splits > 1
    int n_tokens, heads;
    int splits, tps;  // key splits and key tiles a split
    int q_bytes;      // bytes of the block's Q: its boxes stop at N rounded up to 8 rows
    int k_bytes;      // bytes of a K tile: likewise
    float c2;         // scale * log2(e)
};

__global__ void __launch_bounds__(kD128Threads, 1)
attention_d128_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, D128Params p) {
    typedef D128Layout L;
    constexpr int TK = kD128Keys;
    constexpr int SN = TK / 2;  // S accumulator floats a thread, a panel
    constexpr int KK = TK / 8;  // k8 steps of P V (and n8 blocks of S)
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
    uint64_t* kfull = qbar + 1;             // a raw K tile landed
    uint64_t* vfull = kfull + kD128KRing;   // a raw V tile landed
    uint64_t* kready = vfull + kD128VRing;  // K's remainder plane written
    uint64_t* vready = kready + 1;          // V's transposed planes written
    uint64_t* kfree = vready + 1;           // both warpgroups' S done with K's tile and plane
    uint64_t* vfree = kfree + 1;            // both warpgroups' P V done with V's planes

    const int q0 = blockIdx.x * (kD128Groups * kRows);
    const int sp = blockIdx.y % p.splits;  // the key split
    const int bh = blockIdx.y / p.splits;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int n_tiles = (p.n_tokens + TK - 1) / TK;
    const int t0 = sp * p.tps;
    const int nt = max(0, min(n_tiles, t0 + p.tps) - t0);  // its key tiles (0: an empty split)
    const int tid = threadIdx.x;
    // 0, 1: a consumer warpgroup, 2: the producer warpgroup (warp-uniform, as
    // the compiler sees it)
    const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);

    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int i = 0; i < kD128KRing; ++i) mbar_init(&kfull[i], 1);
        for (int i = 0; i < kD128VRing; ++i) mbar_init(&vfull[i], 1);
        mbar_init(kready, 1);
        mbar_init(vready, 1);
        mbar_init(kfree, kD128Groups);
        mbar_init(vfree, kD128Groups);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (role == kD128Groups) {
        // ---- producer warpgroup: one thread issues the TMA loads (Q once, K
        // and V tiles into their rings); all 128 write, for each key tile,
        // K's remainders once both consumers' S of the last tile is done, and
        // V's transposed planes once both consumers' P V of the last tile is
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kD128ProducerRegs));
        const int ptid = tid - kD128Groups * kConsumers;
        const bool leader = ptid == 0;
        auto load = [&](int j, bool is_v) {  // key tile j's K or V into its slot
            const int slot = is_v ? j % kD128VRing : j % kD128KRing;
            uint64_t* bar = is_v ? &vfull[slot] : &kfull[slot];
            unsigned char* st = smem + (is_v ? L::VRING : L::KRING) + slot * L::TILE;
            mbar_expect_tx(bar, is_v ? L::TILE : p.k_bytes);
            for (int pn = 0; pn < kD128Panels; ++pn)
                tma_load(st + pn * L::KPANEL, is_v ? &tmv : &tmk, pn * kPanel, (t0 + j) * TK, h,
                         b, bar);
        };
        if (leader && nt > 0) {
            mbar_expect_tx(qbar, p.q_bytes);
            for (int w = 0; w < kD128Groups; ++w)
                for (int pn = 0; pn < kD128Panels; ++pn)
                    tma_load(smem + L::Q + w * L::QPLANE + pn * kQPanelBytes, &tmq,
                             pn * kPanel, q0 + w * kRows, h, b, qbar);
            for (int j = 0; j < kD128KRing && j < nt; ++j) load(j, false);
            for (int j = 0; j < kD128VRing && j < nt; ++j) load(j, true);
        }
#pragma unroll 1
        for (int it = 0; it < nt; ++it) {
            // K's remainders (the raw tile's slot of tile it - 1 then takes
            // tile it - 1 + kD128KRing)
            if (it > 0) {
                mbar_wait(kfree, (it - 1) & 1);
                if (leader && it - 1 + kD128KRing < nt) load(it - 1 + kD128KRing, false);
            }
            mbar_wait(&kfull[it % kD128KRing], (it / kD128KRing) & 1);
            const float4* kraw =
                reinterpret_cast<const float4*>(smem + L::KRING + (it % kD128KRing) * L::TILE);
            float4* ksm = reinterpret_cast<float4*>(smem + L::KSMALL);
#pragma unroll 4
            for (int u = 0; u < L::TILE / 16 / kConsumers; ++u)
                ksm[ptid + u * kConsumers] = remainder_of(kraw[ptid + u * kConsumers]);
            group_sync(kD128Groups);
            mbar_arrive_if(kready, leader);

            // V's tile (4 panels of TK keys x 32 head dims, swizzled) into
            // Vt: rows of head dims n, keys along the row in the order of P's
            // k indices (key 8j + 2a + b at 8j + a + 4b), raw and remainders
            if (it > 0) mbar_wait(vfree, (it - 1) & 1);
            const int vslot = it % kD128VRing;
            mbar_wait(&vfull[vslot], (it / kD128VRing) & 1);
            const float* vraw = reinterpret_cast<const float*>(smem + L::VRING + vslot * L::TILE);
#pragma unroll 2
            for (int u = 0; u < kD128 * TK / 4 / kConsumers; ++u) {
                const int task = ptid + u * kConsumers;
                const int n = task % kD128;  // a warp's lanes take 32 head dims
                const int j = task / kD128 / 2, bb = (task / kD128) & 1;
                const int col = n & 31;
                const float* src = vraw + (n >> 5) * TK * 32;
                float xs[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const int key = 8 * j + 2 * a + bb;
                    xs[a] = src[key * 32 + (((col >> 2) ^ (key & 7)) << 2) + (col & 3)];
                }
                const float4 x = make_float4(xs[0], xs[1], xs[2], xs[3]);
                const int kpos = 8 * j + 4 * bb;
                const int off = (kpos >> 5) * kD128 * 128 + n * 128 +
                                ((((kpos & 31) >> 2) ^ (n & 7)) << 4);
                *reinterpret_cast<float4*>(smem + L::VT + off) = x;
                *reinterpret_cast<float4*>(smem + L::VT + L::VT_PLANE + off) = remainder_of(x);
            }
            group_sync(kD128Groups);
            mbar_arrive_if(vready, leader);
            if (leader && it + kD128VRing < nt) load(it + kD128VRing, true);  // the raw tile is read
        }
        return;
    }

    // ---- consumers: warpgroup w, query rows q0 + 64 w ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kD128ConsumerRegs));
    const int w = role;
    const int ctid = tid - w * kConsumers;
    const int warp = ctid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // columns 2t, 2t + 1 of each n8 block
    const float* qsm = reinterpret_cast<const float*>(smem + L::Q + w * L::QPLANE);
    // O, 64 rows x 128 head dims: element e is row 16 warp + g + 8 ((e / 2) &
    // 1), head dim 8 (e / 4) + 2t + (e & 1), as a wgmma m64n128 accumulator
    float o[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    if (nt > 0) mbar_wait(qbar, 0);
    const uint32_t kring_sm = smem_addr(smem + L::KRING);
    const uint32_t ksmall_sm = smem_addr(smem + L::KSMALL);
    const uint32_t vt_sm = smem_addr(smem + L::VT);

#pragma unroll 1
    for (int it = 0; it < nt; ++it) {
        // ---- S = Q K^T: a chain of 12 wgmma a 32-wide panel from 0, the
        // panels added in f32 in order. While a panel's chain runs, the next
        // panel's Q fragments are read and split into the other register set;
        // no accumulator is touched while a chain is in flight.
        mbar_wait(kready, it & 1);
        const uint32_t kr = kring_sm + (it % kD128KRing) * L::TILE;
        float s[SN];
#pragma unroll
        for (int e = 0; e < SN; ++e) s[e] = 0.f;
        float acc[SN];
        uint32_t qb[2][4][4], qs[2][4][4];
        auto load = [&](auto par, int pn) {  // panel pn's Q fragments into set P
            constexpr int P = decltype(par)::value;
            // rows 16 warp + g, + 8; head dims 8 kk + t, + 4 of the panel
            const float* qp = qsm + pn * (kQPanelBytes / 4);
            const int r0 = 16 * warp + g;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int lo = (((2 * kk) ^ g) << 2) + t, hi = (((2 * kk + 1) ^ g) << 2) + t;
                split(qp[r0 * 32 + lo], qb[P][kk][0], qs[P][kk][0]);
                split(qp[(r0 + 8) * 32 + lo], qb[P][kk][1], qs[P][kk][1]);
                split(qp[r0 * 32 + hi], qb[P][kk][2], qs[P][kk][2]);
                split(qp[(r0 + 8) * 32 + hi], qb[P][kk][3], qs[P][kk][3]);
            }
        };
        auto run = [&](auto par, int pn) {  // panel pn's chain, from set P
            constexpr int P = decltype(par)::value;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t ko = pn * L::KPANEL + 32 * kk;
                wgmma_tf32(acc, qs[P][kk], desc_kmajor(kr + ko), kk > 0);
                wgmma_tf32(acc, qb[P][kk], desc_kmajor(ksmall_sm + ko), 1);
                wgmma_tf32(acc, qb[P][kk], desc_kmajor(kr + ko), 1);
            }
            wgmma_commit();
        };
        auto retire = [&]() {  // the chain in flight added to S
            wgmma_wait0();
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < SN; ++e) s[e] += acc[e];
        };
        load(Par<0>(), 0);
#pragma unroll
        for (int pn = 0; pn < kD128Panels; pn += 2) {
            run(Par<0>(), pn);
            load(Par<1>(), pn + 1);
            retire();
            run(Par<1>(), pn + 1);
            if (pn + 2 < kD128Panels) load(Par<0>(), pn + 2);
            retire();
        }
        mbar_arrive_if(kfree, ctid == 0);

        // ---- online softmax, f32, in the exp2 domain; s[4n + 2r + c] is
        // row g + 8r, key TK (t0 + it) + 8n + 2t + c, at -inf past N
        const int key0 = (t0 + it) * TK;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < SN; ++e) {
            const int key = key0 + 8 * (e / 4) + 2 * t + (e & 1);
            s[e] = key < p.n_tokens ? s[e] * p.c2 : -INFINITY;
            mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[e]);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
            corr[r] = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
        // P's A fragments: k index t <-> key 8kk + 2t, t + 4 <-> 8kk + 2t + 1
        uint32_t pb[KK][4], ps[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = exp2f(s[4 * kk + e] - m_run[e / 2]);
            l_run[0] += x[0] + x[1];
            l_run[1] += x[2] + x[3];
            split(x[0], pb[kk][0], ps[kk][0]);
            split(x[2], pb[kk][1], ps[kk][1]);
            split(x[1], pb[kk][2], ps[kk][2]);
            split(x[3], pb[kk][3], ps[kk][3]);
        }

        // ---- O += P V: one chain of 3 TK / 8 wgmma m64n128 from 0, added to
        // O with its rescale in one rounding
        mbar_wait(vready, it & 1);
        float pv[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            const uint32_t vr = vt_sm + (kk / 4) * kD128 * 128 + 32 * (kk % 4);
            wgmma_tf32(pv, ps[kk], desc_kmajor(vr), kk > 0);
            wgmma_tf32(pv, pb[kk], desc_kmajor(vr + L::VT_PLANE), 1);
            wgmma_tf32(pv, pb[kk], desc_kmajor(vr), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pv);
        mbar_arrive_if(vfree, ctid == 0);
#pragma unroll
        for (int e = 0; e < 64; ++e) o[e] = fmaf(o[e], corr[(e / 2) & 1], pv[e]);
    }

    // ---- epilogue: row 16 warp + g + 8r of the warpgroup's 64
    const long long BH = (long long)gridDim.y / p.splits;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        const int row = q0 + w * kRows + 16 * warp + g + 8 * r;
        if (row >= p.n_tokens) continue;
        const long long prow = ((long long)sp * BH + bh) * p.n_tokens + row;
        const float inv = 1.0f / l;
        float* dst = p.splits == 1
                         ? p.out + (((long long)b * p.n_tokens + row) * p.heads + h) * kD128
                         : p.opart + prow * kD128;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
            const float x0 = o[4 * n + 2 * r], x1 = o[4 * n + 2 * r + 1];
            *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
                p.splits == 1 ? make_float2(x0 * inv, x1 * inv) : make_float2(x0, x1);
        }
        if (p.splits > 1 && t == 0)
            *reinterpret_cast<float2*>(p.ml + 2 * prow) = make_float2(m_run[r], l);
    }
}

int launch_d128(const void* q, const void* k, const void* v, D128Params p, int B, long long sb,
                long long sn, long long sh, cudaStream_t st) {
    typedef D128Layout L;
    constexpr int TK = kD128Keys;
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    // Q's and K's boxes stop at N rounded up to 8 rows where N is below a
    // tile, as in the wide kernel; V's box stays whole
    const int n8 = (p.n_tokens + 7) / 8 * 8;
    const int q_rows = n8 < kRows ? n8 : kRows, k_rows = n8 < TK ? n8 : TK;
    p.q_bytes = kD128Groups * kD128Panels * q_rows * 128;
    p.k_bytes = kD128Panels * k_rows * 128;
    CUtensorMap tq, tk, tv;
    if (!encode_cached(&tq, q, B, p.n_tokens, p.heads, kD128, sb, sn, sh, q_rows) ||
        !encode_cached(&tk, k, B, p.n_tokens, p.heads, kD128, sb, sn, sh, k_rows) ||
        !encode_cached(&tv, v, B, p.n_tokens, p.heads, kD128, sb, sn, sh, TK))
        return (int)cudaErrorInvalidValue;
    const int rows = kD128Groups * kRows;
    const dim3 grid((p.n_tokens + rows - 1) / rows, B * p.heads * p.splits);
    attention_d128_kernel<<<grid, kD128Threads, L::BYTES, st>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, heads, D) f32 views sharing the element strides (sb, sn,
// sh), unit stride on the last dim, strides multiples of 4, 16-byte aligned;
// out: (B, N, heads, D) contiguous f32. D a multiple of 4 in (128, 1024], any
// N >= 1. key_tile: keys a tile, 16, 32 or 64; `splits` key splits (1 ...
// ceil(N / key_tile)); `slices` slices of O's 64-wide head-dim chunks, each
// of at most 8 chunks, none empty. Scratch, where splits > 1: opart holds
// splits * B * heads * N * D floats and ml splits * B * heads * N * 2; else
// both may be null. Returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int attention_f32_wide(const void* q, const void* k, const void* v, void* out,
                                  void* opart, void* ml, int B, int n_tokens, int heads, int d,
                                  long long sb, long long sn, long long sh, float scale,
                                  int key_tile, int splits, int slices, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int chunks = (d + kChunk - 1) / kChunk;
    const int n_tiles = key_tile > 0 ? (n_tokens + key_tile - 1) / key_tile : 0;
    const int cps = slices > 0 ? (chunks + slices - 1) / slices : 0;
    if (d <= 128 || d > 1024 || d % 4 || n_tokens < 1 ||
        (key_tile != 16 && key_tile != 32 && key_tile != 64) ||
        splits < 1 || splits > n_tiles || slices < 1 || cps > kMaxChunks ||
        (slices - 1) * cps >= chunks || (splits > 1 && (!opart || !ml)))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.out = static_cast<float*>(out);
    p.opart = static_cast<float*>(opart);
    p.ml = static_cast<float*>(ml);
    p.n_tokens = n_tokens;
    p.heads = heads;
    p.d = d;
    p.panels = 2 * ((d + 2 * kPanel - 1) / (2 * kPanel));
    p.chunks = chunks;
    p.cps = cps;
    p.splits = splits;
    p.tps = (n_tiles + splits - 1) / splits;
    p.c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    const int err = key_tile == 16   ? launch<16>(q, k, v, p, B, slices, sb, sn, sh, st)
                    : key_tile == 32 ? launch<32>(q, k, v, p, B, slices, sb, sn, sh, st)
                                     : launch<64>(q, k, v, p, B, slices, sb, sn, sh, st);
    if (err != 0 || splits == 1) return err;
    const int threads = 128;
    const dim3 grid((n_tokens * (d / 4) + threads - 1) / threads, B * heads);
    attention_wide_combine<<<grid, threads, 0, st>>>(p.opart, p.ml, p.out, splits, n_tokens,
                                                     heads, d);
    return (int)cudaGetLastError();
}

// q, k, v: (B, N, heads, 128) f32 views sharing the element strides (sb, sn,
// sh), unit stride on the last dim, strides multiples of 4, 16-byte aligned;
// out: (B, N, heads, 128) contiguous f32. Any N >= 1. `splits` key splits (1
// ... ceil(N / 64), of 64-key tiles). Scratch, where splits > 1: opart holds
// splits * B * heads * N * 128 floats and ml splits * B * heads * N * 2; else
// both may be null. Returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int attention_f32_d128(const void* q, const void* k, const void* v, void* out,
                                  void* opart, void* ml, int B, int n_tokens, int heads,
                                  long long sb, long long sn, long long sh, float scale,
                                  int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (n_tokens + kD128Keys - 1) / kD128Keys;
    if (n_tokens < 1 || splits < 1 || splits > n_tiles || (splits > 1 && (!opart || !ml)))
        return (int)cudaErrorInvalidValue;
    D128Params p;
    p.out = static_cast<float*>(out);
    p.opart = static_cast<float*>(opart);
    p.ml = static_cast<float*>(ml);
    p.n_tokens = n_tokens;
    p.heads = heads;
    p.splits = splits;
    p.tps = (n_tiles + splits - 1) / splits;
    p.c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    const int err = launch_d128(q, k, v, p, B, sb, sn, sh, st);
    if (err != 0 || splits == 1) return err;
    const int threads = 128;
    const dim3 grid((n_tokens * (kD128 / 4) + threads - 1) / threads, B * heads);
    attention_wide_combine<<<grid, threads, 0, st>>>(p.opart, p.ml, p.out, splits, n_tokens,
                                                     heads, kD128);
    return (int)cudaGetLastError();
}
