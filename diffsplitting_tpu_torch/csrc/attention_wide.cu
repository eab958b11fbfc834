// Spatial self-attention softmax(q k^T * scale) v in float32 at wide head
// dims, for sm_90a, on the TF32 tensor cores through wgmma at float32
// accuracy (3xTF32, below): attention_wide_kernel at D a multiple of 4 in
// (128, 1024]; any N >= 1. attention.cu takes D up to 128 (its kernel keeps
// this file's arithmetic); attention_bf16.cu takes bf16; attention_f32.cuh
// holds what the two f32 sources share (the combine, the cached maps).
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`, :60) above D = 128: the mid block and 16² sites of
//   sr_sr3_16_128 and sr_ddpm_16_128 (D = 512), sample_ddpm_128's mid block
//   (D = 256), sr_sr3_64_512's mid block in f32 (D = 1024), and any other D
//   (192 at inner 24 x 8, 320 at inner 40 x 8, ...).
//
// Bound: operations. Each f32 product is three TF32 tensor-core products, so
//   the two products take 3 * 4 * N^2 * D TF32 flops a (batch, head) at 495
//   TFLOP/s dense, against 16 * N * D bytes of q, k, v and out at 3.35 TB/s:
//   0.0008 ms at sr_sr3_16_128's 16² sites at batch 1 (N = 256, D = 512).
//   At such small shapes a kernel is bound by its latency and by how many
//   SMs it keeps busy, not by either rate.
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

#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "tf32x3.cuh"

namespace {

// a block: one consumer warpgroup of kRows queries (attention_f32.cuh)
constexpr int kChunk = 64;        // head dims a chunk of O: one wgmma n64
constexpr int kMaxChunks = 8;     // chunks of O a block holds (512 head dims)
constexpr int kMaxRing = 6;       // ring stages, where they fit
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kOChunkBytes = kRows * kChunk * 4;

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
    return combine_splits(p.opart, p.ml, p.out, splits, B, n_tokens, heads, d, st);
}
