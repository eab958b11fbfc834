// Spatial self-attention softmax(q k^T * scale) v in float32 at head dims up
// to 128, for sm_90a, on the TF32 tensor cores through wgmma at float32
// accuracy (3xTF32, as attention_wide.cu's notes set out):
// attention_f32_kernel<DP, TK, NG> at D = 128 (entry attention_f32_d128) and
// at any multiple of 4 below it (entry attention_f32_narrow); any N >= 1.
// attention_wide.cu takes D above 128, attention_bf16.cu bf16.
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`, :60): at D = 128 the mid block of the splitting UNet
//   (Hagen configs: N = 4096 at a 512² patch, batch 1 in the t-refinement's
//   one-step inversions, 4 in training, 8 in serving; N = 16 in
//   splitting_cifar10_indi) and of the time predictor; below 128 the mid
//   block of a UNet whose last width is below 128 (the splitting UNet at
//   inner 8 attends at D = 64, at inner 12 at D = 96; D = 16 in the parity
//   tests).
//
// Bound: operations, 3 * 4 * N^2 * D TF32 flops a (batch, head) at 495
//   TFLOP/s (3xTF32), counted at the true D: 0.0521 ms at the Hagen mid
//   block at batch 1 (N = 4096, D = 128), 0.4165 at batch 8; 0.0130 at B =
//   8, N = 1024, D = 64 and 0.2082 at N = 4096. The tensor cores work on DP,
//   so the padding adds DP / D - 1 to that work. Below D = 128 the softmax
//   weighs more: B * N^2 exp2 a head at 16 a clock an SM (kernels/variants.py
//   `exp2_ms`: 0.0321 ms at N = 4096, B = 8 on the H100), beside 12 D TF32
//   flops a score; the bound is the larger of the two.
//
// Design. One kernel, a template over the padded head dim DP = 32 ceil(D /
// 32) in {32, 64, 96, 128} (each 32-wide panel one 128-byte TMA box), the
// keys a tile TK in {16, 32, 64} and the consumer warpgroups NG in {1, 2}
// (3 in a variant, kernels/attention_variants.py). Its D = 128 instance, <128, 64, 2>, is the kernel that
// attention_wide.cu held since commit 1ab4dcc (a Hopper redesign of the
// 3xTF32 mma.sync kernel that this file held until commit 1e56b1a, 8 warps
// of 16 queries a block, which ran the Hagen mid block in 0.6081 ms at
// batch 1 on 32 blocks and 1.2204 at batch 8 on an H100 80GB HBM3 at 700 W:
// 8.6 % and 34 % of its bound), with its order of sums and so its bits.
// Below 128 it replaces this file's 3xTF32 mma.sync kernel of commit
// 2357aaa (64 queries a block, cp.async, each warp splitting the whole K and
// V tile into TF32 halves again; 15-34 % of its bound). Keys split across
// blocks by ops/attention.py `d128_plan` and `narrow_plan`, which also picks
// TK and NG by N.
//   * Blocks. NG consumer warpgroups of 64 queries share one stream of K
//     and V tiles (128 queries a block at NG = 2: half the K and V bytes a
//     query of a 64-query block), so that one warpgroup's softmax and splits
//     run while the other's wgmma do. One warpgroup up to N = 128: twice
//     the blocks, and at N <= 64 a second would hold no query. With more
//     than one split each split writes its
//     f32 m, l and unnormalised O to scratch and attention_wide_combine
//     (attention_f32.cuh) adds the splits in split order.
//   * A producer warpgroup prepares each key tile once for all consumers:
//     one thread issues the TMA loads (Q once a block; K and V tiles of DP /
//     32 boxes into rings of two tiles each where they fit, else one), and
//     all 128 write K's remainder plane and V's transposed planes (raw,
//     remainders), then hand them over on mbarriers (kready, vready; kfree
//     and vfree back once every consumer's wgmma that read them completed).
//     The planes are single-buffered: K's of the next tile is written while
//     the consumers run P V, V's while they run S. At NG = 2 setmaxnreg gives
//     the producer's registers to the consumers (56 / 224 beside 168 at
//     launch).
//   * Loads. The TMA maps zero-fill past D and past N (no bounds predicate
//     on a load); Q's and K's boxes stop at N rounded up to 8 rows where N is
//     below a tile: the stale rows past them reach only queries past N (not
//     stored) and keys past N (at -inf before the softmax). V's box stays
//     whole: its zeros past N meet P's zeros there. Q loaded once a block;
//     each panel's A fragments are read from it and split while the last
//     panel's chain runs.
//   * Sums (the accumulator rounds toward zero): S is DP / 32 chains of 12
//     wgmma m64nTKk8 (one a 32-wide panel) from 0, the panels added in f32
//     in order; O in registers (DP / 2 f32 a thread, a wgmma m64nDP
//     accumulator), each tile's P V one chain of 3 TK / 8 wgmma m64nDPk8
//     from 0, added to O with its rescale in one rounding. Zero columns past
//     D add exactly 0 to S, and O's columns past D are not stored.
//   * Tiles. 64 keys above N = 128: a tile's fixed costs (the Q fragments,
//     the barriers, the softmax's rescale of O) serve twice the keys of a
//     32-key tile, and a wgmma's B operand twice the width; up to N = 128
//     32-key tiles, whose more, shorter splits fill more SMs; at N <= 16 one
//     16-key tile (m64n16 S chains, two k8 steps of P V), where a 64-key
//     tile would be three quarters zeros.
//   * Shared memory at <128, 64, 2>: Q 64 KB, K's remainders 32 KB, V's
//     planes 64 KB, the rings 64 KB: 225 KB of the 227; at DP = 64 the same
//     with rings of two: 144 KB.
//   * No atomics and no state kept between calls: two launches, and a
//     CUDA-graph replay, give the same bits.
//   Two earlier arrangements of the two warpgroups at D = 128 and 32-key
//   tiles (development runs on the H100, not kept): each warpgroup writing
//   its own remainder and transposed planes; and Q split once into two
//   planes read by descriptor, all four S chains in flight at once. Neither
//   ran faster than this design at 32-key tiles, though the second issued
//   far fewer instructions; 64-key tiles did (kernels/attention_variants.py,
//   PERF.md §6 row 4). tests/test_torch_port_attention_split.py emulates the
//   order of sums and the split of the operands on the CPU.

#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "tf32x3.cuh"

namespace {

// setmaxnreg at NG consumer warpgroups: the consumers take only what the
// producer gives. One consumer warpgroup (256 threads) needs none.
template <int NG>
struct RegSplit {
    static constexpr bool on = false;
    static constexpr int producer = 0, consumer = 0;
};
template <>
struct RegSplit<2> {  // 168 a thread at launch
    static constexpr bool on = true;
    static constexpr int producer = 56, consumer = 224;
    static_assert(producer + 2 * consumer <= 168 * 3, "the launch's registers");
};

// Shared memory of a block, from a 1024-byte boundary: each consumer
// warpgroup's Q (DP / 32 panels, as TMA lands them); K's remainder plane and
// V's transposed planes (raw, then remainders) of the tile in flight,
// written by the producer warpgroup for all; the rings of raw K and V tiles;
// the barriers.
template <int DP, int TK, int NG>
struct TileLayout {
    static constexpr int PANELS = DP / kPanel;
    static constexpr int KPANEL = TK * 128;             // a tile's keys x 32 head dims
    static constexpr int TILE = PANELS * KPANEL;        // a K or a V tile
    static constexpr int QPLANE = PANELS * kQPanelBytes;  // 64 queries x DP head dims
    static constexpr int Q = 0;                         // [group]
    static constexpr int KSMALL = Q + NG * QPLANE;
    // DP head dims x a tile's keys, rows of at least 128 bytes (the swizzle's)
    static constexpr int VT_PLANE = DP * (TK < 32 ? 32 : TK) * 4;
    static constexpr int VT = KSMALL + TILE;
    static constexpr int KRING = VT + 2 * VT_PLANE;
    // K and V tiles in flight: two each where they fit, else one (the
    // barriers: qbar, kfull[RING], vfull[RING], kready, vready, kfree, vfree)
    static constexpr int RING = KRING + 4 * TILE + 8 * 9 + 1024 <= kSmemLimit ? 2 : 1;
    static constexpr int VRING = KRING + RING * TILE;
    static constexpr int BARS = VRING + RING * TILE;
    static constexpr int BYTES = BARS + 8 * (5 + 2 * RING) + 1024;
    static_assert(DP % kPanel == 0 && DP <= 128 && TK % 16 == 0 && TK <= 64, "the tiling");
    static_assert(BYTES <= kSmemLimit, "227 KB of shared memory a block");
    static_assert(KPANEL % 1024 == 0 && VT % 1024 == 0 && KRING % 1024 == 0 &&
                      VT_PLANE % 1024 == 0,
                  "swizzle atoms aligned");
};

struct TileParams {
    float* out;       // (B, N, heads, d), written where splits == 1
    float* opart;     // [splits][B * heads][N][d] unnormalised O, where splits > 1
    float* ml;        // [splits][B * heads][N][2] running max and row sum, where splits > 1
    int n_tokens, heads, d;
    int splits, tps;  // key splits and key tiles a split
    int q_bytes;      // bytes of the block's Q: its boxes stop at N rounded up to 8 rows
    int k_bytes;      // bytes of a K tile: likewise
    float c2;         // scale * log2(e)
};

template <int DP, int TK, int NG>
__global__ void __launch_bounds__((NG + 1) * kConsumers, 1)
attention_f32_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, TileParams p) {
    typedef TileLayout<DP, TK, NG> L;
    constexpr int PANELS = L::PANELS;
    constexpr int RING = L::RING;
    constexpr int SN = TK / 2;  // S accumulator floats a thread, a panel
    constexpr int KK = TK / 8;  // k8 steps of P V (and n8 blocks of S)
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
    uint64_t* kfull = qbar + 1;        // a raw K tile landed
    uint64_t* vfull = kfull + RING;    // a raw V tile landed
    uint64_t* kready = vfull + RING;   // K's remainder plane written
    uint64_t* vready = kready + 1;     // V's transposed planes written
    uint64_t* kfree = vready + 1;      // every warpgroup's S done with K's tile and plane
    uint64_t* vfree = kfree + 1;       // every warpgroup's P V done with V's planes

    const int q0 = blockIdx.x * (NG * kRows);
    const int sp = blockIdx.y % p.splits;  // the key split
    const int bh = blockIdx.y / p.splits;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int n_tiles = (p.n_tokens + TK - 1) / TK;
    const int t0 = sp * p.tps;
    const int nt = max(0, min(n_tiles, t0 + p.tps) - t0);  // its key tiles (0: an empty split)
    const int tid = threadIdx.x;
    // 0 ... NG - 1: a consumer warpgroup, NG: the producer warpgroup
    // (warp-uniform, as the compiler sees it)
    const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);

    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int i = 0; i < RING; ++i) mbar_init(&kfull[i], 1);
        for (int i = 0; i < RING; ++i) mbar_init(&vfull[i], 1);
        mbar_init(kready, 1);
        mbar_init(vready, 1);
        mbar_init(kfree, NG);
        mbar_init(vfree, NG);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (role == NG) {
        // ---- producer warpgroup: one thread issues the TMA loads (Q once, K
        // and V tiles into their rings); all 128 write, for each key tile,
        // K's remainders once every consumer's S of the last tile is done, and
        // V's transposed planes once every consumer's P V of the last tile is
        if constexpr (RegSplit<NG>::on)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RegSplit<NG>::producer));
        const int ptid = tid - NG * kConsumers;
        const bool leader = ptid == 0;
        auto load = [&](int j, bool is_v) {  // key tile j's K or V into its slot
            const int slot = j % RING;
            uint64_t* bar = is_v ? &vfull[slot] : &kfull[slot];
            unsigned char* st = smem + (is_v ? L::VRING : L::KRING) + slot * L::TILE;
            mbar_expect_tx(bar, is_v ? L::TILE : p.k_bytes);
            for (int pn = 0; pn < PANELS; ++pn)
                tma_load(st + pn * L::KPANEL, is_v ? &tmv : &tmk, pn * kPanel, (t0 + j) * TK, h,
                         b, bar);
        };
        if (leader && nt > 0) {
            mbar_expect_tx(qbar, p.q_bytes);
            for (int w = 0; w < NG; ++w)
                for (int pn = 0; pn < PANELS; ++pn)
                    tma_load(smem + L::Q + w * L::QPLANE + pn * kQPanelBytes, &tmq,
                             pn * kPanel, q0 + w * kRows, h, b, qbar);
            for (int j = 0; j < RING && j < nt; ++j) load(j, false);
            for (int j = 0; j < RING && j < nt; ++j) load(j, true);
        }
#pragma unroll 1
        for (int it = 0; it < nt; ++it) {
            // K's remainders (the raw tile's slot of tile it - 1 then takes
            // tile it - 1 + RING)
            if (it > 0) {
                mbar_wait(kfree, (it - 1) & 1);
                if (leader && it - 1 + RING < nt) load(it - 1 + RING, false);
            }
            mbar_wait(&kfull[it % RING], (it / RING) & 1);
            const float4* kraw =
                reinterpret_cast<const float4*>(smem + L::KRING + (it % RING) * L::TILE);
            float4* ksm = reinterpret_cast<float4*>(smem + L::KSMALL);
#pragma unroll 4
            for (int u = 0; u < L::TILE / 16 / kConsumers; ++u)
                ksm[ptid + u * kConsumers] = remainder_of(kraw[ptid + u * kConsumers]);
            group_sync(NG);
            mbar_arrive_if(kready, leader);

            // V's tile (DP / 32 panels of TK keys x 32 head dims, swizzled)
            // into Vt: rows of head dims n, keys along the row in the order of
            // P's k indices (key 8j + 2a + b at 8j + a + 4b), raw and remainders
            if (it > 0) mbar_wait(vfree, (it - 1) & 1);
            const int vslot = it % RING;
            mbar_wait(&vfull[vslot], (it / RING) & 1);
            const float* vraw = reinterpret_cast<const float*>(smem + L::VRING + vslot * L::TILE);
#pragma unroll 2
            for (int u = 0; u < DP * TK / 4 / kConsumers; ++u) {
                const int task = ptid + u * kConsumers;
                const int n = task % DP;  // a warp's lanes take 32 head dims
                const int j = task / DP / 2, bb = (task / DP) & 1;
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
                const int off = (kpos >> 5) * DP * 128 + n * 128 +
                                ((((kpos & 31) >> 2) ^ (n & 7)) << 4);
                *reinterpret_cast<float4*>(smem + L::VT + off) = x;
                *reinterpret_cast<float4*>(smem + L::VT + L::VT_PLANE + off) = remainder_of(x);
            }
            group_sync(NG);
            mbar_arrive_if(vready, leader);
            if (leader && it + RING < nt) load(it + RING, true);  // the raw tile is read
        }
        return;
    }

    // ---- consumers: warpgroup w, query rows q0 + 64 w ...
    if constexpr (RegSplit<NG>::on)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RegSplit<NG>::consumer));
    const int w = role;
    const int ctid = tid - w * kConsumers;
    const int warp = ctid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // columns 2t, 2t + 1 of each n8 block
    const float* qsm = reinterpret_cast<const float*>(smem + L::Q + w * L::QPLANE);
    // O, 64 rows x DP head dims: element e is row 16 warp + g + 8 ((e / 2) &
    // 1), head dim 8 (e / 4) + 2t + (e & 1), as a wgmma m64nDP accumulator
    float o[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
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
        const uint32_t kr = kring_sm + (it % RING) * L::TILE;
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
        for (int pn = 0; pn < PANELS; pn += 2) {
            run(Par<0>(), pn);
            if (pn + 1 < PANELS) load(Par<1>(), pn + 1);
            retire();
            if (pn + 1 < PANELS) {
                run(Par<1>(), pn + 1);
                if (pn + 2 < PANELS) load(Par<0>(), pn + 2);
                retire();
            }
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

        // ---- O += P V: one chain of 3 TK / 8 wgmma m64nDP from 0, added to
        // O with its rescale in one rounding
        mbar_wait(vready, it & 1);
        float pv[DP / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            const uint32_t vr = vt_sm + (kk / 4) * DP * 128 + 32 * (kk % 4);
            wgmma_tf32(pv, ps[kk], desc_kmajor(vr), kk > 0);
            wgmma_tf32(pv, pb[kk], desc_kmajor(vr + L::VT_PLANE), 1);
            wgmma_tf32(pv, pb[kk], desc_kmajor(vr), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pv);
        mbar_arrive_if(vfree, ctid == 0);
#pragma unroll
        for (int e = 0; e < DP / 2; ++e) o[e] = fmaf(o[e], corr[(e / 2) & 1], pv[e]);
    }

    // ---- epilogue: row 16 warp + g + 8r of the warpgroup's 64, its head
    // dims below d
    const long long BH = (long long)gridDim.y / p.splits;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        const int row = q0 + w * kRows + 16 * warp + g + 8 * r;
        if (row >= p.n_tokens) continue;
        const long long prow = ((long long)sp * BH + bh) * p.n_tokens + row;
        const float inv = 1.0f / l;
        float* dst = p.splits == 1
                         ? p.out + (((long long)b * p.n_tokens + row) * p.heads + h) * p.d
                         : p.opart + prow * p.d;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
            if (8 * n + 2 * t >= p.d) continue;  // d is a multiple of 4: both columns or neither
            const float x0 = o[4 * n + 2 * r], x1 = o[4 * n + 2 * r + 1];
            *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
                p.splits == 1 ? make_float2(x0 * inv, x1 * inv) : make_float2(x0, x1);
        }
        if (p.splits > 1 && t == 0)
            *reinterpret_cast<float2*>(p.ml + 2 * prow) = make_float2(m_run[r], l);
    }
}

template <int DP, int TK, int NG>
int launch_tile(const void* q, const void* k, const void* v, TileParams p, int B, long long sb,
                long long sn, long long sh, cudaStream_t st) {
    typedef TileLayout<DP, TK, NG> L;
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_f32_kernel<DP, TK, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    // Q's and K's boxes stop at N rounded up to 8 rows where N is below a
    // tile; V's box stays whole
    const int n8 = (p.n_tokens + 7) / 8 * 8;
    const int q_rows = n8 < kRows ? n8 : kRows, k_rows = n8 < TK ? n8 : TK;
    p.q_bytes = NG * L::PANELS * q_rows * 128;
    p.k_bytes = L::PANELS * k_rows * 128;
    CUtensorMap tq, tk, tv;
    if (!encode_cached(&tq, q, B, p.n_tokens, p.heads, p.d, sb, sn, sh, q_rows) ||
        !encode_cached(&tk, k, B, p.n_tokens, p.heads, p.d, sb, sn, sh, k_rows) ||
        !encode_cached(&tv, v, B, p.n_tokens, p.heads, p.d, sb, sn, sh, TK))
        return (int)cudaErrorInvalidValue;
    const int rows = NG * kRows;
    const dim3 grid((p.n_tokens + rows - 1) / rows, B * p.heads * p.splits);
    attention_f32_kernel<DP, TK, NG><<<grid, (NG + 1) * kConsumers, L::BYTES, st>>>(tq, tk, tv,
                                                                                   p);
    return (int)cudaGetLastError();
}

// the instance of padded head dim dp at a key tile TK and NG consumer warpgroups
template <int TK, int NG>
int launch_dp(int dp, const void* q, const void* k, const void* v, TileParams p, int B,
              long long sb, long long sn, long long sh, cudaStream_t st) {
    switch (dp) {
        case 32: return launch_tile<32, TK, NG>(q, k, v, p, B, sb, sn, sh, st);
        case 64: return launch_tile<64, TK, NG>(q, k, v, p, B, sb, sn, sh, st);
        case 96: return launch_tile<96, TK, NG>(q, k, v, p, B, sb, sn, sh, st);
        default: return launch_tile<128, TK, NG>(q, k, v, p, B, sb, sn, sh, st);
    }
}

// the instances built: (key tile, consumer warpgroups) as ops/attention.py
// NARROW_TILINGS lists them
int launch_tiling(int key_tile, int groups, int dp, const void* q, const void* k, const void* v,
                  TileParams p, int B, long long sb, long long sn, long long sh,
                  cudaStream_t st) {
    if (key_tile == 16 && groups == 1) return launch_dp<16, 1>(dp, q, k, v, p, B, sb, sn, sh, st);
    if (key_tile == 32 && groups == 1) return launch_dp<32, 1>(dp, q, k, v, p, B, sb, sn, sh, st);
    if (key_tile == 64 && groups == 1) return launch_dp<64, 1>(dp, q, k, v, p, B, sb, sn, sh, st);
    if (key_tile == 64 && groups == 2) return launch_dp<64, 2>(dp, q, k, v, p, B, sb, sn, sh, st);
    return (int)cudaErrorInvalidValue;
}

// the kernel at head dim d (<= 128) and its combine where splits > 1
int attention_tiles(const void* q, const void* k, const void* v, void* out, void* opart, void* ml,
                    int B, int n_tokens, int heads, int d, long long sb, long long sn,
                    long long sh, float scale, int key_tile, int groups, int splits,
                    cudaStream_t st) {
    const int n_tiles = key_tile > 0 ? (n_tokens + key_tile - 1) / key_tile : 0;
    if (d <= 0 || d > 128 || d % 4 || n_tokens < 1 || splits < 1 || splits > n_tiles ||
        (splits > 1 && (!opart || !ml)))
        return (int)cudaErrorInvalidValue;
    TileParams p;
    p.out = static_cast<float*>(out);
    p.opart = static_cast<float*>(opart);
    p.ml = static_cast<float*>(ml);
    p.n_tokens = n_tokens;
    p.heads = heads;
    p.d = d;
    p.splits = splits;
    p.tps = (n_tiles + splits - 1) / splits;
    p.c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    const int dp = (d + kPanel - 1) / kPanel * kPanel;
    const int err = launch_tiling(key_tile, groups, dp, q, k, v, p, B, sb, sn, sh, st);
    if (err != 0 || splits == 1) return err;
    return combine_splits(p.opart, p.ml, p.out, splits, B, n_tokens, heads, d, st);
}

}  // namespace

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
    return attention_tiles(q, k, v, out, opart, ml, B, n_tokens, heads, 128, sb, sn, sh, scale,
                           64, 2, splits, static_cast<cudaStream_t>(stream));
}

// The same at a head dim d below 128, a multiple of 4 (views and scratch as
// above, with d head dims): keys in tiles of `key_tile`, `groups` consumer
// warpgroups of 64 queries a block, a (key_tile, groups) pair that
// launch_tiling builds; `splits` key splits (1 ... ceil(N / key_tile)).
extern "C" int attention_f32_narrow(const void* q, const void* k, const void* v, void* out,
                                    void* opart, void* ml, int B, int n_tokens, int heads,
                                    int d, long long sb, long long sn, long long sh, float scale,
                                    int key_tile, int groups, int splits, void* stream) {
    if (d >= 128) return (int)cudaErrorInvalidValue;
    return attention_tiles(q, k, v, out, opart, ml, B, n_tokens, heads, d, sb, sn, sh, scale,
                           key_tile, groups, splits, static_cast<cudaStream_t>(stream));
}
