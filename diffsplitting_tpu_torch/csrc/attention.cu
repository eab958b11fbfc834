// Spatial self-attention softmax(q k^T * scale) v, float32, for sm_90a, in
// three kernels picked by the head dim D alone: at D = 128 on the tensor cores
// at float32 accuracy (attention_tf32x3_d128_kernel); at D = 256, 384, ...,
// 1024 on the tensor cores in 128-wide head-dim slices
// (attention_tf32x3_wide_kernel, after it); at any other D that is a multiple
// of 4 up to 1024 on the f32 FMA units (attention_f32_simt_kernel, at the end
// of this file).
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`), which held the whole N x N f32 score matrix of one
//   (batch, head) in VMEM. At the splitting UNet's mid block (64 x 64 map,
//   N = 4096 tokens) that matrix alone is 64 MB, and with B = 8 the scores
//   would be 512 MB of device memory traffic each way; here they never leave
//   the SM.
//
// Bound: operations. The two products take 4 * N^2 * D flops per (batch,
//   head): 68.72 GFLOP at B = 8, N = 4096, D = 128, against 67 MB of q, k, v
//   and out (0.020 ms at 3.35 TB/s). Each f32 product here is three TF32
//   tensor-core products (3xTF32, below), so the least time is
//   3 * 68.72 GFLOP at 495 TFLOP/s dense TF32 = 0.4165 ms; the same work at
//   the 67 TFLOP/s f32 FMA rate would take 1.0257 ms. The 134 M exp2 take
//   about 0.03 ms on the SFUs.
//
// Design:
//   * 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Each
//     operand x is split as big = x rounded to TF32 (as cvt.rna.tf32.f32
//     rounds), small = x - big, and a product accumulates small*big +
//     big*small + big*big in f32 (the small*small term, about 2^-22 of the
//     product, is dropped). Both S = Q K^T and O += P V are computed so, so
//     the result keeps float32 accuracy and is held against the f32 plain
//     version with f32 tolerances. The split is done in registers as
//     fragments are loaded, with integer ops rather than cvt (split() in
//     tf32x3.cuh):
//     on the H100 that took the kernel from 1.47 to 1.12 ms at B = 8 at the
//     same error (kernels/attention_variants.py; PERF.md).
//   * One block of 8 warps per (b * head, 128-query tile); each warp owns 16
//     query rows. At B = 8, N = 4096 that is 256 blocks, 1.94 waves of one
//     block per SM on 132 SMs, with two warps per SM sub-partition to hide
//     the mma and shared-memory latency. (64-query blocks of 4 warps would
//     give 512 blocks but, at one block per SM by shared memory, only one
//     warp per sub-partition, and twice the K/V reads from L2.) In the last
//     block, a warp whose 16 rows all lie past N only helps stage K and V;
//     a warp with some rows past N computes on their zeros and stores none.
//   * Dynamic shared memory, 160 KB of the 227 KB (cudaFuncSetAttribute): the
//     block's Q tile (64 KB, raw f32) and a ring of three stages of 32-key K
//     and V tiles (16 KB each a stage). cp.async.cg 16-byte copies fill the
//     stages two tiles ahead while the warps compute; one barrier a tile.
//   * Registers: 243 a thread, no spills (-Xptxas -v): O is 64, S 16, a
//     tile's P V sum 64, and Q's fragments are loaded from shared memory and
//     split per k-step rather than held (they would need 128 more). 32-key
//     tiles are what make room for the P V sum: with 64-key tiles every
//     arrangement of it spilled (PERF.md).
//   * Fragment loads are 16 bytes and free of bank conflicts. The head dim is
//     consumed in a permuted order that is the same for Q and K (a float4 of
//     d = 16s+4t .. 16s+4t+3 feeds two k-steps), and rows are XOR-swizzled in
//     16-byte chunks: chunk ^ 4*(row & 1) for Q and K, chunk ^ ((key >> 1) & 3)
//     for V.
//   * P stays in registers. The S accumulator gives a thread keys 2t and 2t+1
//     of each 8-key group; the P V product takes those as its logical k
//     indices t and t+4, and reads V's rows in the same order (keys 8j+2t and
//     8j+2t+1). The output columns are permuted too: n-tile n, column c is
//     d = 16c + n, so a thread's V loads and its output stores are float4s.
//   * Online softmax in the exp2 domain: running max and a per-thread running
//     sum in f32 registers, the O accumulator rescaled per tile, one division
//     at the end.
//   * The sum over keys in f32 between tensor-core steps. The MMA's own
//     accumulator rounds toward zero (measured on the H100 for conv_gn.cu),
//     so O is not summed over all N keys in it: a tile's P V is summed from 0
//     over its 32 keys (12 MMAs) for all 16 n-tiles, then added to O (4 FADD
//     a 12 MMA). S, 128 terms of one row and key, stays in the accumulator.
//     Summed in the accumulator over all N keys, the kernel erred 7.6e-6 at
//     B = 8, N = 4096; now 7.2e-7. Summing S per 16-wide head-dim step from 0
//     as well took the error to 4.4e-7 for 1-5 % more time (PERF.md).
//   * Any N >= 1. The last K/V tile is zero-filled past N (cp.async with a
//     source size of 0) and its scores there are set to -inf before the row
//     max; every tile holds at least one real key, so a row max is finite and
//     no exp2 sees -inf - -inf. Query rows past N are zero-filled and never
//     stored. D must be 128; the wrapper raises on anything else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kD = 128;
constexpr int kChunks = kD / 4;   // 16-byte chunks a row
constexpr int kTileK = 32;        // keys a stage
constexpr int kNT = kTileK / 8;   // 8-key n-tiles of S a stage
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // queries a block
constexpr int kStages = 3;
constexpr size_t kSmemFloats = (size_t)kBlockQ * kD + (size_t)kStages * 2 * kTileK * kD;

// 16-byte chunk offsets (in floats) of the swizzled tiles
__device__ __forceinline__ int qk_at(int row, int chunk) {
    return row * kD + ((chunk ^ ((row & 1) << 2)) << 2);
}
__device__ __forceinline__ int v_at(int key, int chunk) {
    return key * kD + ((chunk ^ ((key >> 1) & 3)) << 2);
}

__global__ void __launch_bounds__(kThreads, 1)
attention_tf32x3_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             int n_tokens, int heads, long long sb, long long sn, long long sh,
                             float scale) {
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][kD], swizzled
    float* Ks = Qs + kBlockQ * kD;                 // [kStages][kTileK][kD], swizzled
    float* Vs = Ks + kStages * kTileK * kD;        // [kStages][kTileK][kD], swizzled

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * kBlockQ;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // mma group: rows g and g + 8
    const int t = lane % 4;  // thread in group
    const int r0 = warp * 16;
    const bool active = q0 + r0 < n_tokens;  // warp-uniform
    const long long base = (long long)b * sb + (long long)h * sh;

    // stage Q; rows past N are zeros (a source size of 0 reads nothing)
    for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
        const int row = c / kChunks, chunk = c % kChunks;
        const bool ok = q0 + row < n_tokens;
        const long long src = base + (long long)(ok ? q0 + row : 0) * sn + chunk * 4;
        cp_async16_zfill(Qs + qk_at(row, chunk), q + src, ok);
    }
    // keys past N are zeros in K and V
    auto stage_kv = [&](int tile, int stage) {
        float* kd = Ks + stage * kTileK * kD;
        float* vd = Vs + stage * kTileK * kD;
        for (int c = tid; c < kTileK * kChunks; c += kThreads) {
            const int key = c / kChunks, chunk = c % kChunks;
            const int kg = tile * kTileK + key;
            const bool ok = kg < n_tokens;
            const long long src = base + (long long)(ok ? kg : 0) * sn + chunk * 4;
            cp_async16_zfill(kd + qk_at(key, chunk), k + src, ok);
            cp_async16_zfill(vd + v_at(key, chunk), v + src, ok);
        }
    };
    // the ring runs kStages - 1 tiles ahead; a group is committed for every
    // tile slot, empty past the last tile, so the wait count holds throughout
    const int n_tiles = (n_tokens + kTileK - 1) / kTileK;
    for (int p = 0; p < kStages - 1; ++p) {
        if (p < n_tiles) stage_kv(p, p);
        cp_async_commit();
    }

    const float c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    float o[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<kStages - 2>();  // tile it (and Q) have landed for this thread
        __syncthreads();  // ... and for every thread, and no warp still reads tile it - 1
        const int ahead = it + kStages - 1;
        if (ahead < n_tiles) stage_kv(ahead, ahead % kStages);  // into tile it - 1's stage
        cp_async_commit();

        if (active) {
            const float* Kt = Ks + (it % kStages) * kTileK * kD;
            const float* Vt = Vs + (it % kStages) * kTileK * kD;

            // S = Q K^T for rows r0+g, r0+g+8 and the tile's 32 keys, summed
            // over all of D in the MMA accumulator; k-step pair s takes
            // d = 16s + 4t + {0, 1} and 16s + 4t + {2, 3}
            float s[kNT][4];
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
            for (int sp = 0; sp < kD / 16; ++sp) {
                const float4 qa = *reinterpret_cast<const float4*>(Qs + qk_at(r0 + g, 4 * sp + t));
                const float4 qb =
                    *reinterpret_cast<const float4*>(Qs + qk_at(r0 + g + 8, 4 * sp + t));
                uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
                split(qa.x, a0b[0], a0s[0]);
                split(qb.x, a0b[1], a0s[1]);
                split(qa.y, a0b[2], a0s[2]);
                split(qb.y, a0b[3], a0s[3]);
                split(qa.z, a1b[0], a1s[0]);
                split(qb.z, a1b[1], a1s[1]);
                split(qa.w, a1b[2], a1s[2]);
                split(qb.w, a1b[3], a1s[3]);
#pragma unroll
                for (int n = 0; n < kNT; ++n) {
                    const float4 kv = *reinterpret_cast<const float4*>(Kt + qk_at(8 * n + g, 4 * sp + t));
                    uint32_t xb, xs, yb, ys, zb, zs, wb, ws;
                    split(kv.x, xb, xs);
                    split(kv.y, yb, ys);
                    split(kv.z, zb, zs);
                    split(kv.w, wb, ws);
                    mma_3xtf32(s[n], a0b, a0s, xb, yb, xs, ys);
                    mma_3xtf32(s[n], a1b, a1s, zb, wb, zs, ws);
                }
            }

            // s[n] holds rows g (0, 1) and g+8 (2, 3), keys 8n + 2t and
            // 8n + 2t + 1; keys past N take no weight
            const int keys_left = n_tokens - it * kTileK;
            if (keys_left < kTileK) {
#pragma unroll
                for (int n = 0; n < kNT; ++n) {
                    if (8 * n + 2 * t >= keys_left) s[n][0] = s[n][2] = -INFINITY;
                    if (8 * n + 2 * t + 1 >= keys_left) s[n][1] = s[n][3] = -INFINITY;
                }
            }

            // online softmax
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] *= c2;
                mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
            }
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m_run[r], mx[r]);
                corr[r] = exp2f(m_run[r] - m_new);
                m_run[r] = m_new;
                l_run[r] *= corr[r];
            }
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
                s[n][0] = exp2f(s[n][0] - m_run[0]);
                s[n][1] = exp2f(s[n][1] - m_run[0]);
                s[n][2] = exp2f(s[n][2] - m_run[1]);
                s[n][3] = exp2f(s[n][3] - m_run[1]);
                l_run[0] += s[n][0] + s[n][1];
                l_run[1] += s[n][2] + s[n][3];
            }
#pragma unroll
            for (int n = 0; n < 16; ++n) {
                o[n][0] *= corr[0];
                o[n][1] *= corr[0];
                o[n][2] *= corr[1];
                o[n][3] *= corr[1];
            }

            // O += P V over k-steps of 8 keys: logical k t <-> key 8j + 2t,
            // t + 4 <-> 8j + 2t + 1, so P's A fragment is S's C fragment.
            // The tile's P V is summed from 0, then added to O in f32.
            float d[16][4] = {};  // this tile's P V, from 0
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
                uint32_t pb[4], ps[4];
                split(s[j][0], pb[0], ps[0]);
                split(s[j][2], pb[1], ps[1]);
                split(s[j][1], pb[2], ps[2]);
                split(s[j][3], pb[3], ps[3]);
                const int key = 8 * j + 2 * t;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    // d = 16g + 4c .. 16g + 4c + 3: column g of n-tiles 4c .. 4c + 3
                    const float4 v0 = *reinterpret_cast<const float4*>(Vt + v_at(key, 4 * g + c));
                    const float4 v1 = *reinterpret_cast<const float4*>(Vt + v_at(key + 1, 4 * g + c));
                    const float x0[4] = {v0.x, v0.y, v0.z, v0.w};
                    const float x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        uint32_t b0b, b0s, b1b, b1s;
                        split(x0[e], b0b, b0s);
                        split(x1[e], b1b, b1s);
                        mma_3xtf32(d[4 * c + e], pb, ps, b0b, b1b, b0s, b1s);
                    }
                }
            }
#pragma unroll
            for (int n = 0; n < 16; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) o[n][i] += d[n][i];
        }
    }

    if (!active) return;
    // out is (B, N, heads, D) contiguous; o[n] holds d = 32t + n (0, 2) and
    // d = 32t + 16 + n (1, 3) of rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / l;
        const int row = q0 + r0 + g + 8 * r;
        if (row >= n_tokens) continue;
        float4* dst = reinterpret_cast<float4*>(
            out + (((long long)b * n_tokens + row) * heads + h) * kD + 32 * t);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                dst[4 * half + c] = make_float4(
                    o[4 * c][2 * r + half] * inv, o[4 * c + 1][2 * r + half] * inv,
                    o[4 * c + 2][2 * r + half] * inv, o[4 * c + 3][2 * r + half] * inv);
    }
}


// ---------------------------------------------------------------------------
// Wide head dims: attention_tf32x3_wide_kernel<DS>, D = 128 * DS for DS = 2 ... 8.
//
// Replaces the same Pallas `_kernel` (diffsplitting_tpu/ops/attention.py:33)
//   at D = 256, 384, ..., 1024: the mid block of a UNet whose last width is
//   256 (inner 32 x 8; sample_ddpm_128), 512 (sr_sr3_16_128, sr_ddpm_16_128,
//   also their 16² attention sites) or 1024 (sr_sr3_64_512).
//
// Bound: operations, 3 * 4 * N^2 * D TF32 flops a (batch, head) at 495
//   TFLOP/s (3xTF32, as the D = 128 kernel), against 16 * N * D bytes of q,
//   k, v and out. Every block reads all of K and V of its (batch, head) from
//   L2: 8 * N * D bytes for its 16 * kRowGroups queries, so with one row group
//   (D >= 640) the L2 read rate is the nearer limit.
//
// Design: the D = 128 kernel's arithmetic, cut into 128-wide head-dim slices.
//   * One block of kRowGroups x DS warps per (b * head, 16 * kRowGroups-query
//     tile). Warp (rg, ds) owns query rows 16 rg .. 16 rg + 15 and head dims
//     128 ds .. 128 ds + 127, so its O is 16 x 128, 64 floats a thread at any
//     D, and it reads only its slice of Q, K and V. kRowGroups is 4 at D =
//     256, 2 at 384, 1 from 512: at D = 512 two row groups (64 blocks at B =
//     8, N = 256) took 0.068 ms and one 0.046 ms, while at D = 256 one row
//     group (2 warps a block) took 0.31 ms against 0.19 for four
//     (kernels/attention_variants.py --wide; PERF.md).
//   * S = Q K^T by slices: each warp sums its slice's 128 terms of a score in
//     16-wide head-dim steps, each step's 16 terms from 0 in the MMA
//     accumulator and the 8 steps added in f32, writes that partial S to
//     shared memory, and after a barrier each warp of the row group adds the
//     DS partials of its rows in f32 in the order ds = 0, 1, ... All DS warps
//     of a row group so hold the same S bits and keep the same running max
//     and sum; there are no atomics, and two launches give the same bits.
//     Summing all 128 terms in the accumulator, which rounds toward zero,
//     erred 2.15e-6 at D = 512 and chained 48 dependent MMAs an n-tile; the
//     steps from 0 are independent of each other (PERF.md).
//   * Online softmax in the exp2 domain on the full S; keys past N at -inf.
//   * O += P V for the warp's own slice. P stays in registers (S's C fragment
//     is P's A fragment, with the D = 128 kernel's key permutation). Each key
//     tile's P V is summed from 0 over its kTileK keys and then added to O in
//     f32 (the accumulator rounds toward zero), 4 n-tiles at a time, so that
//     only 16 floats of the tile's sum are live.
//   * Shared memory, dynamic: the block's Q tile (16 x 128 floats a warp, 64
//     KB at 8 warps), the partial S (16 x kTileK floats a warp), and a ring
//     of two slots of kTileK rows of D floats. At D = 1024 one 16-key K tile
//     alone is 64 KB, so K and V take turns in the slots: ring item 2i is K
//     tile i, item 2i + 1 is V tile i. A tile has two barriers, one before S
//     (K tile i has landed) and one between S and P V (V tile i has landed,
//     the partials are written); after each, cp.async loads the next item
//     into the slot of the item the barrier retired, so each load has half
//     a tile's work to land behind. Up to four slots, where they fit, bought
//     nothing (within 1 %; PERF.md). kTileK is 32 up to D = 512 and 16
//     above, where a 32-key K tile alone is 80-128 KB.
//   * Fragment loads are 16 bytes and free of bank conflicts: rows of D floats
//     are whole multiples of 128 bytes, and each slice is swizzled and
//     consumed as the D = 128 kernel's tiles are.
//   * Any N >= 1: K and V rows past N are zero-filled, their scores set to
//     -inf after the partials are added; query rows past N are zero-filled
//     and not stored, and a row group all past N only helps stage.

template <int DS>
struct WideTile {
    static_assert(DS >= 2 && DS <= 8, "the wide kernel takes D = 256 ... 1024");
    static constexpr int kD = 128 * DS;
    static constexpr int kChunks = kD / 4;  // 16-byte chunks a row
    static constexpr int kRowGroups = DS <= 2 ? 4 : DS <= 3 ? 2 : 1;
    static constexpr int kTileK = DS <= 4 ? 32 : 16;  // keys a tile
    static constexpr int kSlots = 2;                  // ring slots of K or V tiles
    static constexpr int kWarps = kRowGroups * DS;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kRows = 16 * kRowGroups;  // queries a block
    static constexpr int kNT = kTileK / 8;         // 8-key n-tiles of S a tile
    static constexpr int kQFloats = kRows * kD;
    static constexpr int kSFloats = kWarps * 16 * kTileK;
    static constexpr int kSlotFloats = kTileK * kD;
    static constexpr size_t kSmemBytes =
        (size_t)(kQFloats + kSFloats + kSlots * kSlotFloats) * sizeof(float);
    static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");
};

// 16-byte chunk offsets (in floats) of the swizzled tiles, rows of LD floats;
// chunk counts from the start of the row, and the swizzle stays in its slice
template <int LD>
__device__ __forceinline__ int wide_qk_at(int row, int chunk) {
    return row * LD + ((chunk ^ ((row & 1) << 2)) << 2);
}
template <int LD>
__device__ __forceinline__ int wide_v_at(int key, int chunk) {
    return key * LD + ((chunk ^ ((key >> 1) & 3)) << 2);
}

template <int DS>
__global__ void __launch_bounds__(WideTile<DS>::kThreads, 1)
attention_tf32x3_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             int n_tokens, int heads, long long sb, long long sn, long long sh,
                             float scale) {
    using T = WideTile<DS>;
    constexpr int D = T::kD, TK = T::kTileK, NT = T::kNT, SLOTS = T::kSlots;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);                   // [kRows][D], swizzled
    float4* Sp = reinterpret_cast<float4*>(Qs + T::kQFloats);      // [kWarps][NT][32 lanes]
    float* Ring = Qs + T::kQFloats + T::kSFloats;                  // [SLOTS][TK][D], swizzled

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * T::kRows;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // mma group: rows g and g + 8
    const int t = lane % 4;  // thread in group
    const int rg = warp / DS;
    const int ds = warp % DS;
    const int r0 = 16 * rg;
    const int c0 = 32 * ds;  // the slice's first 16-byte chunk
    const bool active = q0 + r0 < n_tokens;  // warp-uniform, and uniform over a row group
    const long long base = (long long)b * sb + (long long)h * sh;

    // stage Q; rows past N are zeros (a source size of 0 reads nothing)
    for (int c = tid; c < T::kRows * T::kChunks; c += T::kThreads) {
        const int row = c / T::kChunks, chunk = c % T::kChunks;
        const bool ok = q0 + row < n_tokens;
        const long long src = base + (long long)(ok ? q0 + row : 0) * sn + chunk * 4;
        cp_async16_zfill(Qs + wide_qk_at<D>(row, chunk), q + src, ok);
    }
    // ring item 2i is K tile i, 2i + 1 is V tile i; keys past N are zeros
    const int n_tiles = (n_tokens + TK - 1) / TK;
    const int n_items = 2 * n_tiles;
    auto stage = [&](int item) {
        const int tile = item >> 1;
        const bool is_v = item & 1;
        const float* src0 = (is_v ? v : k) + base;
        float* dst = Ring + (item % SLOTS) * T::kSlotFloats;
        for (int c = tid; c < TK * T::kChunks; c += T::kThreads) {
            const int key = c / T::kChunks, chunk = c % T::kChunks;
            const int kg = tile * TK + key;
            const bool ok = kg < n_tokens;
            const float* src = src0 + (long long)(ok ? kg : 0) * sn + chunk * 4;
            cp_async16_zfill(dst + (is_v ? wide_v_at<D>(key, chunk) : wide_qk_at<D>(key, chunk)),
                             src, ok);
        }
    };
    // one cp.async group per ring item, empty past the last, so that before
    // the barrier of item p the groups of items 0 .. p are complete when at
    // most SLOTS - 2 are in flight; Q travels with item 0
    for (int p = 0; p < SLOTS - 1; ++p) {
        if (p < n_items) stage(p);
        cp_async_commit();
    }

    const float c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    float o[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        // K tile it (and Q) have landed for every thread, and no warp still
        // reads V tile it - 1 or the partials of tile it - 1
        cp_async_wait<SLOTS - 2>();
        __syncthreads();
        if (2 * it + SLOTS - 1 < n_items) stage(2 * it + SLOTS - 1);  // into V tile it - 1's slot
        cp_async_commit();

        if (active) {
            const float* Kt = Ring + ((2 * it) % SLOTS) * T::kSlotFloats;
            // this slice's partial S for rows r0+g, r0+g+8 and the tile's
            // keys: each 16-wide head-dim step summed from 0 in the MMA
            // accumulator, the 8 steps added in f32; step sp takes
            // d = 128 ds + 16 sp + 4t + {0, 1}, {2, 3}
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
            for (int sp = 0; sp < 8; ++sp) {
                const int chunk = c0 + 4 * sp + t;
                const float4 qa =
                    *reinterpret_cast<const float4*>(Qs + wide_qk_at<D>(r0 + g, chunk));
                const float4 qb =
                    *reinterpret_cast<const float4*>(Qs + wide_qk_at<D>(r0 + g + 8, chunk));
                uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
                split(qa.x, a0b[0], a0s[0]);
                split(qb.x, a0b[1], a0s[1]);
                split(qa.y, a0b[2], a0s[2]);
                split(qb.y, a0b[3], a0s[3]);
                split(qa.z, a1b[0], a1s[0]);
                split(qb.z, a1b[1], a1s[1]);
                split(qa.w, a1b[2], a1s[2]);
                split(qb.w, a1b[3], a1s[3]);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const float4 kv =
                        *reinterpret_cast<const float4*>(Kt + wide_qk_at<D>(8 * n + g, chunk));
                    uint32_t xb, xs, yb, ys, zb, zs, wb, ws;
                    split(kv.x, xb, xs);
                    split(kv.y, yb, ys);
                    split(kv.z, zb, zs);
                    split(kv.w, wb, ws);
                    float step[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_3xtf32(step, a0b, a0s, xb, yb, xs, ys);
                    mma_3xtf32(step, a1b, a1s, zb, wb, zs, ws);
#pragma unroll
                    for (int i = 0; i < 4; ++i) s[n][i] += step[i];
                }
            }
#pragma unroll
            for (int n = 0; n < NT; ++n)
                Sp[(warp * NT + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        }

        // V tile it has landed and every partial of tile it is written, for
        // every thread; no warp still reads K tile it
        cp_async_wait<SLOTS - 2>();
        __syncthreads();
        if (2 * it + SLOTS < n_items) stage(2 * it + SLOTS);  // into K tile it's slot
        cp_async_commit();

        if (active) {
            // the row group's partials added in f32, ds = 0, 1, ... in order;
            // s[n] holds rows g (0, 1) and g+8 (2, 3), keys 8n + 2t and
            // 8n + 2t + 1
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                float4 a = Sp[(rg * DS * NT + n) * 32 + lane];
#pragma unroll
                for (int e = 1; e < DS; ++e) {
                    const float4 x = Sp[((rg * DS + e) * NT + n) * 32 + lane];
                    a.x += x.x;
                    a.y += x.y;
                    a.z += x.z;
                    a.w += x.w;
                }
                s[n][0] = a.x;
                s[n][1] = a.y;
                s[n][2] = a.z;
                s[n][3] = a.w;
            }
            // keys past N take no weight
            const int keys_left = n_tokens - it * TK;
            if (keys_left < TK) {
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (8 * n + 2 * t >= keys_left) s[n][0] = s[n][2] = -INFINITY;
                    if (8 * n + 2 * t + 1 >= keys_left) s[n][1] = s[n][3] = -INFINITY;
                }
            }

            // online softmax
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] *= c2;
                mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
            }
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m_run[r], mx[r]);
                corr[r] = exp2f(m_run[r] - m_new);
                m_run[r] = m_new;
                l_run[r] *= corr[r];
            }
            uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                s[n][0] = exp2f(s[n][0] - m_run[0]);
                s[n][1] = exp2f(s[n][1] - m_run[0]);
                s[n][2] = exp2f(s[n][2] - m_run[1]);
                s[n][3] = exp2f(s[n][3] - m_run[1]);
                l_run[0] += s[n][0] + s[n][1];
                l_run[1] += s[n][2] + s[n][3];
                // P's A fragment: logical k t <-> key 8n + 2t, t + 4 <-> 8n + 2t + 1
                split(s[n][0], pb[n][0], ps[n][0]);
                split(s[n][2], pb[n][1], ps[n][1]);
                split(s[n][1], pb[n][2], ps[n][2]);
                split(s[n][3], pb[n][3], ps[n][3]);
            }
#pragma unroll
            for (int n = 0; n < 16; ++n) {
                o[n][0] *= corr[0];
                o[n][1] *= corr[0];
                o[n][2] *= corr[1];
                o[n][3] *= corr[1];
            }

            // O += P V for this slice, 4 n-tiles at a time: n-tile 4c + e,
            // column g is d = 128 ds + 16g + 4c + e; the tile's P V is summed
            // from 0 over its keys, then added to O in f32
            const float* Vt = Ring + ((2 * it + 1) % SLOTS) * T::kSlotFloats;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float d[4][4] = {};
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const int key = 8 * j + 2 * t;
                    const int chunk = c0 + 4 * g + c;
                    const float4 v0 =
                        *reinterpret_cast<const float4*>(Vt + wide_v_at<D>(key, chunk));
                    const float4 v1 =
                        *reinterpret_cast<const float4*>(Vt + wide_v_at<D>(key + 1, chunk));
                    const float x0[4] = {v0.x, v0.y, v0.z, v0.w};
                    const float x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        uint32_t b0b, b0s, b1b, b1s;
                        split(x0[e], b0b, b0s);
                        split(x1[e], b1b, b1s);
                        mma_3xtf32(d[e], pb[j], ps[j], b0b, b1b, b0s, b1s);
                    }
                }
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                    for (int i = 0; i < 4; ++i) o[4 * c + e][i] += d[e][i];
            }
        }
    }

    if (!active) return;
    // out is (B, N, heads, D) contiguous; o[n] holds d = 128 ds + 32t + n
    // (0, 2) and 128 ds + 32t + 16 + n (1, 3) of rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / l;
        const int row = q0 + r0 + g + 8 * r;
        if (row >= n_tokens) continue;
        float4* dst = reinterpret_cast<float4*>(
            out + (((long long)b * n_tokens + row) * heads + h) * D + 128 * ds + 32 * t);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                dst[4 * half + c] = make_float4(
                    o[4 * c][2 * r + half] * inv, o[4 * c + 1][2 * r + half] * inv,
                    o[4 * c + 2][2 * r + half] * inv, o[4 * c + 3][2 * r + half] * inv);
    }
}

template <int DS>
int launch_wide(const float* q, const float* k, const float* v, float* out, int B, int n_tokens,
                int heads, long long sb, long long sn, long long sh, float scale,
                cudaStream_t stream) {
    using T = WideTile<DS>;
    cudaError_t err = cudaFuncSetAttribute(attention_tf32x3_wide_kernel<DS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_tokens + T::kRows - 1) / T::kRows, B * heads);
    attention_tf32x3_wide_kernel<DS><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
        q, k, v, out, n_tokens, heads, sb, sn, sh, scale);
    return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Any head dim: attention_f32_simt_kernel.
//
// Replaces the same Pallas `_kernel` (diffsplitting_tpu/ops/attention.py:33)
//   at the head dims the tensor-core kernel does not take: D a multiple of 4
//   up to 1024 (the mid block of a UNet attends at D = inner_channel x the
//   last channel multiplier: 16 in the parity tests, 256 at inner 32, 512 and
//   1024 in the SR3 configs).
//
// Bound: operations, 4 * N^2 * D flops a (batch, head) at the f32 FMA rate
//   (67 TFLOP/s), against 16 * N * D bytes of q, k, v and out.
//
// Design: correct first, a plain f32 flash loop.
//   * One block of 256 threads per (b * head, 16R-query tile); 16R-key K and V
//     tiles staged in shared memory with rows padded to D + 4 floats, so that
//     at D a multiple of 32 the float4 loads of 8 rows at one column fall in
//     8 distinct bank groups.
//     R = 4 for D <= 256, 2 for D <= 512, 1 for D <= 1024, the most rows
//     whose Q, K and V tiles fit: 3 * 16 * 1028 * 4 B = 197 KB of the 227 KB
//     at D = 1024, 200 KB at D = 256 (R = 4), plus the score tile.
//   * Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16i and keys
//     tx + 16j (i, j < R) of the score tile, and of O the same rows and the
//     16-byte column chunks tx + 16c: every O element it updates belongs to a
//     row whose running max and sum it holds, so O stays in registers (at most
//     64 floats) and the 16 threads of a row reduce its max and sum with
//     shuffles.
//   * Online softmax with expf, running max, sum and O in f32, one division
//     at the end; fixed order, no atomics, so two launches give the same bits.
//   * Any N >= 1: K and V rows past N are zero-filled and their scores set to
//     -inf before the row max (every tile holds a real key, so a row max is
//     finite); query rows past N compute on zeros and are not stored.

template <int R>
struct SimtTile {
    static constexpr int kRows = 16 * R;         // queries a block, keys a tile
    static constexpr int kChunks = 16 / R;        // 16-byte O chunks a thread, a row
    static constexpr int kMaxD = 4 * 16 * kChunks;
};

template <int R>
__global__ void __launch_bounds__(256)
attention_f32_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out, int n_tokens,
                          int heads, int d, long long sb, long long sn, long long sh,
                          float scale) {
    constexpr int kRows = SimtTile<R>::kRows;
    constexpr int kNC = SimtTile<R>::kChunks;
    extern __shared__ float4 smem4[];
    const int ld = d + 4;  // padded row, a multiple of 4 floats
    float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][ld]
    float* Ks = Qs + kRows * ld;                   // [kRows][ld]
    float* Vs = Ks + kRows * ld;                   // [kRows][ld]
    float* Ps = Vs + kRows * ld;                   // [kRows][kRows + 1]

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * kRows;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int d4 = d / 4;
    const long long base = (long long)b * sb + (long long)h * sh;

    for (int c = tid; c < kRows * d4; c += 256) {
        const int row = c / d4, chunk = c % d4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + row < n_tokens)
            val = *reinterpret_cast<const float4*>(q + base + (long long)(q0 + row) * sn +
                                                   4 * chunk);
        *reinterpret_cast<float4*>(Qs + row * ld + 4 * chunk) = val;
    }

    float m[R], l[R];
    float4 o[R][kNC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kNC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int k0 = 0; k0 < n_tokens; k0 += kRows) {
        __syncthreads();  // the last tile's K, V and P are read; Q is staged
        for (int c = tid; c < kRows * d4; c += 256) {
            const int row = c / d4, chunk = c % d4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (k0 + row < n_tokens) {
                const long long src = base + (long long)(k0 + row) * sn + 4 * chunk;
                kv = *reinterpret_cast<const float4*>(k + src);
                vv = *reinterpret_cast<const float4*>(v + src);
            }
            *reinterpret_cast<float4*>(Ks + row * ld + 4 * chunk) = kv;
            *reinterpret_cast<float4*>(Vs + row * ld + 4 * chunk) = vv;
        }
        __syncthreads();

        float s[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) s[i][j] = 0.f;
        for (int c = 0; c < d4; ++c) {
            float4 a[R], bk[R];
#pragma unroll
            for (int i = 0; i < R; ++i)
                a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + 4 * c);
#pragma unroll
            for (int j = 0; j < R; ++j)
                bk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + 4 * c);
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
                    s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
                    s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
                    s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < R; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                s[i][j] = k0 + tx + 16 * j < n_tokens ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);  // 0 on the first tile
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const float pj = expf(s[i][j] - m_new);
                rs += pj;
                Ps[(ty + 16 * i) * (kRows + 1) + tx + 16 * j] = pj;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * corr + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
                o[i][c].x *= corr;
                o[i][c].y *= corr;
                o[i][c].z *= corr;
                o[i][c].w *= corr;
            }
        }
        __syncthreads();  // P complete

        for (int kk = 0; kk < kRows; ++kk) {
            float p[R];
#pragma unroll
            for (int i = 0; i < R; ++i) p[i] = Ps[(ty + 16 * i) * (kRows + 1) + kk];
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
                const int chunk = tx + 16 * c;
                if (chunk < d4) {
                    const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * ld + 4 * chunk);
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        o[i][c].x = fmaf(p[i], vv.x, o[i][c].x);
                        o[i][c].y = fmaf(p[i], vv.y, o[i][c].y);
                        o[i][c].z = fmaf(p[i], vv.z, o[i][c].z);
                        o[i][c].w = fmaf(p[i], vv.w, o[i][c].w);
                    }
                }
            }
        }
    }

    // out is (B, N, heads, D) contiguous
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= n_tokens) continue;
        const float inv = 1.0f / l[i];
        float* dst = out + (((long long)b * n_tokens + row) * heads + h) * d;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
            const int chunk = tx + 16 * c;
            if (chunk < d4)
                *reinterpret_cast<float4*>(dst + 4 * chunk) = make_float4(
                    o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv, o[i][c].w * inv);
        }
    }
}

template <int R>
int launch_simt(const float* q, const float* k, const float* v, float* out, int B,
                int n_tokens, int heads, int d, long long sb, long long sn, long long sh,
                float scale, cudaStream_t stream) {
    constexpr int kRows = SimtTile<R>::kRows;
    const size_t smem = ((size_t)3 * kRows * (d + 4) + (size_t)kRows * (kRows + 1)) *
                        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_f32_simt_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_tokens + kRows - 1) / kRows, B * heads);
    attention_f32_simt_kernel<R><<<grid, 256, smem, stream>>>(q, k, v, out, n_tokens, heads, d,
                                                             sb, sn, sh, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, heads, 128) f32 views sharing the element strides
// (sb, sn, sh) with unit stride on the last dim and 16-byte aligned rows;
// out: (B, N, heads, 128) contiguous. Any N >= 1. Returns cudaGetLastError().
extern "C" int attention_f32_d128(const void* q, const void* k, const void* v, void* out, int B,
                                  int n_tokens, int heads, long long sb, long long sn,
                                  long long sh, float scale, void* stream) {
    const size_t smem = kSmemFloats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_tf32x3_d128_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_tokens + kBlockQ - 1) / kBlockQ, B * heads);
    attention_tf32x3_d128_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), n_tokens, heads, sb, sn, sh, scale);
    return (int)cudaGetLastError();
}

// q, k, v: (B, N, heads, D) f32 views sharing the element strides (sb, sn, sh)
// with unit stride on the last dim and 16-byte aligned rows; out: (B, N,
// heads, D) contiguous. D a multiple of 4 up to 1024, any N >= 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a D it does not take.
extern "C" int attention_f32_any_d(const void* q, const void* k, const void* v, void* out,
                                   int B, int n_tokens, int heads, int d, long long sb,
                                   long long sn, long long sh, float scale, void* stream) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 0 || d % 4) return (int)cudaErrorInvalidValue;
    if (d <= SimtTile<4>::kMaxD)
        return launch_simt<4>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
    if (d <= SimtTile<2>::kMaxD)
        return launch_simt<2>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
    if (d <= SimtTile<1>::kMaxD)
        return launch_simt<1>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
    return (int)cudaErrorInvalidValue;
}

// q, k, v: (B, N, heads, D) f32 views sharing the element strides (sb, sn, sh)
// with unit stride on the last dim and 16-byte aligned rows; out: (B, N,
// heads, D) contiguous. D = 256, 384, ..., 1024, any N >= 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a D it does not take.
extern "C" int attention_f32_wide(const void* q, const void* k, const void* v, void* out, int B,
                                  int n_tokens, int heads, int d, long long sb, long long sn,
                                  long long sh, float scale, void* stream) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 256: return launch_wide<2>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 384: return launch_wide<3>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 512: return launch_wide<4>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 640: return launch_wide<5>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 768: return launch_wide<6>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 896: return launch_wide<7>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        case 1024: return launch_wide<8>(qf, kf, vf, of, B, n_tokens, heads, sb, sn, sh, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
