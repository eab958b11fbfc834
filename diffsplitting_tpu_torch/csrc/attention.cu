// Spatial self-attention softmax(q k^T * scale) v, float32, for sm_90a, at
// head dims below 128 (attention_tf32x3_narrow_kernel), on the tensor cores
// at float32 accuracy (3xTF32, below). D = 128 and above: attention_wide.cu.
//
// 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: each operand x
// is split as big = x rounded to TF32 (as cvt.rna.tf32.f32 rounds, with
// integer ops: split() in tf32x3.cuh), small = x - big, and a product
// accumulates small*big + big*small + big*big in f32 (the small*small term,
// about 2^-22 of the product, is dropped), so the result keeps float32
// accuracy. The MMA's accumulator rounds toward zero (measured on the H100
// for conv_gn.cu), so O is not summed over all N keys in it: each key tile's
// P V is summed from 0 and added to O in f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

// Narrow head dims: attention_tf32x3_narrow_kernel<DP>, D < 128 padded to DP.
//
// Replaces the same Pallas `_kernel` (diffsplitting_tpu/ops/attention.py:33)
//   at D < 128, D a multiple of 4: the mid block of a UNet whose last width is
//   below 128 (the splitting UNet at inner 8 attends at D = 64, at inner 12 at
//   D = 96; D = 16 in the parity tests).
//
// Bound: operations, 3 * 4 * N^2 * D TF32 flops a (batch, head) at 495
//   TFLOP/s (3xTF32), counted at the true D: 0.0130 ms at B = 8, N = 1024,
//   D = 64, 0.208 ms at N = 4096. The tensor cores work on DP, so the padding
//   adds DP / D - 1 to that work (below).
//
// Design: 3xTF32 mma.sync at a head dim DP, the smallest of 16, 32, 48, 64,
//   80, 96 that is >= D, and 128 for D in (96, 128).
//   * Padding: Q, K and V columns D ... DP - 1 are zero-filled in shared
//     memory (cp.async with a source size of 0: nothing is read) and never
//     stored; zeros add nothing to S, and O's columns past D are dropped. The
//     share (DP - D) / DP of the tensor-core work spent on zeros is none at
//     D = 16, 32, ..., 96; at the worst D of each DP, D = 4, 20, 36, 52, 68,
//     84, it is 75, 37.5, 25, 18.75, 15 and 12.5 %; at D = 100 ... 124 (DP =
//     128) 21.9 ... 3.1 %.
//   * One block of kWarps = 4 warps per (b * head, 64-query tile); each warp
//     owns 16 query rows. At B = 8, N = 1024 that is 128 blocks on the 132
//     SMs; 128-query blocks give 64, half the card, and took 49 % longer
//     there (H100 at 700 W, kernels/attention_variants.py --narrow; PERF.md).
//   * A ring of kStages stages of kTileK-key K and V tiles, filled by
//     cp.async.cg kStages - 1 tiles ahead; one barrier a tile. kTileK = 64 up
//     to DP = 64: a warp's S, its O and its tile's P V sum are then at most
//     32 floats each (64-key tiles spilled at a head dim of 128); 32 above.
//     32-key tiles at DP = 64 took 29 % longer at N = 1024. kStages is 3
//     where two blocks of it fit on an SM, else 2: at DP = 64 the Q tile and
//     two stages take 83,968 B a block (three stages, one block an SM, took
//     1.40x as long at N = 4096); at DP = 128, 99,328 B.
//   * Sums: 3xTF32 mma.sync.m16n8k8 through tf32x3.cuh, S over all of DP in
//     the MMA accumulator, and, since the accumulator rounds toward zero,
//     each key tile's P V summed from 0 and added to O in f32. Summing S a
//     16-wide head-dim step at a time from 0, as the first wide kernel did, erred less (5.1e-7 against f64 at B = 8, N = 1024, D = 64,
//     against 8.6e-7) but took 0.0719-0.0722 ms against 0.0524-0.0529 (the
//     `s_per_step` variant).
//   * P kept in registers by the key permutation (S's C fragment is P's A
//     fragment: logical k t <-> key 8j + 2t, t + 4 <-> 8j + 2t + 1); online
//     softmax in exp2; keys past N zero-filled and their scores set to -inf;
//     query rows past N zero-filled and not stored. Fixed order, no atomics:
//     two launches give the same bits.
//   * Shared-memory loads free of bank conflicts. Q and K: rows of DP floats
//     read in a permuted head-dim order that is the same for Q and K (a
//     float4 of d = 16s + 4t ... +3 feeds two k-steps); where a row is a multiple of 128 bytes (DP a
//     multiple of 32) odd rows swap the two halves of each 8-chunk block, else
//     rows r and r + 1 already fall 64 bytes apart. V: rows padded to DP + 4
//     floats, so that the keys 8j + 2t of t = 0 ... 3 fall 32 bytes apart, and
//     read as float2: n-tile u of P V's output, column c is d = 2 (8 (u / 2) +
//     c) + u % 2, so that a thread's two columns 2t, 2t + 1 of n-tiles 2i, 2i +
//     1 are the float4 at d = 16i + 4t of its output row.
//   * Registers and spills (-Xptxas -v, nvcc 12.8 for sm_90a, printed by
//     kernels/variants.py and chip_smoke.py): DP = 16: 127, 32: 162, 48: 136,
//     64: 173, 80: 130, 96: 168, 128: 213; 0 spills at every DP. Two blocks
//     of 128 threads fit an SM's registers at each.

constexpr size_t narrow_smem_bytes(int dp, int rows, int tile_k, int stages) {
    // the Q tile, then each stage's K tile (rows of dp) and V tile (rows of dp + 4)
    return ((size_t)rows * dp + (size_t)stages * tile_k * (2 * dp + 4)) * sizeof(float);
}

template <int DP>
struct NarrowTile {
    static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "the narrow kernel takes DP = 16 ... 128");
    static constexpr int kWarps = 4;                   // 16 query rows a warp
    static constexpr int kTileK = DP <= 64 ? 64 : 32;  // keys a stage
    static constexpr int kRows = 16 * kWarps;          // queries a block
    static constexpr int kStages =
        2 * (narrow_smem_bytes(DP, kRows, kTileK, 3) + 1024) <= 233472 ? 3 : 2;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kNT = kTileK / 8;   // 8-key n-tiles of S a tile
    static constexpr int kNO = DP / 8;       // 8-wide n-tiles of O
    static constexpr int kChunks = DP / 4;   // 16-byte chunks a Q or K row
    static constexpr int kLdV = DP + 4;      // floats a V row
    static constexpr int kStageFloats = kTileK * (DP + kLdV);
    static constexpr size_t kSmemBytes = narrow_smem_bytes(DP, kRows, kTileK, kStages);
    static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");
};

// 16-byte chunk offsets (in floats) of Q and K rows of DP floats
template <int DP>
__device__ __forceinline__ int narrow_qk_at(int row, int chunk) {
    if constexpr (DP % 32 == 0)
        return row * DP + ((chunk ^ ((row & 1) << 2)) << 2);
    else
        return row * DP + (chunk << 2);
}

template <int DP>
__global__ void __launch_bounds__(NarrowTile<DP>::kThreads)
attention_tf32x3_narrow_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out,
                               int n_tokens, int heads, int d, long long sb, long long sn,
                               long long sh, float scale) {
    using T = NarrowTile<DP>;
    constexpr int TK = T::kTileK, NT = T::kNT, NO = T::kNO, LDV = T::kLdV, STAGES = T::kStages;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][DP], swizzled
    float* Ring = Qs + T::kRows * DP;             // [STAGES][K: TK x DP, V: TK x LDV]

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * T::kRows;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // mma group: rows g and g + 8
    const int t = lane % 4;  // thread in group
    const int r0 = warp * 16;
    const bool active = q0 + r0 < n_tokens;  // warp-uniform
    const long long base = (long long)b * sb + (long long)h * sh;
    const int d4 = d / 4;  // 16-byte chunks a row that hold data; the rest are zeros

    // stage Q; rows past N and columns past D are zeros (a source size of 0
    // reads nothing)
    for (int c = tid; c < T::kRows * T::kChunks; c += T::kThreads) {
        const int row = c / T::kChunks, chunk = c % T::kChunks;
        const bool ok = q0 + row < n_tokens && chunk < d4;
        const long long src = base + (ok ? (long long)(q0 + row) * sn + chunk * 4 : 0);
        cp_async16_zfill(Qs + narrow_qk_at<DP>(row, chunk), q + src, ok);
    }
    // keys past N, and columns past D, are zeros in K and V
    auto stage_kv = [&](int tile, int stage) {
        float* kd = Ring + stage * T::kStageFloats;
        float* vd = kd + TK * DP;
        for (int c = tid; c < TK * T::kChunks; c += T::kThreads) {
            const int key = c / T::kChunks, chunk = c % T::kChunks;
            const int kg = tile * TK + key;
            const bool ok = kg < n_tokens && chunk < d4;
            const long long src = base + (ok ? (long long)kg * sn + chunk * 4 : 0);
            cp_async16_zfill(kd + narrow_qk_at<DP>(key, chunk), k + src, ok);
            cp_async16_zfill(vd + key * LDV + chunk * 4, v + src, ok);
        }
    };
    // the ring runs STAGES - 1 tiles ahead; a group is committed for every
    // tile slot, empty past the last tile, so the wait count holds throughout
    const int n_tiles = (n_tokens + TK - 1) / TK;
    for (int p = 0; p < STAGES - 1; ++p) {
        if (p < n_tiles) stage_kv(p, p);
        cp_async_commit();
    }

    const float c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<STAGES - 2>();  // tile it (and Q) have landed for this thread
        __syncthreads();  // ... and for every thread, and no warp still reads tile it - 1
        const int ahead = it + STAGES - 1;
        if (ahead < n_tiles) stage_kv(ahead, ahead % STAGES);  // into tile it - 1's stage
        cp_async_commit();

        if (active) {
            const float* Kt = Ring + (it % STAGES) * T::kStageFloats;
            const float* Vt = Kt + TK * DP;

            // S = Q K^T for rows r0+g, r0+g+8 and the tile's keys, summed over
            // all of DP in the MMA accumulator; k-step pair s takes
            // d = 16s + 4t + {0, 1} and 16s + 4t + {2, 3}
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
            for (int sp = 0; sp < DP / 16; ++sp) {
                const float4 qa =
                    *reinterpret_cast<const float4*>(Qs + narrow_qk_at<DP>(r0 + g, 4 * sp + t));
                const float4 qb = *reinterpret_cast<const float4*>(
                    Qs + narrow_qk_at<DP>(r0 + g + 8, 4 * sp + t));
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
                        *reinterpret_cast<const float4*>(Kt + narrow_qk_at<DP>(8 * n + g, 4 * sp + t));
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
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                s[n][0] = exp2f(s[n][0] - m_run[0]);
                s[n][1] = exp2f(s[n][1] - m_run[0]);
                s[n][2] = exp2f(s[n][2] - m_run[1]);
                s[n][3] = exp2f(s[n][3] - m_run[1]);
                l_run[0] += s[n][0] + s[n][1];
                l_run[1] += s[n][2] + s[n][3];
            }
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= corr[0];
                o[n][1] *= corr[0];
                o[n][2] *= corr[1];
                o[n][3] *= corr[1];
            }

            // O += P V over k-steps of 8 keys; n-tile 2i + e, column g is
            // d = 16i + 2g + e: a float2 of V a key for two n-tiles. The
            // tile's P V is summed from 0, then added to O in f32.
            float acc[NO][4] = {};  // this tile's P V, from 0
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t pb[4], ps[4];
                split(s[j][0], pb[0], ps[0]);
                split(s[j][2], pb[1], ps[1]);
                split(s[j][1], pb[2], ps[2]);
                split(s[j][3], pb[3], ps[3]);
                const float* v0row = Vt + (8 * j + 2 * t) * LDV + 2 * g;
#pragma unroll
                for (int i = 0; i < NO / 2; ++i) {
                    const float2 v0 = *reinterpret_cast<const float2*>(v0row + 16 * i);
                    const float2 v1 = *reinterpret_cast<const float2*>(v0row + LDV + 16 * i);
                    uint32_t b0b, b0s, b1b, b1s;
                    split(v0.x, b0b, b0s);
                    split(v1.x, b1b, b1s);
                    mma_3xtf32(acc[2 * i], pb, ps, b0b, b1b, b0s, b1s);
                    split(v0.y, b0b, b0s);
                    split(v1.y, b1b, b1s);
                    mma_3xtf32(acc[2 * i + 1], pb, ps, b0b, b1b, b0s, b1s);
                }
            }
#pragma unroll
            for (int n = 0; n < NO; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) o[n][i] += acc[n][i];
        }
    }

    if (!active) return;
    // out is (B, N, heads, D) contiguous; o[2i + e] holds d = 16i + 4t + e
    // (0, 2) and 16i + 4t + 2 + e (1, 3) of rows g (0, 1) and g + 8 (2, 3):
    // the float4 at d = 16i + 4t, stored where it lies below D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / l;
        const int row = q0 + r0 + g + 8 * r;
        if (row >= n_tokens) continue;
        float* dst = out + (((long long)b * n_tokens + row) * heads + h) * d + 4 * t;
#pragma unroll
        for (int i = 0; i < NO / 2; ++i)
            if (16 * i + 4 * t < d)
                *reinterpret_cast<float4*>(dst + 16 * i) = make_float4(
                    o[2 * i][2 * r] * inv, o[2 * i + 1][2 * r] * inv, o[2 * i][2 * r + 1] * inv,
                    o[2 * i + 1][2 * r + 1] * inv);
    }
}

template <int DP>
int launch_narrow(const float* q, const float* k, const float* v, float* out, int B,
                  int n_tokens, int heads, int d, long long sb, long long sn, long long sh,
                  float scale, cudaStream_t stream) {
    using T = NarrowTile<DP>;
    cudaError_t err = cudaFuncSetAttribute(attention_tf32x3_narrow_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_tokens + T::kRows - 1) / T::kRows, B * heads);
    attention_tf32x3_narrow_kernel<DP><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
        q, k, v, out, n_tokens, heads, d, sb, sn, sh, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, heads, D) f32 views sharing the element strides (sb, sn, sh)
// with unit stride on the last dim and 16-byte aligned rows; out: (B, N,
// heads, D) contiguous. D a multiple of 4 below 128, any N >= 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a D it does not take.
extern "C" int attention_f32_narrow(const void* q, const void* k, const void* v, void* out,
                                    int B, int n_tokens, int heads, int d, long long sb,
                                    long long sn, long long sh, float scale, void* stream) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 0 || d >= 128 || d % 4) return (int)cudaErrorInvalidValue;
    switch (d > 96 ? 8 : (d + 15) / 16) {
        case 1: return launch_narrow<16>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        case 2: return launch_narrow<32>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        case 3: return launch_narrow<48>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        case 4: return launch_narrow<64>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        case 5: return launch_narrow<80>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        case 6: return launch_narrow<96>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
        default: return launch_narrow<128>(qf, kf, vf, of, B, n_tokens, heads, d, sb, sn, sh, scale, st);
    }
}
