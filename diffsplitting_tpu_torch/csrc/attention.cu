// Spatial self-attention softmax(q k^T * scale) v, float32, head dim 128,
// for sm_90a, on the tensor cores at float32 accuracy.
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
