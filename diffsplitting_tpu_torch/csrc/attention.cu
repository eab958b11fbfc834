// Spatial self-attention softmax(q k^T * scale) v, float32, head dim 128,
// for sm_90a.
//
// Replaces: diffsplitting_tpu/ops/attention.py, `_kernel` (launched by
//   `_pallas_forward`), which held the whole N x N f32 score matrix of one
//   (batch, head) in VMEM. At the splitting UNet's mid block (64 x 64 map,
//   N = 4096 tokens) that matrix alone is 64 MB, and with B = 8 the scores
//   would be 512 MB of device memory traffic each way.
//
// Bound: operations. Per (batch, head) the two products take 4 * N^2 * D
//   flops (68.7 GFLOP at B = 8, N = 4096, D = 128) against 4 * N * D * 4
//   bytes of input and output, so the card's f32 rate, not its memory,
//   bounds it.
//
// Design (flash-style, online softmax, plain f32 FMA, no TF32):
//   * One block of 256 threads per (b * head, 64-query tile). The query tile
//     is staged once in shared memory, transposed (Qt[d][query]).
//   * A loop over 64-key tiles stages K transposed (Kt[d][key]) and V
//     (Vs[key][d]) in dynamic shared memory: 112 KB in all, above the 48 KB
//     static limit, granted with cudaFuncSetAttribute.
//   * Each thread owns a 4 x 4 patch of the 64 x 64 score tile and a 4 x 8
//     patch of the 64 x 128 output; its 4 query rows are shared with the 15
//     other lanes of its half-warp, which reduce row max and row sum with
//     shuffles.
//   * The running max and sum stay in f32 registers, O accumulates in f32
//     and is divided by the sum once at the end. The scores never leave the
//     SM.
//   * N must be a multiple of 64 and D must be 128; the wrapper raises on
//     anything else.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 128;
constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr size_t kSmemFloats = (size_t)kD * kTile * 3 + (size_t)kTile * kTile;

__global__ void __launch_bounds__(kThreads)
attention_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int n_tokens,
                      int heads, long long sb, long long sn, long long sh, float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* Qt = smem;                        // [kD][kTile]
    float* Kt = Qt + kD * kTile;             // [kD][kTile]
    float* Vs = Kt + kD * kTile;             // [kTile][kD]
    float* Pt = Vs + kTile * kD;             // [kTile keys][kTile queries]

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * kTile;
    const int t = threadIdx.x;
    const int ty = t / 16;  // query group: rows ty*4 .. ty*4+3
    const int tx = t % 16;  // key group (cols tx*4 ..) and d group (tx*8 ..)
    const long long base = (long long)b * sb + (long long)h * sh;

    // stage Q transposed: thread reads one float4 of one token
    for (int p = 0; p < (kD / 4) * kTile / kThreads; ++p) {
        const int n = t % kTile;
        const int dq = t / kTile + p * (kThreads / kTile);
        const float4 val = *reinterpret_cast<const float4*>(
            q + base + (long long)(q0 + n) * sn + dq * 4);
        Qt[(dq * 4 + 0) * kTile + n] = val.x;
        Qt[(dq * 4 + 1) * kTile + n] = val.y;
        Qt[(dq * 4 + 2) * kTile + n] = val.z;
        Qt[(dq * 4 + 3) * kTile + n] = val.w;
    }

    float m[4], l[4], o[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < n_tokens; k0 += kTile) {
        // stage K transposed and V as is
        for (int p = 0; p < (kD / 4) * kTile / kThreads; ++p) {
            const int n = t % kTile;
            const int dq = t / kTile + p * (kThreads / kTile);
            const float4 val = *reinterpret_cast<const float4*>(
                k + base + (long long)(k0 + n) * sn + dq * 4);
            Kt[(dq * 4 + 0) * kTile + n] = val.x;
            Kt[(dq * 4 + 1) * kTile + n] = val.y;
            Kt[(dq * 4 + 2) * kTile + n] = val.z;
            Kt[(dq * 4 + 3) * kTile + n] = val.w;
        }
        for (int p = 0; p < (kD / 4) * kTile / kThreads; ++p) {
            const int idx = t + p * kThreads;
            const int n = idx / (kD / 4);
            const int dq = idx % (kD / 4);
            reinterpret_cast<float4*>(Vs)[n * (kD / 4) + dq] = *reinterpret_cast<const float4*>(
                v + base + (long long)(k0 + n) * sn + dq * 4);
        }
        __syncthreads();

        // scores for rows ty*4+i, keys tx*4+j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < kD; ++d) {
            const float4 a = reinterpret_cast<const float4*>(Qt + d * kTile)[ty];
            const float4 c = reinterpret_cast<const float4*>(Kt + d * kTile)[tx];
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
        }

        // online softmax over this key tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] *= scale;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                rs += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * corr + rs;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 8; ++j) o[i][j] *= corr;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kTile)[ty] =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncthreads();

        // O[rows ty*4+i][d tx*8+j] += P V
#pragma unroll 4
        for (int kk = 0; kk < kTile; ++kk) {
            const float4 p = reinterpret_cast<const float4*>(Pt + kk * kTile)[ty];
            const float4 v0 = reinterpret_cast<const float4*>(Vs + kk * kD)[tx * 2];
            const float4 v1 = reinterpret_cast<const float4*>(Vs + kk * kD)[tx * 2 + 1];
            const float pv[4] = {p.x, p.y, p.z, p.w};
            const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
        }
        __syncthreads();  // Kt, Vs and Pt are rewritten by the next tile
    }

    // out is (B, N, heads, D) contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float inv = 1.0f / l[i];
        const int row = q0 + ty * 4 + i;
        float4* dst = reinterpret_cast<float4*>(
            out + (((long long)b * n_tokens + row) * heads + h) * kD + tx * 8);
        dst[0] = make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
        dst[1] = make_float4(o[i][4] * inv, o[i][5] * inv, o[i][6] * inv, o[i][7] * inv);
    }
}

}  // namespace

// q, k, v: (B, N, heads, 128) f32 views sharing the element strides
// (sb, sn, sh) with unit stride on the last dim and 16-byte aligned rows;
// out: (B, N, heads, 128) contiguous. N % 64 == 0. Returns cudaGetLastError().
extern "C" int attention_f32_d128(const void* q, const void* k, const void* v, void* out, int B,
                                  int n_tokens, int heads, long long sb, long long sn,
                                  long long sh, float scale, void* stream) {
    const size_t smem = kSmemFloats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_d128_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_tokens / kTile, B * heads);
    attention_d128_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), n_tokens, heads, sb, sn, sh, scale);
    return (int)cudaGetLastError();
}
