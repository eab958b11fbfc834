// GroupNorm + affine + Swish over NHWC float32 activations, for sm_90a.
//
// Replaces: diffsplitting_tpu/experimental/groupnorm_pallas.py,
//   `_stats_kernel` (per-(b, c) f32 sums of x and x^2) and
//   `_normalize_kernel` (group fold, rsqrt(max(E[x^2]-E[x]^2, 0) + eps),
//   gamma/beta, swish), both launched by `_pallas_forward`.
//
// Bound: device-memory bytes. The op reads x twice (once per pass) and
//   writes y once; the least it can move is one read and one write, so its
//   bound is 2 * |x| / HBM bandwidth. The largest tensor on the slice's path
//   is 8 x 512 x 512 x 48 f32 (403 MB), far beyond the 50 MB L2.
//
// Design:
//   * The TPU kernel carried its sums across a sequential grid in VMEM
//     scratch. Blocks here run in parallel, so pass 1 splits H*W into
//     `chunks` row ranges per batch element; each block writes its own
//     per-channel partial sums (no atomics: the result does not depend on
//     the order blocks run in).
//   * Pass 2 uses the same (b, chunk) grid. Each block folds its batch's
//     partials into channel and then group statistics in shared memory (C/G
//     may be 3, 6 or 12: no power of two is assumed), turns them into one
//     scale a_c and shift b_c per channel, and writes swish(x * a + b).
//   * Loads and stores are 16 bytes a thread (float4 over 4 channels). A
//     block of ROWS_PER_ITER x C/4 threads reads ROWS_PER_ITER full rows per
//     iteration, so neighbouring threads touch neighbouring addresses.
//   * Squares are taken in f32 (the input is f32), as the TPU kernel casts to
//     f32 before squaring.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

// partials layout: [B][chunks][2][C] (sum, then sum of squares)
__global__ void gn_stats_kernel(const float4* __restrict__ x, float* __restrict__ partials,
                                long long hw, int c4, int chunks, long long rows_per_chunk) {
    extern __shared__ float smem[];  // [rows_per_iter][2][C]
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int rows_per_iter = blockDim.x / c4;
    const int t = threadIdx.x;
    const int q = t % c4;        // channel quad
    const int r0 = t / c4;       // row offset inside one iteration
    const int C = c4 * 4;

    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ss = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 < rows_per_iter) {
        const long long row_lo = chunk * rows_per_chunk;
        long long row_hi = row_lo + rows_per_chunk;
        if (row_hi > hw) row_hi = hw;
        const float4* xb = x + (long long)b * hw * c4;
        for (long long r = row_lo + r0; r < row_hi; r += rows_per_iter) {
            const float4 v = xb[r * c4 + q];
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
            ss.x += v.x * v.x; ss.y += v.y * v.y; ss.z += v.z * v.z; ss.w += v.w * v.w;
        }
        float* mine = smem + (long long)r0 * 2 * C;
        mine[4 * q + 0] = s.x;  mine[4 * q + 1] = s.y;
        mine[4 * q + 2] = s.z;  mine[4 * q + 3] = s.w;
        mine[C + 4 * q + 0] = ss.x;  mine[C + 4 * q + 1] = ss.y;
        mine[C + 4 * q + 2] = ss.z;  mine[C + 4 * q + 3] = ss.w;
    }
    __syncthreads();
    float* out = partials + ((long long)b * chunks + chunk) * 2 * C;
    for (int i = t; i < 2 * C; i += blockDim.x) {
        float acc = 0.f;
        for (int r = 0; r < rows_per_iter; ++r) acc += smem[r * 2 * C + i];
        out[i] = acc;
    }
}

__global__ void gn_normalize_kernel(const float4* __restrict__ x, const float* __restrict__ partials,
                                    const float* __restrict__ scale, const float* __restrict__ bias,
                                    float4* __restrict__ y, long long hw, int c4, int groups,
                                    int chunks, long long rows_per_chunk, float eps) {
    extern __shared__ float smem[];  // sums[C], sqs[C], a[C], b[C]
    const int C = c4 * 4;
    float* sums = smem;
    float* sqs = smem + C;
    float* a_c = smem + 2 * C;
    float* b_c = smem + 3 * C;
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int t = threadIdx.x;

    // fold the batch's partials into per-channel sums
    const float* pb = partials + (long long)b * chunks * 2 * C;
    for (int i = t; i < 2 * C; i += blockDim.x) {
        float acc = 0.f;
        for (int j = 0; j < chunks; ++j) acc += pb[(long long)j * 2 * C + i];
        smem[i] = acc;  // i < C -> sums, else sqs
    }
    __syncthreads();
    // channels -> groups -> per-channel scale and shift
    const int cs = C / groups;
    const float n = (float)((double)hw * cs);
    for (int c = t; c < C; c += blockDim.x) {
        const int g0 = (c / cs) * cs;
        float gs = 0.f, gq = 0.f;
        for (int k = 0; k < cs; ++k) { gs += sums[g0 + k]; gq += sqs[g0 + k]; }
        const float mean = gs / n;
        const float var = fmaxf(gq / n - mean * mean, 0.f);  // cancellation guard
        const float a = rsqrtf(var + eps) * scale[c];
        a_c[c] = a;
        b_c[c] = bias[c] - mean * a;
    }
    __syncthreads();

    const int rows_per_iter = blockDim.x / c4;
    const int q = t % c4;
    const int r0 = t / c4;
    if (r0 >= rows_per_iter) return;
    const float4 a = make_float4(a_c[4 * q], a_c[4 * q + 1], a_c[4 * q + 2], a_c[4 * q + 3]);
    const float4 sh = make_float4(b_c[4 * q], b_c[4 * q + 1], b_c[4 * q + 2], b_c[4 * q + 3]);
    const long long row_lo = chunk * rows_per_chunk;
    long long row_hi = row_lo + rows_per_chunk;
    if (row_hi > hw) row_hi = hw;
    const long long base = (long long)b * hw * c4;
    for (long long r = row_lo + r0; r < row_hi; r += rows_per_iter) {
        const float4 v = x[base + r * c4 + q];
        float4 o;
        o.x = swish(v.x * a.x + sh.x);
        o.y = swish(v.y * a.y + sh.y);
        o.z = swish(v.z * a.z + sh.z);
        o.w = swish(v.w * a.w + sh.w);
        y[base + r * c4 + q] = o;
    }
}

}  // namespace

// x, y: (B, HW, C) contiguous f32, C % 4 == 0, 16-byte aligned.
// partials: B * chunks * 2 * C floats of scratch. Returns cudaGetLastError().
extern "C" int gn_swish_f32(const void* x, const void* scale, const void* bias, void* partials,
                            void* y, int B, long long hw, int C, int groups, int chunks,
                            long long rows_per_chunk, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int c4 = C / 4;
    const int rows_per_iter = kThreads / c4 > 0 ? kThreads / c4 : 1;
    const int threads = rows_per_iter * c4;
    const dim3 grid(chunks, B);
    gn_stats_kernel<<<grid, threads, (size_t)rows_per_iter * 2 * C * sizeof(float), st>>>(
        static_cast<const float4*>(x), static_cast<float*>(partials), hw, c4, chunks,
        rows_per_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gn_normalize_kernel<<<grid, threads, (size_t)4 * C * sizeof(float), st>>>(
        static_cast<const float4*>(x), static_cast<const float*>(partials),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float4*>(y), hw, c4, groups, chunks, rows_per_chunk, eps);
    return (int)cudaGetLastError();
}
