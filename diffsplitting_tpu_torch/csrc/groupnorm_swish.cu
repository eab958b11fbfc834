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
//   is 8 x 512 x 512 x 48 f32 (403 MB), far beyond the 50 MB L2; a 64 x 64 or
//   128 x 128 map at batch 8 (17-34 MB) fits in it.
//
// Design: two launches on the stream, on one (chunks, B) grid.
//   * gn_stats_kernel: the TPU kernel carried its sums across a sequential
//     grid in VMEM scratch. Blocks here run in parallel, so H*W is cut into
//     `chunks` row ranges per batch element and each block writes its own
//     per-channel partial sums (no atomics). The wrapper sizes the grid from
//     the SM count: chunks * B is about 4 blocks of 256 threads an SM (the
//     least __launch_bounds__ guarantees to be resident), one wave, so every
//     shape keeps the HBM busy, where a grid cut by the tensor's size left the
//     64^2-128^2 maps at one block an SM or none. Each thread keeps kUnroll
//     16-byte loads in flight.
//   * gn_normalize_kernel: each block folds its batch element's partials in a
//     fixed order (a fixed stride over the chunks, then over the strides)
//     into channel, then group statistics (C/G may be 3, 6 or 12: no power of
//     two is assumed), turns them into one scale a_c and shift b_c per
//     channel in shared memory, and writes y = swish(x * a + b). Every block
//     of a batch element folds the same partials in the same order, so they
//     agree bit for bit. (A third launch that folded once a call into a
//     scratch buffer, a normalize pass over the chunks in the reverse order,
//     and streaming cache hints were each measured against this: PERF.md.)
//   * The result depends on the grid (the SM count) but not on the order
//     blocks run in: two launches on one card give the same bits.
//   * Loads and stores are 16 bytes a thread (float4 over 4 channels). A
//     block of rows_per_iter x C/4 threads reads rows_per_iter full rows per
//     step, so neighbouring threads touch neighbouring addresses.
//   * Squares are taken in f32 (the input is f32), as the TPU kernel casts to
//     f32 before squaring.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads a block (at most)
constexpr int kMinBlocksPerSM = 4;
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ void add_sums(float4& s, float4& ss, const float4 v) {
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    ss.x += v.x * v.x; ss.y += v.y * v.y; ss.z += v.z * v.z; ss.w += v.w * v.w;
}

// partials layout: [B][chunks][2][C] (sum, then sum of squares). The block
// has rows_per_iter * c4 threads.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
gn_stats_kernel(const float4* __restrict__ x, float* __restrict__ partials, long long hw, int c4,
                int chunks, long long rows_per_chunk) {
    extern __shared__ float smem[];  // [rows_per_iter][2][C]
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int rows_per_iter = blockDim.x / c4;
    const int t = threadIdx.x;
    const int q = t % c4;   // channel quad
    const int r0 = t / c4;  // row offset inside one step
    const int C = c4 * 4;

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const float4* xb = x + (long long)b * hw * c4 + q;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ss = make_float4(0.f, 0.f, 0.f, 0.f);
    long long r = lo + r0;
    for (; r + (kUnroll - 1) * rows_per_iter < hi; r += kUnroll * rows_per_iter) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = xb[(r + u * rows_per_iter) * c4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_sums(s, ss, v[u]);
    }
    for (; r < hi; r += rows_per_iter) add_sums(s, ss, xb[r * c4]);

    float* mine = smem + r0 * 2 * C;
    mine[4 * q + 0] = s.x;  mine[4 * q + 1] = s.y;
    mine[4 * q + 2] = s.z;  mine[4 * q + 3] = s.w;
    mine[C + 4 * q + 0] = ss.x;  mine[C + 4 * q + 1] = ss.y;
    mine[C + 4 * q + 2] = ss.z;  mine[C + 4 * q + 3] = ss.w;
    __syncthreads();
    float* out = partials + ((long long)b * chunks + chunk) * 2 * C;
    for (int i = t; i < 2 * C; i += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < rows_per_iter; ++k) acc += smem[k * 2 * C + i];
        out[i] = acc;
    }
}

__device__ __forceinline__ float4 scale_shift_swish(const float4 v, const float4 a,
                                                    const float4 sh) {
    return make_float4(swish(v.x * a.x + sh.x), swish(v.y * a.y + sh.y),
                       swish(v.z * a.z + sh.z), swish(v.w * a.w + sh.w));
}

// strides * 2C + 2C floats of dynamic shared memory, strides = max(1,
// blockDim.x / 2C)
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
gn_normalize_kernel(const float4* __restrict__ x, const float* __restrict__ partials,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    float4* __restrict__ y, long long hw, int c4, int groups, int chunks,
                    long long rows_per_chunk, float eps) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);  // [strides][2C] partial folds, then [2C]
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int rows_per_iter = blockDim.x / c4;
    const int t = threadIdx.x;
    const int q = t % c4;
    const int r0 = t / c4;
    const int C = c4 * 4;
    const int E = 2 * C;

    // entry e of stride k: chunks k, k + strides, ... in order
    const int strides = max(1, (int)blockDim.x / E);
    const float* pb = partials + (long long)b * chunks * E;
    for (int i = t; i < strides * E; i += blockDim.x) {
        const int k = i / E, e = i % E;
        float acc = 0.f;
#pragma unroll 4
        for (int j = k; j < chunks; j += strides) acc += pb[(long long)j * E + e];
        smem[i] = acc;
    }
    __syncthreads();
    float* sums = smem + strides * E;  // sums[C], then sums of squares[C]
    for (int e = t; e < E; e += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < strides; ++k) acc += smem[k * E + e];
        sums[e] = acc;
    }
    __syncthreads();
    // channels -> groups -> per-channel scale a and shift, into smem[0, 2C)
    const int cs = C / groups;
    const float n = (float)((double)hw * cs);
    for (int c = t; c < C; c += blockDim.x) {
        const int g0 = (c / cs) * cs;
        float gs = 0.f, gq = 0.f;
        for (int k = 0; k < cs; ++k) { gs += sums[g0 + k]; gq += sums[C + g0 + k]; }
        const float mean = gs / n;
        const float var = fmaxf(gq / n - mean * mean, 0.f);  // cancellation guard
        const float a = rsqrtf(var + eps) * scale[c];
        smem[c] = a;
        smem[C + c] = bias[c] - mean * a;
    }
    __syncthreads();
    const float4 a = smem4[q];
    const float4 sh = smem4[c4 + q];

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const long long base = (long long)b * hw * c4 + q;
    long long r = lo + r0;
    for (; r + (kUnroll - 1) * rows_per_iter < hi; r += kUnroll * rows_per_iter) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = x[base + (r + u * rows_per_iter) * c4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            y[base + (r + u * rows_per_iter) * c4] = scale_shift_swish(v[u], a, sh);
    }
    for (; r < hi; r += rows_per_iter)
        y[base + r * c4] = scale_shift_swish(x[base + r * c4], a, sh);
}

}  // namespace

// x, y: (B, HW, C) contiguous f32, C % 4 == 0, C <= 1024, 16-byte aligned.
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
    const int strides = threads / (2 * C) > 0 ? threads / (2 * C) : 1;
    gn_normalize_kernel<<<grid, threads, (size_t)(strides + 1) * 2 * C * sizeof(float), st>>>(
        static_cast<const float4*>(x), static_cast<const float*>(partials),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float4*>(y), hw, c4, groups, chunks, rows_per_chunk, eps);
    return (int)cudaGetLastError();
}
