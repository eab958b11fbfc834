// GroupNorm + affine + Swish over NHWC float32 or bfloat16 activations, for
// sm_90a.
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
//   * Loads and stores are 16 bytes a thread: a vector of 4 f32 or 8 bf16
//     channels. A row of C channels is C / 4 or C / 8 vectors; a thread
//     covers kPer of them, vectors q, q + C/(E kPer), ... of its row (kPer =
//     1, or 2 for f32 rows past 256 vectors, C in (1024, 2048]), so a block
//     of rows_per_iter x (vectors / kPer) threads reads rows_per_iter full
//     rows a step and neighbouring threads touch neighbouring addresses. At
//     kPer = 2 the kernels keep 2 blocks an SM resident (128 registers a
//     thread): at 4 the normalize pass spilled 52 bytes.
//   * bf16 (the UNet at compute_dtype bfloat16): each value is made f32 as it
//     is loaded, so the sums of x and x^2 are f32 (x made f32 before
//     squaring, as groupnorm_pallas.py:39-42 warns a bf16 square loses 8
//     bits), the scale, shift and swish are f32, and y is rounded to bf16 once,
//     at the store (__float2bfloat16_rn), as the TPU kernel writes
//     out_ref.dtype. The statistics scratch stays f32. Its bound is half the
//     f32 kernel's bytes.
//   * C up to 2048 in both types (sr_sr3_64_512's up path concatenates 1024 +
//     1024 channels at 32^2 and 1024 + 512 at 32^2 and 64^2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads a block (at most)
constexpr int kMinBlocksPerSM = 4;
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

// 16 bytes of T as E floats, and back
template <typename T>
struct Vec;

template <>
struct Vec<float> {
    static constexpr int E = 4;
    using Raw = float4;
    static __device__ __forceinline__ void unpack(const Raw r, float (&f)[E]) {
        f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
    }
    static __device__ __forceinline__ Raw pack(const float (&f)[E]) {
        return make_float4(f[0], f[1], f[2], f[3]);
    }
};

template <>
struct Vec<__nv_bfloat16> {
    static constexpr int E = 8;
    using Raw = uint4;
    static __device__ __forceinline__ void unpack(const Raw r, float (&f)[E]) {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // the low half is the lower channel; a bf16 is the top half of an f32
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ Raw pack(const float (&f)[E]) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

template <int E>
__device__ __forceinline__ void add_sums(float (&s)[E], float (&ss)[E], const float (&v)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
        s[e] += v[e];
        ss[e] += v[e] * v[e];
    }
}

// partials layout: [B][chunks][2][C] (sum, then sum of squares). The block
// has rows_per_iter * tpr threads, tpr = cv / kPer threads a row of cv
// vectors.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads, kPer == 1 ? kMinBlocksPerSM : 2)
gn_stats_kernel(const typename Vec<T>::Raw* __restrict__ x, float* __restrict__ partials,
                long long hw, int cv, int chunks, long long rows_per_chunk) {
    using V = Vec<T>;
    constexpr int E = V::E;
    extern __shared__ float smem[];  // [rows_per_iter][2][C]
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int tpr = cv / kPer;
    const int rows_per_iter = blockDim.x / tpr;
    const int t = threadIdx.x;
    const int q = t % tpr;  // first vector of the thread's row
    const int r0 = t / tpr;  // row offset inside one step
    const int C = cv * E;

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const typename V::Raw* xb = x + (long long)b * hw * cv + q;
    float s[kPer][E] = {}, ss[kPer][E] = {};
    long long r = lo + r0;
    for (; r + (kUnroll - 1) * rows_per_iter < hi; r += kUnroll * rows_per_iter) {
        typename V::Raw raw[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j) raw[u][j] = xb[(r + u * rows_per_iter) * cv + j * tpr];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                float v[E];
                V::unpack(raw[u][j], v);
                add_sums(s[j], ss[j], v);
            }
    }
    for (; r < hi; r += rows_per_iter)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            float v[E];
            V::unpack(xb[r * cv + j * tpr], v);
            add_sums(s[j], ss[j], v);
        }

    float* mine = smem + r0 * 2 * C;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            mine[(q + j * tpr) * E + e] = s[j][e];
            mine[C + (q + j * tpr) * E + e] = ss[j][e];
        }
    __syncthreads();
    float* out = partials + ((long long)b * chunks + chunk) * 2 * C;
    for (int i = t; i < 2 * C; i += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < rows_per_iter; ++k) acc += smem[k * 2 * C + i];
        out[i] = acc;
    }
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::Raw scale_shift_swish(const typename Vec<T>::Raw r,
                                                                  const float* a,
                                                                  const float* sh) {
    constexpr int E = Vec<T>::E;
    float v[E];
    Vec<T>::unpack(r, v);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = swish(v[e] * a[e] + sh[e]);
    return Vec<T>::pack(v);
}

// strides * 2C + 2C floats of dynamic shared memory, strides = max(1,
// blockDim.x / 2C)
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads, kPer == 1 ? kMinBlocksPerSM : 2)
gn_normalize_kernel(const typename Vec<T>::Raw* __restrict__ x,
                    const float* __restrict__ partials, const float* __restrict__ scale,
                    const float* __restrict__ bias, typename Vec<T>::Raw* __restrict__ y,
                    long long hw, int cv, int groups, int chunks, long long rows_per_chunk,
                    float eps) {
    using V = Vec<T>;
    constexpr int E = V::E;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);  // [strides][2C] partial folds, then [2C]
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int tpr = cv / kPer;
    const int rows_per_iter = blockDim.x / tpr;
    const int t = threadIdx.x;
    const int q = t % tpr;
    const int r0 = t / tpr;
    const int C = cv * E;
    const int E2 = 2 * C;

    // entry e of stride k: chunks k, k + strides, ... in order
    const int strides = max(1, (int)blockDim.x / E2);
    const float* pb = partials + (long long)b * chunks * E2;
    for (int i = t; i < strides * E2; i += blockDim.x) {
        const int k = i / E2, e = i % E2;
        float acc = 0.f;
#pragma unroll 4
        for (int j = k; j < chunks; j += strides) acc += pb[(long long)j * E2 + e];
        smem[i] = acc;
    }
    __syncthreads();
    float* sums = smem + strides * E2;  // sums[C], then sums of squares[C]
    for (int e = t; e < E2; e += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < strides; ++k) acc += smem[k * E2 + e];
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
    float a[kPer][E], sh[kPer][E];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            a[j][e] = smem[(q + j * tpr) * E + e];
            sh[j][e] = smem[C + (q + j * tpr) * E + e];
        }

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const long long base = (long long)b * hw * cv + q;
    long long r = lo + r0;
    for (; r + (kUnroll - 1) * rows_per_iter < hi; r += kUnroll * rows_per_iter) {
        typename V::Raw raw[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                raw[u][j] = x[base + (r + u * rows_per_iter) * cv + j * tpr];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                y[base + (r + u * rows_per_iter) * cv + j * tpr] =
                    scale_shift_swish<T>(raw[u][j], a[j], sh[j]);
    }
    for (; r < hi; r += rows_per_iter)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
            y[base + r * cv + j * tpr] = scale_shift_swish<T>(x[base + r * cv + j * tpr], a[j], sh[j]);
}

template <typename T, int kPer>
int launch_gn_swish(const void* x, const void* scale, const void* bias, void* partials, void* y,
                    int B, long long hw, int C, int groups, int chunks,
                    long long rows_per_chunk, float eps, cudaStream_t st) {
    using Raw = typename Vec<T>::Raw;
    const int cv = C / Vec<T>::E;
    const int tpr = cv / kPer;
    const int rows_per_iter = kThreads / tpr > 0 ? kThreads / tpr : 1;
    const int threads = rows_per_iter * tpr;
    const dim3 grid(chunks, B);
    gn_stats_kernel<T, kPer><<<grid, threads, (size_t)rows_per_iter * 2 * C * sizeof(float), st>>>(
        static_cast<const Raw*>(x), static_cast<float*>(partials), hw, cv, chunks,
        rows_per_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int strides = threads / (2 * C) > 0 ? threads / (2 * C) : 1;
    gn_normalize_kernel<T, kPer>
        <<<grid, threads, (size_t)(strides + 1) * 2 * C * sizeof(float), st>>>(
            static_cast<const Raw*>(x), static_cast<const float*>(partials),
            static_cast<const float*>(scale), static_cast<const float*>(bias),
            static_cast<Raw*>(y), hw, cv, groups, chunks, rows_per_chunk, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, HW, C) contiguous f32, 16-byte aligned; C % 4 == 0 up to 1024,
// C % 8 == 0 in (1024, 2048] (two vectors a thread there). scale, bias: C
// f32. partials: B * chunks * 2 * C floats of scratch. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a C it does not take.
extern "C" int gn_swish_f32(const void* x, const void* scale, const void* bias, void* partials,
                            void* y, int B, long long hw, int C, int groups, int chunks,
                            long long rows_per_chunk, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || C <= 0 || C > 2048 || (C > 1024 && C % 8)) return (int)cudaErrorInvalidValue;
    if (C <= 1024)
        return launch_gn_swish<float, 1>(x, scale, bias, partials, y, B, hw, C, groups, chunks,
                                         rows_per_chunk, eps, st);
    return launch_gn_swish<float, 2>(x, scale, bias, partials, y, B, hw, C, groups, chunks,
                                     rows_per_chunk, eps, st);
}

// x, y: (B, HW, C) contiguous bf16, 16-byte aligned, C % 8 == 0 up to 2048;
// scale, bias: C f32; partials: B * chunks * 2 * C floats of scratch. The
// statistics and the arithmetic are f32, y is rounded to bf16 at the store.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a C it does not
// take.
extern "C" int gn_swish_bf16(const void* x, const void* scale, const void* bias, void* partials,
                             void* y, int B, long long hw, int C, int groups, int chunks,
                             long long rows_per_chunk, float eps, void* stream) {
    if (C % 8 || C <= 0 || C > 2048) return (int)cudaErrorInvalidValue;
    return launch_gn_swish<__nv_bfloat16, 1>(x, scale, bias, partials, y, B, hw, C, groups,
                                             chunks, rows_per_chunk, eps,
                                             static_cast<cudaStream_t>(stream));
}
