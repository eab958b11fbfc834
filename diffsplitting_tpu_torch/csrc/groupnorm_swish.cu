// GroupNorm + affine + Swish over NHWC float32 or bfloat16 activations, for
// sm_90a.
//
// Replaces: diffsplitting_tpu/experimental/groupnorm_pallas.py,
//   `_stats_kernel` (per-(b, c) f32 sums of x and x^2) and
//   `_normalize_kernel` (group fold, rsqrt(max(E[x^2]-E[x]^2, 0) + eps),
//   gamma/beta, swish), both launched by `_pallas_forward`.
//
// Bound: device-memory bytes, 2 * |x| / HBM bandwidth (x read once, y written
//   once) on either route below. The arithmetic (two f32 sums, one FMA, an
//   exponential and a reciprocal an element) runs on the SMs' FP32 and
//   special-function units; at 2 MUFU operations an element it takes about
//   half the bytes' time on a whole card, so it has to overlap the traffic.
//
// Two routes, chosen per call by ops/groupnorm.py `plan` from (B, H*W, C, G,
// dtype, SM count):
//
//   * cluster (one launch, one read of x, one write of y): GroupNorm's
//     statistics are per (batch element, group), and groups are contiguous
//     channel ranges. A thread-block cluster of K blocks owns a slab of
//     (b, S channels of whole groups, a multiple of 16 bytes a row; the
//     planner takes 32 or more) over all H*W rows; each block holds
//     ceil(H*W / K) of its rows in shared memory. The rows arrive in 4
//     stages, so the sums of a stage start while the next is in flight:
//     where the slab is the whole row, by one TMA bulk copy a stage
//     (cp.async.bulk) completing on its own mbarrier; else 16 bytes a
//     thread by cp.async, a commit group a stage (a bulk copy a row of 32-96
//     bytes took 3.6x as long at (128^2, 768) bf16: PERF.md). Each block
//     sums its rows in f32 (x made f32 before squaring, as
//     groupnorm_pallas.py:39-42 requires), folds its threads' sums in a
//     fixed order, and the cluster adds the K blocks' per-channel sums
//     through distributed shared memory in rank order, so every block of
//     the cluster computes the same statistics bit for bit. Each block then
//     normalises its rows from shared memory and stores y: the bound's bytes
//     and nothing more. Maps whose slab does not fit a cluster's shared
//     memory (at most 8 blocks, portable; 16 when asked), or that would
//     load the SMs unevenly, take:
//   * stream (two launches on one (chunks, B) grid): gn_stats_kernel cuts
//     H*W into `chunks` row ranges an element, one 256-thread block each,
//     about 4 blocks an SM in one wave, with 8 (f32) or 4 (bf16) 16-byte
//     loads in flight a thread. Where an element has more than 128 chunks,
//     the blocks of a cluster of up to 8 along the chunks (the most that
//     keeps the wave whole) first add their per-channel partials through
//     distributed shared memory (rank order), and rank 0 writes one partial
//     (2C floats) for the cluster. Every gn_normalize_kernel block folds its
//     element's chunks / cluster partials itself, in a fixed order, into a
//     scale a_c and shift b_c a channel, reads x again and writes y: 3 |x|
//     of traffic, the second read partly from L2. The clusters cut the fold
//     8-fold where it costs most (528 chunks an element at the 512^2 maps;
//     folding every chunk's partial in every block, the earlier design, read
//     3.2 GB of L2 at (64^2, 1536) bf16, a map the cluster route now takes).
//     A fold once an element, by the last cluster to arrive on a counter,
//     ran 0.3-1.1 % slower in every measured run (PERF.md) and needed state
//     shared by calls, so each block folds.
//
// Determinism: every sum runs in an order fixed by the launch's shape (no
//   float atomics, no state kept between calls), so two launches give the
//   same bits, and calls on several streams do not interfere.
//
// Types: loads and stores are 16 bytes, 4 f32 or 8 bf16 channels. bf16 is
//   made f32 as it is loaded: f32 sums, scale, shift and swish (the fast
//   exponential and reciprocal), y rounded to bf16 once, at the store
//   (__float2bfloat16_rn), as the TPU kernel writes out_ref.dtype. The
//   statistics scratch is f32. C up to 2048 in both types; on the stream
//   route a thread covers two vectors of a row where a row has more than 256
//   (f32 at C > 1024, 2 blocks an SM there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // stream route: threads a block (at most)
constexpr int kMinBlocksPerSM = 4;
// stream route: 16-byte loads in flight a thread, f32 and bf16
template <typename T>
constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;
constexpr int kClusterThreads = 512;   // cluster route: threads a block (at most)
constexpr int kPartFloats = 4096;      // cluster route: the threads' sums, 16 KB
constexpr int kStages = 4;             // cluster route: load stages (mbarriers, cp.async groups)
constexpr int kSmemMax = 232448;       // dynamic shared memory a block may have
constexpr int kMaxCluster = 16;        // blocks a cluster (above 8: non-portable)
constexpr int kMaxStreamCluster = 8;   // stream route: blocks a cluster along the chunks
constexpr int kMaxBatch = 65535;       // grid.y

__device__ __forceinline__ float swish(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

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

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes) : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    }
}

// bytes from global to shared by the TMA unit, completed on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// 16 bytes from global to shared by this thread (cp.async, in L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// until at most `pending` (0 ... kStages - 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
    switch (pending) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    }
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// every thread of every block of the cluster: arrive, then wait
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared-memory address p of this block, in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
    return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
}

// out[i] = sum over the cluster's K blocks, in rank order, of their buf[i],
// for i < n (the K loads of an entry issued together); every thread of the
// block calls it
template <int kMaxK>
__device__ __forceinline__ void cluster_sum(const float* buf, float* out, int n, int K) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float v[kMaxK];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) v[k] = k < K ? ld_cluster(cluster_addr(buf + i, k)) : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k)
            if (k < K) acc += v[k];
        out[i] = acc;
    }
}

// ----------------------------------------------------------- the statistics

// sums[0, Cl) and sums[Cl, 2Cl): per-channel sums of x and x^2 over hw rows
// of Cl channels in groups of cs -> out[c] = a_c = rsqrt(var + eps) * scale[c],
// out[Cl + c] = bias[c] - mean * a_c. Each group is folded over its channels
// in order; every thread of the block calls it.
__device__ __forceinline__ void group_coef(const float* sums, int Cl, int cs, long long hw,
                                           const float* scale, const float* bias, float eps,
                                           float* out) {
    const float n = (float)((double)hw * cs);
    for (int c = threadIdx.x; c < Cl; c += blockDim.x) {
        const int g0 = (c / cs) * cs;
        float gs = 0.f, gq = 0.f;
        for (int k = 0; k < cs; ++k) { gs += sums[g0 + k]; gq += sums[Cl + g0 + k]; }
        const float mean = gs / n;
        const float var = fmaxf(gq / n - mean * mean, 0.f);  // cancellation guard
        const float a = rsqrtf(var + eps) * scale[c];
        out[c] = a;
        out[Cl + c] = bias[c] - mean * a;
    }
}

// the n partials pb[n][2C] of one batch element, folded in a fixed order (a
// fixed stride over the partials, then over the strides) into out[2C] =
// (a_c, b_c). scratch: max(1, blockDim.x / 2C) * 2C + 2C floats of shared
// memory. Partials written by other blocks are read past L1.
__device__ void fold_coef(const float* pb, int n, int C, int cs, long long hw,
                          const float* scale, const float* bias, float eps, float* scratch,
                          float* out) {
    const int E2 = 2 * C;
    const int strides = max(1, (int)blockDim.x / E2);
    constexpr int kBatch = 8;  // loads issued together, then added in order
    for (int i = threadIdx.x; i < strides * E2; i += blockDim.x) {
        const int k = i / E2, e = i % E2;
        float acc = 0.f;
        for (int j = k; j < n; j += kBatch * strides) {
            float v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int jj = j + u * strides;
                v[u] = jj < n ? __ldcg(pb + (long long)jj * E2 + e) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                if (j + u * strides < n) acc += v[u];
        }
        scratch[i] = acc;
    }
    __syncthreads();
    float* sums = scratch + strides * E2;
    for (int e = threadIdx.x; e < E2; e += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < strides; ++k) acc += scratch[k * E2 + e];
        sums[e] = acc;
    }
    __syncthreads();
    group_coef(sums, C, cs, hw, scale, bias, eps, out);
    __syncthreads();
}

// --------------------------------------------------------- the cluster route

// Grid ((C / S) * K, B), clusters of (K, 1, 1): the block of rank k in
// cluster s of batch element b holds rows [k * rpb, min((k + 1) * rpb, hw))
// x channels [s * S, (s + 1) * S). blockDim.x = rpi * S / E (rpi rows a
// step). Shared memory: 128 bytes of mbarriers, the rows (rpb * S * sizeof T),
// then red[2S], tot[2S], coef[2S] and part[rpi][2S] floats.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, long long hw, int C, int S,
                  int cs, int K, int rpb, float eps) {
    using V = Vec<T>;
    using Raw = typename V::Raw;
    constexpr int E = V::E;
    extern __shared__ __align__(128) unsigned char cluster_smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(cluster_smem);
    unsigned char* rows = cluster_smem + 128;
    const Raw* tile = reinterpret_cast<const Raw*>(rows);
    const int vs = S / E;  // vectors a slab row
    const int rpi = blockDim.x / vs;
    float* red = reinterpret_cast<float*>(rows + (size_t)rpb * S * sizeof(T));
    float* tot = red + 2 * S;
    float* coef = tot + 2 * S;
    float* part = coef + 2 * S;

    const int t = threadIdx.x;
    const int q = t % vs, r0 = t / vs;
    const int b = blockIdx.y;
    const int c0 = (blockIdx.x / K) * S;
    const long long lo = (long long)cluster_rank() * rpb;
    const int n = (int)max(0LL, min((long long)rpb, hw - lo));
    // stages of rps rows, a multiple of rpi, so a thread's rows stay its own
    const int rps = (n + kStages * rpi - 1) / (kStages * rpi) * rpi;
    const uint32_t row_bytes = S * sizeof(T);
    const T* src = x + ((long long)b * hw + lo) * C + c0;

    if (t == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the whole row: one bulk copy a stage; a slab of it: 16 bytes a thread
    const bool bulk = S == C;
    if (bulk && t == 0) {
        for (int s = 0; s < kStages; ++s) {
            const int s_lo = s * rps;
            const int s_n = max(0, min(rps, n - s_lo));
            mbar_expect_tx(&bars[s], s_n * row_bytes);
            if (s_n)
                bulk_copy(rows + (size_t)s_lo * row_bytes, src + (long long)s_lo * C,
                          s_n * row_bytes, &bars[s]);
        }
    } else if (!bulk) {
        Raw* to = reinterpret_cast<Raw*>(rows);
        for (int s = 0; s < kStages; ++s) {
            const int s_lo = s * rps;
            const int s_n = max(0, min(rps, n - s_lo));
            for (int i = t; i < s_n * vs; i += blockDim.x) {
                const int r = s_lo + i / vs, v = i % vs;
                const Raw* from = reinterpret_cast<const Raw*>(src + (long long)r * C) + v;
                cp_async16(to + r * vs + v, from);
            }
            cp_async_commit();
        }
    }

    float s[E] = {}, ss[E] = {};
    for (int st = 0; st < kStages; ++st) {
        const int s_lo = st * rps, s_hi = min(n, s_lo + rps);
        if (s_lo >= s_hi) break;
        if (bulk) {
            mbar_wait(&bars[st], 0);
        } else {
            cp_async_wait(kStages - 1 - st);
            __syncthreads();
        }
#pragma unroll 4
        for (int r = s_lo + r0; r < s_hi; r += rpi) {
            float v[E];
            V::unpack(tile[r * vs + q], v);
            add_sums(s, ss, v);
        }
    }
    float* mine = part + r0 * 2 * S;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        mine[q * E + e] = s[e];
        mine[S + q * E + e] = ss[e];
    }
    __syncthreads();
    for (int i = t; i < 2 * S; i += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < rpi; ++k) acc += part[k * 2 * S + i];
        red[i] = acc;
    }
    cluster_arrive();  // red is complete in every block of the cluster
    cluster_wait();
    cluster_sum<kMaxCluster>(red, tot, 2 * S, K);
    cluster_arrive();  // done reading the other blocks' red; wait before exit
    __syncthreads();
    group_coef(tot, S, cs, hw, scale + c0, bias + c0, eps, coef);
    __syncthreads();

    float a[E], sh[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        a[e] = coef[q * E + e];
        sh[e] = coef[S + q * E + e];
    }
    Raw* dst = reinterpret_cast<Raw*>(y + ((long long)b * hw + lo) * C + c0) + q;
    const int cv = C / E;
#pragma unroll 4
    for (int r = r0; r < n; r += rpi)
        dst[(long long)r * cv] = scale_shift_swish<T>(tile[r * vs + q], a, sh);
    cluster_wait();
}

// threads and dynamic shared memory of a cluster-route block; 0 threads for
// a slab the kernel does not take
template <typename T>
void cluster_shape(int S, long long rpb, int& threads, size_t& smem) {
    constexpr int E = Vec<T>::E;
    const int vs = S / E;
    const int rpi = vs > 0 ? min(kClusterThreads / vs, kPartFloats / (2 * S)) : 0;
    threads = rpi * vs;
    smem = 128 + (size_t)rpb * S * sizeof(T) + (size_t)(6 + 2 * rpi) * S * sizeof(float);
}

template <typename T>
int launch_cluster(const void* x, const void* scale, const void* bias, void* y, int B,
                   long long hw, int C, int groups, int S, int K, long long rpb, float eps,
                   cudaStream_t st) {
    const int cs = C / groups;
    int threads;
    size_t smem;
    cluster_shape<T>(S, rpb, threads, smem);
    if (S <= 0 || (S * sizeof(T)) % 16 || C % S || S % cs || K < 1 || K > kMaxCluster ||
        rpb < 1 || rpb * K < hw || threads < 1 || smem > (size_t)kSmemMax)
        return (int)cudaErrorInvalidValue;
    auto kernel = gn_cluster_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && K > 8)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((C / S) * K, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                             static_cast<const float*>(scale), static_cast<const float*>(bias),
                             static_cast<T*>(y), hw, C, S, cs, K, (int)rpb, eps);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------- the stream route

// Grid (chunks, B), clusters of (Ks, 1, 1) along the chunks. partials:
// [B][chunks / Ks][2C] (sum, then sum of squares), one a cluster, written by
// its rank 0. The block has rows_per_iter * tpr threads, tpr = cv / kPer
// threads a row of cv vectors. Shared memory: [rows_per_iter][2C] then
// red[2C] floats.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads, kPer == 1 ? kMinBlocksPerSM : 2)
gn_stats_kernel(const typename Vec<T>::Raw* __restrict__ x, float* __restrict__ partials,
                long long hw, int cv, int Ks, long long rows_per_chunk) {
    using V = Vec<T>;
    constexpr int E = V::E;
    extern __shared__ float smem[];
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int tpr = cv / kPer;
    const int rows_per_iter = blockDim.x / tpr;
    const int t = threadIdx.x;
    const int q = t % tpr;  // first vector of the thread's row
    const int r0 = t / tpr;  // row offset inside one step
    const int C = cv * E;
    float* red = smem + rows_per_iter * 2 * C;

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const typename V::Raw* xb = x + (long long)b * hw * cv + q;
    float s[kPer][E] = {}, ss[kPer][E] = {};
    long long r = lo + r0;
    for (; r + (kUnroll<T> - 1) * rows_per_iter < hi; r += kUnroll<T> * rows_per_iter) {
        typename V::Raw raw[kUnroll<T>][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll<T>; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j) raw[u][j] = xb[(r + u * rows_per_iter) * cv + j * tpr];
#pragma unroll
        for (int u = 0; u < kUnroll<T>; ++u)
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
    for (int i = t; i < 2 * C; i += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < rows_per_iter; ++k) acc += smem[k * 2 * C + i];
        red[i] = acc;
    }
    // the cluster's Ks partials, added in rank order by rank 0
    cluster_arrive();
    cluster_wait();
    if (cluster_rank() == 0) {
        float* pb = partials + ((long long)b * (gridDim.x / Ks) + chunk / Ks) * 2 * C;
        cluster_sum<kMaxStreamCluster>(red, pb, 2 * C, Ks);
    }
    cluster_arrive();  // the other blocks' red stays until rank 0 has read it
    cluster_wait();
}

// Every block folds its element's nclusters partials (fold_coef) into a_c
// and b_c, then normalizes its chunk. Dynamic shared memory:
// (max(1, blockDim.x / 2C) + 2) * 2C floats (the fold, then a_c and b_c).
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads, kPer == 1 ? kMinBlocksPerSM : 2)
gn_normalize_kernel(const typename Vec<T>::Raw* __restrict__ x,
                    const float* __restrict__ partials, const float* __restrict__ scale,
                    const float* __restrict__ bias, typename Vec<T>::Raw* __restrict__ y,
                    long long hw, int cv, int cs, int nclusters, long long rows_per_chunk,
                    float eps) {
    using V = Vec<T>;
    constexpr int E = V::E;
    extern __shared__ float fold_smem[];
    const int b = blockIdx.y;
    const int chunk = blockIdx.x;
    const int tpr = cv / kPer;
    const int rows_per_iter = blockDim.x / tpr;
    const int t = threadIdx.x;
    const int q = t % tpr;
    const int r0 = t / tpr;
    const int C = cv * E;

    float* cb = fold_smem + (max(1, (int)blockDim.x / (2 * C)) + 1) * 2 * C;
    fold_coef(partials + (long long)b * nclusters * 2 * C, nclusters, C, cs, hw, scale, bias, eps,
              fold_smem, cb);
    float a[kPer][E], sh[kPer][E];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            a[j][e] = cb[(q + j * tpr) * E + e];
            sh[j][e] = cb[C + (q + j * tpr) * E + e];
        }

    const long long lo = chunk * rows_per_chunk;
    const long long hi = min(lo + rows_per_chunk, hw);
    const long long base = (long long)b * hw * cv + q;
    long long r = lo + r0;
    for (; r + (kUnroll<T> - 1) * rows_per_iter < hi; r += kUnroll<T> * rows_per_iter) {
        typename V::Raw raw[kUnroll<T>][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll<T>; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                raw[u][j] = x[base + (r + u * rows_per_iter) * cv + j * tpr];
#pragma unroll
        for (int u = 0; u < kUnroll<T>; ++u)
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                y[base + (r + u * rows_per_iter) * cv + j * tpr] =
                    scale_shift_swish<T>(raw[u][j], a[j], sh[j]);
    }
    for (; r < hi; r += rows_per_iter)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
            y[base + r * cv + j * tpr] =
                scale_shift_swish<T>(x[base + r * cv + j * tpr], a[j], sh[j]);
}

template <typename T, int kPer>
int launch_stream(const void* x, const void* scale, const void* bias, void* scratch, void* y,
                  int B, long long hw, int C, int groups, int Ks, int chunks,
                  long long rows_per_chunk, float eps, cudaStream_t st) {
    using Raw = typename Vec<T>::Raw;
    const int cv = C / Vec<T>::E;
    const int tpr = cv / kPer;
    const int rows_per_iter = kThreads / tpr > 0 ? kThreads / tpr : 1;
    const int threads = rows_per_iter * tpr;
    const int cs = C / groups;
    if (Ks < 1 || Ks > kMaxStreamCluster || chunks < Ks || chunks % Ks || rows_per_chunk < 1 ||
        rows_per_chunk * chunks < hw)
        return (int)cudaErrorInvalidValue;
    float* partials = static_cast<float*>(scratch);

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(chunks, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (size_t)(rows_per_iter + 1) * 2 * C * sizeof(float);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Ks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, gn_stats_kernel<T, kPer>,
                                         static_cast<const Raw*>(x), partials, hw, cv, Ks,
                                         rows_per_chunk);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t norm_smem = (size_t)(max(1, threads / (2 * C)) + 2) * 2 * C * sizeof(float);
    gn_normalize_kernel<T, kPer><<<dim3(chunks, B), threads, norm_smem, st>>>(
        static_cast<const Raw*>(x), partials, static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<Raw*>(y), hw, cv, cs, chunks / Ks,
        rows_per_chunk, eps);
    return (int)cudaGetLastError();
}

template <typename T, int kPer>
int launch_gn_swish(const void* x, const void* scale, const void* bias, void* scratch, void* y,
                    int B, long long hw, int C, int groups, int slab, int cluster, int chunks,
                    long long rows, float eps, cudaStream_t st) {
    if (B < 1 || B > kMaxBatch || hw < 1 || groups < 1 || C % groups)
        return (int)cudaErrorInvalidValue;
    if (slab > 0)
        return launch_cluster<T>(x, scale, bias, y, B, hw, C, groups, slab, cluster, rows, eps,
                                 st);
    return launch_stream<T, kPer>(x, scale, bias, scratch, y, B, hw, C, groups, cluster, chunks,
                                  rows, eps, st);
}

}  // namespace

// x, y: (B, HW, C) contiguous, 16-byte aligned; scale, bias: C f32. The plan
// (ops/groupnorm.py `plan`): slab > 0 takes the cluster route, clusters of
// `cluster` blocks over slabs of `slab` channels (whole groups, a multiple of
// 16 bytes), `rows` rows a block (no scratch); slab == 0 the stream route,
// `chunks` chunks of `rows` rows an element in clusters of `cluster`, with
// scratch of B * (chunks / cluster) * 2C floats. Returns the launch's CUDA
// error, or cudaErrorInvalidValue for what the kernels do not take.
//
// f32: C % 4 == 0 up to 1024, C % 8 == 0 in (1024, 2048].
extern "C" int gn_swish_f32(const void* x, const void* scale, const void* bias, void* scratch,
                            void* y, int B, long long hw, int C, int groups, int slab, int cluster,
                            int chunks, long long rows, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 || C <= 0 || C > 2048 || (C > 1024 && C % 8)) return (int)cudaErrorInvalidValue;
    if (C <= 1024)
        return launch_gn_swish<float, 1>(x, scale, bias, scratch, y, B, hw, C, groups, slab,
                                         cluster, chunks, rows, eps, st);
    return launch_gn_swish<float, 2>(x, scale, bias, scratch, y, B, hw, C, groups, slab, cluster,
                                     chunks, rows, eps, st);
}

// bf16: C % 8 == 0 up to 2048. The statistics and the arithmetic are f32, y is
// rounded to bf16 at the store.
extern "C" int gn_swish_bf16(const void* x, const void* scale, const void* bias, void* scratch,
                             void* y, int B, long long hw, int C, int groups, int slab,
                             int cluster, int chunks, long long rows, float eps, void* stream) {
    if (C % 8 || C <= 0 || C > 2048) return (int)cudaErrorInvalidValue;
    return launch_gn_swish<__nv_bfloat16, 1>(x, scale, bias, scratch, y, B, hw, C, groups, slab,
                                             cluster, chunks, rows, eps,
                                             static_cast<cudaStream_t>(stream));
}
