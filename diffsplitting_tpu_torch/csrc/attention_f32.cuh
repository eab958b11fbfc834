// What the two f32 attention sources share, for sm_90a: attention.cu (the
// kernel at D up to 128) and attention_wide.cu (the wide kernel above 128).
// The tiling both build on, the remainder plane of a shared-memory operand
// (3xTF32), a warpgroup's barrier, the combine launch that adds the key
// splits, and the cached encoding of the Q, K and V tensor maps.

#pragma once

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;           // queries a consumer warpgroup: one wgmma m64 tile
constexpr int kPanel = 32;          // head dims a panel: one 128-byte swizzled f32 row
constexpr int kConsumers = 128;     // threads a warpgroup
constexpr int kQPanelBytes = kRows * 128;
constexpr int kSmemLimit = 232448;  // 227 KB a block

// x - trunc(x): what the tensor core does not read of x (exact in f32)
__device__ __forceinline__ float remainder_of(float x) {
    return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float4 remainder_of(float4 x) {
    return make_float4(remainder_of(x.x), remainder_of(x.y), remainder_of(x.z), remainder_of(x.w));
}

// generic-proxy stores to shared memory made visible to wgmma, then
// warpgroup w's barrier (named barrier 1 + w)
__device__ __forceinline__ void group_sync(int w) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kConsumers) : "memory");
}

template <int N>
struct Par {
    static constexpr int value = N;
};

// out = sum_s w_s O_s / sum_s w_s l_s over the splits in split order, w_s =
// exp2(m_s - max m); a split with no key (m_s = -inf, O_s = 0) has weight 0.
// A thread takes 4 head dims of a row.
__global__ void attention_wide_combine(const float* __restrict__ opart,
                                       const float* __restrict__ ml, float* __restrict__ out,
                                       int splits, int n_tokens, int heads, int d) {
    const int bh = blockIdx.y;
    const int per_row = d / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = e / per_row;
    if (row >= n_tokens) return;
    const int col = (e % per_row) * 4;
    const long long BH = (long long)gridDim.y;
    float m_max = -INFINITY;
    for (int s = 0; s < splits; ++s)
        m_max = fmaxf(m_max, ml[2 * ((s * BH + bh) * n_tokens + row)]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
        const long long prow = (s * BH + bh) * n_tokens + row;
        const float2 m_l = *reinterpret_cast<const float2*>(ml + 2 * prow);
        const float w = m_l.x == -INFINITY ? 0.f : exp2f(m_l.x - m_max);
        L = __fmaf_rn(w, m_l.y, L);
        const float4 x = *reinterpret_cast<const float4*>(opart + prow * d + col);
        acc = make_float4(__fmaf_rn(w, x.x, acc.x), __fmaf_rn(w, x.y, acc.y),
                          __fmaf_rn(w, x.z, acc.z), __fmaf_rn(w, x.w, acc.w));
    }
    const float inv = 1.0f / L;
    const int b = bh / heads, h = bh % heads;
    *reinterpret_cast<float4*>(out + (((long long)b * n_tokens + row) * heads + h) * d + col) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// the combine over a (B, N, heads, d) result on stream st; returns its
// launch error
int combine_splits(const float* opart, const float* ml, float* out, int splits, int B,
                   int n_tokens, int heads, int d, cudaStream_t st) {
    const int threads = 128;
    const dim3 grid((n_tokens * (d / 4) + threads - 1) / threads, B * heads);
    attention_wide_combine<<<grid, threads, 0, st>>>(opart, ml, out, splits, n_tokens, heads, d);
    return (int)cudaGetLastError();
}

// encode_qkv through a small per-thread cache keyed by every argument: a
// map is a function of them alone, and a UNet forward meets the same
// pointers, shapes and strides at every step (the caching allocator hands
// the same addresses back), so most calls skip the driver's encoding.
bool encode_cached(CUtensorMap* map, const void* base, int B, int n_tokens, int heads, int d,
                   long long sb, long long sn, long long sh, int rows) {
    struct Key {
        const void* base;
        long long sb, sn, sh;
        int B, n_tokens, heads, d, rows;
        bool operator==(const Key& o) const {
            return base == o.base && sb == o.sb && sn == o.sn && sh == o.sh && B == o.B &&
                   n_tokens == o.n_tokens && heads == o.heads && d == o.d && rows == o.rows;
        }
    };
    struct Entry {
        Key key;
        CUtensorMap map;
        bool valid;
    };
    constexpr int kEntries = 8;
    thread_local Entry cache[kEntries] = {};
    thread_local int next = 0;
    const Key key = {base, sb, sn, sh, B, n_tokens, heads, d, rows};
    for (int e = 0; e < kEntries; ++e)
        if (cache[e].valid && cache[e].key == key) {
            *map = cache[e].map;
            return true;
        }
    if (!encode_qkv(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, n_tokens, heads, d, sb, sn,
                    sh, rows))
        return false;
    cache[next] = {key, *map, true};
    next = (next + 1) % kEntries;
    return true;
}

}  // namespace
