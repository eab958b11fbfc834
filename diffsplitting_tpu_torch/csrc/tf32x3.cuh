// Float32 products on Hopper's tensor cores from TF32 halves (3xTF32), and
// the cp.async helpers the kernels stage with, for sm_90a. Included by
// attention.cu (split, the 3xTF32 mma.sync, cp.async), attention_wide.cu
// (split, for its tf32 wgmma) and conv_gn.cu (split, for its tf32 wgmma;
// cp.async).

#pragma once

#include <stdint.h>

namespace {

// x = big + small. big is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero, bit for bit what cvt.rna.tf32.f32 gives for finite x,
// computed as an integer add and mask on the bits (cheaper than cvt here).
// small is the exact remainder, passed as f32 bits: the tensor core reads its
// top 19 bits (TF32 by truncation), an error of at most 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b at f32 accuracy from the TF32 halves of a and b (the small*small
// term, about 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
    mma_tf32(d, a_small, b0_big, b1_big);
    mma_tf32(d, a_big, b0_small, b1_small);
    mma_tf32(d, a_big, b0_big, b1_big);
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// 16 bytes from gmem_src, or 16 zero bytes where !valid (gmem_src is then
// not read)
__device__ __forceinline__ void cp_async16_zfill(float* smem_dst, const float* gmem_src,
                                                 bool valid) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace
