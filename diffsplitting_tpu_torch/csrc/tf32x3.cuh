// Float32 products on Hopper's tensor cores from TF32 halves (3xTF32): the
// split of an operand in registers, and the cp.async helpers conv_gn.cu
// stages its windows with, for sm_90a. Included by attention.cu and
// attention_wide.cu (split, for their tf32 wgmma) and conv_gn.cu (split;
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
