// Hopper building blocks shared by the attention kernels of attention_bf16.cu
// and attention_wide.cu, for sm_90a: mbarriers, TMA tensor-map loads and
// their host-side encoding, and the wgmma fences.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// arrive where `pred` (a predicate inside the asm, so that the compiler sees
// no divergent branch near the wgmma: it would serialize them)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
                 "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
                 ::"r"(smem_addr(bar)), "r"((int)pred) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes) : "memory");
}

// until the phase of parity `parity` of the barrier has completed (the loop
// inside the asm: no divergent branch for the compiler)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n"
        ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// a box of map at (dim, row, head, batch) into dst, completed on bar; the box
// is clipped by the map's extents and zero-filled past them
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int dim, int row,
                                         int head, int batch, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(dim), "r"(row),
          "r"(head), "r"(batch), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix in the 128-byte swizzle (as TMA lands a box of
// 128-byte rows): 8-row groups 1024 bytes apart (the stride byte offset). For
// K-major operands the leading byte offset is unused (1).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
           (1ull << 62);
}

// over the 4 threads of a quad, which hold one accumulator row
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(f)
                   : nullptr;
    }();
    return fn;
}

// a 4-d map of (D, N, heads, B) elements of `bytes` bytes at element strides
// (sn, sh, sb), boxes of 128 bytes of head dims x `rows` rows, 128-byte
// swizzle, zeros past the extents
bool encode_qkv(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int B,
                int n_tokens, int heads, int d, long long sb, long long sn, long long sh,
                int rows) {
    EncodeTiled fn = encode_tiled();
    if (!fn) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n_tokens, (cuuint64_t)heads,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)(sn * bytes), (cuuint64_t)(sh * bytes),
                                   (cuuint64_t)(sb * bytes)};
    const cuuint32_t box[4] = {(cuuint32_t)(128 / bytes), (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

}  // namespace
