// Hopper building blocks shared by attention.cu, attention_bf16.cu,
// attention_wide.cu and conv_gn.cu, for sm_90a: mbarriers, TMA tensor-map
// loads and their host-side encoding, the wgmma fences and the tf32 wgmma
// wrappers.

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

#define DSP_D8                                                                               \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define DSP_D16                                                                              \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define DSP_D32                                                                              \
    DSP_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DSP_REGS16 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define DSP_REGS32                                                                     \
    DSP_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
               "%30, %31"
#define DSP_D48 \
    DSP_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define DSP_REGS48 \
    DSP_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
               "%46, %47"
#define DSP_D64 \
    DSP_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define DSP_REGS64 \
    DSP_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
               "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
               "%60, %61, %62, %63"

// d (+)= a b: a 64 x 8 tf32 from registers (a warp's 16 rows: a[0] row g,
// k t; a[1] row g + 8, k t; a[2] row g, k t + 4; a[3] row g + 8, k t + 4),
// b 8 x N tf32 by a K-major descriptor; d zeroed first iff !scale_d
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : DSP_D8
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" DSP_REGS16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : DSP_D16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" DSP_REGS32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : DSP_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {" DSP_REGS48
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : DSP_D48
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" DSP_REGS64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : DSP_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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
