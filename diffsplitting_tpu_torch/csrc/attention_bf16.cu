// Spatial self-attention softmax(q k^T * scale) v in bfloat16, for sm_90a, on
// the bf16 tensor cores (mma.sync.m16n8k16, f32 accumulators): the UNet's
// attention at `compute_dtype: bfloat16`. One kernel,
// attention_bf16_kernel<DS, SW>, at any head dim D that is a multiple of 8 up
// to 1024: DS = 1 slice of SW = D rounded up to a multiple of 16 below 128,
// else DS = ceil(D / 128) slices of SW = 128, the last one zero-filled past D.
//
// Replaces: diffsplitting_tpu/ops/attention.py:33, `_kernel` (launched by
//   `_pallas_forward`) at bf16 q, k and v: f32 scores and softmax, P
//   normalised and cast to bf16, P V summed in f32, a bf16 result
//   (`out_ref.dtype`). The f32 kernels of attention.cu take the float32 UNet.
//
// Bound: operations. The two products take 4 * N^2 * D flops a (batch,
//   head): 4.29 GFLOP at sr_sr3_64_512's mid block (B = 1, N = 1024, D =
//   1024), 0.0043 ms at 989 TFLOP/s dense bf16, against 8.4 MB of q, k, v and
//   out (0.0025 ms at 3.35 TB/s). Each block reads all of K and V of its
//   (batch, head) from L2: 4 * N * D bytes for its 16 * kRowGroups queries.
//
// Design (a simple kernel first: mma.sync, not wgmma or TMA):
//   * One block of kRowGroups x DS warps per (b * head, 16 * kRowGroups-query
//     tile), as attention_tf32x3_wide_kernel: warp (rg, ds) owns query rows
//     16 rg ... 16 rg + 15 and head dims SW ds ... SW ds + SW - 1, so its O is
//     16 x SW f32, at most 64 floats a thread at any D (a 16 x 1024 f32 O
//     would not fit one warp's registers). kRowGroups is 4 up to D = 256, 2
//     up to 512, 1 above.
//   * S = Q K^T by slices: each warp sums its slice's SW terms of a score in
//     the MMA accumulator; with DS > 1 it writes that partial S to shared
//     memory, and after a barrier each warp of the row group adds the DS
//     partials of its rows in f32 in the order ds = 0, 1, ... All warps of a
//     row group so hold the same S bits and the same running max and sum; no
//     atomics, and two launches give the same bits.
//   * Online softmax in f32 in the exp2 domain; keys past N at -inf. P is
//     rounded to bf16 in registers: the m16n8k16 accumulator layout of two
//     8-key n-tiles of S (rows g and g + 8, keys 2t, 2t + 1) is the A
//     fragment of the next MMA (16 keys deep), so P never leaves registers.
//     The row sum is taken on the f32 P, and O is divided by it once, at the
//     end (the Pallas kernel divides P first, then rounds it to bf16).
//   * O += P V in the MMA accumulator, f32, over all keys. The accumulator
//     rounds toward zero (PERF.md, the f32 kernels), about N / 16 roundings
//     of 2^-23 relative at most here, far below bf16's 2^-8 step of the
//     result: it is not designed around.
//   * Shared memory, dynamic: the block's Q tile and a ring of two stages of
//     kTileK-key K and V tiles (rows of DS * SW + 8 bf16), filled by
//     cp.async.cg one tile ahead; the partial S (16 x kTileK f32 a warp) when
//     DS > 1. kTileK is 64 at DS = 1, 32 up to D = 512, 16 above: at D = 1024
//     a stage of K and V is 64 KB.
//   * Fragments come from shared memory through ldmatrix (x4): Q and K as
//     stored, V with .trans, which gives P V's B fragment (keys 2t, 2t + 1 of
//     column g) from row-major V. Rows of DS * SW + 8 bf16 put the 8 rows an
//     8 x 8 matrix reads in 8 different 16-byte bank groups: no conflicts.
//   * Any N >= 1: K and V rows past N, and Q rows past N, are zero-filled
//     (cp.async with a source size of 0 reads nothing); query rows past N are
//     not stored, and a row group all past N only helps stage. Columns past D
//     are zero-filled in Q, K and V, add nothing to S, and are not stored.
//   * Output: bf16, O * (1 / l) rounded once, two values a store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

template <int DS, int SW>
struct Bf16Tile {
    static_assert(SW % 16 == 0 && SW >= 16 && SW <= 128, "slices of 16 ... 128 head dims");
    static_assert(DS >= 1 && DS <= 8 && (DS == 1 || SW == 128), "D up to 1024");
    static constexpr int kD = DS * SW;     // head dims a block works on, D padded
    static constexpr int kLd = kD + 8;     // bf16 a shared-memory row
    static constexpr int kChunks = kD / 8;  // 16-byte chunks a row
    static constexpr int kRowGroups = DS <= 2 ? 4 : DS <= 4 ? 2 : 1;
    static constexpr int kTileK = DS == 1 ? 64 : DS <= 4 ? 32 : 16;  // keys a stage
    static constexpr int kWarps = kRowGroups * DS;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kRows = 16 * kRowGroups;  // queries a block
    static constexpr int kNT = kTileK / 8;         // 8-key n-tiles of S a stage
    static constexpr int kNO = SW / 8;             // 8-wide n-tiles of a warp's O
    static constexpr int kStageElems = 2 * kTileK * kLd;  // K, then V
    static constexpr size_t kSmemBytes =
        (size_t)(kRows * kLd + 2 * kStageElems) * sizeof(bf16) +
        (DS > 1 ? (size_t)kWarps * 16 * kTileK * sizeof(float) : 0);
    static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lanes 8i ... 8i + 7 give the row addresses of
// matrix i, and each lane gets row lane / 4, columns 2 (lane % 4), +1 of each
// (with .trans: column lane / 4, rows 2 (lane % 4), +1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// d += a * b: a 16 x 16 (row), b 16 x 8 (col) bf16, d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DS, int SW>
__global__ void __launch_bounds__(Bf16Tile<DS, SW>::kThreads, 1)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int n_tokens,
                      int heads, int d, long long sb, long long sn, long long sh, float scale) {
    using T = Bf16Tile<DS, SW>;
    constexpr int LD = T::kLd, TK = T::kTileK, NT = T::kNT, NO = T::kNO;
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);          // [kRows][LD]
    bf16* Ring = Qs + T::kRows * LD;                     // [2][K: TK x LD, V: TK x LD]
    float4* Sp = reinterpret_cast<float4*>(Ring + 2 * T::kStageElems);  // [kWarps][NT][32 lanes]

    const int bh = blockIdx.y;
    const int b = bh / heads;
    const int h = bh % heads;
    const int q0 = blockIdx.x * T::kRows;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // mma group: rows g and g + 8
    const int t = lane % 4;  // thread in group
    const int lr = lane % 8;  // ldmatrix: the row this lane addresses ...
    const int lm = lane / 8;  // ... in matrix lm of the four
    const int rg = warp / DS;
    const int ds = warp % DS;
    const int r0 = 16 * rg;
    const int c0 = SW * ds;  // the warp's first head dim
    const bool active = q0 + r0 < n_tokens;  // warp-uniform, and uniform over a row group
    const long long base = (long long)b * sb + (long long)h * sh;
    const int d8 = d / 8;  // 16-byte chunks a row that hold data; the rest are zeros

    // stage Q; rows past N and columns past D are zeros
    for (int c = tid; c < T::kRows * T::kChunks; c += T::kThreads) {
        const int row = c / T::kChunks, chunk = c % T::kChunks;
        const bool ok = q0 + row < n_tokens && chunk < d8;
        const long long src = base + (ok ? (long long)(q0 + row) * sn + chunk * 8 : 0);
        cp_async16(Qs + row * LD + chunk * 8, q + src, ok);
    }
    // keys past N, and columns past D, are zeros in K and V
    auto stage_kv = [&](int tile, int stage) {
        bf16* kd = Ring + stage * T::kStageElems;
        bf16* vd = kd + TK * LD;
        for (int c = tid; c < TK * T::kChunks; c += T::kThreads) {
            const int key = c / T::kChunks, chunk = c % T::kChunks;
            const int kg = tile * TK + key;
            const bool ok = kg < n_tokens && chunk < d8;
            const long long src = base + (ok ? (long long)kg * sn + chunk * 8 : 0);
            cp_async16(kd + key * LD + chunk * 8, k + src, ok);
            cp_async16(vd + key * LD + chunk * 8, v + src, ok);
        }
    };
    const int n_tiles = (n_tokens + TK - 1) / TK;
    stage_kv(0, 0);  // with Q, one group
    cp_async_commit();

    const float c2 = scale * 1.4426950408889634f;  // scores in the exp2 domain
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait_all();  // tile it (and Q) have landed for this thread
        __syncthreads();      // ... and for every thread; no warp still reads tile it - 1
        if (it + 1 < n_tiles) stage_kv(it + 1, (it + 1) & 1);  // into tile it - 1's stage
        cp_async_commit();
        const bf16* Kt = Ring + (it & 1) * T::kStageElems;
        const bf16* Vt = Kt + TK * LD;

        // S = Q K^T for rows r0+g, r0+g+8 and the tile's keys over this
        // warp's slice, summed in the MMA accumulator; s[n] holds rows g (0,
        // 1) and g+8 (2, 3), keys 8n + 2t and 8n + 2t + 1
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
        if (active) {
#pragma unroll
            for (int ks = 0; ks < SW / 16; ++ks) {
                const int col = c0 + 16 * ks;
                uint32_t a[4];  // rows +0 / +8 (lm & 1), head dims +0 / +8 (lm >> 1)
                ldmatrix_x4(a, Qs + (r0 + (lm & 1) * 8 + lr) * LD + col + (lm >> 1) * 8);
#pragma unroll
                for (int p = 0; p < NT / 2; ++p) {
                    uint32_t kb[4];  // keys +0 / +8 (lm >> 1), head dims +0 / +8 (lm & 1)
                    ldmatrix_x4(kb, Kt + (16 * p + (lm >> 1) * 8 + lr) * LD + col + (lm & 1) * 8);
                    mma_bf16(s[2 * p], a, kb[0], kb[1]);
                    mma_bf16(s[2 * p + 1], a, kb[2], kb[3]);
                }
            }
            if constexpr (DS > 1) {
#pragma unroll
                for (int n = 0; n < NT; ++n)
                    Sp[(warp * NT + n) * 32 + lane] =
                        make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
            }
        }
        if constexpr (DS > 1) {
            __syncthreads();  // every partial of tile it is written
            if (active) {
                // the row group's partials added in f32, ds = 0, 1, ... in order
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    float4 acc = Sp[(rg * DS * NT + n) * 32 + lane];
#pragma unroll
                    for (int e = 1; e < DS; ++e) {
                        const float4 x = Sp[((rg * DS + e) * NT + n) * 32 + lane];
                        acc.x += x.x;
                        acc.y += x.y;
                        acc.z += x.z;
                        acc.w += x.w;
                    }
                    s[n][0] = acc.x;
                    s[n][1] = acc.y;
                    s[n][2] = acc.z;
                    s[n][3] = acc.w;
                }
            }
        }
        if (!active) continue;

        // keys past N take no weight
        const int keys_left = n_tokens - it * TK;
        if (keys_left < TK) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                if (8 * n + 2 * t >= keys_left) s[n][0] = s[n][2] = -INFINITY;
                if (8 * n + 2 * t + 1 >= keys_left) s[n][1] = s[n][3] = -INFINITY;
            }
        }

        // online softmax, f32
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] *= c2;
            mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            corr[r] = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            s[n][0] = exp2f(s[n][0] - m_run[0]);
            s[n][1] = exp2f(s[n][1] - m_run[0]);
            s[n][2] = exp2f(s[n][2] - m_run[1]);
            s[n][3] = exp2f(s[n][3] - m_run[1]);
            l_run[0] += s[n][0] + s[n][1];
            l_run[1] += s[n][2] + s[n][3];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
        }

        // O += P V, 16 keys a k-step: P's A fragment is S's n-tiles 2kk and
        // 2kk + 1 rounded to bf16; V's B fragments for two 8-wide n-tiles of
        // O come from one ldmatrix .trans
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int p = 0; p < NO / 2; ++p) {
                uint32_t vb[4];  // keys +0 / +8 (lm & 1), head dims +0 / +8 (lm >> 1)
                ldmatrix_x4_trans(
                    vb, Vt + (16 * kk + (lm & 1) * 8 + lr) * LD + c0 + 16 * p + (lm >> 1) * 8);
                mma_bf16(o[2 * p], pa, vb[0], vb[1]);
                mma_bf16(o[2 * p + 1], pa, vb[2], vb[3]);
            }
        }
    }

    if (!active) return;
    // out is (B, N, heads, D) contiguous; o[n] holds head dims c0 + 8n + 2t,
    // +1 of rows g (0, 1) and g + 8 (2, 3); nothing past D is stored (D is a
    // multiple of 8, so a pair lies wholly below or past it)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / l;
        const int row = q0 + r0 + g + 8 * r;
        if (row >= n_tokens) continue;
        bf16* dst = out + (((long long)b * n_tokens + row) * heads + h) * d;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const int col = c0 + 8 * n + 2 * t;
            if (col < d)
                *reinterpret_cast<uint32_t*>(dst + col) =
                    pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        }
    }
}

template <int DS, int SW>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int n_tokens,
                int heads, int d, long long sb, long long sn, long long sh, float scale,
                cudaStream_t stream) {
    using T = Bf16Tile<DS, SW>;
    cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<DS, SW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_tokens + T::kRows - 1) / T::kRows, B * heads);
    attention_bf16_kernel<DS, SW><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
        q, k, v, out, n_tokens, heads, d, sb, sn, sh, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, heads, D) bf16 views sharing the element strides (sb, sn,
// sh) with unit stride on the last dim, strides multiples of 8 and 16-byte
// aligned rows; out: (B, N, heads, D) contiguous bf16. D a multiple of 8 up to
// 1024, any N >= 1. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// D it does not take.
extern "C" int attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                              int n_tokens, int heads, int d, long long sb, long long sn,
                              long long sh, float scale, void* stream) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 0 || d > 1024 || d % 8) return (int)cudaErrorInvalidValue;
#define DSP_BF16_ATTN(DS, SW) \
    return launch_bf16<DS, SW>(qb, kb, vb, ob, B, n_tokens, heads, d, sb, sn, sh, scale, st)
    if (d <= 128) {
        switch ((d + 15) / 16) {
            case 1: DSP_BF16_ATTN(1, 16);
            case 2: DSP_BF16_ATTN(1, 32);
            case 3: DSP_BF16_ATTN(1, 48);
            case 4: DSP_BF16_ATTN(1, 64);
            case 5: DSP_BF16_ATTN(1, 80);
            case 6: DSP_BF16_ATTN(1, 96);
            case 7: DSP_BF16_ATTN(1, 112);
            default: DSP_BF16_ATTN(1, 128);
        }
    }
    switch ((d + 127) / 128) {
        case 2: DSP_BF16_ATTN(2, 128);
        case 3: DSP_BF16_ATTN(3, 128);
        case 4: DSP_BF16_ATTN(4, 128);
        case 5: DSP_BF16_ATTN(5, 128);
        case 6: DSP_BF16_ATTN(6, 128);
        case 7: DSP_BF16_ATTN(7, 128);
        default: DSP_BF16_ATTN(8, 128);
    }
#undef DSP_BF16_ATTN
}
