// Fused [affine + swish] -> 3x3 conv (SAME) -> + bias [+ residual, or
// residual x W_skip] -> per-(b, channel) sums of y and y^2, float32, for
// sm_90a, on the tensor cores at float32 accuracy.
//
// Replaces: diffsplitting_tpu/experimental/conv_gn.py:270, `_kernel_rows`
//   (launched by `conv_gn_fused`), the conv of the stat-carried fused
//   inference forward. The prologue applies the GroupNorm that the caller
//   folded into a per-(b, c) scale and shift, then swish, while the input is
//   staged; the epilogue emits the statistics the next GroupNorm needs, so
//   no normalized tensor and no second read for statistics reach device
//   memory.
//
// Bound: operations. An implicit GEMM with M = B*H*W pixels, N = Cout and
//   K = 9*Cin (+ Cres for a projected residual): 2*M*N*K flops against
//   (Cin + Cout [+ Cres]) * 4 bytes a pixel. One forward of the splitting
//   UNet at batch 8 and 512^2 does 484.3 GFLOP over its 31 sites. Each f32
//   product here is three TF32 tensor-core products (3xTF32), so the least
//   time is 3 * 484.3 GFLOP at 495 TFLOP/s = 2.94 ms, against 6.1 GB of bytes
//   (1.8 ms at 3.35 TB/s) and 7.24 ms at the 67 TFLOP/s f32 FMA rate. At the
//   512^2 sites with Cout = 16 and no projection the bytes bound.
//
// Design:
//   * 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with f32
//     accumulation, the split of tf32x3.cuh (big rounded by integer add and
//     mask as cvt.rna rounds, small passed unrounded). Every operand is split
//     ONCE, where it is staged, never in the MMA loop: the prologue that
//     activates the input window writes big and small planes to shared
//     memory (each element then feeds 9 taps and every warp), and a small
//     preparatory launch (conv_gn_split_weights) splits the weights once a
//     call into a scratch buffer the wrapper allocates: per K step of 16
//     channels and one tap, [big, small][BN][16] floats, zero past Cin, Cres
//     and Cout, so a stage is one contiguous copy.
//   * The tensor core adds into its f32 accumulator rounding toward zero, a
//     bias that grows with the depth of K (up to 2,560 here) and that the
//     per-channel statistics sum over H*W pixels. So each K step (16
//     channels, one tap: six mma) is summed from 0 and then added to the
//     register accumulator in f32, rounded to nearest.
//   * Implicit GEMM. A block owns a TR x TW tile of pixels of ONE batch
//     element (M) and every output channel (N = BN >= Cout, so the statistics
//     stay in the block); NW warps in WM x WN, each MT m16 tiles (16 pixels
//     of a tile row) by NT n8 tiles. K walks Cin in chunks of 16 channels, each
//     chunk through the 9 taps (an offset into the (TR+2) x (TW+2) halo
//     window), then a projected residual's Cres in chunks of 16 through the
//     centre tap only (the residual pixels staged into the window's centre).
//     Ragged widths (multiples of 4, not of 16) are zero-filled.
//   * Pipeline. The split weights go through a two-stage cp.async ring of
//     TPS taps a stage, one barrier a stage. The activated window cannot be
//     copied as it is, so the next chunk is copied raw by cp.async (zero-
//     filled outside the image) into a third window-sized buffer during the
//     chunk's first stage, and activated, split and stored into the window
//     after its last (one more barrier a chunk). Holding the next chunk in
//     registers instead (register double buffering) takes 24 more a thread
//     and, with the K-step sums above, spilled at 255.
//   * Zero padding is of the ACTIVATED input (swish(shift) != 0): window
//     positions outside the image are written as 0 after the prologue.
//   * Fragment loads are 16 bytes and free of bank conflicts without
//     padding: a pixel's 16 channels are 64 bytes, an m16 tile is 16
//     consecutive pixels, and a thread takes channels 4t .. 4t+3 (two k8
//     steps from one float4, the same permuted K order for A and B).
//   * Epilogue: bias, identity residual, float2 NHWC stores; per-channel sums
//     of y and y^2 over the block's valid pixels, reduced across the lanes of
//     a channel by shuffles and across warps in shared memory, each in a
//     fixed order, into partials [b][tile][2][Cout]; conv_gn_stats_fold
//     (conv_gn_stats.cuh) folds the tiles in order. No atomics, so the
//     result does not depend on the order in which blocks run.
//   * Geometry per Cout (ops/conv_gn.py `conv_gn_tiling` states the same),
//     every warp 2 m16 tiles: BN 16 takes 8 warps on 16 x 16 pixels (NT 2);
//     BN 32 and 64 take 4 warps on 8 x 16 (NT 4, 8), so that 2-3 blocks share
//     an SM (20 % and 6 % faster than 8 warps on 16 x 16, which the
//     registers held to one); BN 128 takes 8 warps on 8 x 16 (WN 2, NT 8),
//     so the 64^2 sites at batch 8 still give 256 blocks on 132 SMs (4 warps
//     on 4 x 16 were no clear gain: -7 % and +2 % in two runs). Shared memory: window and raw buffer
//     62,208 B (16 x 16) or 34,560 B (8 x 16), weight ring 2 * TPS * 128 * BN
//     B (kernels/conv_gn_variants.py times the alternatives).
//     `-Xptxas -v`, no spills: BN 16 121 registers, 99,072 B of shared
//     memory, 2 blocks an SM; BN 32 156, 59,136 B, 3; BN 64 203, 83,712 B,
//     2; BN 128 203, 132,864 B, 1.
//   * Weights are read through their four strides by the split launch, so
//     the HWIO view of a PyTorch OIHW parameter is taken without a copy.
//   * Cin, Cres and Cout are multiples of 4, Cin and Cres at most 256, Cout at
//     most 128; rows and columns that H or W leave ragged are masked. The
//     wrapper raises on anything else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_gn_stats.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kKC = 16;  // input channels a K step: two k8 mma steps

struct Params {
    const float* x;       // (B, H, W, Cin)
    const float* bias;    // (Cout)
    const float* scale;   // (B, Cin), read iff act
    const float* shift;   // (B, Cin), read iff act
    const float* res;     // (B, H, W, Cres), read iff has_res
    const float* wsplit;  // [9 * n_in + n_res][2][BN][kKC] split weights
    float* y;             // (B, H, W, Cout)
    float* partials;      // (B, tiles, 2, Cout)
    int H, W, Cin, Cout, Cres;
    int act, has_res, has_skip;
    int tiles_w, tiles;
    int n_in, n_res;      // chunks of kKC channels of x and of a projected residual
};

// by the fast intrinsics (ex2.approx, approximate division): about 1e-6
// relative error against expf and a true division, 5 % of the kernel's time
// (kernels/conv_gn_variants.py)
__device__ __forceinline__ float swish(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ uint32_t u32(float v) { return __float_as_uint(v); }

// One K step of weights, split: q < 9 * n_in is (chunk q / 9, tap q % 9) of
// w, q >= 9 * n_in a chunk of w_skip. Zero past Cin, Cres and Cout.
__global__ void conv_gn_split_weights(const float* __restrict__ w, long long w_s0, long long w_s1,
                                      long long w_s2, long long w_s3,
                                      const float* __restrict__ wskip, long long k_s0,
                                      long long k_s1, float* __restrict__ out, int Cin, int Cout,
                                      int Cres, int BN, int n_in, int n_res) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)(9 * n_in + n_res) * BN * kKC) return;
    const int ci = (int)(e % kKC);
    const int n = (int)((e / kKC) % BN);
    const int q = (int)(e / ((long long)kKC * BN));
    float v = 0.f;
    if (q < 9 * n_in) {
        const int tap = q % 9;
        const int ch = (q / 9) * kKC + ci;
        if (ch < Cin && n < Cout) v = w[(tap / 3) * w_s0 + (tap % 3) * w_s1 + ch * w_s2 + n * w_s3];
    } else {
        const int ch = (q - 9 * n_in) * kKC + ci;
        if (ch < Cres && n < Cout) v = wskip[ch * k_s0 + n * k_s1];
    }
    uint32_t big, small;
    split(v, big, small);
    float* dst = out + (long long)q * 2 * BN * kKC + n * kKC + ci;
    dst[0] = __uint_as_float(big);
    dst[BN * kKC] = __uint_as_float(small);
}

// BN output channels a block (>= Cout), NW warps of which WN across the
// channels, a TR x TW pixel tile, TPS taps a weight stage. The explicit
// minimum of 1 block an SM lets ptxas take up to 255 registers: without it
// it held BN 64 and 128 to 170 and they ran 20 % slower.
template <int BN, int NW, int WN, int TR, int TW, int TPS>
__global__ void __launch_bounds__(NW * 32, 1) conv_gn_kernel(Params p) {
    constexpr int kThreads = NW * 32;
    constexpr int WM = NW / WN;
    constexpr int NT = BN / (8 * WN);         // n8 tiles a warp
    constexpr int MT = TR * TW / (16 * WM);   // m16 tiles a warp
    constexpr int TW2 = TW + 2;
    constexpr int WPX = (TR + 2) * TW2;       // window pixels
    constexpr int TAP = 2 * BN * kKC;         // floats of one K step of split weights
    constexpr int G = 9 / TPS;                // weight stages a chunk of x
    static_assert(MT * 16 * WM == TR * TW && NT * 8 * WN == BN, "tile does not fit the warps");
    static_assert(TW % 16 == 0 && 9 % TPS == 0, "m16 tiles lie in one tile row");

    extern __shared__ float4 smem4[];
    float* win = reinterpret_cast<float*>(smem4);  // [2][WPX][kKC]: big, then small
    float* raw = win + 2 * WPX * kKC;              // [WPX][kKC]: the next chunk as loaded
    float* wst = raw + WPX * kKC;                  // [2 stages][TPS][TAP]

    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const int r0 = (tile / p.tiles_w) * TR;
    const int c0 = (tile % p.tiles_w) * TW;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // mma group: rows g and g + 8, column g of B
    const int t = lane % 4;  // thread in group: channels 4t .. 4t + 3 of a K step
    const int wm = warp / WN;
    const int wn = warp % WN;
    const long long HW = (long long)p.H * p.W;

    // window offset (in floats) of the top-left tap of this thread's A rows
    int off[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int pp = (wm * MT + i) * 16 + g + 8 * h;
            off[i][h] = ((pp / TW) * TW2 + pp % TW) * kKC + 4 * t;
        }
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int in_steps = p.n_in * G;
    const int n_steps = in_steps + p.n_res;
    const int n_chunks = p.n_in + p.n_res;

    // weight stage s into ring slot s & 1
    auto stage_weights = [&](int s) {
        const int q0 = s < in_steps ? (s / G) * 9 + (s % G) * TPS : 9 * p.n_in + s - in_steps;
        const int n4 = (s < in_steps ? TPS : 1) * TAP / 4;
        const float* src = p.wsplit + (long long)q0 * TAP;
        float* dst = wst + (s & 1) * TPS * TAP;
        for (int e = tid; e < n4; e += kThreads) cp_async16(dst + 4 * e, src + 4 * e);
    };

    // chunk k's input as it is, into raw at its window position: the halo
    // window of x (k < n_in) or the tile's residual pixels (the centre);
    // zero outside the image and past the channels. Element e is window
    // pixel e / 4, channels 4 * (e % 4) .. + 3 of the chunk.
    auto stage_chunk = [&](int k) {
        const bool in = k < p.n_in;
        const int n = in ? WPX * 4 : TR * TW * 4;
        const int C = in ? p.Cin : p.Cres;
        const float* src = in ? p.x : p.res;
        const int ch0 = (in ? k : k - p.n_in) * kKC;
        for (int e = tid; e < n; e += kThreads) {
            const int q = e & 3;
            const int px = e >> 2;
            const int wr = in ? px / TW2 : px / TW + 1;  // window row and column
            const int wc = in ? px % TW2 : px % TW + 1;
            const int gr = r0 - 1 + wr;
            const int gc = c0 - 1 + wc;
            const int ch = ch0 + 4 * q;
            const bool ok = gr >= 0 && gr < p.H && gc >= 0 && gc < p.W && ch < C;
            const float* from = ok ? src + (((long long)b * p.H + gr) * p.W + gc) * C + ch : src;
            cp_async16_zfill(raw + (wr * TW2 + wc) * kKC + 4 * q, from, ok);
        }
    };
    // ... then activated (x only), split and stored into the window
    auto store_chunk = [&](int k) {
        const bool in = k < p.n_in;
        const int n = in ? WPX * 4 : TR * TW * 4;
        for (int e = tid; e < n; e += kThreads) {
            const int q = e & 3;
            const int px = e >> 2;
            const int wr = in ? px / TW2 : px / TW + 1;
            const int wc = in ? px % TW2 : px % TW + 1;
            const int at = (wr * TW2 + wc) * kKC + 4 * q;
            float4 v = *reinterpret_cast<const float4*>(raw + at);
            const int gr = r0 - 1 + wr;
            const int gc = c0 - 1 + wc;
            const int ch = k * kKC + 4 * q;
            // outside the image the ACTIVATED input is 0: swish(shift) != 0
            if (in && p.act && gr >= 0 && gr < p.H && gc >= 0 && gc < p.W && ch < p.Cin) {
                const float4 sc = __ldg(reinterpret_cast<const float4*>(p.scale + (long long)b * p.Cin + ch));
                const float4 sh = __ldg(reinterpret_cast<const float4*>(p.shift + (long long)b * p.Cin + ch));
                v.x = swish(fmaf(v.x, sc.x, sh.x));
                v.y = swish(fmaf(v.y, sc.y, sh.y));
                v.z = swish(fmaf(v.z, sc.z, sh.z));
                v.w = swish(fmaf(v.w, sc.w, sh.w));
            }
            uint4 big, small;
            split(v.x, big.x, small.x);
            split(v.y, big.y, small.y);
            split(v.z, big.z, small.z);
            split(v.w, big.w, small.w);
            *reinterpret_cast<uint4*>(win + at) = big;
            *reinterpret_cast<uint4*>(win + WPX * kKC + at) = small;
        }
    };

    // acc += window (shifted by the tap) x one K step of weights
    auto mma_tap = [&](const float* wt, int toff) {
        float4 ab[MT][2], as[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                ab[i][h] = *reinterpret_cast<const float4*>(win + off[i][h] + toff);
                as[i][h] = *reinterpret_cast<const float4*>(win + WPX * kKC + off[i][h] + toff);
            }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int o = ((wn * NT + j) * 8 + g) * kKC + 4 * t;
            const float4 bb = *reinterpret_cast<const float4*>(wt + o);
            const float4 bs = *reinterpret_cast<const float4*>(wt + BN * kKC + o);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                // the tensor core adds into its accumulator rounding toward
                // zero; a K step is summed from 0 and added to acc in f32
                // (round to nearest), so that bias does not grow with K
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                // k8 step 0: logical k t <-> channel 4t, t + 4 <-> 4t + 1
                const uint32_t a0b[4] = {u32(ab[i][0].x), u32(ab[i][1].x), u32(ab[i][0].y), u32(ab[i][1].y)};
                const uint32_t a0s[4] = {u32(as[i][0].x), u32(as[i][1].x), u32(as[i][0].y), u32(as[i][1].y)};
                mma_3xtf32(d, a0b, a0s, u32(bb.x), u32(bb.y), u32(bs.x), u32(bs.y));
                // k8 step 1: channels 4t + 2 and 4t + 3
                const uint32_t a1b[4] = {u32(ab[i][0].z), u32(ab[i][1].z), u32(ab[i][0].w), u32(ab[i][1].w)};
                const uint32_t a1s[4] = {u32(as[i][0].z), u32(as[i][1].z), u32(as[i][0].w), u32(as[i][1].w)};
                mma_3xtf32(d, a1b, a1s, u32(bb.z), u32(bb.w), u32(bs.z), u32(bs.w));
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
            }
        }
    };

    // the ring: chunk k + 1 is copied raw during chunk k's first weight
    // stage and activated after its last; weight stage s + 1 is copied during
    // stage s. Groups are committed raw first, so waiting for all but the
    // newest group leaves only the weights in flight.
    stage_chunk(0);
    cp_async_commit();
    stage_weights(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    store_chunk(0);
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait<0>();  // stage s (and any raw chunk) has landed for this thread
        __syncthreads();     // ... and for all; the window is stored; slot (s + 1) & 1 is free
        const bool in = s < in_steps;
        const int k = in ? s / G : p.n_in + s - in_steps;
        const bool more = k + 1 < n_chunks;
        if (more && (!in || s % G == 0)) {
            stage_chunk(k + 1);
            cp_async_commit();
        }
        if (s + 1 < n_steps) {
            stage_weights(s + 1);
            cp_async_commit();
        }
        const float* wt = wst + (s & 1) * TPS * TAP;
        const int tap0 = in ? (s % G) * TPS : 4;  // a residual chunk takes the centre tap
        const int taps = in ? TPS : 1;
#pragma unroll 1
        for (int tt = 0; tt < taps; ++tt) {
            const int tap = tap0 + tt;
            mma_tap(wt + tt * TAP, ((tap / 3) * TW2 + tap % 3) * kKC);
        }
        if (more && (!in || s % G == G - 1)) {
            cp_async_wait<1>();  // chunk k + 1 has landed (weights s + 1 may not have)
            __syncthreads();     // ... for all, and every warp is done with chunk k's window
            store_chunk(k + 1);
        }
    }

    // ---- epilogue: bias, identity residual, store, statistics
    float2 bv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int n = (wn * NT + j) * 8 + 2 * t;
        bv[j] = n < p.Cout ? *reinterpret_cast<const float2*>(p.bias + n) : make_float2(0.f, 0.f);
    }
    float s1[NT][2], s2[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int pp = (wm * MT + i) * 16 + g + 8 * h;
            const int gr = r0 + pp / TW;
            const int gc = c0 + pp % TW;
            if (gr >= p.H || gc >= p.W) continue;
            const long long pix = (long long)b * HW + (long long)gr * p.W + gc;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int n = (wn * NT + j) * 8 + 2 * t;  // n + 1 < Cout too: Cout % 4 == 0
                if (n >= p.Cout) continue;
                float v0 = acc[i][j][2 * h] + bv[j].x;
                float v1 = acc[i][j][2 * h + 1] + bv[j].y;
                if (p.has_res && !p.has_skip) {
                    const float2 r = *reinterpret_cast<const float2*>(p.res + pix * p.Cout + n);
                    v0 += r.x;
                    v1 += r.y;
                }
                *reinterpret_cast<float2*>(p.y + pix * p.Cout + n) = make_float2(v0, v1);
                s1[j][0] += v0;
                s1[j][1] += v1;
                s2[j][0] = fmaf(v0, v0, s2[j][0]);
                s2[j][1] = fmaf(v1, v1, s2[j][1]);
            }
        }
    // across the 8 lanes (g) that hold a channel, then across the WM warps
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int m = 4; m < 32; m *= 2) {
                s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
                s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], m);
            }
    __syncthreads();  // the K loop's shared memory is free
    float* red = win;  // [2][WM][BN]
    if (g == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int n = (wn * NT + j) * 8 + 2 * t + e;
                red[wm * BN + n] = s1[j][e];
                red[WM * BN + wm * BN + n] = s2[j][e];
            }
    }
    __syncthreads();
    for (int e = tid; e < 2 * BN; e += kThreads) {
        const int which = e / BN;
        const int n = e % BN;
        if (n >= p.Cout) continue;
        float a = 0.f;
        for (int r = 0; r < WM; ++r) a += red[which * WM * BN + r * BN + n];
        p.partials[(((long long)b * p.tiles + tile) * 2 + which) * p.Cout + n] = a;
    }
}

template <int BN, int NW, int WN, int TR, int TW, int TPS>
int launch(const Params& p, int B, int tr, int tw, cudaStream_t st) {
    if (tr != TR || tw != TW || p.Cout > BN) return (int)cudaErrorInvalidValue;
    const size_t smem = ((size_t)3 * (TR + 2) * (TW + 2) * kKC + (size_t)2 * TPS * 2 * BN * kKC) *
                        sizeof(float);
    auto kernel = conv_gn_kernel<BN, NW, WN, TR, TW, TPS>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(p.tiles, B), NW * 32, smem, st>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), y (B, H, W, Cout) and res (B, H, W, Cres) contiguous f32,
// 16-byte aligned; w read as w[kh*w_s0 + kw*w_s1 + c*w_s2 + n*w_s3]; wskip as
// wskip[c*k_s0 + n*k_s1]; scale, shift (B, Cin) and bias (Cout) contiguous.
// The tile is tr x tw pixels, the block's geometry for this Cout (see
// ops/conv_gn.py `conv_gn_tiling`). wsplit: (9 * ceil(Cin / 16) + (has_skip ?
// ceil(Cres / 16) : 0)) * 2 * BN * 16 floats of 16-byte aligned scratch, BN
// the block's channels; partials: B * tiles * 2 * Cout floats of scratch;
// stats: 2 * B * Cout floats (sums, then sums of squares). Returns the first
// CUDA error of the three launches, or 0.
extern "C" int conv_gn_f32(const void* x, const void* w, long long w_s0, long long w_s1,
                           long long w_s2, long long w_s3, const void* bias, const void* scale,
                           const void* shift, const void* res, const void* wskip, long long k_s0,
                           long long k_s1, void* y, void* partials, void* stats, void* wsplit,
                           int B, int H, int W, int Cin, int Cout, int Cres, int act, int has_res,
                           int has_skip, int tr, int tw, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Params p;
    p.x = static_cast<const float*>(x);
    p.bias = static_cast<const float*>(bias);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.res = static_cast<const float*>(res);
    p.wsplit = static_cast<const float*>(wsplit);
    p.y = static_cast<float*>(y);
    p.partials = static_cast<float*>(partials);
    p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.Cres = Cres;
    p.act = act; p.has_res = has_res; p.has_skip = has_skip;
    p.tiles_w = (W + tw - 1) / tw;
    p.tiles = ((H + tr - 1) / tr) * p.tiles_w;
    p.n_in = (Cin + kKC - 1) / kKC;
    p.n_res = has_skip ? (Cres + kKC - 1) / kKC : 0;

    const int BN = Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
    const long long n_w = (long long)(9 * p.n_in + p.n_res) * BN * kKC;
    conv_gn_split_weights<<<(unsigned)((n_w + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(w), w_s0, w_s1, w_s2, w_s3, static_cast<const float*>(wskip),
        k_s0, k_s1, static_cast<float*>(wsplit), Cin, Cout, Cres, BN, p.n_in, p.n_res);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (BN == 16) err = launch<16, 8, 1, 16, 16, 9>(p, B, tr, tw, st);
    else if (BN == 32) err = launch<32, 4, 1, 8, 16, 3>(p, B, tr, tw, st);
    else if (BN == 64) err = launch<64, 4, 1, 8, 16, 3>(p, B, tr, tw, st);
    else err = launch<128, 8, 2, 8, 16, 3>(p, B, tr, tw, st);
    if (err != 0) return err;
    const int n = 2 * B * Cout;  // entries, a warp each
    conv_gn_stats_fold<<<(n + 7) / 8, 256, 0, st>>>(p.partials, static_cast<float*>(stats), B,
                                                         p.tiles, Cout);
    return (int)cudaGetLastError();
}
