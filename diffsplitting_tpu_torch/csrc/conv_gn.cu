// Fused [affine + swish] -> 3x3 conv (SAME) -> + bias [+ residual, or
// residual x W_skip] -> per-(b, channel) sums of y and y^2, float32, for
// sm_90a.
//
// Replaces: diffsplitting_tpu/experimental/conv_gn.py, `_kernel_rows`
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
//   UNet at batch 8 and 512^2 does about 484 GFLOP over its 31 sites, 7.2 ms
//   at the card's 67 TFLOP/s f32 rate, against about 1 ms of bytes.
//
// Design (plain f32 FMA, no TF32; right and simple before fast):
//   * A block owns BM pixels of ONE batch element (a tr x tw window of rows
//     and columns, tr * tw = BM) and every output channel (BN = 8 * TX >=
//     Cout; TX threads across channels, 256 / TX across pixels). Each thread
//     accumulates 8 pixels x 8 channels in registers.
//   * The K loop walks Cin in chunks of 8 channels. For each chunk the block
//     stages the (tr + 2) x (tw + 2) halo window in shared memory, applying
//     x * scale[b, c] + shift[b, c] and swish as it loads, and writes 0 where
//     the window leaves the image: the zero padding is of the ACTIVATED input
//     (swish(shift) != 0, so masking x instead would be wrong). Beside it, the
//     chunk's 9 x 8 x BN weights. The window is stored as two planes of float4
//     (channels 0-3 and 4-7), so a warp's loads of neighbouring pixels are
//     conflict-free; each of the 9 taps is an offset into the window.
//   * A projected residual is extra K: Cres channels of the residual pixel
//     against the rows of W_skip, staged into the centre of the same window
//     and run as a single tap. An identity residual and the bias are added in
//     the epilogue.
//   * Statistics: each block reduces sums of y and y^2 per output channel over
//     its valid pixels (registers, then a fixed-order sum across threads in
//     shared memory) into partials [b][tile][2][Cout]. A second small launch
//     folds the tiles in a fixed order, without atomics, so the result does
//     not depend on the order in which blocks run.
//   * Weights are read through their four strides, so the HWIO view of a
//     PyTorch OIHW parameter is taken as it is, without a copy.
//   * Cin, Cres and Cout are multiples of 4 (float4 loads and stores), Cout at
//     most 128; rows that H or W leave ragged are masked. The wrapper raises
//     on anything else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 8;  // input channels staged per chunk: two float4 planes
constexpr int kTM = 8;  // pixels per thread
constexpr int kTN = 8;  // output channels per thread

struct Params {
    const float* x;       // (B, H, W, Cin)
    const float* w;       // (3, 3, Cin, Cout) through strides w_s
    long long w_s0, w_s1, w_s2, w_s3;
    const float* bias;    // (Cout)
    const float* scale;   // (B, Cin), read iff act
    const float* shift;   // (B, Cin), read iff act
    const float* res;     // (B, H, W, Cres), read iff has_res
    const float* wskip;   // (Cres, Cout) through strides k_s, read iff has_skip
    long long k_s0, k_s1;
    float* y;             // (B, H, W, Cout)
    float* partials;      // (B, tiles, 2, Cout)
    int H, W, Cin, Cout, Cres;
    int act, has_res, has_skip;
    int tr, tw, tiles_w, tiles;
};

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float lane(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum over the 8 staged channels of win(pixel i, tap) * wts(c, j)
// wts points at this tap's [kKC][BN] weights; this thread's channels are
// tx*4 .. +3 and BN/2 + tx*4 .. +3, so a warp's float4 reads of a weight row
// are consecutive.
template <int BN>
__device__ __forceinline__ void fma_tap(float (&acc)[kTM][kTN], const float4* win, int plane,
                                        const int (&off)[kTM], int toff, const float* wts,
                                        int tx) {
#pragma unroll
    for (int q = 0; q < kKC / 4; ++q) {
        float4 a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = win[q * plane + off[i] + toff];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
            const float* row = wts + (q * 4 + cc) * BN;
            const float4 w0 = reinterpret_cast<const float4*>(row)[tx];
            const float4 w1 = reinterpret_cast<const float4*>(row + BN / 2)[tx];
            const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
                const float av = lane(a[i], cc);
#pragma unroll
                for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
            }
        }
    }
}

template <int TX>
__global__ void __launch_bounds__(kThreads, 2) conv_gn_kernel(Params p) {
    constexpr int TY = kThreads / TX;
    constexpr int BN = TX * kTN;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int tw2 = p.tw + 2;
    const int plane = (p.tr + 2) * tw2;  // window pixels
    float4* win = smem4;                 // [kKC / 4][tr + 2][tw + 2] float4
    float* wsm = smem + kKC * plane;     // [9][kKC][BN]

    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const int r0 = (tile / p.tiles_w) * p.tr;
    const int c0 = (tile % p.tiles_w) * p.tw;
    const int t = threadIdx.x;
    const int tx = t % TX;
    const int ty = t / TX;
    const long long HW = (long long)p.H * p.W;

    // this thread's pixels are ty + i * TY of the tile; off is the window
    // offset of the pixel's top-left tap
    int off[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const int pp = ty + i * TY;
        off[i] = (pp / p.tw) * tw2 + pp % p.tw;
    }
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    // ---- 3x3 taps over Cin, with the affine + swish prologue
    const float* xb = p.x + (long long)b * HW * p.Cin;
    for (int k0 = 0; k0 < p.Cin; k0 += kKC) {
        for (int e = t; e < 2 * plane; e += kThreads) {
            const int pix = e >> 1;
            const int q = e & 1;
            const int gr = r0 - 1 + pix / tw2;
            const int gc = c0 - 1 + pix % tw2;
            const int ch = k0 + 4 * q;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gr >= 0 && gr < p.H && gc >= 0 && gc < p.W && ch < p.Cin) {
                v = *reinterpret_cast<const float4*>(xb + ((long long)gr * p.W + gc) * p.Cin + ch);
                if (p.act) {
                    const float4 sc = *reinterpret_cast<const float4*>(p.scale + (long long)b * p.Cin + ch);
                    const float4 sh = *reinterpret_cast<const float4*>(p.shift + (long long)b * p.Cin + ch);
                    v.x = swish(fmaf(v.x, sc.x, sh.x));
                    v.y = swish(fmaf(v.y, sc.y, sh.y));
                    v.z = swish(fmaf(v.z, sc.z, sh.z));
                    v.w = swish(fmaf(v.w, sc.w, sh.w));
                }
            }
            win[q * plane + pix] = v;
        }
        for (int e = t; e < 9 * kKC * BN; e += kThreads) {
            const int n = e % BN;
            const int c = (e / BN) % kKC;
            const int tap = e / (BN * kKC);
            const int ch = k0 + c;
            float v = 0.f;
            if (n < p.Cout && ch < p.Cin)
                v = p.w[(tap / 3) * p.w_s0 + (tap % 3) * p.w_s1 + ch * p.w_s2 + n * p.w_s3];
            wsm[e] = v;
        }
        __syncthreads();
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap)
            fma_tap<BN>(acc, win, plane, off, (tap / 3) * tw2 + tap % 3, wsm + tap * kKC * BN, tx);
        __syncthreads();
    }

    // ---- projected residual: Cres more K columns through the centre tap
    if (p.has_skip) {
        const float* rb = p.res + (long long)b * HW * p.Cres;
        const int bm = p.tr * p.tw;
        for (int k0 = 0; k0 < p.Cres; k0 += kKC) {
            for (int e = t; e < 2 * bm; e += kThreads) {
                const int pix = e >> 1;
                const int q = e & 1;
                const int rr = pix / p.tw;
                const int cc = pix % p.tw;
                const int gr = r0 + rr;
                const int gc = c0 + cc;
                const int ch = k0 + 4 * q;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (gr < p.H && gc < p.W && ch < p.Cres)
                    v = *reinterpret_cast<const float4*>(rb + ((long long)gr * p.W + gc) * p.Cres + ch);
                win[q * plane + (rr + 1) * tw2 + cc + 1] = v;
            }
            for (int e = t; e < kKC * BN; e += kThreads) {
                const int n = e % BN;
                const int ch = k0 + e / BN;
                wsm[e] = (n < p.Cout && ch < p.Cres) ? p.wskip[ch * p.k_s0 + n * p.k_s1] : 0.f;
            }
            __syncthreads();
            fma_tap<BN>(acc, win, plane, off, tw2 + 1, wsm, tx);
            __syncthreads();
        }
    }

    // ---- epilogue: bias, identity residual, store, statistics
    const int n0 = tx * 4;           // channels n0 .. n0+3
    const int n1 = BN / 2 + tx * 4;  // channels n1 .. n1+3
    const bool v0 = n0 < p.Cout;
    const bool v1 = n1 < p.Cout;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b0 = v0 ? *reinterpret_cast<const float4*>(p.bias + n0) : zero;
    const float4 b1 = v1 ? *reinterpret_cast<const float4*>(p.bias + n1) : zero;
    const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float s[kTN], ss[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) s[j] = ss[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const int pp = ty + i * TY;
        const int gr = r0 + pp / p.tw;
        const int gc = c0 + pp % p.tw;
        if (gr >= p.H || gc >= p.W) continue;
        const long long pix = (long long)b * HW + (long long)gr * p.W + gc;
        float v[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) v[j] = acc[i][j] + bv[j];
        if (p.has_res && !p.has_skip) {
            const float* rr = p.res + pix * p.Cout;
            const float4 r0v = v0 ? *reinterpret_cast<const float4*>(rr + n0) : zero;
            const float4 r1v = v1 ? *reinterpret_cast<const float4*>(rr + n1) : zero;
            v[0] += r0v.x; v[1] += r0v.y; v[2] += r0v.z; v[3] += r0v.w;
            v[4] += r1v.x; v[5] += r1v.y; v[6] += r1v.z; v[7] += r1v.w;
        }
        float* yp = p.y + pix * p.Cout;
        if (v0) *reinterpret_cast<float4*>(yp + n0) = make_float4(v[0], v[1], v[2], v[3]);
        if (v1) *reinterpret_cast<float4*>(yp + n1) = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            s[j] += v[j];
            ss[j] = fmaf(v[j], v[j], ss[j]);
        }
    }
    // the K loop ended on a barrier, so the shared memory is free
    float* red = smem;  // [2][TY][BN]
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
        const int n = j < 4 ? n0 + j : n1 + j - 4;
        red[ty * BN + n] = s[j];
        red[TY * BN + ty * BN + n] = ss[j];
    }
    __syncthreads();
    for (int e = t; e < 2 * BN; e += kThreads) {
        const int which = e / BN;
        const int n = e % BN;
        if (n >= p.Cout) continue;
        float a = 0.f;
        for (int r = 0; r < TY; ++r) a += red[which * TY * BN + r * BN + n];
        p.partials[(((long long)b * p.tiles + tile) * 2 + which) * p.Cout + n] = a;
    }
}

// stats [2][B][Cout] (sums, then sums of squares) from partials
// [B][tiles][2][Cout], each tile in order
__global__ void conv_gn_stats_fold(const float* __restrict__ partials, float* __restrict__ stats,
                                   int B, int tiles, int Cout) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= 2 * B * Cout) return;
    const int which = e / (B * Cout);
    const int b = (e / Cout) % B;
    const int n = e % Cout;
    const float* pp = partials + ((long long)b * tiles * 2 + which) * Cout + n;
    float a = 0.f;
    for (int k = 0; k < tiles; ++k) a += pp[(long long)k * 2 * Cout];
    stats[e] = a;
}

template <int TX>
int launch(const Params& p, int B, cudaStream_t st) {
    constexpr int TY = kThreads / TX;
    constexpr int BN = TX * kTN;
    if (p.tr * p.tw != TY * kTM || p.Cout > BN) return (int)cudaErrorInvalidValue;
    const size_t window = (size_t)kKC * (p.tr + 2) * (p.tw + 2) + (size_t)9 * kKC * BN;
    const size_t reduce = (size_t)2 * TY * BN;
    const size_t smem = (window > reduce ? window : reduce) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(conv_gn_kernel<TX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_gn_kernel<TX><<<dim3(p.tiles, B), kThreads, smem, st>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), y (B, H, W, Cout) and res (B, H, W, Cres) contiguous f32,
// 16-byte aligned; w read as w[kh*w_s0 + kw*w_s1 + c*w_s2 + n*w_s3]; wskip as
// wskip[c*k_s0 + n*k_s1]; scale, shift (B, Cin) and bias (Cout) contiguous.
// The tile is tr x tw pixels with tr * tw equal to the block's pixel count for
// this Cout (see ops/conv_gn.py `conv_gn_tiling`). partials: B * tiles * 2 *
// Cout floats of scratch; stats: 2 * B * Cout floats (sums, then sums of
// squares). Returns the first CUDA error of the two launches, or 0.
extern "C" int conv_gn_f32(const void* x, const void* w, long long w_s0, long long w_s1,
                           long long w_s2, long long w_s3, const void* bias, const void* scale,
                           const void* shift, const void* res, const void* wskip, long long k_s0,
                           long long k_s1, void* y, void* partials, void* stats, int B, int H,
                           int W, int Cin, int Cout, int Cres, int act, int has_res, int has_skip,
                           int tr, int tw, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Params p;
    p.x = static_cast<const float*>(x);
    p.w = static_cast<const float*>(w);
    p.w_s0 = w_s0; p.w_s1 = w_s1; p.w_s2 = w_s2; p.w_s3 = w_s3;
    p.bias = static_cast<const float*>(bias);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.res = static_cast<const float*>(res);
    p.wskip = static_cast<const float*>(wskip);
    p.k_s0 = k_s0; p.k_s1 = k_s1;
    p.y = static_cast<float*>(y);
    p.partials = static_cast<float*>(partials);
    p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.Cres = Cres;
    p.act = act; p.has_res = has_res; p.has_skip = has_skip;
    p.tr = tr; p.tw = tw;
    p.tiles_w = (W + tw - 1) / tw;
    p.tiles = ((H + tr - 1) / tr) * p.tiles_w;

    int err;
    if (Cout <= 16) err = launch<2>(p, B, st);
    else if (Cout <= 32) err = launch<4>(p, B, st);
    else if (Cout <= 64) err = launch<8>(p, B, st);
    else err = launch<16>(p, B, st);
    if (err != 0) return err;
    const int n = 2 * B * Cout;
    conv_gn_stats_fold<<<(n + 255) / 256, 256, 0, st>>>(p.partials, static_cast<float*>(stats), B,
                                                         p.tiles, Cout);
    return (int)cudaGetLastError();
}
