// Fused [affine + swish] -> 3x3 conv (SAME) -> + bias [+ residual, or
// residual x W_skip] -> per-(b, channel) sums of y and y^2, float32, for
// sm_90a, on the TF32 tensor cores through wgmma at float32 accuracy.
//
// Replaces: diffsplitting_tpu/experimental/conv_gn.py:270, `_kernel_rows`
//   (launched by `conv_gn_fused`, :325, call :400; the window conv
//   `_window_conv` :176, the epilogue `_finish_tile` :224), the conv of the
//   stat-carried fused inference forward. The prologue applies the GroupNorm
//   that the caller folded into a per-(b, c) scale and shift, then swish,
//   while the input is staged; the epilogue emits the statistics the next
//   GroupNorm needs, so no normalized tensor and no second read for
//   statistics reach device memory. conv_gn_bf16.cu takes bf16 x.
//
// Bound: operations at most sites. An implicit GEMM with M = B*H*W pixels,
//   N = Cout and K = 9*Cin (+ Cres for a projected residual): 2*M*N*K flops
//   against (Cin + Cout [+ Cres]) * 4 bytes a pixel. One forward of the
//   splitting UNet at batch 8 and 512^2 does 484.3 GFLOP over its 31 sites.
//   Each f32 product is three TF32 tensor-core products (3xTF32), so the
//   least time is 3 * 484.3 GFLOP at 495 TFLOP/s; with the bytes of the six
//   512^2 sites where they bound, 3.2567 ms a forward (7.23 ms at the 67
//   TFLOP/s f32 FMA rate).
//
// Design (a Hopper redesign of the 3xTF32 mma.sync kernel this file held
// until commit 1ab4dcc: 8 or 4 warps a block in a two-stage cp.async ring,
// 12.19 ms for the 31 sites, 27 % of the bound). Times below are device
// times of the 31 sites of one fused Hagen forward at batch 8 on an H100
// 80GB HBM3 at 700 W, by CUDA-graph replay in turns with that kernel
// (`python -m diffsplitting_tpu_torch.kernels.conv_gn_variants --baseline`,
// each variant a text substitution): this design 7.83 ms against 12.19, 42 %
// of the bound; below that kernel at every site.
//   * Block: NWG consumer warpgroups and a producer warpgroup, one block an
//     SM, persistent: the grid is min(items, SMs) and block k takes items k,
//     k + grid, ... (an item: one batch element's tile of NWG * 4 * MT rows
//     of 16 pixels and every output channel, N = BN >= Cout, so the
//     statistics stay in the block). Warpgroup v owns 4 * MT of the tile's
//     rows, MT m64 tiles. setmaxnreg lowers the producer to 24 registers and
//     raises the consumers to 240 (NWG 2; ptxas allocates 168 at launch; at
//     232: 7.87 ms) or 160 (NWG 3; 128 at launch).
//     BN 16 and 32: NWG 3, MT 2 (24 x 16 tiles; on 16 x 16 tiles of two
//     warpgroups 8.59 ms, on 12 x 16 tiles of one m64 tile each at 32
//     channels 8.14); BN 64: NWG 2, MT 2; BN 128: NWG 2, MT 1 (two m64 tiles'
//     running and group sums do not fit). Two blocks an SM, of two
//     warpgroups and a producer warp each, were held to 96 registers a thread
//     and spilled. K walks Cin in chunks of 16 channels,
//     each through the 9 taps (an offset into the halo window), then a
//     projected residual's Cres in chunks of 16 on the centre tap.
//   * Products: wgmma.mma_async.m64nBNk8.f32.tf32.tf32 (BN 16 ... 128), A
//     from registers, B from shared memory by a K-major descriptor (a tf32
//     wgmma reads B only K-major). Each operand is split into big = x rounded
//     to TF32 to nearest (ties away, tf32x3.cuh `split`) and small = x - big,
//     which the tensor core reads truncated; each k8 step takes small*big,
//     big*small and big*big (the small*small term, about 2^-22 of the
//     product, is dropped; 1xTF32 ran in 6.14 ms, its statistics 56x
//     chip_smoke.py's tolerance).
//     - A, the activated window, split in registers where it is loaded: a
//       warp's 16 rows are 16 consecutive pixels, a pixel's 16 channels 64
//       bytes, and a thread loads channels 4t .. 4t+3 of pixel g (+8) as one
//       16-byte load, free of bank conflicts; K is permuted so that k8 step h
//       takes channels 4t + 2h (k t) and 4t + 2h + 1 (k t + 4). The tap is
//       an offset of those loads. A (tap, m64 tile) unit's A goes into one of
//       NB register buffers (16 registers each), loaded once the unit NB back
//       has completed (wgmma.wait_group; NB 3 at 64 and 2 at 128 channels:
//       7.93 ms). Big and small planes written once by the activation (the
//       first form of this design) doubled the loads and the windows' shared
//       memory.
//     - B, the weights: a preparatory launch (conv_gn_split_weights) reads
//       them once a call through their strides, splits them and writes each
//       K step as [big, small][k8 step][BN][8] floats in the 32-byte swizzle
//       (`weight_at`), the K permutation applied, zero past Cin, Cres and
//       Cout. A stage (TPS taps, or one residual chunk) is contiguous, so one
//       producer thread streams it by cp.async.bulk into a ring of NS stages,
//       completed on `full` mbarriers, for every item of the block in turn;
//       each consumer warpgroup releases a stage on its `empty` mbarrier at
//       the end of the group that holds its last tap (one-tap stages at 64
//       and 128 channels: 8.28 ms).
//   * Tap-group sums (the accumulator adds rounding toward zero, PERF.md §6,
//     a bias that the per-channel statistics sum over H*W pixels): each group
//     of TG taps of a chunk, and each residual chunk, is summed from 0 in the
//     tensor core (scale-d = 0 on its first wgmma), waited on, and added in
//     f32 (round to nearest) to the running sum: TG 1 at 16 channels, 3 at
//     32, 64 and 128 (3 at 16: 8.05 ms; 1 everywhere: 8.24; 1 at 32: 7.90).
//     tests/test_torch_port_conv_gn_tf32x3_sums.py emulates the order and
//     holds the statistics against f64 at each Hagen depth: 0.05 (sums) and
//     0.10 (squares) of the relative tolerance, against up to 1.97 and 4.65
//     with all of K in the accumulator.
//   * The windows: each consumer warpgroup has its own halo window of 16
//     channels (its rows and one above and below) in a ring of kSlots = 3
//     slots, across the items. Its threads copy a chunk's window two chunks
//     ahead by cp.async (16-byte pieces, zero-filled outside the image and
//     past the channels), then, one chunk ahead, activate in place the pieces
//     they copied (x * scale + shift, swish by fast intrinsics, about 1e-6
//     relative error; expf and a true division: 8.59 ms) and arrive on the
//     slot's mbarrier. Zero padding is of the ACTIVATED input (swish(shift)
//     != 0): positions outside the image stay 0. Activating while the
//     warpgroup's own group runs was slower.
//   * The warpgroups issue on their own; taking turns (named barriers, a
//     round a group; kTurns) ran 8.43 ms.
//   * Epilogue, each warpgroup for its rows of an item: bias (from shared
//     memory) and identity residual added to the f32 sum; per-channel sums of
//     y and y^2 over its valid pixels, reduced across lanes by shuffles and
//     across its 4 warps in shared memory in a fixed order into partials
//     [b][tile][warpgroup][2][Cout], folded by conv_gn_stats_fold
//     (conv_gn_stats.cuh); y stored in 16-byte pieces (a lane pair swaps
//     halves of its rows). An identity residual is loaded before the stores
//     at 16 and 128 channels (after them everywhere: 7.87 ms; before them
//     everywhere: 7.91). No atomics: two launches give the same bits.
//   * Shared memory (bytes; `Smem`, ops/conv_gn.py `conv_gn_smem_bytes`): BN
//     16 163,256 (ring 3 x 9-tap stages 55,296, windows 9 x 11,520); BN 32
//     160,264 (4 x 3 taps 49,152); BN 64 152,416 (3 x 3 taps 73,728, windows 6
//     x 11,520); BN 128 157,776 (2 x 3 taps 98,304, windows 6 x 6,912).
//   * Registers (`-Xptxas -v`, the launch's allocation): 128 at BN 16 and 32,
//     168 at 64 and 128; spilled 0, 72, 16 and 36 bytes. A consumer thread
//     holds MT * BN / 2 running and as many group sums and NB x 16 of A
//     (NB 3, 2, 2, 3): 80, 96, 160 and 176.
//   * Weights are read through their four strides by the split launch, so
//     the HWIO view of a PyTorch OIHW parameter is taken without a copy.
//   * Cin, Cres and Cout are multiples of 4, Cin and Cres at most 256, Cout at
//     most 128; rows and columns that H or W leave ragged are masked. The
//     wrapper raises on anything else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "conv_gn_stats.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kKC = 16;                     // input channels a K step: two k8 wgmma steps
constexpr int kMaxCin = 256;                // the widest x the kernel takes
constexpr int kSlots = 3;                   // window slots a warpgroup: copied, activated, read
constexpr int kTurns = 0;                   // the warpgroups take turns to issue

struct Params {
    const float* x;       // (B, H, W, Cin)
    const float* bias;    // (Cout)
    const float* scale;   // (B, Cin), read iff act
    const float* shift;   // (B, Cin), read iff act
    const float* res;     // (B, H, W, Cres): projected, or identity
    const float* wsplit;  // [9 * n_in + n_res][2][2][BN][8] split weights (`weight_at`)
    float* y;             // (B, H, W, Cout)
    float* partials;      // (B, tiles, warpgroups, 2, Cout)
    float* stats;         // (2, B, Cout)
    int B, H, W, Cin, Cout, Cres;
    int act, identity;    // the prologue; an identity residual (added in the epilogue)
    int tiles_w, tiles;   // tiles a row of tiles, and a batch element
    int n_in, n_res;      // chunks of kKC channels of x and of a projected residual
};

// by the fast intrinsics (ex2.approx, approximate division): about 1e-6
// relative error against expf and a true division
__device__ __forceinline__ float swish(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// bytes from global to shared by the TMA unit, completed on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

template <int pending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// warpgroup v's threads only (named barrier 8 + v)
__device__ __forceinline__ void group_barrier(int v) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(8 + v) : "memory");
}

// warpgroup v's turn to issue its wgmma (named barrier 2 + v): it waits for
// the warpgroup before it in the round's arrival, which gives the turn
__device__ __forceinline__ void turn_wait(int v) {
    if (kTurns) asm volatile("bar.sync %0, 256;\n" ::"r"(2 + v) : "memory");
}
__device__ __forceinline__ void turn_give(int v) {
    if (kTurns) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + v) : "memory");
}

// B's layout, K-major in the 32-byte swizzle: a k8 step's row of 8 channels
// for output channel n is 32 bytes, its two 16-byte halves swapped where n / 4
// is odd. The descriptor of a k8 step's BN rows at shared address `addr`:
// the leading byte offset unused (1), 8-row groups 256 bytes apart (stride
// byte offset, in 16-byte units), layout 3 (32-byte swizzle).
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
           (3ull << 62);
}

// offset (floats) of element (n, k) of a k8 step's BN x 8 block in that layout
__device__ __forceinline__ int weight_at(int n, int k) {
    return n * 8 + ((k / 4) ^ ((n / 4) % 2)) * 4 + k % 4;
}

// One K step of weights, split: step q < 9 * n_in is (chunk q / 9, tap q %
// 9) of w, a later one a chunk of w_skip; element (plane, k8 step h, n, k)
// holds channel 4 (k % 4) + 2 h + k / 4 of the chunk (the A fragments'
// order). Zero past Cin, Cres and Cout.
__global__ void conv_gn_split_weights(const float* __restrict__ w, long long w_s0, long long w_s1,
                                      long long w_s2, long long w_s3,
                                      const float* __restrict__ wskip, long long k_s0,
                                      long long k_s1, float* __restrict__ out, int Cin, int Cout,
                                      int Cres, int BN, int n_in, int n_res) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)(9 * n_in + n_res) * BN * kKC) return;
    const int k = (int)(e % 8);
    const int n = (int)((e / 8) % BN);
    const int h = (int)((e / (8 * BN)) % 2);
    const long long q = e / ((long long)kKC * BN);
    const int ci = 4 * (k % 4) + 2 * h + k / 4;
    float v = 0.f;
    if (q < 9 * n_in) {
        const int tap = (int)(q % 9);
        const int ch = (int)(q / 9) * kKC + ci;
        if (ch < Cin && n < Cout) v = w[(tap / 3) * w_s0 + (tap % 3) * w_s1 + ch * w_s2 + n * w_s3];
    } else {
        const int ch = (int)(q - 9 * n_in) * kKC + ci;
        if (ch < Cres && n < Cout) v = wskip[ch * k_s0 + n * k_s1];
    }
    uint32_t big, small;
    split(v, big, small);
    float* dst = out + q * 4 * BN * 8 + h * BN * 8 + weight_at(n, k);
    dst[0] = __uint_as_float(big);
    dst[2 * BN * 8] = __uint_as_float(small);
}

// Shared memory of a block, in bytes from a 1024-byte aligned start (the
// swizzle is of address bits): the weight ring, the window slots, the
// warpgroups' statistics reductions (two a warpgroup, by tile parity), the
// bias, then the mbarriers. NWG consumer warpgroups of MT m64 tiles.
template <int BN, int MT, int NWG, int TPS, int NS>
struct Smem {
    static constexpr int HR = 4 * MT;                      // tile rows a warpgroup
    static constexpr int TR = NWG * HR, TW = 16, TW2 = TW + 2;
    static constexpr int WPX = (HR + 2) * TW2;             // its window's pixels
    static constexpr int TAP = BN * kKC * 2 * 4;           // a K step of split weights
    static constexpr int STAGE = TPS * TAP;
    static constexpr int RING = NS * STAGE;
    static constexpr int SLOT = WPX * kKC * 4;             // a window of 16 channels
    static constexpr int RED = RING + NWG * kSlots * SLOT;  // [NWG][2 parity][2][4 warps][BN] f32
    static constexpr int BIAS = RED + NWG * 2 * 2 * 4 * BN * 4;
    static constexpr int BARS = BIAS + BN * 4;
    static constexpr int BYTES = BARS + (2 * NS + NWG * kSlots) * 8 + 1024;  // + the alignment
    static_assert(HR * TW <= WPX, "a residual chunk fits a slot");
    static_assert(TAP % 1024 == 0 && SLOT % 16 == 0, "aligned regions");
};

// BN output channels a block (>= Cout), MT m64 tiles a consumer warpgroup,
// NWG consumer warpgroups (and a producer warpgroup), TPS taps a weight
// stage, NS stages in the ring, TG taps a from-zero group, NB register
// buffers of A. One block an SM.
template <int BN, int MT, int NWG, int TPS, int NS, int TG, int NB>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) conv_gn_kernel(Params p) {
    typedef Smem<BN, MT, NWG, TPS, NS> S;
    constexpr int NC = NWG * 128;          // consumer threads
    constexpr int TR = S::TR, TW = S::TW, TW2 = S::TW2, HR = S::HR, WPX = S::WPX;
    constexpr int NA = BN / 2;             // accumulator floats a thread an m64 tile
    constexpr int NJ = BN / 8;             // n8 column blocks
    constexpr int SPC = 9 / TPS;           // weight stages a chunk of x
    // the consumers' registers once the producer has given its own (the
    // launch's 168 or 128 a thread)
    constexpr int kRegs = NWG == 2 ? 240 : 160;
    static_assert(S::BYTES <= 232448 && (NWG == 2 || NWG == 3), "227 KB a block; registers");
    static_assert(BN % 16 == 0 && BN <= 128 && 9 % TPS == 0 && 9 % TG == 0, "shapes");
    static_assert(TG % TPS == 0 ? TG / TPS <= NS : TPS % TG == 0, "a group's stages fit the ring");

    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    unsigned char* ring = smem;
    float* slots = reinterpret_cast<float*>(smem + S::RING);
    float* bias = reinterpret_cast<float*>(smem + S::BIAS);  // zero past Cout
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
    uint64_t* empty = full + NS;
    uint64_t* ready = empty + NS;  // [NWG][kSlots]: a warpgroup's window slot activated

    const int tid = threadIdx.x;
    const int n_chunks = p.n_in + p.n_res;
    const int n_stages = p.n_in * SPC + p.n_res;
    // the block's items (batch element, tile) are blockIdx.x + k gridDim.x
    const int n_items = (p.B * p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

    for (int n = tid; n < BN; n += NC) bias[n] = n < p.Cout ? p.bias[n] : 0.f;
    if (tid == 0) {
        for (int i = 0; i < NS; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], NWG);
        }
        for (int i = 0; i < NWG * kSlots; ++i) mbar_init(&ready[i], 128);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= NC) {
        // ---- producer: one thread streams each item's weight stages; the
        // warpgroup gives its registers to the consumers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (tid == NC) {
            for (int q = 0; q < n_items * n_stages; ++q) {
                const int slot = q % NS;
                if (q >= NS) mbar_wait(&empty[slot], (q / NS - 1) & 1);
                const int s = q % n_stages;
                const bool in = s < p.n_in * SPC;
                const int k0 = in ? s * TPS : 9 * p.n_in + (s - p.n_in * SPC);
                const uint32_t bytes = (in ? TPS : 1) * S::TAP;
                mbar_expect_tx(&full[slot], bytes);
                bulk_copy(ring + slot * S::STAGE, p.wsplit + (long long)k0 * (S::TAP / 4), bytes,
                          &full[slot]);
            }
        }
        return;
    }

    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs) : "memory");
    const int warp = tid / 32;  // warp w = warp % 4 of warpgroup warp / 4
    const int lane = tid % 32;
    const int g = lane / 4;     // fragment row g and g + 8, column pair 2t of each n8
    const int t = lane % 4;     // channels 4t .. 4t + 3 of a K step
    const int wg = warp / 4;
    const int lt = tid % 128;   // thread in the warpgroup
    const long long HW = (long long)p.H * p.W;
    const int n_total = n_items * n_chunks;  // chunks the warpgroup walks

    // its pixel of fragment row g + 8h of m64 tile i (in its rows)
    auto local = [&](int i, int h) { return (i * 4 + warp % 4) * 16 + g + 8 * h; };
    int off[MT][2];  // window offset (floats) of the top-left tap of this thread's A rows
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int pp = local(i, h);
            off[i][h] = ((pp / TW) * TW2 + pp % TW) * kKC + 4 * t;
        }
    float* my_slots = slots + wg * kSlots * (S::SLOT / 4);
    uint64_t* my_ready = ready + wg * kSlots;
    float* my_red = reinterpret_cast<float*>(smem + S::RED) + wg * 2 * 2 * 4 * BN;

    // The item of the warpgroup's chunk gc: batch element, tile, and the
    // image row and column of its first window pixel (one above and left of
    // its rows)
    struct Item { int b, tile, r0, c0; };
    auto item_of = [&](int gc) {
        const int it = blockIdx.x + (gc / n_chunks) * gridDim.x;
        Item m;
        m.b = it / p.tiles;
        m.tile = it - m.b * p.tiles;
        m.r0 = (m.tile / p.tiles_w) * TR + wg * HR;
        m.c0 = (m.tile % p.tiles_w) * TW;
        return m;
    };

    // The pieces of a window this thread copies and activates: 16 bytes
    // (channels q4 .. q4 + 3 of a chunk) of window pixel lt / 4 + 32 m (a
    // residual chunk's pixel lt / 4 + 32 m of the warpgroup's rows).
    constexpr int NPX = (WPX * 4 + 127) / 128;
    constexpr int NPR = HR * TW * 4 / 128;
    const int q4 = 4 * (lt & 3);

    // chunk gc's input as it is, into its window slot: the
    // halo window of the warpgroup's rows of x chunk c (c < n_in), or a
    // residual chunk at its pixels; zero outside the image and past the
    // channels
    auto copy_chunk = [&](int gc) {
        const Item m = item_of(gc);
        const int c = gc % n_chunks;
        float* dst = my_slots + (gc % kSlots) * (S::SLOT / 4);
        if (c < p.n_in) {
            const int ch = c * kKC + q4;
            const float* xb = p.x + m.b * HW * p.Cin + ch;
#pragma unroll
            for (int k = 0; k < NPX; ++k) {
                const int px = lt / 4 + 32 * k;
                const int gr = m.r0 - 1 + px / TW2;
                const int gcol = m.c0 - 1 + px % TW2;
                const bool ok = gr >= 0 && gr < p.H && gcol >= 0 && gcol < p.W && ch < p.Cin;
                if (px < WPX)
                    cp_async16_zfill(dst + px * kKC + q4,
                                     ok ? xb + ((long long)gr * p.W + gcol) * p.Cin : p.x, ok);
            }
        } else {
            const int ch = (c - p.n_in) * kKC + q4;
            const float* rb = p.res + m.b * HW * p.Cres + ch;
#pragma unroll
            for (int k = 0; k < NPR; ++k) {
                const int px = lt / 4 + 32 * k;
                const int gr = m.r0 + px / TW;
                const int gcol = m.c0 + px % TW;
                const bool ok = gr < p.H && gcol < p.W && ch < p.Cres;
                cp_async16_zfill(dst + px * kKC + q4,
                                 ok ? rb + ((long long)gr * p.W + gcol) * p.Cres : p.res, ok);
            }
        }
    };
    // ... then, where the block has a prologue, the pieces of x this thread
    // copied activated in place (where the pixel is in the image); the slot
    // is ready once the warpgroup has arrived. Channels past Cin stay 0.
    auto activate_chunk = [&](int gc) {
        const int c = gc % n_chunks;
        const int ch = c * kKC + q4;
        if (c < p.n_in && p.act && ch < p.Cin) {
            const Item m = item_of(gc);
            float* win = my_slots + (gc % kSlots) * (S::SLOT / 4);
            const float4 sc =
                __ldg(reinterpret_cast<const float4*>(p.scale + (long long)m.b * p.Cin + ch));
            const float4 sh =
                __ldg(reinterpret_cast<const float4*>(p.shift + (long long)m.b * p.Cin + ch));
#pragma unroll
            for (int k = 0; k < NPX; ++k) {
                const int px = lt / 4 + 32 * k;
                const int gr = m.r0 - 1 + px / TW2;
                const int gcol = m.c0 - 1 + px % TW2;
                // outside the image the ACTIVATED input is 0: swish(shift) != 0
                if (px >= WPX || gr < 0 || gr >= p.H || gcol < 0 || gcol >= p.W) continue;
                float4* at = reinterpret_cast<float4*>(win + px * kKC + q4);
                float4 v = *at;
                v.x = swish(fmaf(v.x, sc.x, sh.x));
                v.y = swish(fmaf(v.y, sc.y, sh.y));
                v.z = swish(fmaf(v.z, sc.z, sh.z));
                v.w = swish(fmaf(v.w, sc.w, sh.w));
                *at = v;
            }
        }
        mbar_arrive_if(&my_ready[gc % kSlots], true);
    };

    float acc[MT][NA], tmp[MT][NA];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[i][e] = tmp[i][e] = 0.f;

    // A of one unit: both k8 steps of this thread's rows g and g + 8 at
    // window offsets o0 and o1, split into big and small
    auto load_a = [&](uint32_t (&ab)[2][4], uint32_t (&as)[2][4], const float* win, int o0,
                      int o1) {
        const float4 r0 = *reinterpret_cast<const float4*>(win + o0);
        const float4 r1 = *reinterpret_cast<const float4*>(win + o1);
        split(r0.x, ab[0][0], as[0][0]); split(r1.x, ab[0][1], as[0][1]);
        split(r0.y, ab[0][2], as[0][2]); split(r1.y, ab[0][3], as[0][3]);
        split(r0.z, ab[1][0], as[1][0]); split(r1.z, ab[1][1], as[1][1]);
        split(r0.w, ab[1][2], as[1][2]); split(r1.w, ab[1][3], as[1][3]);
    };

    // One chunk: NT taps (9 of x, or the centre tap of a residual chunk) of
    // the window `win` against global weight stages q0, q0 + 1, ... (SP taps
    // each), in groups of GT taps summed from 0; a stage is released at the
    // end of the group that holds its last tap; `between` runs once the
    // chunk's first group has been added; `last`: the warpgroup's last chunk.
    auto run_chunk = [&](auto nt, auto sp, auto gt, const float* win, int q0, auto aoff,
                         auto between, bool last) {
        constexpr int NT = decltype(nt)::value, SP = decltype(sp)::value, GT = decltype(gt)::value;
        uint32_t ab[NB][2][4], as[NB][2][4];
#pragma unroll
        for (int tp = 0; tp < NT; ++tp) {
            const int gs = tp / GT * GT;  // the group's first tap
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int u = tp * MT + i;   // unit of the chunk
                const int ug = u - gs * MT;  // ... of the group
                if (ug >= NB) wgmma_wait<NB - 1>();  // unit u - NB has completed: its buffer is free
                load_a(ab[u % NB], as[u % NB], win, aoff(tp, i, 0), aoff(tp, i, 1));
                if (ug == 0) {
#pragma unroll
                    for (int j = 0; j < MT; ++j) fence_regs(tmp[j]);
                    turn_wait(wg);
                }
                const int q = q0 + tp / SP;  // the global weight stage
                if (i == 0 && tp % SP == 0) mbar_wait(&full[q % NS], (q / NS) & 1);
                const uint32_t wt = smem_addr(ring) + (q % NS) * S::STAGE + (tp % SP) * S::TAP;
                wgmma_fence();
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t big = wt + h * BN * 32, small = wt + (2 + h) * BN * 32;
                    wgmma_tf32(tmp[i], as[u % NB][h], weight_desc(big), tp > gs || h > 0);
                    wgmma_tf32(tmp[i], ab[u % NB][h], weight_desc(small), 1);
                    wgmma_tf32(tmp[i], ab[u % NB][h], weight_desc(big), 1);
                }
                wgmma_commit();
            }
            if (tp == gs + GT - 1) {
                // the next warpgroup's turn (but for the first's after the last group)
                if (!(wg == NWG - 1 && last && tp == NT - 1)) turn_give((wg + 1) % NWG);
                wgmma_wait<0>();
                // the stages whose last tap is in this group are done with
#pragma unroll
                for (int st = gs / SP; st <= tp / SP; ++st)
                    if ((st + 1) * SP - 1 <= tp) mbar_arrive_if(&empty[(q0 + st) % NS], lt == 0);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    fence_regs(tmp[i]);
#pragma unroll
                    for (int e = 0; e < NA; ++e) acc[i][e] += tmp[i][e];
                }
                if (gs == 0) between();
            }
        }
    };

    // The warpgroup's part of an item's epilogue: bias and identity residual
    // added to the f32 sums; the statistics of its pixels, across the 8 lanes
    // (g) that hold a channel by shuffles and across its 4 warps in shared
    // memory, into partials [b][NWG tile + wg]; y stored in 16-byte pieces
    // (the lanes of a pair swap halves: the even lane stores row g, the odd
    // one row g + 8). acc is zeroed for the next item.
    auto epilogue = [&](const Item& m, int parity) {
        float s1[NJ][2], s2[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            long long pix[2];
            bool valid[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int pp = local(i, h);
                const int gr = m.r0 + pp / TW;
                const int gcol = m.c0 + pp % TW;
                valid[h] = gr < p.H && gcol < p.W;
                pix[h] = m.b * HW + (long long)gr * p.W + gcol;
            }
#pragma unroll
            // an identity residual of the m64 tile's rows, at 16 and 128
            // channels loaded before any store of y (the compiler does not
            // move the loads above them); at 32 and 64 the values held push
            // the consumers' registers into spills that cost more
            constexpr bool kEarlyRes = BN == 16 || BN == 128;
            float2 rr[2][kEarlyRes ? NJ : 1];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < (kEarlyRes ? NJ : 0); ++j) {
                    const int n = 8 * j + 2 * t;
                    rr[h][j] = p.identity && valid[h] && n < p.Cout
                                   ? *reinterpret_cast<const float2*>(p.res + pix[h] * p.Cout + n)
                                   : make_float2(0.f, 0.f);
                }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int n = 8 * j + 2 * t;  // n + 1 < Cout too: Cout % 4 == 0
                const float2 bv = *reinterpret_cast<const float2*>(bias + n);
                float v[2][2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    v[h][0] = acc[i][4 * j + 2 * h] + bv.x;
                    v[h][1] = acc[i][4 * j + 2 * h + 1] + bv.y;
                    if (valid[h] && n < p.Cout) {
                        if (p.identity) {
                            const float2 r =
                                kEarlyRes ? rr[h][kEarlyRes ? j : 0]
                                          : *reinterpret_cast<const float2*>(p.res + pix[h] * p.Cout + n);
                            v[h][0] += r.x;
                            v[h][1] += r.y;
                        }
                        s1[j][0] += v[h][0];
                        s1[j][1] += v[h][1];
                        s2[j][0] = fmaf(v[h][0], v[h][0], s2[j][0]);
                        s2[j][1] = fmaf(v[h][1], v[h][1], s2[j][1]);
                    }
                }
                // the even lane sends row g + 8's pair and takes its odd
                // neighbour's row g pair; the odd lane the reverse
                const int odd = t & 1;
                const float x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0][0] : v[1][0], 1);
                const float x1 = __shfl_xor_sync(0xffffffffu, odd ? v[0][1] : v[1][1], 1);
                const int h = odd;
                const int n4 = 8 * j + 4 * (t / 2);
                if (valid[h] && n4 < p.Cout)
                    *reinterpret_cast<float4*>(p.y + pix[h] * p.Cout + n4) =
                        odd ? make_float4(x0, x1, v[1][0], v[1][1])
                            : make_float4(v[0][0], v[0][1], x0, x1);
            }
#pragma unroll
            for (int e = 0; e < NA; ++e) acc[i][e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int k = 4; k < 32; k *= 2) {
                    s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], k);
                    s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], k);
                }
        float* red = my_red + parity * 2 * 4 * BN;  // [2][4 warps][BN]
        if (g == 0) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = 8 * j + 2 * t + e;
                    red[(warp % 4) * BN + n] = s1[j][e];
                    red[4 * BN + (warp % 4) * BN + n] = s2[j][e];
                }
        }
        group_barrier(wg);
        for (int e = lt; e < 2 * BN; e += 128) {
            const int which = e / BN;
            const int n = e % BN;
            if (n >= p.Cout) continue;
            const float* r = red + which * 4 * BN + n;
            const float a = ((r[0] + r[BN]) + r[2 * BN]) + r[3 * BN];
            p.partials[((((long long)m.b * p.tiles + m.tile) * NWG + wg) * 2 + which) * p.Cout + n] = a;
        }
    };

    // the window ring: chunk gc + 2 is copied and chunk gc + 1 activated
    // once chunk gc's first group has been added (while the other
    // warpgroup's wgmma run), across the items
    copy_chunk(0);
    cp_async_commit();
    if (n_total > 1) copy_chunk(1);
    cp_async_commit();
    cp_async_wait<1>();
    activate_chunk(0);
    // the first turn is warpgroup 0's
    if (wg == NWG - 1) turn_give(0);
#pragma unroll 1
    for (int gc = 0; gc < n_total; ++gc) {
        mbar_wait(&my_ready[gc % kSlots], (gc / kSlots) & 1);  // activated; gc - 1 read
        const float* win = my_slots + (gc % kSlots) * (S::SLOT / 4);
        const bool last = gc + 1 == n_total;
        const int c = gc % n_chunks;
        const int q0 = (gc / n_chunks) * n_stages + (c < p.n_in ? c * SPC : p.n_in * SPC + c - p.n_in);
        auto next = [&]() {
            if (gc + 2 < n_total) copy_chunk(gc + 2);  // into gc - 1's slot
            cp_async_commit();
            if (gc + 1 < n_total) {
                cp_async_wait<1>();  // this thread's copies of gc + 1 have landed
                activate_chunk(gc + 1);
            }
        };
        if (c < p.n_in) {
            run_chunk(std::integral_constant<int, 9>(), std::integral_constant<int, TPS>(),
                      std::integral_constant<int, TG>(), win, q0,
                      [&](int tp, int i, int h) {
                          return off[i][h] + ((tp / 3) * TW2 + tp % 3) * kKC;
                      }, next, last);
        } else {
            run_chunk(std::integral_constant<int, 1>(), std::integral_constant<int, 1>(),
                      std::integral_constant<int, 1>(), win, q0,
                      [&](int, int i, int h) { return local(i, h) * kKC + 4 * t; }, next, last);
        }
        if (c == n_chunks - 1) epilogue(item_of(gc), (gc / n_chunks) & 1);
    }
    cp_async_wait<0>();
}

// NWG consumer warpgroups of MT m64 tiles, NB register buffers of A, TG
// taps a from-zero group
template <int BN, int MT, int NWG, int TPS, int NS, int NB, int TG>
int launch(const Params& p, int tr, int tw, int sms, cudaStream_t st) {
    typedef Smem<BN, MT, NWG, TPS, NS> S;
    if (tr != S::TR || tw != S::TW || p.Cout > BN) return (int)cudaErrorInvalidValue;
    auto kernel = conv_gn_kernel<BN, MT, NWG, TPS, NS, TG, NB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return (int)err;
    const int items = p.B * p.tiles;
    kernel<<<items < sms ? items : sms, (NWG + 1) * 128, S::BYTES, st>>>(p);
    const int n = 2 * p.B * p.Cout;  // statistics entries, a warp each
    conv_gn_stats_fold<<<(n + 7) / 8, 256, 0, st>>>(p.partials, p.stats, p.B, NWG * p.tiles,
                                                         p.Cout);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), y (B, H, W, Cout) and res (B, H, W, Cres) contiguous f32,
// 16-byte aligned; w read as w[kh*w_s0 + kw*w_s1 + c*w_s2 + n*w_s3]; wskip as
// wskip[c*k_s0 + n*k_s1]; scale, shift (B, Cin) and bias (Cout) contiguous,
// 16-byte aligned. The tile is tr x tw pixels, the block's geometry for this
// Cout (see ops/conv_gn.py `conv_gn_tiling`). wsplit: (9 * ceil(Cin / 16) +
// (has_skip ? ceil(Cres / 16) : 0)) * 2 * BN * 16 floats of 16-byte aligned
// scratch, BN the block's channels (the least of 16, 32, 64, 128 that holds
// Cout); partials: B * tiles * G * 2 * Cout floats of scratch, G the block's
// consumer warpgroups (ops/conv_gn.py `conv_gn_partial_rows`); stats: 2 * B *
// Cout floats (sums, then sums of squares).
// Returns the first CUDA error of the three launches, or 0.
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
    p.stats = static_cast<float*>(stats);
    p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.Cres = Cres; p.act = act;
    p.identity = has_res && !has_skip;
    p.tiles_w = (W + tw - 1) / tw;
    p.tiles = ((H + tr - 1) / tr) * p.tiles_w;
    p.n_in = (Cin + kKC - 1) / kKC;
    p.n_res = has_skip ? (Cres + kKC - 1) / kKC : 0;
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;

    const int BN = Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
    const long long n_w = (long long)(9 * p.n_in + p.n_res) * BN * kKC;
    conv_gn_split_weights<<<(unsigned)((n_w + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(w), w_s0, w_s1, w_s2, w_s3, static_cast<const float*>(wskip),
        k_s0, k_s1, static_cast<float*>(wsplit), Cin, Cout, Cres, BN, p.n_in, p.n_res);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (BN == 16) return launch<16, 2, 3, 9, 3, 3, 1>(p, tr, tw, sms, st);
    if (BN == 32) return launch<32, 2, 3, 3, 4, 2, 3>(p, tr, tw, sms, st);
    if (BN == 64) return launch<64, 2, 2, 3, 3, 2, 3>(p, tr, tw, sms, st);
    return launch<128, 1, 2, 3, 2, 3, 3>(p, tr, tw, sms, st);
}
