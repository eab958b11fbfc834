// The statistics fold of the conv_gn kernels (conv_gn.cu, conv_gn_bf16.cu),
// for sm_90a: each kernel's blocks write per-tile partial sums of y and y^2,
// and this launch folds them in a fixed order, so the statistics do not
// depend on the order in which blocks run.

#pragma once

namespace {

// stats [2][B][Cout] (sums, then sums of squares) from partials
// [B][tiles][2][Cout]: a warp an entry, lane l summing tiles l, l + 32, ... in
// order, then a fixed shuffle tree
__global__ void conv_gn_stats_fold(const float* __restrict__ partials, float* __restrict__ stats,
                                   int B, int tiles, int Cout) {
    const int e = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (e >= 2 * B * Cout) return;  // the whole warp
    const int which = e / (B * Cout);
    const int b = (e / Cout) % B;
    const int n = e % Cout;
    const float* pp = partials + ((long long)b * tiles * 2 + which) * Cout + n;
    float a = 0.f;
    for (int k = lane; k < tiles; k += 32) a += pp[(long long)k * 2 * Cout];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) a += __shfl_xor_sync(0xffffffffu, a, m);
    if (lane == 0) stats[e] = a;
}

}  // namespace
