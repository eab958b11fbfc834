"""How csrc/conv_gn_bf16.cu sums K, emulated in f64 on the CPU.

The tensor core adds each k16 step's products into its f32 accumulator
rounding toward zero (the model of tests/test_torch_port_attention_split.py).
The kernel sums each stage's K steps from 0 in the accumulator (a tap group:
a chunk's 9 taps, K = 144; a projected residual's 4 chunks, K = 64) and adds
that sum to its running sum in f32, rounded to nearest. The first bf16
kernel (mma.sync) did the same with every K step alone. Accumulating all of K in the tensor core
would leave the bias of every truncation in y, and the per-channel
statistics sum that bias over H·W pixels.

At the K depths of the 11 conv sites of a fused sr_sr3_64_512 forward
(K = 9·Cin + Cres, 576 to 1,728), on seeded bf16 operands over 32² pixels,
the statistics of each arrangement's y (summed in f64, so only the
accumulation differs) are held against f64 with the tolerances
chip_smoke.py `phase_conv_gn_bf16` asserts: sums within 1e-5·Σ|y| + 1e-4,
sums of squares within 1e-5·Σy² + 1e-4.
"""

import numpy as np
import pytest
import torch

KC = 16  # channels a K step (one k16 wgmma)
TAPS = 9
RES_GROUP = 4  # residual chunks a stage
PIXELS = 32 * 32

# (Cin, Cout, Cres of a projected residual) of the 11 sites; the identity
# residual and the unprojected sites share K = 9·Cin
SR512_SITES = [(64, 64, 0), (64, 64, 0), (128, 128, 0), (192, 64, 0), (64, 64, 192),
               (128, 64, 0), (64, 64, 128), (64, 128, 0), (128, 128, 64), (192, 128, 0),
               (128, 128, 192)]
DEPTHS = sorted(set(SR512_SITES), key=lambda s: (9 * s[0] + s[2], s))


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values to the f32 next toward zero (as f64): what the tensor
    core's accumulator keeps of a sum."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def _groups(Cin: int, Cres: int):
    """The kernel's K steps (as slices of K) grouped as it sums them from 0:
    each x chunk's 9 taps, then the residual's chunks RES_GROUP at a time."""
    steps = [slice(k, k + KC) for k in range(0, TAPS * Cin, KC)]
    x_groups = [steps[i:i + TAPS] for i in range(0, len(steps), TAPS)]
    res = [slice(k, k + KC) for k in range(TAPS * Cin, TAPS * Cin + Cres, KC)]
    return x_groups + [res[i:i + RES_GROUP] for i in range(0, len(res), RES_GROUP)]


def emulate(a: torch.Tensor, b: torch.Tensor, groups, mode: str) -> torch.Tensor:
    """a (P, K) @ b (K, N) as the kernel sums it: `mode` "group" (each group
    from 0 in the accumulator, then added to the running sum in f32),
    "step" (every K step alone: the first mma.sync kernel) or "all" (all of
    K in the accumulator)."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for group in groups:
        if mode == "all":
            for k in group:
                acc = _round_toward_zero(acc + a[:, k] @ b[k])
            continue
        for part in ([group] if mode == "group" else [[k] for k in group]):
            tmp = torch.zeros_like(acc)
            for k in part:
                tmp = _round_toward_zero(tmp + a[:, k] @ b[k])
            acc = _f32(acc + tmp)
    return acc


def stats_errors(Cin: int, Cout: int, Cres: int, seed: int = 0) -> dict:
    """Per arrangement, the statistics' worst error against f64 as a share
    of phase_conv_gn_bf16's tolerance: (sums, sums of squares)."""
    rng = np.random.default_rng(seed)
    K = TAPS * Cin + Cres
    # activated inputs (swish of a unit normal: mostly positive, so the
    # truncations of a channel's partial sums lean one way) and weights, bf16
    xa = rng.standard_normal((PIXELS, K))
    xa = xa / (1 + np.exp(-xa))
    w = rng.standard_normal((K, Cout)) / np.sqrt(K)
    a = torch.from_numpy(xa).bfloat16().double()
    b = torch.from_numpy(w).bfloat16().double()
    bias = torch.from_numpy(rng.standard_normal(Cout) * 0.1).float().double()
    exact = a @ b + bias
    s64, q64 = exact.sum(0), (exact * exact).sum(0)
    tol_s, tol_q = 1e-5 * exact.abs().sum(0) + 1e-4, 1e-5 * q64 + 1e-4
    out = {}
    for mode in ("group", "step", "all"):
        y = _f32(emulate(a, b, _groups(Cin, Cres), mode) + bias)
        out[mode] = (((y.sum(0) - s64).abs() / tol_s).max().item(),
                     ((y * y).sum(0) - q64).abs().div(tol_q).max().item())
    return out


@pytest.fixture(scope="module")
def errors():
    # one torch thread: these small products only lose to threading (28 s
    # against 5 s here), and the suite runs several workers side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {site: stats_errors(*site) for site in DEPTHS}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("site", DEPTHS, ids=lambda s: f"K{9 * s[0] + s[2]}-Cout{s[1]}")
def test_tap_group_sums_keep_the_statistics_within_tolerance(errors, site):
    """The shipped arrangement (a stage's taps summed from 0, then added in
    f32) keeps both statistics well within the card check's tolerance at
    every K depth of the path, as does the one-step arrangement."""
    err = errors[site]
    print(f"K={9 * site[0] + site[2]} Cout={site[1]}: statistics' err / tol (sums, sumsqs): "
          f"tap groups {err['group'][0]:.3g} {err['group'][1]:.3g}, one step "
          f"{err['step'][0]:.3g} {err['step'][1]:.3g}, all of K in the accumulator "
          f"{err['all'][0]:.3g} {err['all'][1]:.3g}")
    assert max(err["group"]) <= 0.25
    assert max(err["step"]) <= 0.25


def test_accumulating_all_of_k_in_the_tensor_core_costs_the_most(errors):
    """Summing all of K in the accumulator leaves its truncations in y: at
    the path's deepest K (1,728) its sums of squares err several times more
    than the tap groups' and stay within the tolerance only by the margin
    recorded here (printed; PERF.md holds it beside the card's figure)."""
    deepest = max(DEPTHS, key=lambda s: 9 * s[0] + s[2])
    ratios = {s: errors[s]["all"][1] / max(errors[s]["group"][1], 1e-30) for s in DEPTHS}
    print("all of K / tap groups, sums of squares' err: "
          + ", ".join(f"K{9 * s[0] + s[2]}-Cout{s[1]} {r:.3g}" for s, r in ratios.items())
          + f"; at K={9 * deepest[0] + deepest[2]} all of K reaches "
          f"{errors[deepest]['all'][1]:.3g} of the tolerance")
    assert errors[deepest]["all"][1] > 3 * errors[deepest]["group"][1]
    assert all(r > 1 for r in ratios.values())
