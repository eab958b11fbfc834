"""How csrc/conv_gn.cu sums K on the TF32 tensor cores, emulated in f64 on the CPU.

The kernel runs only on the card, so its arithmetic is pinned here. Every
operand is split once where it is staged: big = x rounded to TF32 to
nearest, ties away (the kernel's integer add and mask), small = x - big,
which the tensor core reads truncated to TF32. Each k8 wgmma step adds one
product of the three (small·big, big·small, big·big, in that order) into its
f32 accumulator, rounding toward zero (the model of
tests/test_torch_port_attention_split.py). K walks Cin in chunks of 16
channels, each through the 9 taps, then a projected residual's chunks on the
centre tap; a K step of 16 channels is two k8 steps, the first taking the
channels ≡ 0, 1 (mod 4), the second ≡ 2, 3 (the permuted order of the A
fragments). The kernel sums each group of taps of a chunk (its depth by block
width, read from the source's launch lines), and each residual chunk, from 0
in the accumulator and adds that sum to its running sum in f32, rounded to
nearest.

At the K depths of the 31 conv sites of a fused Hagen forward (K = 9·Cin +
Cres, 144 to 2,304) the statistics of the emulated y (summed in f64, so only
the accumulation differs) are held against f64 as a share of the relative
part of chip_smoke.py `phase_conv_gn`'s tolerance (sums within 1e-5·Σ|y|,
sums of squares within 1e-5·Σy²), beside one-tap groups and all of K in the
accumulator. The whole convolution, emulated at the kernel's group depth on
small maps, is held against JAX's Pallas kernel in interpret mode (at its
aligned widths), JAX's and the port's plain versions (at ragged widths) and
f64. The swish is exact here; the kernel's fast intrinsics add about 1e-6
relative error to the activated input.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_attention_split import tf32_rna, tf32_trunc
from test_torch_port_conv_gn_bf16_sums import _round_toward_zero

from diffsplitting_tpu.experimental import conv_gn as jax_conv_gn
from diffsplitting_tpu_torch.ops import conv_gn_reference

KC = 16  # channels a K step: two k8 wgmma steps
TAPS = 9
SOURCE = Path(__file__).resolve().parents[1] / "diffsplitting_tpu_torch" / "csrc" / "conv_gn.cu"
# block channels -> taps a from-zero group, from the kernel's launch lines
# (`launch<BN, MT, NWG, TPS, NS, NB, TG>`)
TAP_GROUPS = {int(bn): int(tg) for bn, tg in re.findall(
    r"launch<(\d+), \d+, \d+, \d+, \d+, \d+, (\d+)>\(p", SOURCE.read_text())}
PIXELS = 128

# (Cin, Cout, Cres of a projected residual) of the 31 Hagen sites (an
# identity residual adds nothing to K)
HAGEN_SITES = [
    (16, 16, 0), (16, 16, 32), (16, 16, 48), (32, 16, 0), (48, 16, 0),
    (16, 32, 0), (32, 32, 16), (32, 32, 48), (32, 32, 96), (48, 32, 0), (96, 32, 0), (32, 32, 0),
    (64, 64, 0), (192, 64, 0), (32, 64, 0), (64, 64, 192), (64, 64, 32), (64, 64, 96),
    (96, 64, 0), (128, 128, 0), (128, 128, 192), (128, 128, 256), (128, 128, 64),
    (192, 128, 0), (256, 128, 0), (64, 128, 0),
]
DEPTHS = sorted(set(HAGEN_SITES), key=lambda s: (9 * s[0] + s[2], s))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small f64 products: one torch thread a worker keeps them fast
    beside the suite's other workers. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(x: torch.Tensor):
    """f32 x -> (big, small) as the tensor core reads them, in f64."""
    big = tf32_rna(x)
    return big.double(), tf32_trunc(x - big).double()


def _groups(Cin: int, Cres: int, depth):
    """The kernel's K steps (column offsets of 16 channels, x's chunks
    zero-padded to 16) grouped as it sums them from 0: `depth` taps of a
    chunk a group (None: all of K in one group); each residual chunk alone."""
    n_in, n_res = -(-Cin // KC), -(-Cres // KC)
    steps = list(range(0, TAPS * n_in * KC, KC))
    if depth is None:
        return [steps + list(range(TAPS * n_in * KC, (TAPS * n_in + n_res) * KC, KC))]
    groups = [steps[i:i + depth] for i in range(0, len(steps), depth)]
    return groups + [[(TAPS * n_in + r) * KC] for r in range(n_res)]


def emulate(a: torch.Tensor, b: torch.Tensor, groups) -> torch.Tensor:
    """a (P, K) @ b (K, N), f32 operands, as the kernel sums it (f64 holding
    f32 values): each K step's two k8 steps, three products each, added into
    a group's accumulator rounding toward zero; each group from 0, added to
    the running sum in f32."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    half = [torch.tensor([c for c in range(KC) if (c % 4) // 2 == h]) for h in (0, 1)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for group in groups:
        tmp = torch.zeros_like(acc)
        for k0 in group:
            for cols in half:
                k = k0 + cols
                for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                    tmp = _round_toward_zero(tmp + x[:, k] @ y[k])
        acc = (acc + tmp).float().double()
    return acc


def _operands(Cin: int, Cout: int, Cres: int, seed: int):
    """Activated inputs (swish of a unit normal: mostly positive, so the
    truncations of a channel's partial sums lean one way), weights and a
    bias at a site's depth, f32, in the kernel's K layout."""
    rng = np.random.default_rng(seed)
    n_in, n_res = -(-Cin // KC), -(-Cres // KC)
    K = (TAPS * n_in + n_res) * KC
    xa = rng.standard_normal((PIXELS, K))
    xa = xa / (1 + np.exp(-xa))
    w = rng.standard_normal((K, Cout)) / np.sqrt(TAPS * Cin + Cres)
    # zero past Cin and Cres in each chunk, as the kernel's zero fill
    step, ch = np.arange(K) // KC, np.arange(K) % KC
    x_step = step < TAPS * n_in
    chunk = np.where(x_step, step // TAPS, step - TAPS * n_in)
    live = chunk * KC + ch < np.where(x_step, Cin, Cres)
    xa[:, ~live] = 0
    w[~live] = 0
    bias = rng.standard_normal(Cout) * 0.1
    return (torch.from_numpy(xa).float(), torch.from_numpy(w).float(),
            torch.from_numpy(bias).float())


def _block_depth(Cout: int) -> int:
    """The kernel's group depth at Cout channels (rounded up to its block)."""
    return TAP_GROUPS[next(bn for bn in sorted(TAP_GROUPS) if bn >= Cout)]


def stats_errors(Cin: int, Cout: int, Cres: int, seed: int = 0) -> dict:
    """Per group depth (the kernel's, 1, all of K), the statistics' worst
    error against f64 as a share of the relative part of phase_conv_gn's
    tolerance: (sums, sums of squares)."""
    a, b, bias = _operands(Cin, Cout, Cres, seed)
    exact = a.double() @ b.double() + bias.double()
    s64, q64 = exact.sum(0), (exact * exact).sum(0)
    tol_s, tol_q = 1e-5 * exact.abs().sum(0), 1e-5 * q64
    out = {}
    for name, depth in (("kernel", _block_depth(Cout)), ("tap", 1), ("all", None)):
        y = (emulate(a, b, _groups(Cin, Cres, depth)) + bias.double()).float().double()
        out[name] = (((y.sum(0) - s64).abs() / tol_s).max().item(),
                     ((y * y).sum(0) - q64).abs().div(tol_q).max().item())
    return out


@pytest.fixture(scope="module")
def errors():
    return {site: stats_errors(*site) for site in DEPTHS}


def test_the_emulation_reads_the_kernels_group_depth():
    """A depth for each of the kernel's block widths, each a divisor of a
    chunk's 9 taps."""
    assert sorted(TAP_GROUPS) == [16, 32, 64, 128]
    assert all(tg in (1, 3, 9) for tg in TAP_GROUPS.values())


@pytest.mark.parametrize("site", DEPTHS, ids=lambda s: f"K{9 * s[0] + s[2]}-Cout{s[1]}")
def test_tap_group_sums_keep_the_statistics_within_tolerance(errors, site):
    """The kernel's groups keep both statistics well within the card check's
    tolerance at every K depth of the Hagen walk."""
    err = errors[site]
    print(f"K={9 * site[0] + site[2]} Cout={site[1]}: statistics' err / relative tol (sums, "
          f"sumsqs): groups of {_block_depth(site[1])} taps {err['kernel'][0]:.3g} "
          f"{err['kernel'][1]:.3g}, "
          f"one tap {err['tap'][0]:.3g} {err['tap'][1]:.3g}, all of K in the accumulator "
          f"{err['all'][0]:.3g} {err['all'][1]:.3g}")
    assert max(err["kernel"]) <= 0.25
    assert max(err["tap"]) <= 0.25


def test_accumulating_all_of_k_in_the_tensor_core_costs_the_most(errors):
    """Summing all of K in the accumulator leaves its truncations in y: at
    the deepest K its sums of squares err several times more than the
    kernel's groups."""
    deepest = max(DEPTHS, key=lambda s: 9 * s[0] + s[2])
    ratios = {s: errors[s]["all"][1] / max(errors[s]["kernel"][1], 1e-30) for s in DEPTHS}
    print("all of K / groups, sums of squares' err: "
          + ", ".join(f"K{9 * s[0] + s[2]}-Cout{s[1]} {r:.3g}" for s, r in ratios.items())
          + f"; at K={9 * deepest[0] + deepest[2]} all of K reaches "
          f"{errors[deepest]['all'][1]:.3g} of the relative tolerance")
    assert errors[deepest]["all"][1] > 3 * errors[deepest]["kernel"][1]
    assert sum(r > 1 for r in ratios.values()) > len(ratios) // 2


def _im2col(xa: torch.Tensor, Cin: int):
    """(P, 9·16·n_in) of the zero-padded activated window in the kernel's K
    order: chunk, tap, channel."""
    B, H, W, _ = xa.shape
    win = F.pad(xa, (0, -Cin % KC, 1, 1, 1, 1))
    cols = []
    for c in range(0, win.shape[-1], KC):
        for tap in range(TAPS):
            kh, kw = divmod(tap, 3)
            cols.append(win[:, kh:kh + H, kw:kw + W, c:c + KC].reshape(-1, KC))
    return torch.cat(cols, dim=1)


def emulate_conv(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
    """(y, sums, sumsqs) of the whole fused conv as the kernel computes them
    (statistics summed in f64)."""
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    depth = _block_depth(Cout)
    xa = x
    if scale is not None:
        xa = x * scale[:, None, None, :] + shift[:, None, None, :]
        xa = xa / (1 + torch.exp(-xa))
    a = _im2col(xa, Cin)
    wk = F.pad(w, (0, 0, 0, -Cin % KC))  # (3, 3, 16 n_in, Cout)
    bk = wk.permute(2, 0, 1, 3).reshape(-1, KC, TAPS, Cout).permute(0, 2, 1, 3).reshape(-1, Cout)
    Cres = 0
    if w_skip is not None:
        Cres = residual.shape[-1]
        a = torch.cat([a, F.pad(residual, (0, -Cres % KC)).reshape(-1, Cres + -Cres % KC)], dim=1)
        bk = torch.cat([bk, F.pad(w_skip, (0, 0, 0, -Cres % KC))])
    y = (emulate(a, bk, _groups(Cin, Cres, depth)) + b.double()).float()
    y = y.reshape(B, H, W, Cout)
    if residual is not None and w_skip is None:
        y = y + residual
    yd = y.double()
    return y, yd.sum(dim=(1, 2)), (yd * yd).sum(dim=(1, 2))


def _f64(x, w, b, scale=None, shift=None, residual=None, w_skip=None):
    """y and its statistics in f64 from the same f32 inputs."""
    xa = x.double()
    if scale is not None:
        xa = xa * scale.double()[:, None, None, :] + shift.double()[:, None, None, :]
        xa = xa * torch.sigmoid(xa)
    y = F.conv2d(xa.permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.double()
    if residual is not None:
        y = y + (residual.double() @ w_skip.double() if w_skip is not None
                 else residual.double())
    return y, y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


def _inputs(B, H, W, Cin, Cout, act, res, Cres, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, H, W, Cin), w=f(3, 3, Cin, Cout) / np.float32(np.sqrt(9 * Cin)),
        b=f(Cout) * np.float32(0.1),
        scale=f(B, Cin) * np.float32(0.2) + 1 if act else None,
        shift=f(B, Cin) * np.float32(0.5) if act else None,
        residual=f(B, H, W, Cres) if res else None,
        w_skip=f(Cres, Cout) / np.float32(np.sqrt(Cres)) if res == "projected" else None)


def _check(got, want, exact):
    """y within chip_smoke.py's 1e-4·(1 + max|y|) of `want`; the statistics
    within its 1e-5·Σ|y| + 1e-3 and 1e-5·Σy² + 1e-3 of f64."""
    y, s, q = got
    y64, s64, q64 = exact
    tol = 1e-4 * (1 + np.abs(want).max())
    assert np.abs(y.numpy() - want).max() <= tol
    assert ((s - s64).abs() <= 1e-5 * y64.abs().sum(dim=(1, 2)) + 1e-3).all()
    assert ((q - q64).abs() <= 1e-5 * q64 + 1e-3).all()


# at JAX's aligned widths, where its Pallas kernel runs (interpret mode)
@pytest.mark.parametrize("act,res,Cres", [(True, None, 0), (False, "identity", 128),
                                          (True, "projected", 128)])
def test_emulated_conv_matches_jax_pallas_kernel(act, res, Cres):
    args = _inputs(1, 8, 8, 128, 128, act, res, Cres, seed=Cres + act)
    targs = {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}
    want = np.asarray(jax_conv_gn.conv_gn_fused(
        **{k: None if v is None else jnp.asarray(v) for k, v in args.items()},
        interpret=True)[0])
    got = emulate_conv(**targs)
    _check(got, want, _f64(**targs))
    np.testing.assert_allclose(got[0].numpy(), conv_gn_reference(**targs)[0].numpy(),
                               atol=1e-4 * (1 + np.abs(want).max()), rtol=0)


# ragged widths (12, 20, 48 channels: a K step part filled) against JAX's
# and the port's plain versions
@pytest.mark.parametrize("Cin,Cout,res,Cres", [(12, 12, "projected", 20), (20, 12, "identity", 12),
                                               (48, 20, "projected", 48), (48, 48, None, 0)])
def test_emulated_conv_matches_plain_versions_at_ragged_widths(Cin, Cout, res, Cres):
    args = _inputs(2, 6, 5, Cin, Cout, True, res, Cres, seed=Cin + Cout)
    targs = {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}
    want = conv_gn_reference(**targs)[0].numpy()
    want_jax = np.asarray(jax_conv_gn.conv_gn_reference(
        **{k: None if v is None else jnp.asarray(v) for k, v in args.items()})[0])
    got = emulate_conv(**targs)
    _check(got, want, _f64(**targs))
    _check(got, want_jax, _f64(**targs))
