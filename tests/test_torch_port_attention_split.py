"""The 3xTF32 arithmetic of csrc/attention.cu, emulated in plain PyTorch.

The kernel runs only on the card, so its arithmetic is pinned here: each f32
operand x is split into big = x rounded to TF32 (10 mantissa bits, to nearest,
ties away from zero, as cvt.rna.tf32.f32 rounds; the kernel does it with an
integer add and mask) and small = x - big, which the tensor core reads
truncated to TF32. A product accumulates small*big + big*small + big*big in
f32. The emulation walks the keys in the kernel's 32-key tiles with its
online softmax in the exp2 domain, and sums as the kernel does: S over all of
D in one accumulator, each tile's P V from 0, then added to O in f32. A last
tile that N does not fill is zero-padded and its scores there set to -inf. The emulation is held against JAX's `attention_reference`
and the port's within the chip check's tolerance 1e-4 * (1 + max|ref|). A
1xTF32 emulation (big*big only) is printed beside it to record what the split
buys.

The wide kernel (D above 128) is emulated in its own order of sums, with the
accumulator rounding toward zero after every MMA: each 128-wide slice's
partial S in 16-wide head-dim steps from 0, added in f32; the partials added
in f32 in slice order; each key tile's P V from 0. Where D is not a multiple
of 128 its last slice is zero-filled past D. The narrow kernel (D below 128)
is emulated at its padded head dim DP and key tile, with the same model of
the accumulator and the D = 128 kernel's sums: S over all of DP in it, each
key tile's P V from 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.ops.attention import attention_reference as jax_attention
from diffsplitting_tpu_torch.ops import attention_reference

TILE = 32  # keys a stage of the kernel
STEP = 16  # head dims of S a step, where S is summed from 0 a step
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding: (bits + 0x1000) & 0xffffe000 on the f32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def rna_by_definition(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, to nearest, ties away from zero (f64)."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))  # |x| = m * 2^e, m in [0.5, 1)
    return np.sign(x) * np.ldexp(np.floor(m * 2.0 ** 11 + 0.5), e - 11)


def split(x):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def mm(a, b, terms: int):
    """a @ b from TF32 operands, f32 sums: 3 terms (3xTF32) or 1 (1xTF32)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if terms == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def emulate(q, k, v, scale: float, terms: int = 3):
    """(N, D) q, k, v of one (batch, head): the kernel's tile loop."""
    n, d = q.shape
    c2 = scale * LOG2E
    pad = -n % TILE  # the last tile's keys past N are zeros
    k = torch.cat([k, torch.zeros(pad, d)])
    v = torch.cat([v, torch.zeros(pad, d)])
    o = torch.zeros(n, d)
    m = torch.full((n, 1), -torch.inf)
    l = torch.zeros(n, 1)
    for k0 in range(0, n, TILE):
        kt = k[k0:k0 + TILE]
        s = mm(q, kt.T, terms) * c2
        s[:, n - k0:] = -torch.inf  # keys past N take no weight
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=1, keepdim=True)
        o = o * corr + mm(p, v[k0:k0 + TILE], terms)
        m = m_new
    return o / l


def test_integer_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
        # exact ties: 11 significant bits and a half, both signs
        np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 3.0 - 2.0 ** -10,
                  2.0 - 2.0 ** -12, 0.0]),
    ]).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, rna_by_definition(x))


def test_split_is_exact_and_small():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=100_000) * 3).astype(np.float32))
    big = tf32_rna(x)
    small = x - big
    assert torch.equal(big + small, x)  # the remainder is exact in f32
    assert (small.abs() <= x.abs() * 2.0 ** -11).all()
    # the tensor core's truncation of small costs at most 2^-21 |x|
    assert ((small - tf32_trunc(small)).abs() <= x.abs() * 2.0 ** -21).all()


def _emulation_errors(N: int, score_gain: float, seed: int):
    """Max abs errors of the 3xTF32 and 1xTF32 emulations against the port's
    reference, the 3xTF32 one's against JAX's, and the tolerance."""
    B, H, D = 1, 1, 128
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3))
    scale = score_gain / np.sqrt(D)
    want_jax = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    want = attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    tq, tk, tv = (torch.from_numpy(a[0, :, 0]) for a in (q, k, v))
    got3 = emulate(tq, tk, tv, scale).numpy()
    got1 = emulate(tq, tk, tv, scale, terms=1).numpy()
    tol = 1e-4 * (1 + np.abs(want).max())
    err3 = np.abs(got3 - want[0, :, 0]).max()
    err1 = np.abs(got1 - want[0, :, 0]).max()
    print(f"N={N} score gain {score_gain}: 3xTF32 max abs err {err3:.3g}, 1xTF32 {err1:.3g}, "
          f"tolerance {tol:.3g}")
    return err3, err1, np.abs(got3 - want_jax[0, :, 0]).max(), tol


@pytest.mark.parametrize("score_gain", [1, 8])
def test_3xtf32_emulation_matches_references(score_gain):
    err3, err1, err3_jax, tol = _emulation_errors(256, score_gain, seed=2)
    assert err3 <= tol
    assert err3_jax <= tol
    assert err3 * 10 < err1  # the split buys f32 accuracy back


# N = 100: three full tiles, then a tile of 4 keys and 28 zero-filled slots
@pytest.mark.parametrize("score_gain", [1, 8])
def test_3xtf32_emulation_masks_the_last_tile(score_gain):
    err3, err1, err3_jax, tol = _emulation_errors(100, score_gain, seed=3)
    assert err3 <= tol
    assert err3_jax <= tol
    assert err3 * 10 < err1


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values to the f32 next toward zero (as f64): what the tensor
    core's accumulator keeps of a sum."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _mma_steps(a, b, acc):
    """acc + a @ b in k-steps of 8 (one m16n8k8 MMA each, 3xTF32 products
    exact), the accumulator rounded toward zero after every step."""
    for k0 in range(0, a.shape[1], 8):
        ab, as_ = split(a[:, k0:k0 + 8].float())
        bb, bs = split(b[k0:k0 + 8].float())
        acc = _round_toward_zero(acc + as_.double() @ bb.double() + ab.double() @ bs.double()
                                 + ab.double() @ bb.double())
    return acc


def emulate_accumulator(q, k, v, scale: float, s_in_mma: bool, o_in_mma: bool):
    """The kernel's tile loop with the MMA accumulator modelled as rounding
    toward zero: S over all of D (s_in_mma) or per STEP head dims from 0, O
    over all N keys (o_in_mma) or per tile from 0, the rest in f32."""
    f32 = lambda x: x.float().double()  # noqa: E731
    n, d = q.shape
    q, k, v = q.double(), k.double(), v.double()
    c2 = scale * LOG2E
    o = torch.zeros(n, d, dtype=torch.float64)
    m = torch.full((n, 1), -torch.inf, dtype=torch.float64)
    l = torch.zeros(n, 1, dtype=torch.float64)
    for k0 in range(0, n, TILE):
        kt, vt = k[k0:k0 + TILE], v[k0:k0 + TILE]
        zeros = torch.zeros(n, TILE, dtype=torch.float64)
        if s_in_mma:
            s = _mma_steps(q, kt.T, zeros)
        else:
            s = zeros
            for d0 in range(0, d, STEP):
                s = f32(s + _mma_steps(q[:, d0:d0 + STEP], kt[:, d0:d0 + STEP].T, zeros))
        s = f32(s * c2)
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        corr = f32(torch.exp2(m - m_new))
        p = f32(torch.exp2(s - m_new))
        l = f32(l * corr + p.sum(dim=1, keepdim=True))
        o = f32(o * corr)
        o = _mma_steps(p, vt, o) if o_in_mma else f32(o + _mma_steps(p, vt, torch.zeros_like(o)))
        m = m_new
    return (o / l).float()


def test_truncating_accumulator_error_comes_from_the_sum_over_keys():
    """Why the kernel sums P V from 0 a tile and adds it in f32: with an
    accumulator that rounds toward zero, summing O over all N keys in it
    costs more than summing S over D in it, and the kernel's order (S in
    it, O per tile) leaves well under half of the error of both in it."""
    N, D = 512, 128
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(3))
    scale = 1 / np.sqrt(D)
    exact = torch.softmax((q.double() @ k.double().T) * scale, dim=1) @ v.double()
    err = {(s_acc, o_acc): (emulate_accumulator(q, k, v, scale, s_acc, o_acc).double() - exact)
           .abs().max().item() for s_acc in (True, False) for o_acc in (True, False)}
    print(f"N={N}: max abs err, S and O in the accumulator {err[True, True]:.3g}, O only "
          f"{err[False, True]:.3g}, S only (the kernel) {err[True, False]:.3g}, neither "
          f"{err[False, False]:.3g}")
    assert err[False, True] > 2 * err[False, False]
    assert err[False, True] > err[True, False]
    assert err[True, True] > 2 * err[True, False]


# The wide kernel (attention_tf32x3_wide_kernel, D in (128·(DS − 1), 128·DS]):
# head dims a warp owns, and keys a tile by DS, as WideTile's kTileK in
# csrc/attention.cu
SLICE = 128


def wide_tile(D: int) -> int:
    return 32 if -(-D // SLICE) <= 4 else 16


def _mma3(a, b, acc):
    """acc + a @ b in k-steps of 8, each step three MMAs in mma_3xtf32's
    order (small·big, big·small, big·big), the accumulator rounded toward
    zero after each (f64 values, f32 operands)."""
    for k0 in range(0, a.shape[1], 8):
        ab, as_ = split(a[:, k0:k0 + 8].float())
        bb, bs = split(b[k0:k0 + 8].float())
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = _round_toward_zero(acc + x.double() @ y.double())
    return acc


def emulate_wide(q, k, v, scale: float, tile: int, s_step: int = STEP):
    """(N, D) q, k, v of one (batch, head): the wide kernel's tile loop. Each
    128-wide slice's partial S is summed in `s_step`-wide head-dim steps,
    each from 0 in the accumulator, the steps added in f32; the partials are
    added in f32 in slice order; each tile's P V is summed from 0 in the
    accumulator and added to O in f32. Keys past N are zeros, their scores
    -inf; columns past D up to a whole slice are zeros, and dropped from O."""
    f32 = lambda x: x.float().double()  # noqa: E731
    n, width = q.shape
    d = width + -width % SLICE
    pad = -n % tile
    q = torch.nn.functional.pad(q.double(), (0, d - width))
    k = torch.nn.functional.pad(k.double(), (0, d - width, 0, pad))
    v = torch.nn.functional.pad(v.double(), (0, d - width, 0, pad))
    c2 = scale * LOG2E
    o = torch.zeros(n, d, dtype=torch.float64)
    m = torch.full((n, 1), -torch.inf, dtype=torch.float64)
    l = torch.zeros(n, 1, dtype=torch.float64)
    for k0 in range(0, n, tile):
        kt, vt = k[k0:k0 + tile], v[k0:k0 + tile]
        zeros = torch.zeros(n, tile, dtype=torch.float64)
        s = None
        for s0 in range(0, d, SLICE):
            part = zeros
            for d0 in range(s0, s0 + SLICE, s_step):
                part = f32(part + _mma3(q[:, d0:d0 + s_step], kt[:, d0:d0 + s_step].T, zeros))
            s = part if s is None else f32(s + part)
        s = f32(s * c2)
        s[:, n - k0:] = -torch.inf  # keys past N take no weight
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        corr = f32(torch.exp2(m - m_new))
        p = f32(torch.exp2(s - m_new))
        l = f32(l * corr + p.sum(dim=1, keepdim=True))
        o = f32(f32(o * corr) + _mma3(p, vt, torch.zeros_like(o)))
        m = m_new
    return (o / l)[:, :width].float()


# N = 40: a full tile and a masked one (8 of 32 keys, or 8 of 16 at D = 1024);
# D = 192 and 1020 with the last slice zero-filled past D
@pytest.mark.parametrize("D,score_gain", [(256, 1), (256, 8), (512, 8), (1024, 1), (192, 1),
                                          (192, 8), (1020, 1)])
def test_wide_kernel_emulation_matches_references(D, score_gain):
    N = 40
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, N, 1, D)).astype(np.float32) for _ in range(3))
    scale = score_gain / np.sqrt(D)
    want_jax = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    want = attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    tq, tk, tv = (torch.from_numpy(a[0, :, 0]) for a in (q, k, v))
    exact = (torch.softmax(tq.double() @ tk.double().T * scale, dim=1) @ tv.double()).numpy()
    got = emulate_wide(tq, tk, tv, scale, wide_tile(D)).numpy()
    tol = 1e-4 * (1 + np.abs(want).max())
    err_jax = np.abs(got - want_jax[0, :, 0]).max()
    err_exact = np.abs(got - exact).max()
    print(f"D={D} N={N} score gain {score_gain}: against JAX {err_jax:.3g}, the port's "
          f"reference {np.abs(got - want[0, :, 0]).max():.3g}, f64 {err_exact:.3g}")
    assert err_jax <= tol
    assert np.abs(got - want[0, :, 0]).max() <= tol
    # the error the kernel is held to on the card at scores of unit scale;
    # scores x8 carry 8x the absolute score error into exp
    assert err_exact <= 2e-6 * score_gain


def test_wide_kernel_sums_s_per_step():
    """Why the wide kernel sums S a 16-wide head-dim step at a time: with an
    accumulator that rounds toward zero, a slice's 128 terms summed in it
    err more than the same terms in steps from 0 added in f32."""
    N, D = 64, 512
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(3))
    scale = 1 / np.sqrt(D)
    exact = torch.softmax((q.double() @ k.double().T) * scale, dim=1) @ v.double()
    err = {step: (emulate_wide(q, k, v, scale, wide_tile(D), s_step=step).double() - exact)
           .abs().max().item() for step in (STEP, SLICE)}
    print(f"N={N} D={D}: max abs err, S in 16-wide steps {err[STEP]:.3g}, a slice in the "
          f"accumulator {err[SLICE]:.3g}")
    assert 2 * err[STEP] < err[SLICE]


# The narrow kernel (attention_tf32x3_narrow_kernel<DP>, D below 128): the
# padded head dim DP and the keys a tile, as NarrowTile in csrc/attention.cu
def narrow_dp(D: int) -> int:
    return 128 if D > 96 else 16 * -(-D // 16)


def narrow_tile(DP: int) -> int:
    return 64 if DP <= 64 else 32


def emulate_narrow(q, k, v, scale: float):
    """(N, D) q, k, v of one (batch, head): the narrow kernel's tile loop at
    its padded head dim DP, columns D ... DP − 1 zeros. S is summed over all
    of DP in the accumulator (rounding toward zero after every MMA); each
    tile's P V from 0 in the accumulator, then added to O in f32; keys past N
    are zeros, their scores -inf; O's columns past D are dropped."""
    f32 = lambda x: x.float().double()  # noqa: E731
    n, d = q.shape
    dp = narrow_dp(d)
    tile = narrow_tile(dp)
    pad = -n % tile
    q = torch.nn.functional.pad(q.double(), (0, dp - d))
    k = torch.nn.functional.pad(k.double(), (0, dp - d, 0, pad))
    v = torch.nn.functional.pad(v.double(), (0, dp - d, 0, pad))
    c2 = scale * LOG2E
    o = torch.zeros(n, dp, dtype=torch.float64)
    m = torch.full((n, 1), -torch.inf, dtype=torch.float64)
    l = torch.zeros(n, 1, dtype=torch.float64)
    for k0 in range(0, n, tile):
        kt, vt = k[k0:k0 + tile], v[k0:k0 + tile]
        s = f32(_mma3(q, kt.T, torch.zeros(n, tile, dtype=torch.float64)) * c2)
        s[:, n - k0:] = -torch.inf  # keys past N take no weight
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        corr = f32(torch.exp2(m - m_new))
        p = f32(torch.exp2(s - m_new))
        l = f32(l * corr + p.sum(dim=1, keepdim=True))
        o = f32(f32(o * corr) + _mma3(p, vt, torch.zeros_like(o)))
        m = m_new
    return (o / l)[:, :d].float()


# D = 12 and 16 at DP = 16, 64 at 64 (64-key tiles), 100 at 128 (32-key
# tiles); N = 40 and 100 leave the last tile part empty at either tile size
@pytest.mark.parametrize("score_gain", [1, 8])
@pytest.mark.parametrize("N", [40, 100])
@pytest.mark.parametrize("D", [12, 16, 64, 100])
def test_narrow_kernel_emulation_matches_references(D, N, score_gain):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, N, 1, D)).astype(np.float32) for _ in range(3))
    scale = score_gain / np.sqrt(D)
    want_jax = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    want = attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    tq, tk, tv = (torch.from_numpy(a[0, :, 0]) for a in (q, k, v))
    exact = (torch.softmax(tq.double() @ tk.double().T * scale, dim=1) @ tv.double()).numpy()
    got = emulate_narrow(tq, tk, tv, scale).numpy()
    tol = 1e-4 * (1 + np.abs(want).max())
    err_jax = np.abs(got - want_jax[0, :, 0]).max()
    err_port = np.abs(got - want[0, :, 0]).max()
    err_exact = np.abs(got - exact).max()
    print(f"D={D} (DP={narrow_dp(D)}) N={N} score gain {score_gain}: against JAX {err_jax:.3g}, "
          f"the port's reference {err_port:.3g}, f64 {err_exact:.3g}")
    assert got.shape == (N, D)
    assert err_jax <= tol
    assert err_port <= tol
    # S's up to 48 chained MMAs (DP = 128) in an accumulator that rounds toward
    # zero err up to about twice the wide kernel's 16-term steps; scores x8
    # carry 8x the absolute score error into exp
    assert err_exact <= 3e-6 * score_gain
