"""The 3xTF32 arithmetic of the f32 attention kernels, emulated in plain PyTorch.

The kernels run only on the card, so their arithmetic is pinned here: each f32
operand x in registers is split into big = x rounded to TF32 (10 mantissa
bits, to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds; the
kernels do it with an integer add and mask) and small = x - big, which the
tensor core reads truncated to TF32. A product accumulates small*big +
big*small + big*big in f32.

The D = 128 kernel and the wide kernel (csrc/attention_wide.cu, tf32 wgmma)
are emulated in their order of sums and their split of the operands, with the
accumulator rounding toward zero after every product: Q and P split in
registers (big = rna(x)), K and V read as their raw tiles (truncated by the
tensor core) beside a plane of remainders x - trunc(x); S a chain from 0 a
32-wide panel of D, the panels added in f32; each key tile's P V a chain from
0, added to O with the rescale; the keys split by the kernel's plan
(`ops.attention.d128_plan`, `wide_plan`) and the splits combined in split
order. Each is held against JAX's Pallas kernel (interpret mode), the port's
plain version and f64, with its plan; a 1xTF32 emulation (big*big only) of
the D = 128 kernel records what the split buys. Below D = 128 the same
kernel runs at the head dim padded to DP = 32 ceil(D / 32) (zero columns past
D) and the key tile of its plan (`ops.attention.narrow_plan`: 16 keys at N <=
16, 32 up to N = 128), emulated the same way.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.ops.attention import _pallas_forward as jax_pallas_attention
from diffsplitting_tpu.ops.attention import attention_reference as jax_attention
from diffsplitting_tpu_torch.ops import attention as A
from diffsplitting_tpu_torch.ops import attention_reference

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The emulations run many small f64 products: with torch's one thread a
    core in each of a suite's worker processes they wait on descheduled
    threads; one thread a worker keeps them fast. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The kernels' rounding: (bits + 0x1000) & 0xffffe000 on the f32 bits."""
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
    """a @ b from TF32 operands split in registers, f32 sums: 3 terms
    (3xTF32) or 1 (1xTF32). tests/test_torch_port_conv_gn_split.py uses it."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if terms == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


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


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values to the f32 next toward zero (as f64): what the tensor
    core's accumulator keeps of a sum."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


# The f32 wgmma kernels (csrc/attention_wide.cu: the D = 128 kernel and the
# wide kernel above 128): an operand in registers (Q, P) split as big =
# rna(x), small = x - big; an operand in shared memory (K, V) read as its raw
# tile (the tensor core reads it truncated) beside a plane of remainders x -
# trunc(x); S a chain from 0 over each 32-wide panel of D (4 k8 steps of
# three products), the panels added in f32; a tile's P V a chain from 0 over
# its keys, added to O with the rescale in one rounding; the keys split by
# the kernel's plan and the splits combined in split order with fused
# multiply-adds
PANEL = 32  # head dims of S a chain


def split_trunc(x):
    """A shared-memory operand as the tensor core reads it: its truncation
    and the truncation of its remainder x - trunc(x)."""
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def _chain(a, b, acc=None, chain=8, terms=3):
    """a (rows, K) registers, b (K, cols) shared memory, f64 tensors of f32
    values: acc + a @ b in k8 steps of three products (small·big, big·small,
    big·big, each exact; big·big alone at terms 1), the accumulator rounded
    toward zero after each; a chain from 0 (acc None) every `chain` head dims
    or keys, the chains added in f32."""
    total = None
    for c0 in range(0, a.shape[1], chain):
        run = acc
        for k0 in range(c0, min(c0 + chain, a.shape[1]), 8):
            ab, as_ = split(a[:, k0:k0 + 8].float())
            bb, bs = split_trunc(b[k0:k0 + 8].float())
            for x, y in ((as_, bb), (ab, bs), (ab, bb))[3 - terms:]:
                step = x.double() @ y.double()
                run = _round_toward_zero(step if run is None else run + step)
        total = run if total is None else (total + run).float().double()
    return total


def _emulate_wgmma(q, k, v, scale: float, tk: int, splits: int, tiles_per_split: int,
                   s_chain: int = PANEL, o_in_acc: bool = False, terms: int = 3,
                   dp: int = None):
    """(N, D) q, k, v of one (batch, head): a wgmma kernel's result (f32
    values as f64) and each split's running max, at key tiles of `tk`,
    `splits` splits of `tiles_per_split` tiles. `s_chain` head dims of S a
    chain from 0 (the kernels: a panel); `o_in_acc` carries O in the
    accumulator across a split's key tiles, rescaled there, where the
    kernels start each tile's P V from 0 and add it to O in f32; `terms` 1
    takes big·big alone (1xTF32); `dp` the padded head dim (the wide
    kernel's: an even count of panels), zero past D."""
    f32 = lambda x: x.float().double()  # noqa: E731
    n, width = q.shape
    d = dp or -(-width // (2 * PANEL)) * 2 * PANEL
    keys = -(-n // tk) * tk
    zq = torch.nn.functional.pad(q.double(), (0, d - width))
    zk = torch.nn.functional.pad(k.double(), (0, d - width, 0, keys - n))
    zv = torch.nn.functional.pad(v.double(), (0, d - width, 0, keys - n))
    # S of every key at once: a key's S is summed alike in any tile or split
    scores = _chain(zq, zk.T, chain=s_chain, terms=terms)
    c2 = f32(torch.tensor(np.float32(scale) * np.float32(LOG2E), dtype=torch.float64))
    parts = []
    for sp in range(splits):
        m = torch.full((n, 1), -torch.inf, dtype=torch.float64)
        l = torch.zeros(n, 1, dtype=torch.float64)
        o = torch.zeros(n, d, dtype=torch.float64)
        first = sp * tiles_per_split
        for t in range(first, min(first + tiles_per_split, keys // tk)):
            s = f32(scores[:, t * tk:(t + 1) * tk] * c2)
            s[:, max(0, n - t * tk):] = -torch.inf  # keys past N
            m_new = torch.maximum(m, s.max(1, keepdim=True).values)
            corr = f32(torch.exp2(m - m_new))
            p = f32(torch.exp2(s - m_new))
            l = f32(l * corr + p.sum(1, keepdim=True))
            vt = zv[t * tk:(t + 1) * tk]
            if o_in_acc:
                o = _chain(p, vt, acc=f32(o * corr), chain=tk, terms=terms)
            else:
                o = f32(o * corr + _chain(p, vt, chain=tk, terms=terms))
            m = m_new
        parts.append((m, l, o[:, :width]))
    if splits == 1:
        m, l, o = parts[0]
        return f32(o * f32(1 / l)).float(), [m]
    m_max = torch.stack([m for m, _, _ in parts]).max(0).values
    big_l = torch.zeros_like(m_max)
    acc = torch.zeros(n, width, dtype=torch.float64)
    for m, l, o in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m), f32(torch.exp2(m - m_max)))
        big_l = f32(w * l + big_l)  # one rounding: a fused multiply-add
        acc = f32(w * o + acc)
    return f32(acc * f32(1 / big_l)).float(), [m for m, _, _ in parts]


def emulate_d128(q, k, v, scale: float, splits: int = None, s_chain: int = PANEL,
                 o_in_acc: bool = False, terms: int = 3):
    """(N, 128) q, k, v of one (batch, head): the D = 128 kernel's result
    and each split's running max, by `d128_plan` at B·heads 1 on 132 SMs
    (`splits` forced as there). Its Q planes in shared memory hold big =
    rna(x) and small = x - big, the split of an operand in registers."""
    how = A.d128_plan(1, q.shape[0], 132, splits)
    return _emulate_wgmma(q, k, v, scale, A.D128_KEY_TILE, how.splits, how.tiles_per_split,
                          s_chain, o_in_acc, terms)


def emulate_narrow(q, k, v, scale: float, splits: int = None, key_tile: int = None,
                   groups: int = None):
    """(N, D) q, k, v of one (batch, head), D below 128: the kernel's result
    and each split's running max at D padded to DP = 32 ceil(D / 32), by
    `narrow_plan` at B·heads 1 on 132 SMs (`splits`, `key_tile`, `groups`
    forced as there; the warpgroups change no sum)."""
    n, d = q.shape
    how = A.narrow_plan(1, n, 132, splits, key_tile, groups)
    return _emulate_wgmma(q, k, v, scale, how.key_tile, how.splits, how.tiles_per_split,
                          dp=-(-d // PANEL) * PANEL)


def emulate_wide(q, k, v, scale: float, splits: int = None, slices: int = None,
                 key_tile: int = None, s_chain: int = PANEL, o_in_acc: bool = False):
    """(N, D) q, k, v of one (batch, head): the wide kernel's result and each
    split's running max, by `wide_plan` at B·heads 1 on 132 SMs (slices of O
    recompute the same S and do not change the sums)."""
    how = A.wide_plan(1, q.shape[0], q.shape[1], 132, splits, slices, key_tile)
    return _emulate_wgmma(q, k, v, scale, how.key_tile, how.splits, how.tiles_per_split,
                          s_chain, o_in_acc)


@functools.lru_cache(maxsize=None)
def _wide_case(N: int, D: int, gain: float):
    """Seeded q, k, v (1, N, 1, D), JAX's Pallas kernel (interpret mode),
    the port's plain version and f64 on them."""
    rng = np.random.default_rng(N * 13 + D)
    q, k, v = (rng.normal(size=(1, N, 1, D)).astype(np.float32) for _ in range(3))
    scale = gain / np.sqrt(D)
    pallas = np.asarray(jax_pallas_attention(*(jnp.asarray(a) for a in (q, k, v)), scale,
                                             interpret=True))[0, :, 0]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = attention_reference(tq, tk, tv, scale).numpy()[0, :, 0]
    t3 = [t[0, :, 0] for t in (tq, tk, tv)]
    exact = (torch.softmax(t3[0].double() @ t3[1].double().T * scale, dim=1)
             @ t3[2].double()).numpy()
    return t3, scale, pallas, plain, exact


def _d128_errors(N: int, score_gain: float):
    """Max abs errors of the D = 128 kernel's emulation at its plan against
    JAX's Pallas kernel, the port's plain version and f64, of its 1xTF32
    emulation against f64, the tolerance and the plan's split count."""
    (tq, tk, tv), scale, pallas, plain, exact = _wide_case(N, 128, score_gain)
    got3, ms = emulate_d128(tq, tk, tv, scale)
    got1, _ = emulate_d128(tq, tk, tv, scale, terms=1)
    got3, got1 = got3.double().numpy(), got1.double().numpy()
    assert got3.shape == (N, 128) and np.isfinite(got3).all()
    err = dict(jax=np.abs(got3 - pallas).max(), port=np.abs(got3 - plain).max(),
               f64=np.abs(got3 - exact).max(), one=np.abs(got1 - exact).max())
    tol = 1e-4 * (1 + np.abs(plain).max())
    print(f"D=128 N={N} splits {len(ms)} score gain {score_gain}: 3xTF32 against JAX's Pallas "
          f"kernel {err['jax']:.3g}, the port's reference {err['port']:.3g}, f64 {err['f64']:.3g}; "
          f"1xTF32 against f64 {err['one']:.3g}; tolerance {tol:.3g}")
    return err, tol, len(ms)


# N = 256 at the plan: 4 splits of one 64-key tile each, combined in order
@pytest.mark.parametrize("score_gain", [1, 8])
def test_3xtf32_emulation_matches_references(score_gain):
    err, tol, splits = _d128_errors(256, score_gain)
    assert splits == 4
    assert err["jax"] <= tol
    assert err["port"] <= tol
    # the card's bound at unit-scale scores; scores x8 carry 8x the score error
    assert err["f64"] <= 2e-6 * score_gain
    assert err["f64"] * 10 < err["one"]  # the split buys f32 accuracy back


# N = 100 at the plan: two splits of a 64-key tile, the last of 36 keys and
# 28 zero-filled slots
@pytest.mark.parametrize("score_gain", [1, 8])
def test_3xtf32_emulation_masks_the_last_tile(score_gain):
    err, tol, splits = _d128_errors(100, score_gain)
    assert splits == 2
    assert err["jax"] <= tol
    assert err["port"] <= tol
    assert err["f64"] <= 2e-6 * score_gain
    assert err["f64"] * 10 < err["one"]


def test_truncating_accumulator_error_comes_from_the_sum_over_keys():
    """Why the D = 128 kernel starts each key tile's P V from 0 and adds it
    to O in f32: with an accumulator that rounds toward zero, carrying O in
    it over all of a split's keys (one split of 8 tiles here) costs more
    than summing S over all of D in one chain, and the kernel's order (S a
    chain a 32-wide panel, O per tile) leaves well under half of the error
    of O in the accumulator, with S in one chain or not."""
    N, D = 512, 128
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(3))
    scale = 1 / np.sqrt(D)
    exact = torch.softmax((q.double() @ k.double().T) * scale, dim=1) @ v.double()
    err = {}
    for s_one_chain in (True, False):
        for o_acc in (True, False):
            got, _ = emulate_d128(q, k, v, scale, splits=1, s_chain=D if s_one_chain else PANEL,
                                  o_in_acc=o_acc)
            err[s_one_chain, o_acc] = (got.double() - exact).abs().max().item()
    print(f"N={N}: max abs err, S in one chain and O in the accumulator {err[True, True]:.3g}, "
          f"O only {err[False, True]:.3g}, S only {err[True, False]:.3g}, neither (the kernel) "
          f"{err[False, False]:.3g}")
    assert err[False, True] > 2 * err[False, False]
    assert err[False, True] > err[True, False]
    assert err[True, True] > 2 * err[True, False]


def test_d128_kernel_split_with_no_key_adds_nothing():
    """Three splits of N = 256 (four 64-key tiles, two a split) leave the
    last with no key: its m stays -inf, the combine gives it weight 0, and
    the result equals the two-split one bit for bit."""
    (tq, tk, tv), scale, _, _, _ = _wide_case(256, 128, 1)
    assert A.d128_plan(1, 256, 132, 3).tiles_per_split == 2
    three, ms = emulate_d128(tq, tk, tv, scale, 3)
    two, _ = emulate_d128(tq, tk, tv, scale, 2)
    assert torch.isinf(ms[2]).all() and (ms[2] < 0).all()
    assert torch.isfinite(three).all()
    assert torch.equal(three, two)


# the D = 128 kernel's plan: the Hagen mid block (N = 4096) at batch 1, 4 and
# 8 (and 2), splitting_cifar10_indi's (N = 16), a masked N, one token


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("BH,N", [(1, 4096), (4, 4096), (8, 4096), (8, 16), (8, 100), (2, 4096),
                                  (1, 1), (3, 257)])
def test_d128_plan_walks_every_key_tile_once(sms, BH, N):
    """64-key tiles, 128 queries a block; every key tile in exactly one
    split, none empty; more than one split only where the grid stays within
    one block an SM, and as many as keep it there."""
    how = A.d128_plan(BH, N, sms)
    assert A.D128_KEY_TILE == 64
    assert how.query_tiles == -(-N // A.D128_ROWS)
    tiles = -(-N // A.D128_KEY_TILE)
    walked = [t for s in range(how.splits)
              for t in range(s * how.tiles_per_split, min((s + 1) * how.tiles_per_split, tiles))]
    assert walked == list(range(tiles))
    assert (how.splits - 1) * how.tiles_per_split < tiles  # the last split holds a key
    if how.splits > 1:
        assert how.blocks * BH <= sms
    # the most splits that fit the card, down to a count that leaves none empty
    fit = min(tiles, max(1, sms // (how.query_tiles * BH)))
    assert how.splits == -(-tiles // -(-tiles // fit))


def test_d128_plan_at_the_served_shapes():
    """On 132 SMs the Hagen mid block at batch 1 takes 4 key splits (128
    blocks, the kernel it replaced had 32), at 2 two, at 4 and 8 one (128 and
    256 blocks); N = 16 one block a (batch, head)."""
    assert A.d128_plan(1, 4096, 132) == A.D128Plan(4, 16, 32)
    assert A.d128_plan(2, 4096, 132) == A.D128Plan(2, 32, 32)
    assert A.d128_plan(4, 4096, 132) == A.D128Plan(1, 64, 32)
    assert A.d128_plan(8, 4096, 132) == A.D128Plan(1, 64, 32)
    assert A.d128_plan(8, 16, 132) == A.D128Plan(1, 1, 1)
    assert A.d128_plan(1, 4096, 114).splits == 3  # 22, 22 and 20 tiles


def test_d128_plan_forced_counts():
    """A forced count may leave the last split with no key, or split more
    than the card holds at once; counts of 0 or more than one split a key
    tile are refused."""
    how = A.d128_plan(1, 256, 132, splits=3)
    assert (how.splits, how.tiles_per_split) == (3, 2)
    assert (how.splits - 1) * how.tiles_per_split >= 4  # the last split: no key
    assert A.d128_plan(1, 4096, 132, splits=8) == A.D128Plan(8, 8, 32)
    for bad in (dict(splits=0), dict(splits=5)):
        with pytest.raises(ValueError, match="splits"):
            A.d128_plan(1, 256, 132, **bad)


# (N, D, forced (splits, slices, key tile) or None for the plan, score gain):
# D = 192 and 1020 with a panel and a chunk past D zero-filled; N = 40 ends in
# a tile of 8 of 32 keys, N = 100 in one of 4 of 32 or 36 of 64; forced splits
# at N = 100 (4 tiles of 32: 3 splits of 2) leave the last split with no key;
# one split of two 64-key tiles carries O across them; N = 16 takes one
# 16-key tile, and N = 40 three forced ones (the last of 8 keys)
WIDE_EMULATION_CASES = [
    (40, 192, None, 1), (100, 192, (3, 1, 32), 8), (40, 256, None, 8), (100, 256, None, 1),
    (40, 512, None, 1), (100, 512, (3, 2, 32), 1), (40, 1020, None, 8), (100, 1020, (2, 3, 32), 1),
    (40, 1024, None, 1), (100, 1024, (1, 2, 64), 8), (16, 256, None, 8), (40, 512, (3, 2, 16), 1),
]


@pytest.mark.parametrize("N,D,forced,score_gain", WIDE_EMULATION_CASES,
                         ids=[f"N{c[0]}-D{c[1]}-{'plan' if c[2] is None else 'forced'}-gain{c[3]}"
                              for c in WIDE_EMULATION_CASES])
def test_wide_kernel_emulation_matches_references(N, D, forced, score_gain):
    (tq, tk, tv), scale, pallas, plain, exact = _wide_case(N, D, score_gain)
    got, ms = emulate_wide(tq, tk, tv, scale, *(forced or ()))
    got = got.double().numpy()
    tol = 1e-4 * (1 + np.abs(plain).max())
    err_jax, err_port = np.abs(got - pallas).max(), np.abs(got - plain).max()
    err_exact = np.abs(got - exact).max()
    print(f"D={D} N={N} splits {len(ms)} score gain {score_gain}: against JAX's Pallas kernel "
          f"{err_jax:.3g}, the port's reference {err_port:.3g}, f64 {err_exact:.3g} (the plain "
          f"version {np.abs(plain - exact).max():.3g})")
    assert got.shape == (N, D) and np.isfinite(got).all()
    assert err_jax <= tol
    assert err_port <= tol
    # the error the kernel is held to on the card at scores of unit scale;
    # scores x8 carry 8x the absolute score error into exp
    assert err_exact <= 2e-6 * score_gain


def test_wide_kernel_split_with_no_key_adds_nothing():
    """Three splits of N = 100 at 32-key tiles (two tiles each) leave the
    last with no key: its m stays -inf, the combine gives it weight 0, and
    the result equals the two-split one bit for bit."""
    (tq, tk, tv), scale, _, _, _ = _wide_case(100, 256, 1)
    assert A.wide_plan(1, 100, 256, 132, 3, key_tile=32).tiles_per_split == 2
    three, ms = emulate_wide(tq, tk, tv, scale, 3, key_tile=32)
    two, _ = emulate_wide(tq, tk, tv, scale, 2, key_tile=32)
    assert torch.isinf(ms[2]).all() and (ms[2] < 0).all()
    assert torch.isfinite(three).all()
    assert torch.equal(three, two)


def test_wide_kernel_chains_start_from_zero():
    """Why the wide kernel starts a chain of wgmma from 0 every 32-wide panel
    of S and every key tile of P V: with an accumulator that rounds toward
    zero, S over all of D in one chain, or O carried in the accumulator over
    all of a split's key tiles, err more against f64 than the kernel's chains
    added in f32."""
    N, D = 256, 512
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(3))
    scale = 1 / np.sqrt(D)
    exact = torch.softmax((q.double() @ k.double().T) * scale, dim=1) @ v.double()
    err = {}
    for name, s_chain, o_in_acc in (("kernel", PANEL, False), ("S in one chain", D, False),
                                    ("O in the accumulator", PANEL, True)):
        got, _ = emulate_wide(q, k, v, scale, 1, 1, 64, s_chain, o_in_acc)
        err[name] = (got.double() - exact).abs().max().item()
    print(f"N={N} D={D}, one split: max abs err against f64, " +
          ", ".join(f"{k} {e:.3g}" for k, e in err.items()))
    assert 2 * err["kernel"] < err["S in one chain"]
    assert err["kernel"] < err["O in the accumulator"]


# the plan


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("BH,N,D", [(1, 256, 512), (1, 64, 512), (4, 256, 512), (12, 16, 256),
                                    (8, 100, 256), (8, 1024, 256), (2, 1024, 1024),
                                    (8, 4096, 192), (1, 1, 132), (3, 257, 1020), (2, 1023, 896)])
def test_wide_plan_walks_every_key_tile_and_chunk_once(sms, BH, N, D):
    """Every key tile in exactly one split and every 64-wide chunk of O in
    exactly one slice, none empty, at most 8 chunks a slice; more than one
    split or more slices than O needs only where the grid stays within one
    block an SM; the key tile by N and the 64-key plan's blocks."""
    how = A.wide_plan(BH, N, D, sms)
    tiles, chunks = -(-N // how.key_tile), -(-D // A.WIDE_CHUNK)
    least = -(-chunks // A.WIDE_MAX_CHUNKS)
    # 64-key tiles where one a split gives a quarter of the SMs blocks
    long_blocks = how.query_tiles * BH * -(-N // 64) * least
    assert how.key_tile == (16 if N <= 16 else 64 if long_blocks >= sms // 4 else 32)
    assert how.splits * how.tiles_per_split >= tiles > (how.splits - 1) * how.tiles_per_split
    assert how.slices * how.chunks_per_slice >= chunks > (how.slices - 1) * how.chunks_per_slice
    assert how.chunks_per_slice <= A.WIDE_MAX_CHUNKS
    if how.splits > 1 or how.slices > least:
        assert how.blocks * BH <= sms


def test_wide_plan_at_the_served_shapes():
    """On 132 SMs, at least four times the blocks of the kernel it replaced
    (one a 64-, 32- or 16-query row group by B·heads: 16, 4, 16 and 12) at
    sr_sr3_16_128's serving shapes (N = 256 and 64 at D = 512, batch 1),
    B = 8, N = 100, D = 256 and sample_ddpm_128's mid block; one split where
    the query tiles fill the card."""
    assert A.wide_plan(1, 256, 512, 132) == A.WidePlan(32, 8, 1, 4, 2, 4)  # 128 blocks
    assert A.wide_plan(1, 64, 512, 132) == A.WidePlan(32, 2, 1, 8, 1, 1)  # 16
    assert A.wide_plan(8, 100, 256, 132).blocks * 8 == 128
    assert A.wide_plan(12, 16, 256, 132).blocks * 12 == 48
    assert A.wide_plan(8, 4096, 192, 132) == A.WidePlan(64, 1, 64, 1, 3, 64)


def test_wide_plan_forced_counts():
    """A forced count may leave the last split with no key; counts of 0,
    more than one split a key tile, fewer slices than O needs or more than
    one a chunk, and other key tiles are refused."""
    how = A.wide_plan(1, 256, 512, 132, splits=3, slices=2, key_tile=64)
    assert (how.splits, how.tiles_per_split, how.slices, how.chunks_per_slice) == (3, 2, 2, 4)
    assert (how.splits - 1) * how.tiles_per_split >= 4  # the last split: no key
    for bad in (dict(splits=0), dict(splits=9), dict(slices=0), dict(slices=9),
                dict(splits=5, key_tile=64)):
        with pytest.raises(ValueError, match="splits|slices"):
            A.wide_plan(1, 256, 512, 132, **bad)
    with pytest.raises(ValueError, match="slices"):
        A.wide_plan(1, 256, 1024, 132, slices=1)
    with pytest.raises(ValueError, match="key tiles"):
        A.wide_plan(1, 256, 512, 132, key_tile=8)


# Below D = 128: D = 4, 12, 16, 20 (DP = 32, up to 28 zero columns), 64, 100
# and 124 (DP = 128) at N = 16 (one 16-key tile), 40 (two 32-key tiles, the
# last of 8 keys, one split each) and 100 (four 32-key tiles in four splits,
# the last of 4 keys); scores x1 and x8
NARROW_EMULATION_CASES = [(d, n, gain) for d in (4, 12, 16, 20, 64, 100, 124)
                          for n in (16, 40, 100) for gain in (1, 8)]


@functools.lru_cache(maxsize=None)
def _jax_reference(N: int, D: int, gain: float):
    """JAX's attention_reference on _wide_case's inputs."""
    rng = np.random.default_rng(N * 13 + D)
    q, k, v = (rng.normal(size=(1, N, 1, D)).astype(np.float32) for _ in range(3))
    return np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    gain / np.sqrt(D)))[0, :, 0]


@pytest.mark.parametrize("D,N,score_gain", NARROW_EMULATION_CASES,
                         ids=[f"D{d}-N{n}-gain{g}" for d, n, g in NARROW_EMULATION_CASES])
def test_narrow_kernel_emulation_matches_references(D, N, score_gain):
    (tq, tk, tv), scale, pallas, plain, exact = _wide_case(N, D, score_gain)
    got, ms = emulate_narrow(tq, tk, tv, scale)
    got = got.double().numpy()
    tol = 1e-4 * (1 + np.abs(plain).max())
    err = dict(jax=np.abs(got - _jax_reference(N, D, score_gain)).max(),
               pallas=np.abs(got - pallas).max(), port=np.abs(got - plain).max(),
               f64=np.abs(got - exact).max())
    how = A.narrow_plan(1, N, 132)
    print(f"D={D} (DP={-(-D // PANEL) * PANEL}) N={N} key tile {how.key_tile}, splits {len(ms)}, "
          f"score gain {score_gain}: against JAX's reference {err['jax']:.3g}, its Pallas kernel "
          f"{err['pallas']:.3g}, the port's reference {err['port']:.3g}, f64 {err['f64']:.3g} "
          f"(the plain version {np.abs(plain - exact).max():.3g})")
    assert got.shape == (N, D) and np.isfinite(got).all()
    assert err["jax"] <= tol
    assert err["pallas"] <= tol
    assert err["port"] <= tol
    # the chip check's bound at scores of unit scale; scores x8 carry 8x the
    # absolute score error into exp
    assert err["f64"] <= 2e-6 * score_gain


def test_narrow_kernel_split_with_no_key_adds_nothing():
    """Six splits of N = 100 at 16-key tiles (7 tiles, two a split) leave
    the last two with no key: their m stays -inf, the combine gives them
    weight 0, and the result equals the four-split one bit for bit."""
    (tq, tk, tv), scale, _, _, _ = _wide_case(100, 20, 1)
    assert A.narrow_plan(1, 100, 132, 6, 16, 1).tiles_per_split == 2
    assert A.narrow_plan(1, 100, 132, 4, 16, 1).tiles_per_split == 2
    six, ms = emulate_narrow(tq, tk, tv, scale, 6, 16, 1)
    four, _ = emulate_narrow(tq, tk, tv, scale, 4, 16, 1)
    assert all(torch.isinf(m).all() and (m < 0).all() for m in ms[4:])
    assert torch.isfinite(six).all()
    assert torch.equal(six, four)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("BH,N", [(8, 16), (8, 100), (8, 1024), (8, 4096), (1, 1), (3, 17),
                                  (16, 128), (2, 129), (1, 4095), (40, 64)])
def test_narrow_plan_walks_every_key_tile_once(sms, BH, N):
    """16-key tiles and one warpgroup up to N = 16, 32-key tiles and one
    warpgroup up to 128, 64-key tiles and two above; every key tile in
    exactly one split, none empty; more than one split only where the grid
    stays within one block an SM, and as many as keep it there."""
    how = A.narrow_plan(BH, N, sms)
    assert (how.key_tile, how.groups) == ((16, 1) if N <= 16 else (32, 1) if N <= 128
                                          else (64, 2))
    assert (how.key_tile, how.groups) in A.NARROW_TILINGS
    assert how.query_tiles == -(-N // (A.NARROW_ROWS * how.groups))
    tiles = -(-N // how.key_tile)
    walked = [t for s in range(how.splits)
              for t in range(s * how.tiles_per_split, min((s + 1) * how.tiles_per_split, tiles))]
    assert walked == list(range(tiles))
    assert (how.splits - 1) * how.tiles_per_split < tiles  # the last split holds a key
    if how.splits > 1:
        assert how.blocks * BH <= sms
    fit = min(tiles, max(1, sms // (how.query_tiles * BH)))
    assert how.splits == -(-tiles // -(-tiles // fit))


def test_narrow_plan_at_the_served_shapes():
    """On 132 SMs: the inner-8 path's mid block (B = 8, N = 16) one block a
    (batch, head); kernels/attention_variants.py's NARROW_SHAPES: N = 100 four
    splits of one 32-key tile (64 blocks, the mma.sync kernel had 16), N =
    1024 two splits of 8 64-key tiles (128 blocks), N = 4096 one split (256
    blocks, two waves)."""
    assert A.narrow_plan(8, 16, 132) == A.NarrowPlan(16, 1, 1, 1, 1)
    assert A.narrow_plan(8, 100, 132) == A.NarrowPlan(32, 1, 4, 1, 2)
    assert A.narrow_plan(8, 1024, 132) == A.NarrowPlan(64, 2, 2, 8, 8)
    assert A.narrow_plan(8, 4096, 132) == A.NarrowPlan(64, 2, 1, 64, 32)
    assert A.narrow_plan(8, 1024, 132).blocks * 8 == 128


def test_narrow_plan_forced_counts():
    """Forced tilings and counts, one that leaves the last split with no
    key; counts of 0 or more than one split a key tile, and tilings the
    kernel has no form for, are refused."""
    how = A.narrow_plan(1, 256, 132, splits=3, key_tile=64, groups=2)
    assert (how.splits, how.tiles_per_split, how.query_tiles) == (3, 2, 2)
    assert (how.splits - 1) * how.tiles_per_split >= 4  # the last split: no key
    assert A.narrow_plan(8, 100, 132, key_tile=16, groups=1) == A.NarrowPlan(16, 1, 7, 1, 2)
    for bad in (dict(splits=0), dict(splits=5, key_tile=64, groups=2)):
        with pytest.raises(ValueError, match="splits"):
            A.narrow_plan(1, 256, 132, **bad)
    for bad in (dict(key_tile=8), dict(groups=4)):
        with pytest.raises(ValueError, match="key tiles"):
            A.narrow_plan(1, 256, 132, **bad)
