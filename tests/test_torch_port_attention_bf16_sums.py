"""How csrc/attention_bf16.cu sums, emulated in f64 on the CPU.

The kernels run only on the card, so their order of sums is pinned here, in
plain PyTorch, walking the keys in their key splits (`ops.attention.plan`)
and their softmax groups (a 64-key tile up to D = 256; two tiles, 128 keys,
in the wide kernel above), with their arithmetic:
  * bf16 products, exact, added into an f32 accumulator that rounds toward
    zero after each k16 tensor-core step (the model of
    tests/test_torch_port_conv_gn_bf16_sums.py);
  * S summed over all of D's k16 steps (its panels of 64 head dims in
    order, those past D zero) in the accumulator;
  * scores times scale·log2(e) in f32, keys past N at -inf, the online
    softmax in f32 in the exp2 domain across groups; P rounded to bf16 to
    nearest even; O rescaled in f32 (the wide kernel reloads it from its
    scratch for that), then P·V added in the accumulator a k16 step at a
    time;
  * each split's (m, l, O) combined in split order with f32 fused
    multiply-adds, weight 0 for a split with no key; the result O·(1/l)
    rounded to bf16.
The emulation is held against JAX's Pallas kernel (`_pallas_forward(...,
interpret=True)`) within the bf16 tolerance of tests/test_torch_port_bf16.py
(2·2^-7·max|ref|), and against an f32 reference from the same bf16 inputs
with chip_smoke.py's bound: at most 2x the error of the port's plain bf16
version (`attention_reference` at bf16). Head dims 64, 128 and 1024 (the
wide kernel), several split counts (at D = 1024 splits of one group, of
one tile and of several groups), and N whose last split holds no key; and
the plan.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.ops.attention import _pallas_forward as jax_pallas_attention
from diffsplitting_tpu_torch.ops import attention as A

LOG2E = 1.4426950408889634
BF16_STEP = 2.0 ** -7
K16 = 16  # head dims or keys a tensor-core step


def _rtz(x: torch.Tensor) -> torch.Tensor:
    """f64 values to the f32 next toward zero (as f64): what the tensor
    core's accumulator keeps of a sum."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def _mma(acc, a, b):
    """acc + a @ b in k16 steps, the accumulator rounded toward zero after
    each (acc None: the first step starts from 0)."""
    for k0 in range(0, a.shape[1], K16):
        step = a[:, k0:k0 + K16] @ b[k0:k0 + K16]
        acc = _rtz(step if acc is None else acc + step)
    return acc


def emulate(q, k, v, scale: float, splits: int):
    """(N, D) bf16 q, k, v of one (batch, head), as f64 tensors of bf16
    values: the kernel's result (bf16 values as f64) and each split's m."""
    n, d = q.shape
    how = A.plan(1, n, d, 132, splits)
    pad = -d % A.BF16_PANEL
    tk = A.BF16_TILE_KEYS
    group = A.BF16_WIDE_GROUP if how.wide else 1  # key tiles a softmax step
    keys = -(-n // tk) * tk
    zq = torch.cat([q, torch.zeros(n, pad, dtype=q.dtype)], 1)
    zk = torch.zeros(keys, d + pad, dtype=q.dtype)
    zk[:n, :d] = k
    zv = torch.zeros(keys, d + pad, dtype=q.dtype)
    zv[:n, :d] = v
    c2 = _f32(torch.tensor(np.float32(scale) * np.float32(LOG2E), dtype=torch.float64))
    parts = []
    for s in range(how.splits):
        m = torch.full((n, 1), -torch.inf, dtype=torch.float64)
        l = torch.zeros(n, 1, dtype=torch.float64)
        o = torch.zeros(n, d + pad, dtype=torch.float64)
        first = s * how.tiles_per_split
        end = min((s + 1) * how.tiles_per_split, keys // tk)
        for t in range(first, end, group):
            t_end = min(t + group, end)
            kt, vt = zk[t * tk:t_end * tk], zv[t * tk:t_end * tk]
            sc = _f32(_mma(None, zq, kt.T) * c2)
            sc[:, max(0, n - t * tk):] = -torch.inf
            m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
            corr = _f32(torch.exp2(m - m_new))
            p = _f32(torch.exp2(sc - m_new))
            l = _f32(l * corr + p.sum(1, keepdim=True))
            o = _mma(_f32(o * corr), p.bfloat16().double(), vt)
            m = m_new
        parts.append((m, l, o[:, :d]))
    if how.splits == 1:
        m, l, o = parts[0]
        return _f32(o * _f32(1 / l)).bfloat16().double(), [m]
    m_max = torch.stack([m for m, _, _ in parts]).max(0).values
    big_l = torch.zeros_like(m_max)
    acc = torch.zeros(n, d, dtype=torch.float64)
    for m, l, o in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m), _f32(torch.exp2(m - m_max)))
        big_l = _f32(w * l + big_l)  # one rounding: a fused multiply-add
        acc = _f32(w * o + acc)
    return _f32(acc * _f32(1 / big_l)).bfloat16().double(), [m for m, _, _ in parts]


@functools.lru_cache(maxsize=None)
def _case(N: int, D: int, gain: float):
    """Seeded bf16 q, k, v (1, N, 1, D) as numpy f32, JAX's Pallas kernel
    and the two references on them."""
    rng = np.random.default_rng(N * 7 + D)
    q, k, v = (rng.standard_normal((1, N, 1, D)).astype(np.float32) for _ in range(3))
    tq = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    scale = gain / np.sqrt(D)
    jq = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tq]
    pallas = np.asarray(jax_pallas_attention(*jq, scale, interpret=True)).astype(np.float64)
    exact = A.attention_reference(*[t.float() for t in tq], scale).double()
    plain = A.attention_reference(*tq, scale).double()
    return tq, scale, pallas[0, :, 0], exact[0, :, 0], plain[0, :, 0]


# (N, D, split counts, score gain): N = 256 has 4 key tiles (3 splits of 2
# leave the last split empty), N = 200 ends in a tile of 8 keys, N = 130 in
# one of 2 (2 splits of 2 tiles and 1)
CASES = [(256, 64, (1, 3, 4), 1.0), (200, 128, (1, 2, 3), 8.0), (256, 1024, (1, 2, 3), 1.0),
         (130, 1024, (2,), 8.0), (256, 128, (4,), 8.0)]


@pytest.mark.parametrize("N,D,splits,gain", CASES,
                         ids=[f"N{c[0]}-D{c[1]}-gain{c[3]:g}" for c in CASES])
def test_emulated_sums_match_pallas_and_the_references(N, D, splits, gain):
    tq, scale, pallas, exact, plain = _case(N, D, gain)
    q, k, v = (t[0, :, 0].double() for t in tq)
    plain_err = (plain - exact).abs().max().item()
    for sp in splits:
        got, ms = emulate(q, k, v, scale, sp)
        assert torch.isfinite(got).all()
        err = (got - exact).abs().max().item()
        err_jax = np.abs(got.numpy() - pallas).max()
        print(f"N={N} D={D} gain {gain:g} splits {sp}: err against f32 {err:.3g} (plain bf16 "
              f"{plain_err:.3g}), against JAX's Pallas kernel {err_jax:.3g}")
        assert err <= 2 * plain_err
        assert err_jax <= 2 * BF16_STEP * np.abs(pallas).max()


def test_a_split_with_no_key_adds_nothing():
    """Three splits of N = 256 (two key tiles each) leave the last with no
    key: its m stays -inf, the combine gives it weight 0, and the result
    equals the two-split one bit for bit."""
    tq, scale, _, _, _ = _case(256, 64, 1.0)
    q, k, v = (t[0, :, 0].double() for t in tq)
    assert A.plan(1, 256, 64, 132, 3).tiles_per_split == 2
    three, ms = emulate(q, k, v, scale, 3)
    two, _ = emulate(q, k, v, scale, 2)
    assert torch.isinf(ms[2]).all() and (ms[2] < 0).all()
    assert torch.isfinite(three).all()
    assert torch.equal(three, two)


def test_the_wide_kernel_carries_o_across_groups():
    """At D = 1024 one split of four key tiles takes two softmax groups,
    the first group's O rescaled and carried (through the wide kernel's
    scratch) into the second; it lands within a bf16 step of two splits of
    one group each, and within the card's bound."""
    how = A.plan(1, 256, 1024, 132, splits=1)
    assert how.wide and how.tiles_per_split == 2 * A.BF16_WIDE_GROUP
    tq, scale, _, exact, plain = _case(256, 1024, 1.0)
    q, k, v = (t[0, :, 0].double() for t in tq)
    carried, _ = emulate(q, k, v, scale, 1)
    split, _ = emulate(q, k, v, scale, 2)
    assert (carried - split).abs().max() <= BF16_STEP * exact.abs().max()
    assert (carried - exact).abs().max() <= 2 * (plain - exact).abs().max()


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("BH,N,D", [(1, 1024, 1024), (2, 1024, 1024), (1, 1024, 512),
                                    (1, 1024, 128), (1, 1024, 64), (2, 100, 1000), (1, 1, 256),
                                    (4, 4096, 64), (3, 257, 768)])
def test_plan_walks_every_key_tile_once_within_the_card(sms, BH, N, D):
    """Every key tile in exactly one split, none empty, at most one split a
    tile; up to D = 256 more than one split only where the grid stays within
    one block an SM; above, one softmax group a split where the grid stays
    within 4 blocks an SM, and no more splits than that."""
    how = A.plan(BH, N, D, sms)
    tiles = -(-N // A.BF16_TILE_KEYS)
    assert 1 <= how.splits <= tiles
    assert how.splits * how.tiles_per_split >= tiles > (how.splits - 1) * how.tiles_per_split
    assert how.wide == (D > A.BF16_PANEL * A.BF16_MAX_PANELS)
    if how.wide:
        assert how.tiles_per_split <= A.BF16_WIDE_GROUP or how.splits * how.query_tiles * BH <= 4 * sms
        assert how.splits == 1 or how.blocks * BH <= 4 * sms
    else:
        assert how.splits == 1 or how.blocks * BH <= sms


def test_plan_at_the_mid_block_of_sr_sr3_64_512():
    """N = 1024 tokens of 32², D = 1024, one head, on 132 SMs: the wide
    kernel, 16 query tiles and 8 splits of one group of two key tiles, at
    batch 1 and 2; D = 128 on the other kernel, 8 splits of two tiles."""
    assert A.plan(1, 1024, 1024, 132) == A.AttnPlan(8, 2, 16, True)
    assert A.plan(2, 1024, 1024, 132) == A.AttnPlan(8, 2, 16, True)
    assert A.plan(1, 1024, 128, 132) == A.AttnPlan(8, 2, 16, False)


def test_forced_split_counts():
    """A forced count may leave the last split with no key; a count of 0 or
    more than one a key tile is refused."""
    how = A.plan(1, 256, 128, 132, splits=3)
    assert (how.splits, how.tiles_per_split) == (3, 2)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="key splits"):
            A.plan(1, 256, 128, 132, splits=bad)
