"""The 3xTF32 arithmetic of csrc/attention.cu, emulated in plain PyTorch.

The kernel runs only on the card, so its arithmetic is pinned here: each f32
operand x is split into big = x rounded to TF32 (10 mantissa bits, to nearest,
ties away from zero, as cvt.rna.tf32.f32 rounds; the kernel does it with an
integer add and mask) and small = x - big, which the tensor core reads
truncated to TF32. A product accumulates small*big + big*small + big*big in
f32. The emulation walks the keys in the kernel's 64-key tiles with its
online softmax in the exp2 domain, and is held against JAX's
`attention_reference` and the port's within the chip check's tolerance
1e-4 * (1 + max|ref|). A 1xTF32 emulation (big*big only) is printed beside
it to record what the split buys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.ops.attention import attention_reference as jax_attention
from diffsplitting_tpu_torch.ops import attention_reference

TILE = 64  # keys a stage of the kernel
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
    o = torch.zeros(n, d)
    m = torch.full((n, 1), -torch.inf)
    l = torch.zeros(n, 1)
    for k0 in range(0, n, TILE):
        s = mm(q, k[k0:k0 + TILE].T, terms) * c2
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


@pytest.mark.parametrize("score_gain", [1, 8])
def test_3xtf32_emulation_matches_references(score_gain):
    B, N, H, D = 1, 256, 1, 128
    rng = np.random.default_rng(2)
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
    print(f"score gain {score_gain}: 3xTF32 max abs err {err3:.3g}, 1xTF32 {err1:.3g}, "
          f"tolerance {tol:.3g}")
    assert err3 <= tol
    assert np.abs(got3 - want_jax[0, :, 0]).max() <= tol
    assert err3 * 10 < err1  # the split buys f32 accuracy back
