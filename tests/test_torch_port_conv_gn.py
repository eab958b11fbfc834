"""The port's conv+GroupNorm op against the JAX package's.

The plain version (what a CPU tensor runs) is held against the JAX
`conv_gn_reference` at the unaligned widths of the splitting UNet, and
against the Pallas kernel in interpret mode at the aligned shapes of
tests/test_conv_gn.py. Same numpy inputs on both sides. Tolerances, as the
JAX package's own tests state them: y max abs 3e-5 (f32, the conv's sums in
another order); statistics rtol 1e-4, atol 1e-2 (sums of squares over H·W
pixels of values up to about 10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.experimental import conv_gn as jax_conv_gn
from diffsplitting_tpu_torch.ops import (
    FusedConvGN,
    channel_stats,
    conv_gn_fused,
    conv_gn_reference,
    fold_gn_affine,
)
from diffsplitting_tpu_torch.ops.conv_gn import conv_gn_tiling


def _inputs(B, H, W, Cin, Cout, act, res, seed=0):
    """numpy inputs: res is None, "identity" or "projected"."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    Cres = Cin if res == "projected" else Cout
    return dict(
        x=f(B, H, W, Cin), w=f(3, 3, Cin, Cout) * np.float32(0.1), b=f(Cout),
        scale=f(B, Cin) * np.float32(0.2) + 1 if act else None,
        shift=f(B, Cin) * np.float32(0.1) if act else None,
        residual=f(B, H, W, Cres) if res else None,
        w_skip=f(Cres, Cout) * np.float32(0.1) if res == "projected" else None)


def _torch(args):
    return {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}


def _jax(args):
    return {k: None if v is None else jnp.asarray(v) for k, v in args.items()}


def _assert_close(got, want):
    y, s, q = (np.asarray(a) for a in got)
    y_ref, s_ref, q_ref = (np.asarray(a) for a in want)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=3e-5)
    np.testing.assert_allclose(s, s_ref, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(q, q_ref, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("Cin", [48, 96, 192])
@pytest.mark.parametrize("mode", ["act", "identity", "projected", "no_prologue"])
def test_reference_matches_jax_at_unaligned_widths(Cin, mode):
    res = mode if mode in ("identity", "projected") else None
    args = _inputs(2, 6, 5, Cin, 32, mode != "no_prologue", res, seed=Cin)
    got = conv_gn_reference(**_torch(args))
    want = jax_conv_gn.conv_gn_reference(**_jax(args))
    _assert_close([t.numpy() for t in got], want)

    # on a CPU tensor the wrapper runs the plain version and launches nothing
    before = FusedConvGN.launches
    fused = conv_gn_fused(**_torch(args))
    assert FusedConvGN.launches == before
    for a, b in zip(fused, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize(
    "B,H,W,Cin,Cout,act,res",
    [  # the shapes of tests/test_conv_gn.py, where the Pallas kernel runs
        (2, 32, 16, 128, 128, True, None),
        (2, 32, 16, 128, 128, False, None),
        (1, 16, 8, 128, 128, True, "identity"),
        (2, 8, 8, 128, 128, True, "projected"),
        (1, 8, 8, 128, 128, False, None),
    ],
)
def test_reference_matches_jax_pallas_kernel(B, H, W, Cin, Cout, act, res):
    args = _inputs(B, H, W, Cin, Cout, act, res)
    want = jax_conv_gn.conv_gn_fused(**_jax(args), interpret=True)
    got = conv_gn_fused(**_torch(args))
    _assert_close([t.numpy() for t in got], want)


def test_fold_gn_affine_and_channel_stats_match_jax():
    rng = np.random.default_rng(4)
    B, H, W, C, G = 2, 8, 8, 48, 16
    x = (rng.normal(size=(B, H, W, C)) * 1.5 + 0.3).astype(np.float32)
    gamma = (rng.normal(size=C) * 0.3 + 1).astype(np.float32)
    beta = (rng.normal(size=C) * 0.2).astype(np.float32)

    sums, sumsqs = channel_stats(torch.from_numpy(x))
    jsums, jsumsqs = jax_conv_gn.channel_stats(jnp.asarray(x))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sumsqs.numpy(), np.asarray(jsumsqs), rtol=1e-5, atol=1e-4)

    scale, shift = fold_gn_affine(sums, sumsqs, H * W, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), G)
    jscale, jshift = jax_conv_gn.fold_gn_affine(jsums, jsumsqs, H * W, jnp.asarray(gamma),
                                                jnp.asarray(beta), G)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(shift.numpy(), np.asarray(jshift), rtol=1e-5, atol=1e-5)

    # x·scale + shift is GroupNorm(x)·γ + β
    got = x * scale.numpy()[:, None, None, :] + shift.numpy()[:, None, None, :]
    want = torch.nn.functional.group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), G, torch.from_numpy(gamma),
        torch.from_numpy(beta), 1e-5).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_zero_padding_is_of_the_activated_input():
    """With shift > 0 swish(shift) ≠ 0, so padding x with zeros before the
    prologue would give another border; the contract pads the activated input."""
    args = _torch(_inputs(1, 4, 4, 8, 4, True, None, seed=1))
    args["scale"] = torch.zeros_like(args["scale"])
    args["shift"] = torch.full_like(args["shift"], 2.0)
    args["b"] = torch.zeros_like(args["b"])
    y, _, _ = conv_gn_reference(**args)
    act = 2.0 / (1.0 + np.exp(-2.0))  # swish(2), the same at every pixel
    taps = args["w"].sum(dim=2)  # (3, 3, Cout)
    np.testing.assert_allclose(y[0, 1, 1].numpy(), act * taps.sum(dim=(0, 1)).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(y[0, 0, 0].numpy(), act * taps[1:, 1:].sum(dim=(0, 1)).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(x=np.zeros((1, 4, 4, 6), np.float32), w=np.zeros((3, 3, 6, 4), np.float32)),
         "Cin=6 must be a multiple of 4"),
        (dict(x=np.zeros((1, 4, 4, 260), np.float32), w=np.zeros((3, 3, 260, 4), np.float32)),
         "at most 256"),
        (dict(w=np.zeros((3, 3, 8, 132), np.float32), b=np.zeros(132, np.float32)),
         "Cout=132"),
        (dict(w_skip=np.zeros((8, 4), np.float32)), "w_skip needs a residual"),
        (dict(residual=np.zeros((1, 4, 4, 8), np.float32)), "identity residual needs Cres"),
        (dict(residual=np.zeros((1, 4, 4, 6), np.float32),
              w_skip=np.zeros((6, 4), np.float32)), "Cres=6"),
    ],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, error):
    args = _inputs(1, 4, 4, 8, 4, True, None)
    args.update(change)
    with pytest.raises(ValueError, match=error):
        conv_gn_fused(**_torch(args))


def test_wrapper_raises_on_other_types_and_layouts():
    args = _torch(_inputs(1, 4, 4, 8, 4, False, None))
    with pytest.raises(TypeError, match="float32"):
        conv_gn_fused(args["x"].double(), args["w"], args["b"])
    nchw = args["x"].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        conv_gn_fused(nchw, args["w"], args["b"])


@pytest.mark.parametrize("H,W,Cout", [(512, 512, 16), (512, 512, 32), (256, 256, 32),
                                      (128, 128, 64), (64, 64, 128), (128, 128, 128),
                                      (13, 20, 128), (7, 5, 16)])
def test_tiling_covers_the_map(H, W, Cout):
    tr, tw, tiles = conv_gn_tiling(H, W, Cout)
    # all of Cout in one block, 2 m16 tiles a warp: 16x16 pixels on 8 warps
    # at 16 channels, 8x16 on 4 warps at 32 and 64 and on 8 warps at 128; an
    # m16 tile is 16 pixels of one tile row
    assert (tr, tw) == {16: (16, 16), 32: (8, 16), 64: (8, 16), 128: (8, 16)}[Cout]
    assert tw % 16 == 0 and (tr * tw) % (16 * 4 * 2) == 0
    assert tiles == -(-H // tr) * -(-W // tw)
    # the 64^2 sites at batch 8 still fill the card's 132 SMs
    if (H, W) == (64, 64):
        assert 8 * tiles >= 132
