"""The 3xTF32 implicit GEMM of csrc/conv_gn.cu, emulated in plain PyTorch.

The kernel runs only on the card, so its arithmetic is pinned here, with the
split helpers of tests/test_torch_port_attention_split.py: every activated
input and weight is split once into big (TF32, round to nearest, ties away)
and small (read truncated to TF32 by the tensor core), and a product
accumulates small*big + big*small + big*big in f32. The emulation walks K in
the kernel's order: chunks of 16 input channels (zero-filled past Cin), each
through the 9 taps of the zero-padded activated window, then a projected
residual's chunks of 16 through the centre tap; bias and an identity
residual are added after. It is held against JAX's `conv_gn_reference` and
the port's plain version within the chip check's 1e-4 * (1 + max|ref|); a
1xTF32 emulation (big*big only) is printed beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_attention_split import mm

from diffsplitting_tpu.experimental import conv_gn as jax_conv_gn
from diffsplitting_tpu_torch.ops import conv_gn_reference

KC = 16  # input channels a K step of the kernel


def _chunks(t, C):
    """t (..., C) zero-filled to a multiple of KC, cut into chunks of KC."""
    t = F.pad(t, (0, -C % KC))
    return [t[..., c:c + KC] for c in range(0, t.shape[-1], KC)]


def emulate(x, w, b, scale=None, shift=None, residual=None, w_skip=None, terms: int = 3):
    """(y, sums, sumsqs) as the kernel computes them, K step by K step."""
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    xa = x
    if scale is not None:
        xa = x * scale[:, None, None, :] + shift[:, None, None, :]
        xa = xa / (1 + torch.exp(-xa))  # the kernel's swish, exact (it uses fast intrinsics)
    win = F.pad(xa, (0, 0, 1, 1, 1, 1))  # the padding is of the activated input
    acc = torch.zeros(B * H * W, Cout)
    for xc, wc in zip(_chunks(win, Cin), _chunks(w.transpose(2, 3), Cin)):
        for tap in range(9):
            kh, kw = divmod(tap, 3)
            a = xc[:, kh:kh + H, kw:kw + W].reshape(-1, KC)
            acc = acc + mm(a, wc[kh, kw].T.contiguous(), terms)
    if w_skip is not None:
        Cres = residual.shape[-1]
        for rc, wc in zip(_chunks(residual, Cres), _chunks(w_skip.T, Cres)):
            acc = acc + mm(rc.reshape(-1, KC), wc.T.contiguous(), terms)
    y = acc.reshape(B, H, W, Cout) + b
    if residual is not None and w_skip is None:
        y = y + residual
    return y, y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


# (Cin, Cout, residual, Cres, gain): the two longest K, Cout 16, a ragged
# width, and inputs x8
CASES = [
    (128, 64, "projected", 256, 1),
    (256, 128, None, 0, 1),
    (48, 16, "projected", 48, 1),
    (32, 16, "identity", 16, 1),
    (12, 12, "projected", 20, 1),
    (96, 32, "projected", 96, 8),
]


@pytest.mark.parametrize("Cin,Cout,res,Cres,gain", CASES)
def test_3xtf32_emulation_matches_references(Cin, Cout, res, Cres, gain):
    B, H, W = 1, 6, 5
    rng = np.random.default_rng(Cin + Cout + gain)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = dict(
        x=f(B, H, W, Cin) * np.float32(gain), w=f(3, 3, Cin, Cout) / np.float32(np.sqrt(9 * Cin)),
        b=f(Cout) * np.float32(0.1), scale=f(B, Cin) * np.float32(0.2) + 1,
        shift=f(B, Cin) * np.float32(0.5),
        residual=f(B, H, W, Cres) * np.float32(gain) if res else None,
        w_skip=f(Cres, Cout) / np.float32(np.sqrt(Cres)) if res == "projected" else None)
    targs = {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}
    want = conv_gn_reference(**targs)[0].numpy()
    want_jax = np.asarray(jax_conv_gn.conv_gn_reference(
        **{k: None if v is None else jnp.asarray(v) for k, v in args.items()})[0])
    y3, s3, q3 = emulate(**targs)
    y1 = emulate(**targs, terms=1)[0]
    tol = 1e-4 * (1 + np.abs(want).max())
    err3 = np.abs(y3.numpy() - want).max()
    err1 = np.abs(y1.numpy() - want).max()
    print(f"Cin {Cin} Cout {Cout} residual {res} Cres {Cres} gain {gain}: 3xTF32 max abs err "
          f"{err3:.3g}, 1xTF32 {err1:.3g}, tolerance {tol:.3g}")
    assert err3 <= tol
    assert np.abs(y3.numpy() - want_jax).max() <= tol
    assert err3 * 10 < err1  # the split buys f32 accuracy back
    # the statistics come from the same f32 accumulator
    y_ref = torch.from_numpy(want)
    torch.testing.assert_close(s3, y_ref.sum(dim=(1, 2)), rtol=1e-4, atol=1e-3 * gain * gain)
    torch.testing.assert_close(q3, (y_ref * y_ref).sum(dim=(1, 2)), rtol=1e-4,
                               atol=1e-3 * gain * gain)
