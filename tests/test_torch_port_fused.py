"""The port's stat-carried fused forward against the JAX package.

Splitting topology (1 channel in and out, inner 16, 16 groups, mults
(1, 2, 4, 8), one res block), seeded random weights whose vectors are
1 + N(0, 0.1²) (`random_like`), so every ResnetBlock's 1×1 res_conv has a
non-zero bias. The port's walk runs on the CPU through the plain versions.
Tolerance: max abs ≤ 2e-4·max|ref| + 1e-5 (f32 on both sides; the GroupNorm
statistics are carried as E[x²] − E[x]² from sums over the whole map, and
the sums run in another order).

The JAX walk (`fused_unet_apply`) drops the res_conv bias, and the port adds
it, so the port is held against the JAX walk with those biases set to zero,
and against `net.apply` with all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.experimental.fused_forward import fused_unet_apply
from diffsplitting_tpu.experimental import fused_forward as jax_ff
from diffsplitting_tpu.experimental.conv_gn import channel_stats as jax_channel_stats
from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu_torch.models import UNet, apply_unet, fused_enabled
from diffsplitting_tpu_torch.models import forward_utils
from diffsplitting_tpu_torch.models import fused_forward as ff
from diffsplitting_tpu_torch.predict import predict_frames
from diffsplitting_tpu_torch.serving import SplittingModel
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_predict import joint_opt
from tests.test_torch_port_unet import random_flax_params

KW = dict(in_channel=1, out_channel=1, inner_channel=16, norm_groups=16,
          channel_mults=(1, 2, 4, 8), attn_res=(), res_blocks=1)


def _close(got, want):
    return np.abs(got - want).max() <= 2e-4 * np.abs(want).max() + 1e-5


def _zero_res_conv_biases(params):
    """Copy of a flax UNet's params with every ResnetBlock's 1×1 res_conv bias
    at zero (the only bias the JAX fused walk drops)."""
    out = jax.tree_util.tree_map(np.array, params)
    n = 0
    for name, block in out.items():
        rp = block.get("ResnetBlock_0", {}) if name.startswith("ResnetBlockWithAttn") else {}
        if "Conv_0" in rp:
            rp["Conv_0"]["bias"] = np.zeros_like(rp["Conv_0"]["bias"])
            n += 1
    assert n == 11  # 3 in the encoder, 8 in the decoder
    return out


def _setup(cond_type, image, B=1, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, image, image, 1)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, size=(B,)).astype(np.float32) if cond_type == "time" else None
    net = FlaxUNet(cond_type=cond_type, image_size=image, **KW)
    params = random_flax_params(net, x.shape, t is not None, seed=seed)
    return net, params, x, t


def _port(params, cond_type, image):
    port = UNet(cond_type=cond_type, image_size=image, **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, cond_type),
                         strict=True)
    return port


def _port_fused(port, x, t):
    return ff.fused_unet_forward(port, torch.from_numpy(x),
                                 None if t is None else torch.from_numpy(t)).numpy()


def _jt(t):
    return None if t is None else jnp.asarray(t)


@pytest.mark.parametrize("cond_type", ["time", "none"])
def test_fused_forward_matches_flax_apply(cond_type):
    net, params, x, t = _setup(cond_type, 64)
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), _jt(t)))
    got = _port_fused(_port(params, cond_type, 64), x, t)
    assert got.shape == want.shape == (1, 64, 64, 1)
    assert _close(got, want)


def test_fused_forward_matches_jax_fused_walk_with_zero_res_conv_biases():
    """At image 64 the JAX walk's 128-channel sites run the Pallas kernel in
    interpret mode."""
    net, params, x, t = _setup("time", 64, seed=2)
    params = _zero_res_conv_biases(params)
    want = np.asarray(fused_unet_apply(net, {"params": params}, jnp.asarray(x), _jt(t),
                                       interpret=True))
    got = _port_fused(_port(params, "time", 64), x, t)
    assert _close(got, want)


def test_jax_fused_walk_drops_res_conv_bias_and_the_port_does_not():
    """The fault this port does not copy: with non-zero res_conv biases the
    JAX fused walk is far from net.apply; the port's walk is not."""
    net, params, x, t = _setup("time", 32, B=2, seed=3)
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), _jt(t)))
    jax_fused = np.asarray(fused_unet_apply(net, {"params": params}, jnp.asarray(x), _jt(t),
                                            interpret=True))
    assert np.abs(jax_fused - want).max() > 0.1 * np.abs(want).max()
    assert _close(_port_fused(_port(params, "time", 32), x, t), want)


def test_carried_stat_algebra_matches_jax():
    rng = np.random.default_rng(5)
    B, H, W, C = 2, 4, 4, 8
    h = rng.normal(size=(B, H, W, C)).astype(np.float32)
    a1, b1, b2 = (rng.normal(size=(B, C)).astype(np.float32) for _ in range(3))

    st = ff.st_add_channel_affine(ff.st_from(torch.from_numpy(h)), torch.from_numpy(b1),
                                  torch.from_numpy(a1))
    st = ff.st_add_channel_affine(st, torch.from_numpy(b2))
    jst = jax_ff.st_add_channel_affine(jax_ff.st_from(jnp.asarray(h)), jnp.asarray(b1),
                                       jnp.asarray(a1))
    jst = jax_ff.st_add_channel_affine(jst, jnp.asarray(b2))
    for got, want in ((st.sums, jst.sums), (st.sumsqs, jst.sumsqs), (st.cbias, jst.cbias),
                      (st.cscale, jst.cscale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)

    # the carried statistics are those of the materialized tensor
    true = ff.materialize(st)
    np.testing.assert_allclose(true.numpy(), np.asarray(jax_ff.materialize(jst)), atol=1e-6)
    s, q = jax_channel_stats(jnp.asarray(true.numpy()))
    np.testing.assert_allclose(st.sums.numpy(), np.asarray(s), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(st.sumsqs.numpy(), np.asarray(q), rtol=1e-4, atol=1e-3)

    cat = ff.st_concat(ff.st_from(torch.from_numpy(h)), ff.st_from(torch.from_numpy(h[..., :4])))
    assert cat.data.shape == (B, H, W, C + 4) and cat.channels == C + 4
    with pytest.raises(ValueError, match="pending affine"):
        ff.st_concat(st, st)


def test_apply_unet_switch(monkeypatch):
    port = UNet(cond_type="time", image_size=16, **KW).eval()
    x = torch.randn(1, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    t = torch.full((1,), 0.5)
    calls = []
    monkeypatch.setattr(forward_utils, "fused_unet_forward",
                        lambda *a: calls.append(1) or ff.fused_unet_forward(*a))
    monkeypatch.delenv("DSP_FUSED", raising=False)
    assert not fused_enabled()
    with torch.no_grad():
        torch.testing.assert_close(apply_unet(port, x, t), port(x, t), rtol=0, atol=0)
        assert not calls
        monkeypatch.setenv("DSP_FUSED", "1")
        assert fused_enabled()
        apply_unet(port, x, t)
        assert len(calls) == 1
        torch.testing.assert_close(apply_unet(port, x, t, fused=False), port(x, t),
                                   rtol=0, atol=0)
        assert len(calls) == 1


@pytest.mark.parametrize("which", ["joint_indi", "indi"])
def test_predict_frames_fused_matches_unfused(tmp_path, monkeypatch, which):
    """The CPU slice: tiled prediction through the fused walk against the
    UNet's own forward, same weights and noise."""
    opt = joint_opt(tmp_path)
    opt["model"]["which_model_G"] = which
    opt["model"]["indi"]["noise_mode"] = "gaussian"
    frames = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 64, 64, 1))
                              .astype(np.float32))
    monkeypatch.delenv("DSP_FUSED", raising=False)
    model = SplittingModel(opt, device="cpu", seed=0)
    outs = {}
    for fused in (False, True):
        model.generator.manual_seed(0)
        outs[fused] = predict_frames(model, frames, 32, batch_size=8, fused=fused).numpy()
    assert outs[True].shape == outs[False].shape == (1, 64, 64, 2 if which == "joint_indi" else 1)
    assert _close(outs[True], outs[False])

    # DSP_FUSED=1 opts a model built with fused=None in, as in the JAX package
    monkeypatch.setenv("DSP_FUSED", "1")
    model.generator.manual_seed(0)
    np.testing.assert_array_equal(predict_frames(model, frames, 32, batch_size=8).numpy(),
                                  outs[True])
