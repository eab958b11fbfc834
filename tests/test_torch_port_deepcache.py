"""The port's DeepCache (models/deepcache.py, diffusion/deepcache.py and the
serving switches) against the JAX package's, on the CPU.

A tiny UNet (in and out 1, inner 8, 4 groups, mults (1, 2, 4), attention at
8², one res block, 16² inputs), the JAX params carried across by
`unet_state_dict_from_jax`. Torch cannot replay threefry, so the cached
chains are handed the draws JAX makes (`replay_noise`: split, then one key a
step, as JAX's cached chain splits them). The JAX side runs jitted.
Tolerance: max abs ≤ 1e-4·max|ref| + 1e-5, as tests/test_torch_port_unet.py
(f32; convolutions and GroupNorm sums in another order). Interval 1 and the
full pass are held to the port's exact chain and UNet bit for bit.
"""

import logging
from unittest import mock
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import InDIProcess as JaxInDI
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu.diffusion import deepcache as jax_dc
from diffsplitting_tpu.models import UNet as JaxUNet
from diffsplitting_tpu.models.deepcache import CachedUNet as JaxCachedUNet
from diffsplitting_tpu.train import trainer as jax_trainer
from diffsplitting_tpu_torch.diffusion import InDIProcess, JointInDIProcess
from diffsplitting_tpu_torch.diffusion import deepcache as dc
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.models.deepcache import CachedUNet
from diffsplitting_tpu_torch.serving import SplittingModel
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_diffusion import replay_noise
from tests.test_torch_port_unet import random_flax_params
from tests.test_trainer import tiny_opt

S, B, N = 16, 2, 6
KW = dict(in_channel=1, out_channel=1, inner_channel=8, norm_groups=4, channel_mults=(1, 2, 4),
          attn_res=(8,), res_blocks=1, image_size=S)
PROC = dict(out_channel=1, e=0.5, noise_mode="gaussian", num_timesteps=N)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5


@pytest.fixture(scope="module")
def nets():
    """Two JAX UNets' params and the port's UNets from them."""
    jnet = JaxUNet(**KW)
    params = [random_flax_params(jnet, (B, S, S, 1), True, seed) for seed in (1, 2)]
    ports = []
    for p in params:
        port = UNet(**KW).eval()
        port.load_state_dict(unet_state_dict_from_jax(p, KW["channel_mults"], 1), strict=True)
        ports.append(port)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, S, 1)).astype(np.float32)
    return SimpleNamespace(jnet=jnet, params=params, ports=ports, x=x)


@pytest.mark.parametrize("depth", [1, 2])
def test_full_pass_is_the_unet_forward_bit_for_bit(nets, depth):
    port = nets.ports[0]
    x, t = torch.from_numpy(nets.x), torch.tensor([0.5, 0.25])
    cnet = CachedUNet(port, depth)
    with torch.no_grad():
        want = port(x, t)
        out, deep = cnet(x, t)
        again, kept = cnet(x, t, deep)  # shallow levels on the cache of the same input
    assert torch.equal(out, want) and torch.equal(again, want) and kept is deep
    assert tuple(deep.shape) == cnet.deep_shape(B)


def test_cache_depth_out_of_range_raises(nets):
    for depth in (0, 3):
        with pytest.raises(ValueError, match="cache_depth"):
            CachedUNet(nets.ports[0], depth)


@pytest.mark.parametrize("depth", [1, 2])
def test_cached_unet_matches_jax(nets, depth):
    """Full pass (output and cache) and a shallow pass on JAX's cache at
    another input and time."""
    cnet = JaxCachedUNet.from_unet(nets.jnet, depth)
    apply = jax.jit(cnet.apply)
    variables = {"params": nets.params[0]}
    x2 = np.random.default_rng(1).normal(size=nets.x.shape).astype(np.float32)
    t, t2 = np.array([0.5, 0.25], np.float32), np.array([0.4, 0.15], np.float32)
    jout, jdeep = apply(variables, jnp.asarray(nets.x), jnp.asarray(t))
    jout2, _ = apply(variables, jnp.asarray(x2), jnp.asarray(t2), jdeep)

    port = CachedUNet(nets.ports[0], depth)
    with torch.no_grad():
        out, deep = port(torch.from_numpy(nets.x), torch.from_numpy(t))
        cache = torch.from_numpy(np.asarray(jdeep)).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        out2, _ = port(torch.from_numpy(x2), torch.from_numpy(t2), cache)
    close(out, jout)
    close(deep.permute(0, 2, 3, 1), jdeep)
    close(out2, jout2)
    b, c, h, w = port.deep_shape(B)
    assert (b, h, w, c) == cnet.deep_shape(B)


@pytest.fixture(scope="module")
def jax_cached_indi(nets):
    """JAX's cached InDI chain, jitted once with the refresh flags traced."""
    proc = JaxInDI(image_size=S, conditional=False, **PROC)

    def run(params, rng, x, flags):
        full, shallow, _ = jax_dc.make_cached_denoisers(nets.jnet, {"params": params}, 1)
        return jax_dc.cached_indi_inference(proc, rng, x, full, shallow, num_timesteps=N,
                                            refresh_override=flags)

    return jax.jit(run)


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_cached_indi_matches_jax(nets, jax_cached_indi, interval):
    rng = jax.random.PRNGKey(11)
    flags = jax_dc._refresh_flags(N, interval, None)
    want = jax_cached_indi(nets.params[0], rng, jnp.asarray(nets.x), flags)
    full, shallow = dc.make_cached_denoisers(nets.ports[0], 1)
    got = dc.cached_indi_inference(InDIProcess(**PROC), torch.from_numpy(nets.x), full, shallow,
                                   interval=interval, num_timesteps=N,
                                   noise=replay_noise(rng, (B, S, S, 1), N))
    close(got, want)


@pytest.fixture(scope="module")
def jax_cached_joint(nets):
    """JAX's cached joint chain at depth 2, jitted once for every interval: it
    takes no refresh flags, so while it traces its `_refresh_flags` is swapped
    for one that returns the traced flags."""
    jproc = JaxJointInDI(image_size=S, conditional=False, **PROC)

    def run(p1, p2, rng, x, flags):
        a1 = jax_dc.make_cached_denoisers(nets.jnet, {"params": p1}, 2)[:2]
        a2 = jax_dc.make_cached_denoisers(nets.jnet, {"params": p2}, 2)[:2]
        with mock.patch.object(jax_dc, "_refresh_flags", lambda *_: flags):
            return jax_dc.cached_joint_indi_inference(jproc, rng, x, a1, a2,
                                                      num_timesteps=N, t_float_start=0.4)

    return jax.jit(run)


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_cached_joint_indi_matches_jax(nets, jax_cached_joint, interval):
    """Depth 2; net 2 starts at 1 − t_float_start."""
    rng = jax.random.PRNGKey(5)
    flags = jax_dc._refresh_flags(N, interval, None)
    want = jax_cached_joint(*nets.params, rng, jnp.asarray(nets.x), flags)
    rng1, rng2 = jax.random.split(rng)
    noise = tuple(replay_noise(r, (B, S, S, 1), N) for r in (rng1, rng2))
    got = dc.cached_joint_indi_inference(
        JointInDIProcess(**PROC), torch.from_numpy(nets.x),
        *[dc.make_cached_denoisers(p, 2) for p in nets.ports], interval=interval,
        num_timesteps=N, t_float_start=0.4, noise=noise)
    assert got.shape == (B, S, S, 2)
    close(got, want)


def test_interval_one_is_the_exact_chain_bit_for_bit(nets):
    x = torch.from_numpy(nets.x)
    proc, jproc = InDIProcess(**PROC), JointInDIProcess(**PROC)
    full, shallow = dc.make_cached_denoisers(nets.ports[0], 2)
    exact = proc.inference(nets.ports[0], x, N, 1.0, generator=torch.Generator().manual_seed(3))
    cached = dc.cached_indi_inference(proc, x, full, shallow, 1, N, 1.0,
                                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(cached, exact)
    exact = jproc.inference(*nets.ports, x, N, 0.5, generator=torch.Generator().manual_seed(4))
    cached = dc.cached_joint_indi_inference(
        jproc, x, *[dc.make_cached_denoisers(p, 1) for p in nets.ports], 1, N, 0.5,
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(cached, exact)


@pytest.mark.parametrize("n,interval", [(6, 1), (6, 4), (10, 3), (3, 5), (1, 2)])
def test_refresh_flags_match_jax(n, interval):
    want = np.asarray(jax_dc._refresh_flags(n, interval, None))
    np.testing.assert_array_equal(dc._refresh_flags(n, interval), want)
    override = np.array([1, 0, 0, 1, 1, 0], np.int32)
    np.testing.assert_array_equal(dc._refresh_flags(6, interval, override), override)


def test_first_step_must_refresh(nets):
    full, shallow = dc.make_cached_denoisers(nets.ports[0], 1)
    with pytest.raises(ValueError, match="starting with a refresh"):
        dc.cached_indi_inference(InDIProcess(**PROC), torch.from_numpy(nets.x), full, shallow,
                                 num_timesteps=3, refresh_override=[0, 1, 1])


def test_auto_interval_resolves_as_jax():
    jax_model = SimpleNamespace(deepcache=("auto", 1))
    port = SimpleNamespace(deepcache=("auto", 1))
    for T in (1, 2, 3, 4, 10, 13, 25, 50, 2000):
        assert SplittingModel.dc_interval(port, T) == jax_trainer.DiffusionModel._dc_interval(
            jax_model, T)
    assert SplittingModel.dc_interval(port, 3) == 1  # the Hagen config's N
    assert SplittingModel.dc_interval(port, 10) == 4


def joint_opt(**model_keys):
    opt = tiny_opt("joint_indi", in_ch=1, out_ch=1, channels=1)
    opt["model"]["beta_schedule"]["val"]["n_timestep"] = 5
    opt["model"].update(model_keys)
    return opt


def test_config_key_and_setter_switch_serving():
    """model.deepcache routes `test` through the cached joint chain (same
    generator state, same bits); set_deepcache(None) restores the exact chain
    and 'auto' at N = 5 is interval 2."""
    model = SplittingModel(joint_opt(deepcache={"interval": 2, "depth": 1}), device="cpu", seed=0)
    assert model.deepcache == (2, 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(B, S, S, 1)).astype(np.float32))
    appliers = [dc.make_cached_denoisers(u, 1) for u in model.unets()]

    def cached(interval):
        return dc.cached_joint_indi_inference(model.process, x, *appliers, interval, 5, 0.5,
                                              generator=torch.Generator().manual_seed(9))

    model.generator.manual_seed(9)
    assert torch.equal(model.test(x), cached(2))
    model.set_deepcache("auto")
    assert model.deepcache == ("auto", 1)
    model.generator.manual_seed(9)
    assert torch.equal(model.test(x), cached(2))
    model.set_deepcache(None)
    model.generator.manual_seed(9)
    exact = model.process.inference(*model.unets(), x, 5, 0.5,
                                    generator=torch.Generator().manual_seed(9))
    assert model.deepcache is None and torch.equal(model.test(x), exact)
    assert not torch.equal(exact, cached(2))


def test_continuous_serves_the_exact_chain_with_one_warning(caplog):
    model = SplittingModel(joint_opt(deepcache={"interval": 2}), device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, S, S, 1)).astype(np.float32))
    with caplog.at_level(logging.WARNING, logger="base"):
        trajectories = []
        for _ in range(2):
            model.generator.manual_seed(1)
            trajectories.append(model.test(x, continuous=True))
    want = model.process.inference(*model.unets(), x, 5, 0.5,
                                   generator=torch.Generator().manual_seed(1), continuous=True)
    assert all(torch.equal(tr, want) for tr in trajectories)
    assert sum("deepcache ignores continuous" in r.message for r in caplog.records) == 1


def test_ema_nets_serve_through_deepcache():
    """DiffusionModel reads model.deepcache and serves the EMA nets through
    the cached chain."""
    opt = joint_opt(deepcache={"interval": 3, "depth": 1})
    opt["train"]["ema_scheduler"] = {"enabled": True, "step_start_ema": 0, "ema_decay": 0.9}
    model = DiffusionModel(opt, device="cpu", seed=0)
    with torch.no_grad():
        for p in model.ema_nets.parameters():
            p.mul_(0.9)  # EMA weights that differ from the trained ones
    x = np.random.default_rng(4).normal(size=(B, S, S, 1)).astype(np.float32)
    model.feed_data({"input": x})
    model._server.generator.manual_seed(6)
    got = model.test()
    ema = model.ema_nets
    want = dc.cached_joint_indi_inference(
        model.process, torch.from_numpy(x),
        *[dc.make_cached_denoisers(n.denoise_fn, 1) for n in (ema.indi1, ema.indi2)],
        3, model.current_T, 0.5, generator=torch.Generator().manual_seed(6))
    assert torch.equal(got, want)
    model.set_deepcache(None)
    model._server.generator.manual_seed(6)
    assert not torch.equal(model.test(), want)
    assert model._server.deepcache is None
