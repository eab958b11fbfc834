"""The port's parallel-in-time InDI samplers (diffusion/parallel_sampling.py)
and the sliding-window serving switch against the JAX package's, on the CPU.

The sampler comparisons use the simple elementwise denoiser of
tests/test_torch_port_diffusion.py, so they hold the samplers alone; one case
runs the tiny UNet of tests/test_torch_port_deepcache.py. Torch cannot replay
threefry, so the port is handed the draws JAX makes: the initial draw from
`split`, then the per-step draws (`split(rng, N)` for the whole-trajectory
sweeps, `fold_in(rng, g)` for the window). Tolerance: max abs ≤
1e-4·max|ref| + 1e-5; sweep counts equal. τ = 0 is held to the port's exact
chain: bit for bit with the elementwise denoiser or at W = 1, within the
tolerance for the UNet at W > 1 (a batch of W·B sums its convolutions in
another order).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import InDIProcess as JaxInDI
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu.diffusion import parallel_sampling as jax_ps
from diffsplitting_tpu.models import UNet as JaxUNet
from diffsplitting_tpu_torch.diffusion import InDIProcess, JointInDIProcess
from diffsplitting_tpu_torch.diffusion import parallel_sampling as ps
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.serving import SplittingModel
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_deepcache import KW, joint_opt
from tests.test_torch_port_diffusion import jax_denoise, replay_noise, torch_denoise
from tests.test_torch_port_unet import random_flax_params

N = 8
SHAPE = (2, 8, 8, 1)
PROC = dict(out_channel=1, e=0.5, noise_mode="gaussian", num_timesteps=N)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5


def fold_in_noise(rng, shape, n_steps):
    """The draws JAX's sliding window makes from `rng`."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(rng, g), shape, jnp.float32)
              for g in range(n_steps)]
    return [torch.from_numpy(np.array(d)) for d in draws]


def inputs(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("num_sweeps", [3, None])
def test_parallel_matches_jax(num_sweeps):
    """Fixed sweeps, and until max |ΔX| < tol (which reaches the exact chain)."""
    x, rng = inputs(1), jax.random.PRNGKey(4)
    want = jax.jit(lambda r, xx: jax_ps.indi_inference_parallel(
        JaxInDI(image_size=8, conditional=False, **PROC), jax_denoise, r, xx, N, 0.8,
        num_sweeps=num_sweeps))(rng, jnp.asarray(x))
    noise = replay_noise(rng, SHAPE, N)
    proc = InDIProcess(**PROC)
    got = ps.indi_inference_parallel(proc, torch_denoise, torch.from_numpy(x), N, 0.8,
                                     num_sweeps=num_sweeps, noise=noise)
    close(got, want)
    if num_sweeps is None:
        exact = proc.inference(torch_denoise, torch.from_numpy(x), N, 0.8, noise=noise)
        close(got, exact)


@pytest.mark.parametrize("window,tau", [(1, 0.0), (1, 0.1), (3, 0.0), (3, 0.1), (8, 0.0),
                                        (8, 0.1), (3, 20.0), (4, 300.0)])
def test_sliding_window_matches_jax(window, tau):
    x, rng = inputs(2), jax.random.PRNGKey(8)
    want, want_sweeps = jax.jit(lambda r, xx: jax_ps.indi_inference_sliding_window(
        JaxInDI(image_size=8, conditional=False, **PROC), jax_denoise, r, xx, N, 1.0,
        window=window, tau=tau))(rng, jnp.asarray(x))
    got, sweeps = ps.indi_inference_sliding_window(
        InDIProcess(**PROC), torch_denoise, torch.from_numpy(x), N, 1.0, window, tau,
        noise=fold_in_noise(rng, SHAPE, N))
    close(got, want)
    assert sweeps == int(want_sweeps)


def test_sliding_window_through_a_unet_matches_jax():
    jnet = JaxUNet(**KW)
    params = random_flax_params(jnet, (2, 16, 16, 1), True, seed=3)
    net = UNet(**KW).eval()
    net.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1), strict=True)
    x, rng = inputs(3, (2, 16, 16, 1)), jax.random.PRNGKey(2)
    want, want_sweeps = jax.jit(lambda p, r, xx: jax_ps.indi_inference_sliding_window(
        JaxInDI(image_size=16, conditional=False, **PROC),
        lambda a, t: jnet.apply({"params": p}, a, t), r, xx, N, 1.0, window=3, tau=0.1))(
        params, rng, jnp.asarray(x))
    got, sweeps = ps.indi_inference_sliding_window(
        InDIProcess(**PROC), net, torch.from_numpy(x), N, 1.0, 3, 0.1,
        noise=fold_in_noise(rng, (2, 16, 16, 1), N))
    close(got, want)
    assert sweeps == int(want_sweeps)


@pytest.mark.parametrize("window", [1, 3, 8, 12])
def test_tau_zero_is_the_exact_chain(window):
    """Same generator seed, same bits (elementwise denoiser); every step
    takes a sweep."""
    x = torch.from_numpy(inputs(4))
    proc = InDIProcess(**PROC)
    exact = proc.inference(torch_denoise, x, N, 1.0, generator=torch.Generator().manual_seed(5))
    got, sweeps = ps.indi_inference_sliding_window(proc, torch_denoise, x, N, 1.0, window, 0.0,
                                                   generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, exact) and sweeps == N


def test_joint_sliding_window_matches_jax():
    """As JAX's serving runs it (train/trainer.py `_build_sliding_window_fn`):
    split the key, net 1 from t_float_start, net 2 from 1 − t_float_start,
    concatenate, add the sweeps."""
    x, rng = inputs(5), jax.random.PRNGKey(6)
    jproc = JaxJointInDI(image_size=8, conditional=False, **PROC)
    d2 = lambda a, t: -jax_denoise(a, t)  # noqa: E731

    def run(r, xx):
        r1, r2 = jax.random.split(r)
        ch1, s1 = jax_ps.indi_inference_sliding_window(jproc.indi1, jax_denoise, r1, xx, N, 0.5,
                                                       window=3, tau=20.0)
        ch2, s2 = jax_ps.indi_inference_sliding_window(jproc.indi2, d2, r2, xx, N, 0.5,
                                                       window=3, tau=20.0)
        return jnp.concatenate([ch1, ch2], axis=-1), s1 + s2

    want, want_sweeps = jax.jit(run)(rng, jnp.asarray(x))
    r1, r2 = jax.random.split(rng)
    got, sweeps = ps.joint_indi_inference_sliding_window(
        JointInDIProcess(**PROC), torch_denoise, lambda a, t: -torch_denoise(a, t),
        torch.from_numpy(x), N, 0.5, 3, 20.0,
        noise=(fold_in_noise(r1, SHAPE, N), fold_in_noise(r2, SHAPE, N)))
    assert got.shape == (2, 8, 8, 2)
    close(got, want)
    assert sweeps == int(want_sweeps)


def test_serving_switch_and_sweeps(caplog):
    """model.sliding_window routes `test` through the windowed joint chain
    (τ = 0: the exact chain's function); `continuous` serves the exact chain
    with one warning; set_sliding_window(None) restores it."""
    model = SplittingModel(joint_opt(sliding_window={"window": 3, "tau": 0}), device="cpu",
                           seed=0)
    assert model.sliding_window == (3, 0.0)
    x = torch.from_numpy(inputs(6, (2, 16, 16, 1)))
    model.generator.manual_seed(2)
    got = model.test(x)
    assert model.last_sliding_sweeps == 2 * 5
    exact = model.process.inference(*model.unets(), x, 5, 0.5,
                                    generator=torch.Generator().manual_seed(2))
    close(got, exact)
    with caplog.at_level(logging.WARNING, logger="base"):
        for _ in range(2):
            model.generator.manual_seed(2)
            frames = model.test(x, continuous=True)
    assert frames.shape[0] == 6 and torch.equal(frames[-1], exact)
    assert sum("sliding_window ignores continuous" in r.message for r in caplog.records) == 1
    model.set_sliding_window(None)
    model.generator.manual_seed(2)
    assert model.sliding_window is None and torch.equal(model.test(x), exact)


def test_deepcache_with_sliding_window_raises():
    opt = joint_opt(sliding_window={"window": 2}, deepcache={"interval": 2})
    model = SplittingModel(opt, device="cpu", seed=0)
    assert model.sliding_window == (2, 0.1) and model.deepcache == (2, 1)
    x = torch.zeros(1, 16, 16, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.test(x)
    trainer = DiffusionModel(joint_opt(), device="cpu", seed=0)
    trainer.set_deepcache(2)
    trainer.set_sliding_window(4, 0.0)
    trainer.feed_data({"input": np.zeros((1, 16, 16, 1), np.float32)})
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainer.test()
    trainer.set_deepcache(None)
    trainer.test()
    assert trainer.last_sliding_sweeps == 2 * trainer.current_T
