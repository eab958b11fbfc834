"""The port's InDI and joint-InDI reverse loops against the JAX processes.

Torch cannot replay JAX's threefry streams, so the test draws the JAX
process's noise itself, from the same key and in the same order as
diffsplitting_tpu/diffusion/indi.py `inference` (split into (rng, init_rng),
the initial draw, then one draw per step key from split(rng, N)), and injects
those draws into the port. Both sides use the same simple denoiser, so the
comparison is of the processes alone. Tolerance 1e-5 (f32 arithmetic in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import InDIProcess as JaxInDI
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu_torch.diffusion import InDIProcess, JointInDIProcess

N = 4
SHAPE = (2, 8, 8, 1)


def jax_denoise(x, t):
    return jnp.tanh(x) * 0.9 + t[:, None, None, None] * 0.1


def torch_denoise(x, t):
    return torch.tanh(x) * 0.9 + t[:, None, None, None] * 0.1


def replay_noise(rng, shape, n_steps):
    """The draws JAX InDIProcess.inference makes from `rng`."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(rng, n_steps)]
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.mark.parametrize("noise_mode,out_channel,t_start",
                         [("gaussian", 1, 1.0), ("brownian", 2, 0.7)])
def test_indi_inference_matches_jax(noise_mode, out_channel, t_start):
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    kw = dict(out_channel=out_channel, e=0.05, noise_mode=noise_mode, num_timesteps=N)
    want = np.asarray(JaxInDI(image_size=8, conditional=False, **kw).inference(
        jax_denoise, rng, jnp.asarray(x), num_timesteps=N, t_float_start=t_start))
    noise = replay_noise(rng, SHAPE[:3] + (out_channel,), N)
    got = InDIProcess(**kw).inference(torch_denoise, torch.from_numpy(x), N, t_start,
                                      noise=noise).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_joint_indi_inference_matches_jax():
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    kw = dict(out_channel=1, e=0.05, noise_mode="gaussian", num_timesteps=N)
    want = np.asarray(JaxJointInDI(image_size=8, conditional=False, **kw).inference(
        jax_denoise, lambda a, t: -jax_denoise(a, t), rng, jnp.asarray(x), num_timesteps=N,
        t_float_start=0.5))
    rng1, rng2 = jax.random.split(rng)
    noise = (replay_noise(rng1, SHAPE, N), replay_noise(rng2, SHAPE, N))
    got = JointInDIProcess(**kw).inference(
        torch_denoise, lambda a, t: -torch_denoise(a, t), torch.from_numpy(x), N, 0.5,
        noise=noise).numpy()
    assert got.shape == want.shape == (2, 8, 8, 2)
    assert np.abs(got - want).max() <= 1e-5


def test_q_sample_matches_jax():
    rng = np.random.default_rng(2)
    xs, xe, nz = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    t = np.array([0.3, 0.9], np.float32)
    for mode in ("gaussian", "brownian"):
        want = np.asarray(JaxInDI(image_size=8, e=0.05, noise_mode=mode, conditional=False)
                          .q_sample(*map(jnp.asarray, (xs, xe, t, nz))))
        got = InDIProcess(e=0.05, noise_mode=mode).q_sample(
            *map(torch.from_numpy, (xs, xe, t, nz))).numpy()
        assert np.abs(got - want).max() <= 1e-6
