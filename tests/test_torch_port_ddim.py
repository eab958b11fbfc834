"""The port's respaced DDIM (diffusion/ddim.py) against the JAX package's, on
the CPU.

  * `ddim_timesteps` and `ddim_coefficients` at S = 1, S < T and S ≥ T:
    equal (both compute in float64 from the same float32 schedule);
  * `ddim_sample_loop` for DDPM and SR3, conditional and unconditional, at
    η = 0 and 1, with JAX's draws replayed as injected noise (the initial
    draw from split(rng)[1], then one a step from split(rng, S)): through a
    small closed-form denoiser (tests/test_torch_port_sr3.py's) in every
    case, and through a tiny UNet (inner 8, mults (1, 2), attention at 8²,
    16² images) unconditional DDPM at η = 0 (the SR3 chain through a UNet is
    held by tests/test_torch_port_sr_accelerators.py's cached DDIM at
    interval 1, the uncached chain bit for bit);
  * η = 1 over the full sequence against the port's own `p_sample_loop` on
    the same noise.

Tolerance: max abs ≤ 1e-4·max|ref| + 1e-5 (f32 both sides; the UNet's sums
and the coefficients' products in another order). Each JAX chain is jitted
once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import ddim as jax_ddim
from diffsplitting_tpu_torch.diffusion import ddim

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_sr3 import (C, chain_noise, flax_and_port, jax_denoiser, processes,
                                       torch_denoiser)

T, S, B = 8, 3, 2
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-3, "linear_end": 0.2}
CASES = [(w, c, e) for w in ("sr3", "ddpm") for c in (True, False) for e in (0.0, 1.0)]
IDS = [f"{w}_{'cond' if c else 'sample'}_eta{e:g}" for w, c, e in CASES]
UNET_CASES = [("ddpm", False, 0.0)]


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, err


def procs(which, cond):
    from diffsplitting_tpu.diffusion import build_ddpm_schedule as jax_schedule
    from diffsplitting_tpu_torch.diffusion import build_ddpm_schedule

    jp, tp, _, _ = processes(which, cond)
    return jp, tp, jax_schedule(SCHED), build_ddpm_schedule(SCHED)


def jax_t_cond(which, js):
    """The conditioning JAX's serving passes: SR3's noise level, else None
    (raw t)."""
    if which != "sr3":
        return None
    levels = np.asarray(js.sqrt_alphas_cumprod_prev)
    return lambda t: levels[t + 1]


def condition(seed=7):
    return np.random.default_rng(seed).uniform(-1, 1, size=(B, 16, 16, C)).astype(np.float32)


def jax_ddim_chain(which, cond, eta, denoise, steps=S):
    jp, _, js, _ = procs(which, cond)
    rng = jax.random.PRNGKey(21)
    x_in = jnp.asarray(condition()) if cond else (B, 16, 16, C)
    run = jax.jit(lambda r: jax_ddim.ddim_sample_loop(
        jp, denoise, js, r, x_in, steps=steps, eta=eta, t_cond=jax_t_cond(which, js)))
    return rng, np.asarray(run(rng))


@pytest.mark.parametrize("T_,steps", [(8, 1), (8, 3), (8, 8), (8, 13), (2000, 250), (2000, 50)])
def test_ddim_timesteps_match_jax(T_, steps):
    got = ddim.ddim_timesteps(T_, steps)
    np.testing.assert_array_equal(got, jax_ddim.ddim_timesteps(T_, steps))
    assert got[0] == T_ - 1 and got[-1] == 0 or len(got) == 1


@pytest.mark.parametrize("steps,eta", [(1, 1.0), (3, 0.0), (3, 0.5), (8, 1.0), (12, 1.0)])
def test_ddim_coefficients_match_jax(steps, eta):
    _, _, js, ts = procs("ddpm", True)
    got = ddim.ddim_coefficients(ts, steps, eta)
    want = jax_ddim.ddim_coefficients(js, steps, eta)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_closed_form_chains():
    return {case: jax_ddim_chain(*case, jax_denoiser) for case in CASES}


@pytest.mark.parametrize("which,cond,eta", CASES, ids=IDS)
def test_ddim_sample_loop_matches_jax(which, cond, eta, jax_closed_form_chains):
    rng, want = jax_closed_form_chains[(which, cond, eta)]
    _, tp, _, ts = procs(which, cond)
    noise = chain_noise(rng, (B, 16, 16, C), len(ddim.ddim_timesteps(T, S)))
    x_in = torch.from_numpy(condition()) if cond else (B, 16, 16, C)
    got = ddim.ddim_sample_loop(tp, torch_denoiser, ts, x_in, S, eta, noise=noise)
    close(got, want)


@pytest.fixture(scope="module")
def unets():
    """(flax net, params, port UNet) of each UNET_CASES model: noise-level
    conditioning for SR3, time for DDPM; 6 input channels when conditional."""
    out = {}
    for which, cond, _ in UNET_CASES:
        out[which] = flax_and_port("noise_level" if which == "sr3" else "time",
                                   in_channel=2 * C if cond else C, seed=3)
    return out


@pytest.mark.parametrize("which,cond,eta", UNET_CASES, ids=["ddpm_sample_eta0"])
def test_ddim_through_a_unet_matches_jax(which, cond, eta, unets):
    net, params, port = unets[which]
    rng, want = jax_ddim_chain(which, cond, eta, lambda x, t: net.apply({"params": params}, x, t))
    _, tp, _, ts = procs(which, cond)
    noise = chain_noise(rng, (B, 16, 16, C), S)
    x_in = torch.from_numpy(condition()) if cond else (B, 16, 16, C)
    got = ddim.ddim_sample_loop(tp, port, ts, x_in, S, eta, noise=noise)
    assert torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
def test_eta1_over_the_full_sequence_is_the_exact_chain(which):
    """σ at η = 1 over all T steps is the posterior's standard deviation, so
    the chain is `p_sample_loop`'s, to rounding, on the same draws."""
    _, tp, _, ts = procs(which, True)
    noise = chain_noise(jax.random.PRNGKey(5), (B, 16, 16, C), T)
    x = torch.from_numpy(condition(8))
    want = tp.p_sample_loop(torch_denoiser, ts, x, noise=noise)
    close(ddim.ddim_sample_loop(tp, torch_denoiser, ts, x, T, 1.0, noise=noise), want)
    # and from one generator: DDIM draws as the exact chain draws
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    close(ddim.ddim_sample_loop(tp, torch_denoiser, ts, x, T, 1.0, generator=g[0]),
          tp.p_sample_loop(torch_denoiser, ts, x, generator=g[1]))


def test_step_conditioning_is_each_process_s():
    """SR3 sees √ᾱ_{t+1} (`SR3Process.noise_level`), DDPM raw t."""
    ts_ = np.array([7, 3, 0])
    _, sr3, _, sched = procs("sr3", True)
    got = ddim.step_conditioning(sr3, sched, ts_)
    want = [sr3.noise_level(sched, int(t), 1, torch.float32).item() for t in ts_]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    _, ddpm, _, _ = procs("ddpm", True)
    np.testing.assert_array_equal(ddim.step_conditioning(ddpm, sched, ts_), ts_.astype(np.float32))


def test_noise_contract():
    """S + 1 injected tensors, even at η = 0; fewer raise."""
    _, tp, _, ts = procs("ddpm", False)
    noise = [torch.zeros(B, 16, 16, C)] * S
    with pytest.raises(ValueError, match=f"need {S + 1}"):
        ddim.ddim_sample_loop(tp, torch_denoiser, ts, (B, 16, 16, C), S, 0.0, noise=noise)
    with pytest.raises(ValueError, match="at least one"):
        ddim.ddim_timesteps(T, 0)
