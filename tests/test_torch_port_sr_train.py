"""The port's ddpm and sr3 train steps against the JAX package's
`DiffusionModel`.

tests/test_trainer.py's `tiny_opt` models (inner 8, 4 groups, mults (1, 2),
16² patches, mid block attention at N = 64), conditional (2 input and 2
target channels, so the UNet takes 4), batch 8, Adam at lr 1e-3, dropout 0.
Both sides start from the same weights, carried across by
`state_dict_from_jax`. The port is handed the draws the JAX step makes: its
key is fold_in(base_rng, 0x5EED + counter), split into (dropout key,
process key) (train/trainer.py:391-407); ddpm splits the process key into
(t key, noise key), t one integer a sample in [0, T) (ddpm.py:245-248); sr3
into (t key, γ key, noise key), t one integer in [1, T] and
γ = √ᾱ_{t-1} + u·(√ᾱ_t − √ᾱ_{t-1}) a sample (sr3.py:161-174).

Tolerances, as tests/test_torch_port_train.py states them (f32 on both
sides; the convolutions and sums run in another order):
  * loss and pre-clip grad_norm: relative 2e-6;
  * every gradient: max abs error <= 2e-5 · max|g| of its tensor (JAX's
    read from its Adam first moment after the first step);
  * after one step, each parameter's change within 1e-3·lr where
    |g| > 1e-3·max|g| of its tensor; Adam's first update moves an element
    whose gradient is near zero by anything up to ±lr on a rounding
    difference, so those elements are exempt and held only to 2·lr;
  * after three steps every parameter within 3e-2·lr, except the elements
    exempted at the first step, held to 6·lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.train import DiffusionModel

from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_train import (LR, assert_logs_match, build_pair, params_of,
                                         to_port)
from tests.test_trainer import synth_batch, tiny_opt


def opt_for(which):
    return tiny_opt(which, conditional=True, in_ch=4, out_ch=2, channels=2)


def jax_keys(jm, counter):
    rng = jax.random.fold_in(jm.base_rng, 0x5EED + counter)
    return jax.random.split(rng)  # (dropout key, process key)


def jax_draws(jm, batch, counter):
    """The (t, noise) of a ddpm step or the (t, γ, noise) of an sr3 step, as
    the JAX step `counter` draws them."""
    _, p_rng = jax_keys(jm, counter)
    target = batch["target"]
    b, sched = target.shape[0], jm.current_sched
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if jm.which == "ddpm":
        t_rng, n_rng = jax.random.split(p_rng)
        t = jax.random.randint(t_rng, (b,), 0, sched.num_timesteps)
        return [(as_t(t), as_t(jax.random.normal(n_rng, target.shape, jnp.float32)))]
    t_rng, g_rng, n_rng = jax.random.split(p_rng, 3)
    t = jax.random.randint(t_rng, (), 1, sched.num_timesteps + 1)
    lo, hi = sched.sqrt_alphas_cumprod_prev[t - 1], sched.sqrt_alphas_cumprod_prev[t]
    gamma = lo + jax.random.uniform(g_rng, (b,), jnp.float32) * (hi - lo)
    return [(int(t), as_t(gamma), as_t(jax.random.normal(n_rng, target.shape, jnp.float32)))]


ADAM_B1 = 0.9  # optax.adam's default; the JAX trainer's tx is bare Adam here


def jax_first_grads(jm):
    """The gradients of the JAX step just taken, the first: Adam's first
    moment after one update is (1 − b1)·g, read from the step's own
    optimizer state rather than from a second jitted loss."""
    adam = jm.opt_state[0]
    assert int(adam.count) == 1
    return jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / (1 - ADAM_B1),
                                  adam.mu)


def step_both(jm, port, batch):
    draws = jax_draws(jm, batch, jm._rng_counter + 1)
    jm.feed_data(batch)
    jm.optimize_parameters()
    port.feed_data(batch)
    port.optimize_parameters(draws)
    return jm.get_current_log(), port.get_current_log()


@pytest.mark.parametrize("which", ["ddpm", "sr3"])
def test_one_and_three_steps_match_jax(which):
    opt = opt_for(which)
    jm, port = build_pair(opt)
    net = port.nets.denoise_fn
    assert isinstance(net, UNet)
    assert net.cond_type == ("noise_level" if which == "sr3" else "time")
    batch = synth_batch(in_ch=2, out_ch=2)
    start = params_of(port)

    jlog, plog = step_both(jm, port, batch)
    assert_logs_match(jlog, plog)  # the loss and grad_norm
    assert set(plog) == {"l_pix", "grad_norm"}
    grads = to_port(jm, jax_first_grads(jm))

    exempt = {}
    after = to_port(jm, jm.params)
    for name, p in port.nets.named_parameters():
        want_g = grads[name].numpy()
        gmax = np.abs(want_g).max()
        assert np.abs(p.grad.numpy() - want_g).max() <= 2e-5 * gmax, name
        moved = np.abs((p.detach().numpy() - start[name]) - (after[name].numpy() - start[name]))
        exempt[name] = np.abs(want_g) <= 1e-3 * gmax
        assert moved[~exempt[name]].max(initial=0) <= 1e-3 * LR, name
        assert moved[exempt[name]].max(initial=0) <= 2 * LR, name

    for _ in range(2):
        jlog, plog = step_both(jm, port, batch)
        assert_logs_match(jlog, plog)
    after = to_port(jm, jm.params)
    for name, p in port.nets.named_parameters():
        diff = np.abs(p.detach().numpy() - after[name].numpy())
        ex = exempt.get(name, np.zeros(diff.shape, bool))
        assert diff[~ex].max(initial=0) <= 3e-2 * LR, name
        assert diff[ex].max(initial=0) <= 6 * LR, name
    assert port.global_step == jm.global_step == 3 and port.updates == 3

    # serving from the trained weights over the val schedule (T = 4): the
    # trajectory (every step a frame) and its last frame; the trainer's nets
    # stay in train mode
    port.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    assert port.current_sched.num_timesteps == 4
    port.feed_data({"input": synth_batch(b=1, in_ch=2)["input"]})
    frames = port.test(continuous=True)
    assert frames.shape == (5, 1, 16, 16, 2) and torch.isfinite(frames).all()
    assert port.nets.training
    vis = port.get_current_visuals()
    assert vis["prediction"].shape == (5, 1, 16, 16, 2) and vis["input"].shape == (1, 16, 16, 2)


def test_unconditional_sample_and_refusals():
    """sample() serves an unconditional model ('SAM' visuals); test() on it,
    sample() on a conditional one and the accelerators of item 1f raise."""
    opt = tiny_opt("sr3", conditional=False, in_ch=2, out_ch=2, channels=2)
    port = DiffusionModel(opt, device="cpu", seed=0)
    port.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    out = port.sample(batch_size=2)
    assert out.shape == (2, 16, 16, 2) and torch.isfinite(out).all()
    assert port.get_current_visuals(sample=True)["SAM"].shape == (2, 16, 16, 2)
    port.feed_data({"input": np.zeros((1, 16, 16, 2), np.float32)})
    with pytest.raises(ValueError, match="sample"):
        port.test()
    # a ddpm / sr3 chain runs the phase's schedule: a step count or a start
    # time, which only indi / joint_indi read, raises instead of being ignored
    cond_sr3 = DiffusionModel(opt_for("sr3"), device="cpu")
    x = np.zeros((1, 16, 16, 2), np.float32)
    with pytest.raises(ValueError, match="set_new_noise_schedule"):
        cond_sr3.inference(x, num_timesteps=3)
    with pytest.raises(ValueError, match="t_float_start"):
        cond_sr3.inference(x, t_float_start=0.5)
    for call in (lambda: port.set_deepcache(2), lambda: port.set_sliding_window(4)):
        with pytest.raises(NotImplementedError, match="item 1f"):
            call()
    cond = opt_for("ddpm")
    cond["model"]["ddim"] = {"steps": 10}
    with pytest.raises(NotImplementedError, match="item 1f"):
        DiffusionModel(cond, device="cpu")
