"""The port's train step against the JAX package's `DiffusionModel`.

tests/test_trainer.py's `tiny_opt` models (inner 8, 4 groups, mults (1, 2),
16² patches, so the mid block attends at N = 64, D = 16), batch 8, Adam at
lr 1e-3. Both sides start from the same weights, carried across by
`state_dict_from_jax`. Torch cannot replay threefry, so the port is handed
the t and noise that the JAX step draws: its key is
fold_in(base_rng, 0x5EED + counter), split into (dropout key, process key)
(train/trainer.py:391-404); joint_indi splits the process key into one key a
net (joint_indi.py:100); each net's key splits into (t key, noise key)
(indi.py:139).

Tolerances (f32 on both sides; the convolutions and sums run in another
order):
  * loss and pre-clip grad_norm: relative 2e-6;
  * every gradient: max abs error <= 2e-5 · max|g| of its tensor;
  * after one step, each parameter's change: within 1e-3·lr where
    |g| > 1e-3·max|g| of its tensor. Adam's first update is about
    lr·g/(|g| + eps), so an element whose gradient is near zero can move by
    anything up to ±lr on a rounding difference: those elements are exempt
    and held only to 2·lr;
  * after three steps every parameter within 3e-2·lr, except the elements
    exempted at the first step, held to 6·lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.train.trainer import DiffusionModel as JaxModel
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_trainer import synth_batch, tiny_opt

LR = 1e-3
KW = {"indi": dict(in_ch=2, out_ch=2), "joint_indi": dict(in_ch=1, out_ch=1, channels=1)}


def jax_draws(jm, batch, counter):
    """Each net's (t, noise), as the JAX step `counter` draws them."""
    rng = jax.random.fold_in(jm.base_rng, 0x5EED + counter)
    _, p_rng = jax.random.split(rng)
    target = batch["target"]
    b, T = target.shape[0], jm.current_T
    if jm.which == "joint_indi":
        keys = jax.random.split(p_rng)
        procs, shape = (jm.process.indi1, jm.process.indi2), target[..., 0:1].shape
    else:
        keys, procs, shape = [p_rng], [jm.process], target.shape
    out = []
    for key, proc in zip(keys, procs):
        t_rng, n_rng = jax.random.split(key)
        out.append((torch.from_numpy(np.array(proc.sample_t(t_rng, b, T))),
                    torch.from_numpy(np.array(jax.random.normal(n_rng, shape, jnp.float32)))))
    return out


def jax_loss_and_grads(jm, batch, counter):
    """The JAX step's loss and gradients (its loss_fn, trainer.py:391-404)."""
    proc = jm.process

    def loss_fn(params):
        rng = jax.random.fold_in(jm.base_rng, 0x5EED + counter)
        d_rng, p_rng = jax.random.split(rng)
        if jm.which == "joint_indi":
            r1, r2 = jax.random.split(d_rng)
            d1 = lambda x, t: jm._apply("net_ch1", params, x, t, train=True, rng=r1)  # noqa: E731
            d2 = lambda x, t: jm._apply("net_ch2", params, x, t, train=True, rng=r2)  # noqa: E731
            return proc.p_losses(d1, d2, p_rng, batch, num_timesteps=jm.current_T)[0]
        d = lambda x, t: jm._apply("net", params, x, t, train=True, rng=d_rng)  # noqa: E731
        return proc.p_losses(d, p_rng, batch, num_timesteps=jm.current_T)

    return jax.jit(jax.value_and_grad(loss_fn))(jm.params)


def to_port(jm, tree):
    """A JAX params-shaped tree in the port's state-dict layout."""
    return state_dict_from_jax(jm.which, jax.tree_util.tree_map(np.asarray, tree),
                               jm.opt["model"]["unet"])


def build_pair(opt, seed=0):
    jm = JaxModel(opt, seed=seed, use_mesh=False)
    port = DiffusionModel(opt, device="cpu", seed=seed, state_dict=to_port(jm, jm.params))
    return jm, port


def step_both(jm, port, batch):
    draws = jax_draws(jm, batch, jm._rng_counter + 1)
    jm.feed_data(batch)
    jm.optimize_parameters()
    port.feed_data(batch)
    port.optimize_parameters(draws)
    return jm.get_current_log(), port.get_current_log()


def assert_logs_match(jlog, plog):
    assert set(jlog) == set(plog)
    for k in jlog:
        np.testing.assert_allclose(plog[k], jlog[k], rtol=2e-6, atol=1e-7, err_msg=k)


def params_of(port):
    return {k: v.detach().numpy().copy() for k, v in port.nets.named_parameters()}


@pytest.mark.parametrize("which", ["indi", "joint_indi"])
def test_one_and_three_steps_match_jax(which):
    opt = tiny_opt(which, **KW[which])
    jm, port = build_pair(opt)
    batch = synth_batch(out_ch=2)
    start = params_of(port)
    loss, grads = jax_loss_and_grads(jm, {k: jnp.asarray(v) for k, v in batch.items()}, 1)
    grads = to_port(jm, grads)

    jlog, plog = step_both(jm, port, batch)
    assert_logs_match(jlog, plog)
    np.testing.assert_allclose(plog["l_pix"], float(loss), rtol=2e-6)
    if which == "joint_indi":
        assert set(plog) == {"l_pix", "loss_splitting", "alpha", "offset", "scale", "grad_norm"}
        assert plog["alpha"] == 0.5 and plog["scale"] == 1.0

    exempt = {}
    after = to_port(jm, jm.params)
    for name, p in port.nets.named_parameters():
        want_g = grads[name].numpy()
        if name in ("alpha_param", "offset_param", "scale_param"):
            assert p.grad is None and not want_g.any()  # unused by the loss
            np.testing.assert_array_equal(p.detach().numpy(), start[name])
            continue
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

    # serving from the trained weights, as the JAX model serves after a
    # switch to the val schedule (T = 4)
    port.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    port.feed_data(synth_batch(b=1))
    out = port.test()
    assert out.shape == (1, 16, 16, 2) and torch.isfinite(out).all()
