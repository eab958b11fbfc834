"""The port's checkpoint pair (`train/checkpoints.py`, `DiffusionModel.save_network`
and `load_network`) across frameworks and across a stop.

tests/test_trainer.py's `tiny_opt` models (inner 8, 4 groups, mults (1, 2),
16² inputs), on the CPU.

  * JAX `export_torch` -> the port's `load_network`, and the port's
    `_gen.pth` -> the JAX `load_network` (its torch import): the same UNet
    forwards on the same input within 1e-5 of the output's scale (f32,
    convolutions summed in another order).
  * A fresh model starts as JAX's does: zero biases, orthogonal kernels.
  * Save -> resume -> one step equals one step of a model that never
    stopped, bit for bit: parameters, Adam state, EMA, counters, the
    accumulation buffer and the t/noise generator all come back, and the
    CPU's arithmetic is deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.train.trainer import DiffusionModel as JaxModel
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.train.checkpoints import resolve_checkpoint
from diffsplitting_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_trainer import synth_batch, tiny_opt
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse)

KW = {"indi": dict(in_ch=2, out_ch=2), "joint_indi": dict(in_ch=1, out_ch=1, channels=1)}
ROLES = {"indi": [("net", "denoise_fn")],
         "joint_indi": [("net_ch1", "indi1.denoise_fn"), ("net_ch2", "indi2.denoise_fn")]}


def assert_forwards_match(jm, port):
    rng = np.random.default_rng(9)
    in_ch = port.opt["model"]["unet"]["in_channel"]
    x = rng.normal(size=(2, 16, 16, in_ch)).astype(np.float32)
    t = np.array([0.25, 0.75], np.float32)
    for role, path in ROLES[port.which]:
        want = np.asarray(jm._apply(role, jm.params, jnp.asarray(x), jnp.asarray(t)))
        net = port.nets.get_submodule(path)
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0), role


@pytest.mark.parametrize("which", ["indi", "joint_indi"])
def test_jax_export_loads_into_the_port(which, tmp_path):
    jm = JaxModel(tiny_opt(which, tmp_path, **KW[which]), seed=3, use_mesh=False)
    jm.export_torch(str(tmp_path / "I7_E2"))
    opt = tiny_opt(which, tmp_path, **KW[which])
    opt["path"]["resume_state"] = str(tmp_path / "I7_E2")  # a prefix with no _opt.pth
    port = DiffusionModel(opt, device="cpu", seed=0)
    assert port.begin_step == port.begin_epoch == 0 and not port.optimizer.state
    assert_forwards_match(jm, port)


@pytest.mark.parametrize("which", ["indi", "joint_indi"])
def test_port_checkpoint_loads_into_jax(which, tmp_path):
    port = DiffusionModel(tiny_opt(which, tmp_path, **KW[which]), device="cpu", seed=4)
    with torch.no_grad():  # the joint scalars too, so the round trip carries them
        for p in port.nets.parameters():
            p.add_(0.01)
    port.save_network(2, 7)
    opt = tiny_opt(which, tmp_path, **KW[which])
    opt["path"]["resume_state"] = str(tmp_path / "I7_E2")
    jm = JaxModel(opt, seed=0, use_mesh=False)
    assert_forwards_match(jm, port)
    if which == "joint_indi":
        for k in ("alpha_param", "offset_param", "scale_param"):
            assert float(jm.params["extra"][k]) == pytest.approx(
                getattr(port.nets, k).item(), abs=1e-7)


def resumable_opt(tmp_path, **train):
    opt = tiny_opt("joint_indi", tmp_path, **KW["joint_indi"])
    opt["train"]["optimizer"].update(accum_steps=2, grad_clip=1.0,
                                     schedule={"type": "cosine", "warmup": 2})
    opt["train"]["ema_scheduler"] = {"enabled": True, "step_start_ema": 2, "ema_decay": 0.9}
    opt["train"].update(train)
    return opt


def state_of(m):
    out = {f"p.{k}": v.detach().clone() for k, v in m.nets.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in m.ema_nets.state_dict().items()})
    for i, st in m.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v).clone() for k, v in st.items()})
    for i, a in enumerate(m._acc or []):
        out[f"acc.{i}"] = a.clone()
    out["generator"] = m.generator.get_state()
    return out


def assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_then_step_equals_an_uninterrupted_step(tmp_path):
    batches = [synth_batch(b=2, out_ch=2, seed=s) for s in range(4)]
    run = DiffusionModel(resumable_opt(tmp_path), device="cpu", seed=1)
    for b in batches[:3]:  # 3 micro-steps: one update and one accumulated micro-step
        run.feed_data(b)
        run.optimize_parameters()
    assert run._mini_step == 1 and run.updates == 1
    run.save_network(1, 3)

    opt = resumable_opt(tmp_path)
    opt["path"]["resume_state"] = str(tmp_path / "I3_E1")
    resumed = DiffusionModel(opt, device="cpu", seed=2)  # another seed: all must come back
    assert (resumed.begin_step, resumed.begin_epoch) == (3, 1)
    assert (resumed.global_step, resumed.updates, resumed._mini_step) == (3, 1, 1)
    assert_states_equal(state_of(resumed), state_of(run))

    for m in (run, resumed):
        m.feed_data(batches[3])
        m.optimize_parameters()  # completes the accumulation: an update
    assert resumed.updates == run.updates == 2
    assert_states_equal(state_of(resumed), state_of(run))
    assert resumed.get_current_log() == run.get_current_log()


def test_weights_only_outside_train_and_for_a_pth(tmp_path):
    run = DiffusionModel(resumable_opt(tmp_path), device="cpu", seed=1)
    run.feed_data(synth_batch(b=2, out_ch=2))
    run.optimize_parameters()
    run.save_network(1, 1)
    weights = {k: v.clone() for k, v in run.nets.state_dict().items()}
    for phase, resume in (("val", "I1_E1"), ("train", "I1_E1_gen.pth")):
        opt = resumable_opt(tmp_path)
        opt["phase"] = phase
        opt["path"]["resume_state"] = str(tmp_path / resume)
        m = DiffusionModel(opt, device="cpu", seed=2)
        assert all(torch.equal(v, weights[k]) for k, v in m.nets.state_dict().items())
        # the EMA starts from the loaded weights, the rest from scratch
        assert all(torch.equal(v, weights[k]) for k, v in m.ema_nets.state_dict().items())
        assert m.begin_step == m.global_step == m.updates == 0 and not m.optimizer.state


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="I5_E1_gen.pth"):
        resolve_checkpoint(str(tmp_path / "I5_E1"))
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(str(tmp_path / "nothing.pth"))


@pytest.mark.parametrize("which", ["indi", "joint_indi"])
def test_fresh_weights_are_drawn_as_jax_draws_them(which):
    """A fresh model's weights follow the JAX package's initializers: every
    tensor JAX starts at zeros or ones (conv and linear biases, GroupNorm)
    starts there in the port too, and every matrix or kernel is orthogonal
    (flattened to (out, fan_in), orthonormal rows or columns within 1e-5)."""
    opt = tiny_opt(which, **KW[which])
    jm = JaxModel(opt, seed=0, use_mesh=False)
    want = state_dict_from_jax(which, jax.tree_util.tree_map(np.asarray, jm.params),
                               opt["model"]["unet"])
    port = DiffusionModel(opt, device="cpu", seed=0)
    got = dict(port.nets.named_parameters())
    assert set(got) == {k for k in want if not k.endswith(".inv_freq")}  # a buffer
    for name, p in got.items():
        w, p = want[name].numpy(), p.detach().numpy()
        if p.ndim >= 2:
            m = p.reshape(p.shape[0], -1)
            g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            assert np.abs(g - np.eye(len(g))).max() <= 1e-5, name
        else:
            for const in (0.0, 1.0):
                if np.all(w == const):
                    assert np.all(p == const), name
