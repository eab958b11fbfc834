"""The port's InDI / joint-InDI training pieces against the JAX processes,
and the trainer's refusals.

`sample_t`: torch cannot replay threefry, so the draws are compared as
distributions on 20,000 draws at T = 10: the same support, and the share of
draws snapped to the maximum within 4σ of 1 − 1/(a+1) (plus, for the
full-translation variant, the 1/(T−1) chance that the uniform draw is T/2
already).

`p_losses`: the JAX process's own t and noise, drawn from its key in its
order (indi.py:139: split into t key and noise key; joint_indi.py:100: one
key a net, net 1's first), are injected into the port; both sides use the
same simple denoiser, so the comparison is of the processes alone. Tolerance
relative 1e-6 (f32 elementwise, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import InDIProcess as JaxInDI
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu_torch.diffusion import InDIProcess, JointInDIProcess
from diffsplitting_tpu_torch.train import DiffusionModel

from tests.test_trainer import synth_batch, tiny_opt

T = 10
DRAWS = 20_000
SAMPLING = [("uniform", "base"), ("uniform_in_range", "base"), ("linear_ramp", "base"),
            ("quadratic_ramp", "base"), ("linear_indi", "base"), ("linear_indi", "custom_t"),
            ("linear_indi", "full_translation")]


@pytest.mark.parametrize("a", [1.0, 3.0])
@pytest.mark.parametrize("mode,variant", SAMPLING)
def test_sample_t_support_and_snap_share(mode, variant, a):
    kw = dict(t_sampling_mode=mode, linear_indi_a=a, t_variant=variant)
    want = np.asarray(JaxInDI(image_size=16, conditional=False, **kw).sample_t(
        jax.random.PRNGKey(0), DRAWS, T))
    got = InDIProcess(**kw).sample_t(DRAWS, T, torch.Generator().manual_seed(0)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert set(np.unique(got)) == set(np.unique(want))
    if mode != "linear_indi":
        return
    maxv = T if variant == "base" else T // 2
    p = 1 - 1 / (a + 1)
    if variant == "full_translation":
        p += (1 - p) / (T - 1)
    share = np.mean(got == np.float32(maxv / T))
    assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / DRAWS)


def test_joint_variants_need_an_even_t():
    with pytest.raises(ValueError, match="even"):
        InDIProcess(t_variant="custom_t").sample_t(4, 9)


def _denoise_jax(x, t):
    return jnp.tanh(x) * 0.9 + t[:, None, None, None] * 0.1


def _denoise_torch(x, t):
    return torch.tanh(x) * 0.9 + t[:, None, None, None] * 0.1


def _draw(rng, b, shape, proc):
    t_rng, n_rng = jax.random.split(rng)
    return (torch.from_numpy(np.array(proc.sample_t(t_rng, b, T))),
            torch.from_numpy(np.array(jax.random.normal(n_rng, shape, jnp.float32))))


@pytest.mark.parametrize("loss_type,reduction", [("l1", "mean"), ("l1", "sum"), ("l2", "mean"),
                                                 ("l2", "sum")])
def test_indi_p_losses_matches_jax(loss_type, reduction):
    batch = synth_batch(b=4, s=8, out_ch=2, seed=3)
    kw = dict(loss_type=loss_type, lr_reduction=reduction, out_channel=2, e=0.05,
              num_timesteps=T)
    jp = JaxInDI(image_size=8, conditional=False, **kw)
    rng = jax.random.PRNGKey(4)
    want = float(jp.p_losses(_denoise_jax, rng, {k: jnp.asarray(v) for k, v in batch.items()}))
    t, noise = _draw(rng, 4, batch["target"].shape, jp)
    got = InDIProcess(**kw).p_losses(_denoise_torch,
                                     {k: torch.from_numpy(v) for k, v in batch.items()},
                                     t_float=t, noise=noise)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("full_translation", [False, True])
def test_joint_indi_p_losses_matches_jax(full_translation):
    batch = synth_batch(b=4, s=8, out_ch=2, seed=5)
    kw = dict(loss_type="l1", lr_reduction="mean", out_channel=1, e=0.01, num_timesteps=T,
              w_input_loss=0.1, allow_full_translation=full_translation)
    jp = JaxJointInDI(image_size=8, conditional=False, **kw)
    rng = jax.random.PRNGKey(6)
    want, want_logs = jp.p_losses(_denoise_jax, lambda x, t: -_denoise_jax(x, t), rng,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    shape = batch["target"][..., 0:1].shape
    r1, r2 = jax.random.split(rng)
    draws = (_draw(r1, 4, shape, jp.indi1), _draw(r2, 4, shape, jp.indi2))
    port = JointInDIProcess(**kw)
    assert port.indi1.t_variant == ("full_translation" if full_translation else "custom_t")
    got, logs = port.p_losses(_denoise_torch, lambda x, t: -_denoise_torch(x, t),
                              {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(logs["loss_splitting"]),
                               float(want_logs["loss_splitting"]), rtol=1e-6)


def test_indi_refuses_a_conditional_bridge():
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(b=2, s=8).items()}
    with pytest.raises(ValueError, match="unconditional"):
        InDIProcess(conditional=True).p_losses(_denoise_torch, batch, T)


@pytest.mark.parametrize("edit,error,match", [
    (lambda o: o["model"]["unet"].update(dropout=1.0), ValueError, "dropout"),
    (lambda o: o["model"].update(finetune_norm=True), ValueError, "finetune_norm"),
    # bfloat16 trains (models/precision.py); a dtype the JAX package does
    # not take is refused
    (lambda o: o["model"].update(compute_dtype="float16"), NotImplementedError,
     "compute_dtype"),
    # W8A8 serving (ROADMAP item 1g) is refused for every family, indi too
    (lambda o: o["model"].update(quant={"bits": 8}), NotImplementedError, "item 1g"),
])
def test_trainer_refusals(edit, error, match):
    opt = tiny_opt("indi", in_ch=2, out_ch=2)
    edit(opt)
    with pytest.raises(error, match=match):
        DiffusionModel(opt, device="cpu")


def test_trainer_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = tiny_opt("indi", in_ch=2, out_ch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionModel(opt)
    assert DiffusionModel(opt, device="cpu").device.type == "cpu"


def test_trainer_steps_and_serves_on_the_cpu_and_keeps_both_step_counts():
    """Train T (10) for the t grid, serving N (4) for SplittingModel; the EMA,
    when on, is what test() serves."""
    opt = tiny_opt("joint_indi", in_ch=1, out_ch=1, channels=1)
    opt["train"]["ema_scheduler"] = {"enabled": True, "step_start_ema": 1, "ema_decay": 0.5}
    m = DiffusionModel(opt, device="cpu", seed=1)
    assert (m.process.num_timesteps, m.process.val_num_timesteps, m.current_T) == (10, 4, 10)
    m.feed_data(synth_batch(b=2, out_ch=2))
    m.optimize_parameters()
    logs = m.get_current_log()
    assert np.isfinite(logs["l_pix"]) and logs["grad_norm"] > 0
    p = m.nets.indi1.denoise_fn.final_conv.block[3].bias
    e = m.ema_nets.indi1.denoise_fn.final_conv.block[3].bias
    assert not torch.equal(p, e)  # decayed at step 1 >= step_start_ema
    m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    m.feed_data(synth_batch(b=1))
    out = m.test()
    assert out.shape == (1, 16, 16, 2) and m._server.nets is m.ema_nets
