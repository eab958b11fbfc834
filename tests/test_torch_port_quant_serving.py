"""W8A8 quantized serving through the port's switches, trainer and chains
(serving.AcceleratorSwitches `set_quant` / `model.quant`), on the CPU.

  * InDI's calibration batch (`indi_calib_inputs`) against JAX's trainer
    `_calib_inputs` for both joint-InDI nets, JAX's draw injected (f32 both
    sides: max abs ≤ 1e-6);
  * the switches: the config key and the setter, the quantized nets built
    once per (nets, kind) and dropped by `set_quant`, a train step, an EMA
    update and a load; `set_quant(None)` gives the exact chain back bit for
    bit; only 8 bits;
  * composition: DeepCache at interval 1 bit for bit the W8A8 chain (InDI
    and SR3, its DDIM chain too); W8A8 with DDIM and with the window (τ = 0:
    the W8A8 chain within 1e-4·max + 1e-5, its forward batched W-wide);
    DSP_FUSED=1 serves the W8A8 forward (the fused walk is never entered),
    logged once.
JAX's serving of the same tiny models is held in tests/test_quant_unet.py
and test_quant_deepcache.py; the port's W8A8 forward against JAX's in
tests/test_torch_port_quant.py.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu.train.trainer import DiffusionModel as JaxDiffusionModel
from diffsplitting_tpu_torch.diffusion import JointInDIProcess
from diffsplitting_tpu_torch.models import fused_forward
from diffsplitting_tpu_torch.models.quant_unet import is_quantized, iter_quant_sites
from diffsplitting_tpu_torch.serving import indi_calib_inputs
from diffsplitting_tpu_torch.train import DiffusionModel

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_trainer import synth_batch, tiny_opt

K = 4


def served(m, **kw):
    """The model's chain on its fed input, its draws from seed 0."""
    gen = m._server.generator if m._server is not None else m.sample_generator
    gen.manual_seed(0)
    return m.test(**kw).clone()


def model(which, quant=None, **kw):
    conditional = which == "sr3"
    opt = tiny_opt(which, conditional=conditional, in_ch=2 if conditional else 1,
                   out_ch=1, channels=1)
    if quant is not None:
        opt["model"]["quant"] = quant
    for key, val in kw.items():
        opt["model"][key] = val
    m = DiffusionModel(opt, device="cpu", seed=0)
    m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    m.feed_data({"input": synth_batch(b=2, in_ch=1)["input"]})
    return m


def quant_cache(m):
    return m.switches._quant_nets


def test_indi_calibration_batch_equals_jax():
    kw = dict(out_channel=1, e=0.5, noise_mode="gaussian", num_timesteps=10,
              val_num_timesteps=4)
    jproc = JaxJointInDI(image_size=16, conditional=False, **kw)
    cond = np.random.default_rng(0).normal(size=(2, 16, 16, 1)).astype(np.float32)
    fake = SimpleNamespace(
        quant={"calib": K}, which="joint_indi", process=jproc, data={"input": jnp.asarray(cond)},
        nets={"net_ch1": SimpleNamespace(in_channel=1), "net_ch2": SimpleNamespace(in_channel=1)},
        opt={"model": {"diffusion": {"channels": 1, "image_size": 16}}})
    eps = np.array(jax.random.normal(jax.random.PRNGKey(0xCA11B), (K, 16, 16, 1), jnp.float32))
    port = JointInDIProcess(**kw)
    for role, proc in (("net_ch1", port.indi1), ("net_ch2", port.indi2)):
        want_x, want_t = JaxDiffusionModel._calib_inputs(fake, role, "test")
        x, t = indi_calib_inputs(proc, 1, torch.from_numpy(cond[:1]), K, "cpu", eps)
        assert np.abs(x.numpy() - np.asarray(want_x)).max() <= 1e-6
        np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("which", ["indi", "joint_indi", "sr3"])
def test_set_quant_serves_and_restores_the_exact_chain(which):
    m = model(which)
    exact = served(m)
    m.set_quant(8, calib=K)
    fast = served(m)
    assert fast.shape == exact.shape and torch.isfinite(fast).all()
    assert not torch.equal(fast, exact)
    (key, (sources, nets)), = quant_cache(m).items()
    assert key[0] == "test" and all(is_quantized(n) for n in nets)
    assert [len(list(iter_quant_sites(n))) for n in nets] == [16] * len(nets)
    assert torch.equal(served(m), fast)  # the same quantized nets, cached
    assert quant_cache(m)[key][1] is nets
    m.set_quant(None)
    assert not quant_cache(m) and torch.equal(served(m), exact)
    with pytest.raises(ValueError, match="only 8-bit"):
        m.set_quant(4)


def test_config_key_and_sites_flags():
    m = model("sr3", quant={"bits": 8, "calib": K, "updown": True, "shortcut": True,
                            "attn": True, "clip": 0.9})
    assert m.quant == dict(calib=K, updown=True, shortcut=True, attn=True, clip=0.9)
    served(m)
    (_, (_, (net,))), = quant_cache(m).items()
    kinds = {name.split(".")[-1] for name, _ in iter_quant_sites(net)}
    assert {"qkv", "out", "conv", "res_conv", "3"} == kinds
    with pytest.raises(ValueError, match="only 8-bit"):
        model("indi", quant={"bits": 4})


def test_quantized_nets_dropped_after_train_step_ema_and_load(tmp_path):
    opt = tiny_opt("joint_indi", tmp_path, in_ch=1, out_ch=1, channels=1)
    opt["train"]["ema_scheduler"] = {"enabled": True, "step_start_ema": 1, "ema_decay": 0.5}
    opt["model"]["quant"] = {"bits": 8, "calib": K}
    m = DiffusionModel(opt, device="cpu", seed=1)
    m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    m.feed_data(synth_batch(b=1, in_ch=1))
    before = served(m)
    ((sources, _),) = quant_cache(m).values()
    assert sources[0] is m.ema_nets.indi1.denoise_fn  # the EMA nets serve
    m.feed_data(synth_batch(b=2, out_ch=2, seed=1))
    m.optimize_parameters()
    assert not quant_cache(m)
    m.feed_data(synth_batch(b=1, in_ch=1))
    assert not torch.equal(served(m), before)
    m.save_network(0, 1)
    m.opt["path"]["resume_state"] = str(tmp_path / "I1_E0")
    m.load_network()
    assert not quant_cache(m)


@pytest.mark.parametrize("which", ["joint_indi", "sr3"])
def test_deepcache_interval_1_is_the_w8a8_chain_bit_for_bit(which):
    m = model(which, quant={"bits": 8, "calib": K})
    want = served(m)
    m.set_deepcache(1, 1)
    assert torch.equal(served(m), want)
    if which == "sr3":  # and the respaced chain
        m.set_deepcache(None)
        m.set_ddim(2, 1.0)
        ddim = served(m)
        m.set_deepcache(1, 1)
        assert torch.equal(served(m), ddim)


def test_w8a8_serves_with_ddim_deepcache_and_the_window():
    m = model("sr3", quant={"bits": 8, "calib": K})
    exact = served(m)
    for ddim, dc in (((2, 1.0), None), ((2, 1.0), (2, 1)), (None, (2, 1))):
        m.set_ddim(*(ddim or (None,)))
        m.set_deepcache(*(dc or (None,)))
        out = served(m)
        assert out.shape == exact.shape and torch.isfinite(out).all()
    m.set_ddim(None)
    m.set_deepcache(None)
    m.set_sliding_window(2, 0.0)
    windowed = served(m)
    assert m.last_sliding_sweeps == 4
    assert (windowed - exact).abs().max() <= 1e-4 * exact.abs().max() + 1e-5


def test_indi_window_with_w8a8():
    m = model("joint_indi", quant={"bits": 8, "calib": K})
    exact = served(m)
    m.set_sliding_window(2, 0.0)
    windowed = served(m)
    assert m.last_sliding_sweeps == 2 * 4
    assert (windowed - exact).abs().max() <= 1e-4 * exact.abs().max() + 1e-5


@pytest.mark.parametrize("which", ["joint_indi", "sr3"])
def test_fused_request_serves_the_w8a8_forward(which, monkeypatch, caplog):
    m = model(which, quant={"bits": 8, "calib": K})
    want = served(m)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused walk was entered with W8A8 on")

    monkeypatch.setattr(fused_forward, "fused_unet_forward", refuse)
    monkeypatch.setattr("diffsplitting_tpu_torch.models.forward_utils.fused_unet_forward", refuse)
    monkeypatch.setenv("DSP_FUSED", "1")
    with caplog.at_level(logging.INFO, logger="base"):
        assert torch.equal(served(m), want)
        assert torch.equal(served(m, fused=True), want)
    assert sum("unfused forward" in r.getMessage() for r in caplog.records) == 1
