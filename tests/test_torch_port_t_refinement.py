"""The port's PSNR-based t-refinement against the JAX package's, on the CPU.

A tiny joint-InDI pair of UNets (tests/test_trainer.py `tiny_opt`'s: inner
8, 4 groups, mults (1, 2), 16² patches) and a tiny TimePredictor, with the JAX
weights carried across by `state_dict_from_jax` /
`time_predictor_state_dict_from_jax`. Torch cannot replay threefry, so the
port is handed the one-step noise JAX draws: one key a direction, split as
diffsplitting_tpu/diffusion/indi.py `inference` splits it
(tests/test_torch_port_diffusion.py `replay_noise`), the same draw for every
sample. Tolerances:

  * `get_channel_estimates`: the classifier's t and both channel estimates
    within 1e-5 (max abs);
  * the PSNR grid against JAX's remix loop on JAX's estimates: within 1e-4
    dB; per-sample and consensus t: equal;
  * the workflow's report rows (`scripts/t_refinement_workflow.py` of both
    packages on one checkpoint written by the port, noise_mode 'none' so
    neither side draws, the constant 0.5 classifier as without
    `--time-resume`): t values equal, PSNRs within 1e-4 dB.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.models import TimePredictor as JaxTimePredictor
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu.models import UNet as JaxUNet
from diffsplitting_tpu.train import trainer as jax_trainer
from diffsplitting_tpu.utils import t_refinement as jax_tref
from diffsplitting_tpu.utils.psnr import RangeInvariantPsnr as jax_psnr
from diffsplitting_tpu_torch.models import TimePredictor
from diffsplitting_tpu_torch.scripts import t_refinement_workflow as workflow
from diffsplitting_tpu_torch.serving import define_generator
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.utils import t_refinement as tref
from diffsplitting_tpu_torch.utils.weights import (state_dict_from_jax,
                                                   time_predictor_state_dict_from_jax)

from tests.test_torch_port_data import one_torch_thread, write_tiff  # noqa: F401
from tests.test_torch_port_diffusion import replay_noise
from tests.test_trainer import tiny_opt

ROOT = Path(__file__).resolve().parent.parent
S = 16
TP_KW = dict(in_channel=1, out_channel=1, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
             attn_res=(), res_blocks=1, image_size=S)


def smooth_channels(n, seed=0):
    """Two positive, morphologically distinct (n, S, S) channels."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    ch0 = np.stack([gaussian_filter(rng.normal(size=(S, S)), 2.5) for _ in range(n)])
    ch1 = np.stack([gaussian_filter(rng.normal(size=(S, S)), 0.8) for _ in range(n)])
    ch0 = 200 + 1200 * (ch0 - ch0.min()) / np.ptp(ch0)
    ch1 = 200 + 1200 * (ch1 - ch1.min()) / np.ptp(ch1)
    return ch0.astype(np.float32), ch1.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """A JAX joint-InDI process and its two UNets (one jitted init), a JAX
    classifier, all jitted, and the port's from the same weights."""
    opt = tiny_opt("joint_indi", in_ch=1, out_ch=1, channels=1)
    jproc = JaxJointInDI(image_size=S, channels=1, out_channel=1, conditional=False,
                         num_timesteps=10)
    unet = JaxUNet(in_channel=1, out_channel=1, inner_channel=8, norm_groups=4,
                   channel_mults=(1, 2), attn_res=(), res_blocks=1, image_size=S)
    init = jax.jit(unet.init)
    params = {role: jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(i), jnp.zeros((1, S, S, 1)), jnp.zeros((1,)))["params"])
        for i, role in enumerate(("net_ch1", "net_ch2"))}
    params["extra"] = jax.tree_util.tree_map(np.asarray, JaxJointInDI.init_extra_params())
    proc, nets = define_generator(opt)
    nets.load_state_dict(state_dict_from_jax("joint_indi", params, opt["model"]["unet"]))
    nets.eval()
    jtp = JaxTimePredictor(dropout=0.0, **TP_KW)
    tp_params = jax.tree_util.tree_map(np.asarray, jax.jit(jtp.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, S, S, 1)))["params"])
    tp = TimePredictor(dropout=0.2, **TP_KW)
    tp.load_state_dict(time_predictor_state_dict_from_jax(tp_params, opt["model"]["unet"]))
    tp.eval()

    def jax_net(role):
        return jax.jit(lambda x, t: unet.apply({"params": params[role]}, x, t))

    def port_net(net):
        return lambda x, t: net(x, t)

    return dict(jproc=jproc, proc=proc,
                jax_fns=(jax_net("net_ch1"), jax_net("net_ch2"),
                         jax.jit(lambda x: jtp.apply({"params": tp_params}, x))),
                port_fns=(port_net(nets.indi1.denoise_fn), port_net(nets.indi2.denoise_fn),
                          torch.no_grad()(tp)))


def mixture(t_true=0.35, n=2):
    ch0, ch1 = smooth_channels(n)
    ch0 = (ch0 - ch0.mean()) / ch0.std()
    ch1 = (ch1 - ch1.mean()) / ch1.std()
    return (t_true * ch0 + (1 - t_true) * ch1)[..., None].astype(np.float32)


def replayed(rng):
    r1, r2 = jax.random.split(rng)
    return replay_noise(r1, (1, S, S, 1), 1), replay_noise(r2, (1, S, S, 1), 1)


def test_channel_estimates_and_psnr_grid_match_jax(models):
    jproc, proc = models["jproc"], models["proc"]
    inp = mixture()
    rng = jax.random.PRNGKey(5)
    jd1, jd2, jclf = models["jax_fns"]
    pd1, pd2, pclf = models["port_fns"]
    want1, want2, want_t = jax_tref.get_channel_estimates(
        jnp.asarray(inp), jproc.indi1, jproc.indi2, jd1, jd2, jclf, rng)
    got1, got2, got_t = tref.get_channel_estimates(
        torch.from_numpy(inp), proc.indi1, proc.indi2, pd1, pd2, pclf,
        noise=replayed(rng))
    assert np.all((want_t > 0.05) & (want_t < 0.95))  # start times inside (0, 1)
    assert np.abs(got_t - want_t).max() <= 1e-5
    assert got1.shape == want1.shape == got2.shape == (2, S, S, 1)
    assert np.abs(got1 - want1).max() <= 1e-5 and np.abs(got2 - want2).max() <= 1e-5

    # the grid, as JAX's estimate_time_using_PSNR loops over it
    t_list = np.arange(0, 1.0, 0.05)
    want_m = np.stack([np.asarray(jax_psnr(inp[..., 0], want1[..., 0] * t
                                           + want2[..., 0] * (1 - t))) for t in t_list])
    got_t_list, got_m = tref.psnr_grid(torch.from_numpy(inp), got1, got2)
    np.testing.assert_array_equal(got_t_list, t_list)
    assert got_m.shape == want_m.shape == (20, 2)
    assert np.abs(got_m - want_m).max() <= 1e-4

    want_ps, want_c = jax_tref.estimate_time_using_PSNR(
        jnp.asarray(inp), jproc.indi1, jproc.indi2, jd1, jd2, jclf, rng=rng)
    times = {}
    got_ps, got_c = tref.estimate_time_using_PSNR(
        torch.from_numpy(inp), proc.indi1, proc.indi2, pd1, pd2, pclf,
        noise=replayed(rng), times=times)
    np.testing.assert_array_equal(got_ps, want_ps)
    assert got_c == want_c
    assert set(times) == {"classifier", "one_step", "psnr_grid"}


def test_one_step_noise_is_one_draw_a_direction_for_every_sample(models):
    """From a generator: indi_1's two draws, then indi_2's, each shaped for
    one sample and reused for all of them (JAX reuses one key a
    direction)."""
    inp = torch.from_numpy(mixture(n=2))
    seen = []

    def spy(indi):
        real = indi.inference

        def inference(fn, x, n, t0, noise=None):
            seen.append([t.clone() for t in noise])
            return real(fn, x, n, t0, noise=noise)
        return inference

    pd1, pd2, pclf = models["port_fns"]
    indi1, indi2 = models["proc"].indi1, models["proc"].indi2
    g = torch.Generator().manual_seed(4)
    indi1.inference, indi2.inference = spy(indi1), spy(indi2)
    try:
        tref.get_channel_estimates(inp, indi1, indi2, pd1, pd2, pclf, generator=g)
    finally:
        del indi1.inference, indi2.inference  # back to the class's method
    g = torch.Generator().manual_seed(4)
    want = [torch.randn(1, S, S, 1, generator=g) for _ in range(4)]
    assert len(seen) == 4  # (indi1, indi2) for each of the 2 samples
    for i, draws in enumerate(seen):
        off = 0 if i % 2 == 0 else 2
        assert all(torch.equal(d, w) for d, w in zip(draws, want[off: off + 2]))


def test_workflow_report_rows_match_jax(tmp_path, monkeypatch):
    ch0, ch1 = smooth_channels(4, seed=1)
    paths = {}
    for c, ch in (("ch0", ch0), ("ch1", ch1)):
        paths[c] = str(tmp_path / f"val_{c}.tif")
        write_tiff(paths[c], list(ch.astype(np.uint16)))
    opt = tiny_opt("joint_indi", tmp_path=tmp_path / "ckpt", in_ch=1, out_ch=1, channels=1)
    opt["model"]["indi"] = {"noise_mode": "none"}
    opt["datasets"] = {"patch_size": S, "max_qval": 1.0, "channel_weights": [1, 1],
                       "val": {"name": "Hagen", "datapath": paths}}
    cfg = tmp_path / "joint.json"
    cfg.write_text(json.dumps(opt))
    # a joint model trained by the port for 20 steps on these frames, so that
    # the PSNR grid's consensus lies inside (0, 1): at its edge 0 the refined
    # start puts indi_2 at t = 0, where both packages' steps divide 0 by 0
    m = DiffusionModel(opt, device="cpu", seed=0)
    c0, c1 = workflow.load_normalized_channels(opt, patch=S)
    m.feed_data({"target": np.stack([c0, c1], axis=-1).astype(np.float32)})
    for _ in range(20):
        m.optimize_parameters()
    m.save_network(1, 20)
    prefix = str(tmp_path / "ckpt" / "I20_E1")

    args = ["-c", str(cfg), "--resume", prefix, "--t-true", "0.35",
            "--num_steps", "4", "--batch", "2"]
    got = workflow.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])

    spec = importlib.util.spec_from_file_location(
        "jax_t_refinement_workflow", ROOT / "scripts" / "t_refinement_workflow.py")
    jax_workflow = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_workflow)
    monkeypatch.setattr(sys, "argv", ["t_refinement_workflow.py", *args,
                                      "--out", str(tmp_path / "jax.json")])
    # the JAX model's initial weights are replaced by the checkpoint's: draw
    # them through one jitted init instead of ~300 eager compiles (~10 s)
    monkeypatch.setattr(jax_trainer, "init_on_host",
                        lambda fn, *a, **k: jax.jit(fn)(*a, **k))
    jax_workflow.main()
    want = json.loads((tmp_path / "jax.json").read_text())

    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"seconds"}
        for k in ("t_true", "classifier_t", "per_sample_t_mean", "consensus_t",
                  "refined_t_start"):
            assert g[k] == pytest.approx(w[k], abs=1e-12), k
        for k in ("psnr_refined_ch0", "psnr_refined_ch1", "psnr_naive_ch0", "psnr_naive_ch1"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g[k], w[k])
        assert g["classifier_t"] == 0.5
        assert set(g["seconds"]) == {"classifier", "one_step", "psnr_grid", "joint_refined",
                                     "joint_naive"}
