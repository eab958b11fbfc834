"""The port's training CLI (`diffsplitting_tpu_torch/split.py`) and what it
runs, on the CPU, against the JAX package where it has a counterpart.

  * `split.main`: a 4-iteration train run on small synthetic TIFFs (64²
    frames, patch 32, inner 8, 4 groups) that validates and saves checkpoint
    pairs, a resumed run from a prefix, then `-p val` on the last checkpoint;
    joint-InDI on the device pool (auto-enabled: the stacks fit), indi on the
    host loader. Without a device argument and without CUDA it refuses.
  * `continuous=True` trajectories of the InDI and joint-InDI processes
    against JAX's with the same injected noise: within 1e-5 (f32 in another
    order), at N = 45, so `capture_plan` records every third step and the
    last.
  * `PSNR` and `RangeInvariantPsnr` within 1e-4 dB of JAX's (float64 here,
    float32 in jnp); `calculate_psnr` and `calculate_ssim` within 1e-6.
  * the config parse and its debug shrink: equal to JAX's but for the root.
  * the synthetic quality script, end to end at a tiny size.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffsplitting_tpu.config.loader import parse_config as jax_parse_config
from diffsplitting_tpu.diffusion import InDIProcess as JaxInDI
from diffsplitting_tpu.diffusion import JointInDIProcess as JaxJointInDI
from diffsplitting_tpu.utils import metrics as jax_metrics
from diffsplitting_tpu.utils import psnr as jax_psnr
from diffsplitting_tpu_torch import split
from diffsplitting_tpu_torch.config import parse_config
from diffsplitting_tpu_torch.diffusion import InDIProcess, JointInDIProcess
from diffsplitting_tpu_torch.diffusion.common import capture_plan
from diffsplitting_tpu_torch.scripts import quality_joint_indi_synthetic
from diffsplitting_tpu_torch.utils import metrics, psnr
from diffsplitting_tpu_torch.utils.wandb_logger import WandbLogger

from tests.test_torch_port_diffusion import jax_denoise, replay_noise, torch_denoise
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse)


def write_tiff(path, seed):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 800, (3, 64, 64)).astype(np.uint16)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:])


def write_config(tmp_path, which, **train):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    for split_name, seed in (("train", 0), ("val", 1)):
        for c in (0, 1):
            write_tiff(str(data / f"{split_name}_ch{c}.tif"), seed + 10 * c)
    one = which == "joint_indi"
    cfg = {
        "name": "smoke", "phase": "train",
        "path": {"root": str(tmp_path / "exp"), "log": "logs", "results": "results",
                 "checkpoint": "checkpoint", "resume_state": None},
        "datasets": {
            "upper_clip": False, "patch_size": 32, "max_qval": 1.0, "channel_weights": [1, 1],
            "train": {"name": "Hagen", "batch_size": 4, "use_shuffle": True,
                      "uncorrelated_channels": False,
                      "datapath": {"ch0": str(data / "train_ch0.tif"),
                                   "ch1": str(data / "train_ch1.tif")}},
            "val": {"name": "Hagen", "datapath": {"ch0": str(data / "val_ch0.tif"),
                                                  "ch1": str(data / "val_ch1.tif")}},
        },
        "model": {
            "which_model_G": which, "loss_type": "l1", "lr_reduction": "mean",
            "unet": {"in_channel": 1 if one else 2, "out_channel": 1 if one else 2,
                     "inner_channel": 8, "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": 0},
            "beta_schedule": {"train": {"n_timestep": 10}, "val": {"n_timestep": 2}},
            "diffusion": {"image_size": 32, "channels": 1 if one else 2, "conditional": False},
        },
        "train": {"n_iter": 4, "val_freq": 4, "save_checkpoint_freq": 2, "print_freq": 2,
                  "optimizer": {"type": "adam", "lr": 1e-3}, **train},
        "wandb": {"project": "smoke"},
    }
    p = tmp_path / f"cfg_{which}.json"
    p.write_text(json.dumps(cfg))
    return p, cfg


def checkpoints_of(run):
    d = run["opt"]["path"]["checkpoint"]
    return sorted(f for f in os.listdir(d))


@pytest.mark.parametrize("which,pool", [("joint_indi", None), ("indi", False)])
def test_split_trains_resumes_and_evaluates_on_cpu(tmp_path, which, pool):
    cfg_path, cfg = write_config(tmp_path, which)
    if pool is not None:
        cfg["datasets"]["train"]["device_pool"] = pool
        cfg_path.write_text(json.dumps(cfg))
    run = split.main(["-c", str(cfg_path), "-p", "train", "--device", "cpu"])
    assert run["model"].device.type == "cpu" and run["model"].global_step == 4
    assert len(run["val_psnrs"]) == 1 and math.isfinite(run["val_psnrs"][0])
    assert checkpoints_of(run) == ["I2_E1_gen.pth", "I2_E1_opt.pth",
                                   "I4_E2_gen.pth", "I4_E2_opt.pth"]
    pngs = os.listdir(os.path.join(run["opt"]["path"]["results"], "2"))
    assert len(pngs) == 9  # 3 val items (capped while training) x target/input/pred
    prefix = os.path.join(run["opt"]["path"]["checkpoint"], "I4_E2")

    cfg["path"]["resume_state"] = prefix
    cfg["train"]["n_iter"] = 6
    cfg_path.write_text(json.dumps(cfg))
    resumed = split.main(["-c", str(cfg_path), "--device", "cpu"])
    assert (resumed["model"].begin_step, resumed["model"].global_step) == (4, 6)
    assert checkpoints_of(resumed) == ["I6_E3_gen.pth", "I6_E3_opt.pth"]

    val = split.main(["-c", str(cfg_path), "-p", "val", "--device", "cpu"])
    assert math.isfinite(val["psnr"]) and 0 < val["ssim"] <= 1
    assert len(os.listdir(val["opt"]["path"]["results"])) == 3 * 3 * 4  # 12 grid items


def test_split_refuses_without_cuda(tmp_path, monkeypatch):
    cfg_path, _ = write_config(tmp_path, "indi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        split.main(["-c", str(cfg_path)])
    assert not (tmp_path / "exp").exists()


def test_wandb_is_asked_for_but_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        WandbLogger({"wandb": {"project": "p"}}, "unused", "name")


def test_capture_plan():
    flags, slots = capture_plan(range(7), 3, include_last=True)
    assert flags == [1, 0, 0, 1, 0, 0, 1] and slots == [1, 0, 0, 2, 0, 0, 3]
    assert capture_plan(range(4), 1 | (4 // 20), include_last=True)[0] == [1, 1, 1, 1]


N_CONT = 45
SHAPE = (2, 8, 8, 1)


def test_indi_trajectory_matches_jax():
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    kw = dict(out_channel=2, e=0.05, noise_mode="gaussian", num_timesteps=N_CONT)
    want = np.asarray(JaxInDI(image_size=8, conditional=False, **kw).inference(
        jax_denoise, rng, jnp.asarray(x), continuous=True, num_timesteps=N_CONT,
        t_float_start=0.9))
    noise = replay_noise(rng, SHAPE[:3] + (2,), N_CONT)
    got = InDIProcess(**kw).inference(torch_denoise, torch.from_numpy(x), N_CONT, 0.9,
                                      noise=noise, continuous=True).numpy()
    assert got.shape == want.shape == (1 + 15 + 1, 2, 8, 8, 2)
    assert np.abs(got - want).max() <= 1e-5


def test_joint_indi_trajectory_matches_jax():
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    kw = dict(out_channel=1, e=0.05, noise_mode="gaussian", num_timesteps=N_CONT)
    want = np.asarray(JaxJointInDI(image_size=8, conditional=False, **kw).inference(
        jax_denoise, lambda a, t: -jax_denoise(a, t), rng, jnp.asarray(x), continuous=True,
        num_timesteps=N_CONT, t_float_start=0.5))
    rng1, rng2 = jax.random.split(rng)
    noise = (replay_noise(rng1, SHAPE, N_CONT), replay_noise(rng2, SHAPE, N_CONT))
    got = JointInDIProcess(**kw).inference(
        torch_denoise, lambda a, t: -torch_denoise(a, t), torch.from_numpy(x), N_CONT, 0.5,
        noise=noise, continuous=True).numpy()
    assert got.shape == want.shape == (17, 2, 8, 8, 2)
    assert np.abs(got - want).max() <= 1e-5
    # the last frame is the non-continuous result
    final = JointInDIProcess(**kw).inference(
        torch_denoise, lambda a, t: -torch_denoise(a, t), torch.from_numpy(x), N_CONT, 0.5,
        noise=noise).numpy()
    assert np.array_equal(final, got[-1])


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(100, 1800, (3, 32, 32)).astype(np.float32)
    pred = (gt * 0.9 + rng.normal(0, 40, gt.shape)).astype(np.float32)
    for name in ("PSNR", "RangeInvariantPsnr"):
        got, want = getattr(psnr, name)(gt, pred), getattr(jax_psnr, name)(gt, pred)
        assert got.shape == want.shape == (3,)
        assert np.abs(got - want).max() <= 1e-4, name
    got = psnr.PSNR(gt, pred, range_=1000.0)
    assert np.abs(got - jax_psnr.PSNR(gt, pred, range_=1000.0)).max() <= 1e-4
    g2, p2 = gt.reshape(3, -1).astype(np.float64), pred.reshape(3, -1).astype(np.float64)
    for name in ("fix_range", "fix"):
        got = getattr(psnr, name)(g2, p2)
        want = np.asarray(getattr(jax_psnr, name)(jnp.asarray(g2), jnp.asarray(p2)))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name
    with pytest.raises(ValueError):
        psnr.PSNR(gt[0], pred[0])


def test_image_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 36, 2)).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255).astype(np.uint8)
    assert abs(metrics.calculate_psnr(a, b) - jax_metrics.calculate_psnr(a, b)) <= 1e-6
    assert abs(metrics.calculate_ssim(a, b) - jax_metrics.calculate_ssim(a, b)) <= 1e-6
    assert metrics.calculate_psnr(a, a) == float("inf")
    metrics.save_img(a, str(tmp_path / "port.png"), mode="L")
    jax_metrics.save_img(a, str(tmp_path / "jax.png"), mode="L")
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          np.asarray(Image.open(tmp_path / "jax.png")))


@pytest.mark.parametrize("debug", [False, True])
def test_parse_config_matches_jax(tmp_path, debug):
    cfg_path, _ = write_config(tmp_path, "joint_indi")
    got = parse_config(str(cfg_path), "train", rootdir=str(tmp_path / "port"), debug=debug)
    want = jax_parse_config(str(cfg_path), "train", rootdir=str(tmp_path / "jax"), debug=debug)
    assert got["experiment_name"] == want["experiment_name"]
    port_root, jax_root = got["path"]["experiment_root"], want["path"]["experiment_root"]
    assert os.path.relpath(port_root, tmp_path / "port") == os.path.relpath(jax_root,
                                                                            tmp_path / "jax")
    for k in ("log", "results", "checkpoint"):
        assert os.path.isdir(got["path"][k])
        assert os.path.relpath(got["path"][k], port_root) == os.path.relpath(want["path"][k],
                                                                            jax_root)
    strip = lambda o: {k: v for k, v in o.items() if k != "path"}  # noqa: E731
    assert json.dumps(strip(got), sort_keys=True) == json.dumps(strip(want), sort_keys=True)
    assert (got["train"]["val_freq"] == 2) is debug


def test_quality_script_tiny_run(tmp_path):
    out = quality_joint_indi_synthetic.main(
        ["--iters", "2", "--patch", "32", "--batch", "2", "--frames", "2", "--size", "64",
         "--workdir", str(tmp_path), "--num_steps", "1", "2", "--device", "cpu"])
    assert out["checkpoint"].endswith("I2_E1") and len(out["val_psnrs"]) == 2  # val_freq 1
    assert set(out["metrics"]) == {1, 2}
    assert all(math.isfinite(v) for m in out["metrics"].values() for v in m.values())
    assert json.loads((tmp_path / "metrics.json").read_text())["1"] == out["metrics"][1]


def test_trainer_inference_trajectory_and_visuals(caplog):
    from diffsplitting_tpu_torch.train import create_model

    from tests.test_trainer import synth_batch, tiny_opt

    m = create_model(tiny_opt("joint_indi", in_ch=1, out_ch=1, channels=1), device="cpu")
    x = synth_batch(b=2, in_ch=1)["input"]
    frames = m.inference(x, continuous=True, num_timesteps=3)
    assert frames.shape == (4, 2, 16, 16, 2) and m.current_T == 10  # T restored
    vis = m.get_current_visuals()
    assert set(vis) == {"prediction", "input"} and isinstance(vis["prediction"], np.ndarray)
    assert vis["prediction"].shape == (4, 2, 16, 16, 2) and vis["input"].shape == (2, 16, 16, 1)
    m.feed_data(synth_batch(b=2, in_ch=1, out_ch=2))
    out = m.test()
    assert out.shape == (2, 16, 16, 2) and set(m.get_current_visuals()) == {
        "prediction", "input", "target"}
    with caplog.at_level("INFO", logger="base"):
        m.print_network()
    assert f"{sum(p.numel() for p in m.params):,d}" in caplog.text
