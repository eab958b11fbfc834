"""The port's UNet FLOP count, MFU and LPIPS (utils/flops.py,
utils/profiling.py, utils/lpips.py) against the JAX package's, on the CPU.

  * `unet_forward_flops` equal to JAX's, to the FLOP, for the UNet of every
    config in configs/ at its train patch (or image size), batch 1 and 4;
    split.py's FLOPs a train step equal to the top-level split.py's;
  * `peak_flops` from the H100 table, raising on a card or device it does not
    know; `StepTimer`'s MFU;
  * LPIPS within 1e-5 of JAX's on JAX's random weights carried across
    (HWIO → OIHW), RGB and grayscale; zero on identical images and ordered
    by the perturbation; the npz round trip both ways between the packages
    and the torch `.pth` layout (torchvision `features.*` and lpips `lin*`);
    `evaluate_joint_indi.py --lpips-weights` on a tiny joint-InDI config.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.utils import flops as jax_flops
from diffsplitting_tpu.utils import lpips as jax_lpips
from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
from diffsplitting_tpu_torch.split import train_flops_per_step
from diffsplitting_tpu_torch.utils import lpips, profiling
from diffsplitting_tpu_torch.utils.flops import config_forward_flops, unet_forward_flops

from tests.test_torch_port_data import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.json"))


def config(name):
    return dict_to_nonedict(load_json(str(ROOT / "configs" / name)))


@pytest.mark.parametrize("name", CONFIGS)
def test_unet_forward_flops_equal_jax(name):
    opt = config(name)
    m, unet = opt["model"], opt["model"]["unet"]
    size = opt["datasets"].get("patch_size") or m["diffusion"]["image_size"]
    cond = m["which_model_G"] != "UnetClassifier"  # the time predictor's UNet: cond_type none
    for batch in (1, 4):
        kw = dict(image_size=size, in_channel=unet["in_channel"],
                  out_channel=unet["out_channel"], inner_channel=unet["inner_channel"],
                  channel_mults=tuple(unet["channel_multiplier"]),
                  attn_res=tuple(unet["attn_res"] or ()), res_blocks=unet["res_blocks"],
                  cond=cond, batch=batch)
        got = unet_forward_flops(**kw)
        assert got == jax_flops.unet_forward_flops(**kw) and got > 0
        if cond:
            assert config_forward_flops(m, size, batch) == got


@pytest.mark.parametrize("name", [n for n in CONFIGS if config(n)["datasets"].get("patch_size")
                                  and config(n)["model"]["which_model_G"] != "UnetClassifier"])
def test_train_flops_per_step_equal_top_level_split(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import split as jax_split

    opt = config(name)
    assert train_flops_per_step(opt) == jax_split._train_flops_per_step(opt)
    assert train_flops_per_step(config("sr_sr3_16_128.json")) is None  # no patch
    sys.modules.pop("split", None)


def test_peak_flops_table_and_mfu(monkeypatch):
    with pytest.raises(ValueError, match="cpu"):
        profiling.peak_flops(torch.float32, "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.peak_flops(torch.bfloat16, "cuda") == 989e12
    assert profiling.peak_flops(None, "cuda") == profiling.peak_flops(torch.float32) == 67e12
    assert profiling.PEAK_FLOPS["NVIDIA H100 80GB HBM3"]["tf32"] == 495e12
    assert profiling.peak_flops(torch.int8, "cuda") == 1979e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other GPU")
    with pytest.raises(ValueError, match="Some Other GPU"):
        profiling.peak_flops(torch.bfloat16, "cuda")

    timer = profiling.StepTimer(flops_per_step=2e12, peak=4e12)
    timer._avg = 0.5
    assert timer.metrics() == {"step_time_s": 0.5, "steps_per_sec": 2.0,
                               "flops_per_sec": 4e12, "mfu": 1.0}
    assert "mfu" not in profiling.StepTimer(flops_per_step=2e12).metrics()


# ------------------------------------------------------------------------ LPIPS


@pytest.fixture(scope="module")
def weights():
    """JAX's random LPIPS weights and the port's copy of them (OIHW)."""
    jp = jax_lpips.random_lpips_params(jax.random.PRNGKey(0))
    port = {}
    for i in range(5):
        conv = jp[f"conv{i}"]
        port[f"conv{i}"] = {"weight": torch.from_numpy(np.asarray(conv["kernel"])
                                                       .transpose(3, 2, 0, 1).copy()),
                            "bias": torch.from_numpy(np.array(conv["bias"]))}
        port[f"lin{i}"] = {"weight": torch.from_numpy(np.array(jp[f"lin{i}"]["weight"]))}
    return jp, port


def images(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    y = np.clip(x + 0.3 * rng.normal(size=shape), -1, 1).astype(np.float32)
    return x, y


def test_lpips_equals_jax(weights):
    jp, port = weights
    x, y = images((2, 64, 64, 3), 1)
    want = np.asarray(jax_lpips.lpips(jp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = lpips.lpips(port, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2,) and np.abs(got - want).max() <= 1e-5
    g1, g2 = images((2, 64, 64, 1), 2)
    want = np.asarray(jax_lpips.lpips_grayscale(jp, jnp.asarray(g1), jnp.asarray(g2)))
    with torch.no_grad():
        got = lpips.lpips_grayscale(port, torch.from_numpy(g1), torch.from_numpy(g2)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert lpips.FEATURE_CHANNELS == jax_lpips.FEATURE_CHANNELS


def test_lpips_zero_on_identical_and_ordered():
    params = lpips.random_lpips_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    with torch.no_grad():
        assert float(lpips.lpips(params, x, x)[0]) <= 1e-6
        small = float(lpips.lpips(params, x, (x + 0.05 * noise).clamp(-1, 1))[0])
        big = float(lpips.lpips(params, x, (x + 0.5 * noise).clamp(-1, 1))[0])
    assert 0 < small < big


def test_npz_roundtrip_both_ways_with_jax(tmp_path, weights):
    jp, port = weights
    x, y = images((1, 64, 64, 3), 4)
    want = np.asarray(jax_lpips.lpips(jp, jnp.asarray(x), jnp.asarray(y)))
    jax_lpips.save_lpips_weights(jp, str(tmp_path / "jax.npz"))
    from_jax = lpips.load_lpips_weights(str(tmp_path / "jax.npz"))
    lpips.save_lpips_weights(port, str(tmp_path / "port.npz"))
    back = jax_lpips.load_lpips_weights(str(tmp_path / "port.npz"))
    for i in range(5):
        assert torch.equal(from_jax[f"conv{i}"]["weight"], port[f"conv{i}"]["weight"])
        np.testing.assert_array_equal(np.asarray(back[f"conv{i}"]["kernel"]),
                                      np.asarray(jp[f"conv{i}"]["kernel"]))
    with torch.no_grad():
        got = lpips.lpips(from_jax, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("nested", [True, False], ids=["alexnet_lpips", "flat"])
def test_load_torch_pth(tmp_path, weights, nested):
    """A torchvision-AlexNet + lpips-lin state dict in a `.pth` loads to the
    same weights, as JAX's `load_lpips_weights` reads it."""
    _, port = weights
    alexnet = {}
    for i, j in enumerate(lpips.TORCHVISION_CONVS):
        alexnet[f"features.{j}.weight"] = port[f"conv{i}"]["weight"].clone()
        alexnet[f"features.{j}.bias"] = port[f"conv{i}"]["bias"].clone()
    lin = {f"lin{i}.model.1.weight": port[f"lin{i}"]["weight"].reshape(1, -1, 1, 1).clone()
           for i in range(5)}
    path = str(tmp_path / "lpips.pth")
    torch.save({"alexnet": alexnet, "lpips": lin} if nested else {**alexnet, **lin}, path)
    got = lpips.load_lpips_weights(path)
    want = jax_lpips.load_lpips_weights(path)
    for i in range(5):
        assert torch.equal(got[f"conv{i}"]["weight"], port[f"conv{i}"]["weight"])
        assert torch.equal(got[f"lin{i}"]["weight"], port[f"lin{i}"]["weight"])
        np.testing.assert_array_equal(np.asarray(want[f"conv{i}"]["kernel"]),
                                      got[f"conv{i}"]["weight"].numpy().transpose(2, 3, 1, 0))
    with pytest.raises(FileNotFoundError):
        lpips.load_lpips_weights(str(tmp_path / "missing.npz"))


def test_evaluate_joint_indi_reports_lpips(tmp_path):
    """`scripts/evaluate_joint_indi.py --lpips-weights` reports each
    channel's LPIPS beside the PSNR, as the JAX script's flag does."""
    from diffsplitting_tpu_torch.scripts import evaluate_joint_indi
    from diffsplitting_tpu_torch.train import DiffusionModel
    from tests.test_torch_port_split import write_config

    cfg_path, _ = write_config(tmp_path, "joint_indi")
    m = DiffusionModel(dict_to_nonedict(load_json(str(cfg_path))), device="cpu", seed=0)
    torch.save(m.nets.state_dict(), tmp_path / "joint_gen.pth")
    lpips.save_lpips_weights(lpips.random_lpips_params(torch.Generator().manual_seed(1)),
                             str(tmp_path / "lpips.npz"))
    results = evaluate_joint_indi.main([
        "-c", str(cfg_path), "--resume", str(tmp_path / "joint_gen.pth"), "--lpips-weights",
        str(tmp_path / "lpips.npz"), "--device", "cpu", "--out", str(tmp_path / "m.json")])
    row = results[1]
    assert sorted(row) == ["lpips_ch0", "lpips_ch1", "psnr_ch0", "psnr_ch1"]
    assert all(np.isfinite(v) for v in row.values()) and row["lpips_ch0"] > 0
    assert (tmp_path / "m.json").exists()
