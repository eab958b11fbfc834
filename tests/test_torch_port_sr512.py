"""configs/sr_sr3_64_512.json, the default config of infer.py, through the
port's infer.py and its train step on the CPU, cut in width and size.

Its structure as the config has it: sr3 (noise-level UNet), mults (1, 2, 4,
8, 16), one res block, 16 groups, no attn_res (attention in the mid block
only), compute_dtype bfloat16, remat on, l_resolution 1/8 of r_resolution.
Cut: inner 16 (widths 16 ... 256, 9,723,315 parameters), 64² (8² LR), 3 val
steps, 2 synthetic LR/HR/SR triples written by the port's prepare_data.

  * infer.py writes the config's files; the UNet computes in bf16 with every
    block marked for remat; with DSP_PRECAST=1 the chain is bit for bit the
    same;
  * a train step at the config's batch 2 with remat on and off from the same
    weights and draws: the same loss and gradients, bit for bit (the
    recompute runs the same CPU ops); parameters and gradients f32;
  * infer.py's default config is the top-level infer.py's.
"""

import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diffsplitting_tpu_torch import infer
from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
from diffsplitting_tpu_torch.data import prepare_data
from diffsplitting_tpu_torch.models.blocks import ResnetBlockWithAttn
from diffsplitting_tpu_torch.train import DiffusionModel

from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs/sr_sr3_64_512.json"
SIZE, LR_SIZE = 64, 8


@pytest.fixture(scope="module")
def cut_config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sr512")
    src = tmp / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 255, (80, 72, 3), dtype=np.uint8)
        Image.fromarray(img).save(src / f"{i}.png")
    root = tmp / "root"
    assert prepare_data.prepare(str(src), str(root), n_worker=1, sizes=(LR_SIZE, SIZE)) == 2
    cfg = load_json(str(CONFIG))
    cfg["path"]["root"] = str(tmp / "experiments")
    cfg["model"]["unet"]["inner_channel"] = 16
    cfg["model"]["diffusion"]["image_size"] = SIZE
    cfg["model"]["beta_schedule"]["val"]["n_timestep"] = 3
    for phase in ("train", "val"):
        cfg["datasets"][phase].update(dataroot=str(root), l_resolution=LR_SIZE,
                                      r_resolution=SIZE)
    cfg["datasets"]["val"]["data_len"] = 1
    path = tmp / "sr_sr3_64_512_cut.json"
    path.write_text(json.dumps(cfg))
    return path, root


def test_config_is_bf16_with_remat():
    model = load_json(str(CONFIG))["model"]
    assert (model["compute_dtype"], model["remat"], model["which_model_G"]) == (
        "bfloat16", True, "sr3")


def test_infer_py_serves_the_cut_config(cut_config, monkeypatch):
    path, _ = cut_config
    run = infer.main(["-c", str(path), "--device", "cpu"])
    net = run["model"].nets.denoise_fn
    assert net.compute_dtype == torch.bfloat16 and net.cond_type == "noise_level"
    assert all(b.remat for b in net.modules() if isinstance(b, ResnetBlockWithAttn))
    assert sum(p.numel() for p in net.parameters()) == 9723315
    results = Path(run["results"])
    assert sorted(p.name for p in results.glob("*.png")) == [
        "0_1_hr.png", "0_1_inf.png", "0_1_sr.png", "0_1_sr_process.png"]
    sr = np.asarray(Image.open(results / "0_1_sr.png"))
    assert sr.shape == (SIZE, SIZE, 3)

    monkeypatch.setenv("DSP_PRECAST", "1")
    precast = infer.main(["-c", str(path), "--device", "cpu"])
    again = np.asarray(Image.open(Path(precast["results"]) / "0_1_sr.png"))
    np.testing.assert_array_equal(again, sr)
    torch.testing.assert_close(precast["model"].prediction, run["model"].prediction,
                               rtol=0, atol=0)


def test_train_step_with_and_without_remat(cut_config):
    path, _ = cut_config
    rng = np.random.default_rng(1)
    batch = {k: rng.uniform(-1, 1, size=(2, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("target", "input")}
    draws = [(7, torch.tensor([0.9, 0.95]),
              torch.from_numpy(rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)))]
    runs = {}
    for remat in (True, False):
        opt = dict_to_nonedict(load_json(str(path)))
        opt["model"]["remat"] = remat
        m = DiffusionModel(opt, device="cpu", seed=0)
        m.feed_data(batch)
        m.optimize_parameters(draws)
        runs[remat] = m
    on, off = runs[True], runs[False]
    assert on.get_current_log() == off.get_current_log()
    assert np.isfinite(on.get_current_log()["l_pix"])
    for (name, p), q in zip(on.nets.named_parameters(), off.nets.parameters()):
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_infer_default_config_is_the_top_level_one():
    """`python -m diffsplitting_tpu_torch.infer` with no -c serves what
    `python infer.py` serves."""
    pattern = r'"--config", type=str, default="([^"]+)"'
    port = re.search(pattern, inspect.getsource(infer.main)).group(1)
    top = re.search(pattern, (ROOT / "infer.py").read_text()).group(1)
    assert port == top == "configs/sr_sr3_64_512.json"
