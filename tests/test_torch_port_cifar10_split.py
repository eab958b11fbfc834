"""configs/splitting_cifar10.json (a conditional ddpm, 9 channels in and 6
out, on the CIFAR-10 splitting data) through the port's split.py and the
repository's top-level split.py, on the CPU.

Cut to size: synthetic CIFAR-10 pickles (2 batches of 40 images,
tests/test_torch_port_cifar10_check.py `write_cifar`), batch 4, 2 iterations
with a validation and a checkpoint pair at the second; the UNet keeps the
config's width (inner 16, 16 groups, mults (1, 2, 4, 8)), 32² patches and its
3-step schedules. Then `-p val` from the checkpoint.

Both runs write the same files, one validation PSNR each, and the same
`input` and `target` PNGs bit for bit (the same data through the same
normalization); the predictions differ (each package draws its own weights
and noise).
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from diffsplitting_tpu_torch import split
from diffsplitting_tpu_torch.config import load_json

from tests.test_torch_port_cifar10_check import write_cifar
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def cifar_config(tmp_path, data, name):
    cfg = load_json(str(ROOT / "configs/splitting_cifar10.json"))
    cfg["path"]["root"] = str(tmp_path / name)
    for phase in ("train", "val"):
        cfg["datasets"][phase]["datapath"] = data
    cfg["datasets"]["train"]["batch_size"] = 4
    cfg["train"].update(n_iter=2, val_freq=2, save_checkpoint_freq=2, print_freq=1)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def written(run_root: Path) -> dict:
    return {p.relative_to(run_root).as_posix(): p for p in run_root.rglob("*")
            if p.is_file() and "logs" not in p.parts}


def test_cifar10_ddpm_splitting_through_split_py(tmp_path, monkeypatch):
    data = write_cifar(tmp_path / "data")
    cfg_path, cfg = cifar_config(tmp_path, data, "port")
    run = split.main(["-c", str(cfg_path), "--device", "cpu"])
    model = run["model"]
    assert model.which == "ddpm" and model.process.conditional
    assert model.nets.denoise_fn.in_channel == 9 and model.global_step == 2
    assert len(run["val_psnrs"]) == 1 and math.isfinite(run["val_psnrs"][0])
    port_files = written(Path(run["opt"]["path"]["experiment_root"]))
    assert sorted(f for f in port_files if "checkpoint" in f) == [
        "checkpoint/I2_E1_gen.pth", "checkpoint/I2_E1_opt.pth"]

    # the val phase from that checkpoint pair
    cfg["path"]["resume_state"] = str(Path(run["opt"]["path"]["checkpoint"]) / "I2_E1")
    cfg_path.write_text(json.dumps(cfg))
    val = split.main(["-c", str(cfg_path), "-p", "val", "--device", "cpu"])
    assert math.isfinite(val["psnr"]) and -1 <= val["ssim"] <= 1

    # the repository's split.py on the same config and data
    import split as jax_split

    jax_cfg, _ = cifar_config(tmp_path, data, "jax")
    monkeypatch.setattr(sys, "argv", ["split.py", "-c", str(jax_cfg)])
    jax_split.main()
    jax_root = next((tmp_path / "jax").glob("*/*/*"))
    jax_pngs = {k: v for k, v in written(jax_root).items() if k.endswith(".png")}
    port_pngs = {k: v for k, v in port_files.items() if k.endswith(".png")}
    assert sorted(jax_pngs) == sorted(port_pngs) and len(port_pngs) == 9
    for name, path in port_pngs.items():
        got, want = (np.asarray(Image.open(p)) for p in (path, jax_pngs[name]))
        assert got.shape == want.shape, name
        if not name.endswith("_pred.png"):
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert any("checkpoint/I2_E1_gen" in k for k in written(jax_root))


@pytest.fixture(autouse=True)
def _repo_root_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
