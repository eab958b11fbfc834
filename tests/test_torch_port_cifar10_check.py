"""The port's CIFAR-10 splitting data (data/cifar10.py, SplitDataset) and its
dataset-layout check (data/check.py, `--check_data`) against the JAX
package's, on the CPU.

No dataset ships, so the tests write synthetic pickles in the reference
layout (b'data' (N, 3072) uint8, b'labels') and synthetic Hagen TIFF stacks
(tests/test_check_data.py `_cfg`). Items, batches and the normalization are
held equal exactly; the check's verdict, report and printed lines too, apart
from the parity commands, which name each package's own CLIs.
"""

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from diffsplitting_tpu.config import dict_to_nonedict as jax_nonedict
from diffsplitting_tpu.data import NumpyLoader as JaxLoader
from diffsplitting_tpu.data import SplitDataset as JaxDataset
from diffsplitting_tpu.data import check as jax_check
from diffsplitting_tpu.data.cifar10 import load_train_val_data as jax_load_cifar
from diffsplitting_tpu.data.split_dataset import DataLocation as JaxLoc
from diffsplitting_tpu_torch import split
from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
from diffsplitting_tpu_torch.data import DataLocation, NumpyLoader, SplitDataset
from diffsplitting_tpu_torch.data import check
from diffsplitting_tpu_torch.data.cifar10 import load_train_val_data
from diffsplitting_tpu_torch.scripts import evaluate_joint_indi

from tests.test_check_data import _cfg
from tests.test_cli_e2e import write_tiff
from tests.test_torch_port_data import assert_items_equal, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def write_cifar(d, n_batches=2, n=40, seed=0):
    """Pickle batches with classes 1 and 7 present among 0, 1, 2, 7."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for b in range(n_batches):
        labels = list(rng.choice([0, 1, 2, 7], size=n))
        labels[0], labels[1] = 1, 7
        with open(os.path.join(d, f"data_batch_{b + 1}"), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": labels}, f)
    return str(d)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    return write_cifar(tmp_path_factory.mktemp("cifar"))


def test_cifar10_loader_matches_jax(cifar_dir):
    got, want = load_train_val_data(cifar_dir, [1, 7]), jax_load_cifar(cifar_dir, [1, 7])
    assert sorted(got) == sorted(want) == [0, 1]
    for c in want:
        assert got[c].dtype == want[c].dtype == np.uint8 and got[c].shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("kw", [
    dict(random_patching=False),
    dict(random_patching=True, enable_transforms=True, uncorrelated_channels=True, seed=3),
    dict(random_patching=True, channel_weights=[1, 0.3], input_from_normalized_target=True),
])
def test_cifar10_items_and_batches_match_jax(cifar_dir, kw):
    port = SplitDataset("cifar10", DataLocation(directory=cifar_dir), 32, max_qval=1.0, **kw)
    jax_ds = JaxDataset("cifar10", JaxLoc(directory=cifar_dir), 32, max_qval=1.0, **kw)
    assert len(port) == len(jax_ds) > 0
    for k, v in jax_ds.get_normalization_dict().items():
        np.testing.assert_array_equal(np.asarray(port.get_normalization_dict()[k]),
                                      np.asarray(v))
    for i in list(range(len(port))) * 2:
        item = port[i]
        assert_items_equal(item, jax_ds[i])
    assert item["input"].shape == (32, 32, 3) and item["target"].shape == (32, 32, 6)
    for a, b in zip(NumpyLoader(port, batch_size=4, shuffle=True, seed=2),
                    JaxLoader(jax_ds, batch_size=4, shuffle=True, seed=2)):
        assert_items_equal(a, b)


def test_cifar10_indi_config_trains_through_split(tmp_path):
    """configs/splitting_cifar10_indi.json at its widths, cut in memory to a
    few iterations on synthetic pickles: train, validate, checkpoint. (JAX's
    split.py stops on this config at its first step: it tiles the 3-channel
    input to 18 channels against the 6-channel target; the port tiles it to
    the target's width, `InDIProcess.tile_input`.)"""
    opt = load_json(str(ROOT / "configs/splitting_cifar10_indi.json"))
    ds = opt["datasets"]
    ds["train"]["datapath"] = write_cifar(tmp_path / "train")
    ds["val"]["datapath"] = write_cifar(tmp_path / "val", n_batches=1, n=6, seed=1)
    ds["train"]["batch_size"] = 4
    opt["path"]["root"] = str(tmp_path / "exp")
    opt["model"]["beta_schedule"]["val"]["n_timestep"] = 2
    opt["train"].update(n_iter=3, val_freq=3, save_checkpoint_freq=3, print_freq=1)
    cfg = tmp_path / "cifar.json"
    cfg.write_text(json.dumps(opt))
    run = split.main(["-c", str(cfg), "--device", "cpu"])
    assert len(run["val_psnrs"]) == 1 and np.isfinite(run["val_psnrs"][0])
    assert sorted(os.listdir(run["opt"]["path"]["checkpoint"])) == ["I3_E1_gen.pth",
                                                                    "I3_E1_opt.pth"]


def layouts(tmp_path, case):
    if case == "ok":
        return _cfg(tmp_path)
    if case == "missing_file":
        return _cfg(tmp_path, train_ch1=str(tmp_path / "nope.tif"))
    if case == "frames_disagree":
        other = str(tmp_path / "two_frames.tif")
        write_tiff(other, n=2)
        return _cfg(tmp_path, train_ch1=other)
    if case == "patch_too_big":
        return _cfg(tmp_path, patch=128)
    return _cfg(tmp_path, name="cifar10")  # nothing to check


@pytest.mark.parametrize("case", ["ok", "missing_file", "frames_disagree", "patch_too_big",
                                  "not_hagen"])
def test_run_check_matches_jax(tmp_path, case):
    cfg = layouts(tmp_path, case)
    raw = json.loads(Path(cfg).read_text())
    got_lines, want_lines = [], []
    got = check.run_check(cfg, dict_to_nonedict(raw), print_fn=got_lines.append)
    want = jax_check.run_check(cfg, jax_nonedict(raw), print_fn=want_lines.append)
    assert got == want == (case in ("ok", "not_hagen"))
    if case != "not_hagen":
        assert check.check_hagen_layout(dict_to_nonedict(raw)) == jax_check.check_hagen_layout(
            jax_nonedict(raw))
    cut = lambda lines: lines[:lines.index("parity-run commands (once data is in place):")] \
        if case != "not_hagen" else lines  # noqa: E731
    assert cut(got_lines) == cut(want_lines)
    if case != "not_hagen":
        commands = got_lines[len(cut(got_lines)) + 1:]
        assert commands and all("diffsplitting_tpu_torch." in c for c in commands)


@pytest.mark.parametrize("main", [split.main, evaluate_joint_indi.main],
                         ids=["split", "evaluate_joint_indi"])
def test_check_data_exit_codes(tmp_path, capsys, main):
    for d in ("ok", "bad"):
        (tmp_path / d).mkdir()
    ok = _cfg(tmp_path / "ok")
    with pytest.raises(SystemExit) as exit_ok:
        main(["-c", ok, "--check_data"])
    out = capsys.readouterr().out
    assert exit_ok.value.code == 0
    assert "dataset layout check: OK" in out and "3 frames" in out
    assert "diffsplitting_tpu_torch.scripts.evaluate_joint_indi" in out
    bad = _cfg(tmp_path / "bad", train_ch1=str(tmp_path / "nope.tif"))
    with pytest.raises(SystemExit) as exit_bad:
        main(["-c", bad, "--check_data"])
    out = capsys.readouterr().out
    assert exit_bad.value.code == 1 and "FAILED" in out and "nope.tif" in out
    assert not (tmp_path / "ok" / "exp").exists() and not (tmp_path / "bad" / "exp").exists()
