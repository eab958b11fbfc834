"""The port's predict CLI with the serving accelerators and their flag
parser, on the CPU.

`parse_accel_flag` is held to JAX's case by case. `predict.main` runs on a
TIFF with each new flag; its TIFFs are held bit for bit to `predict_frames`
on a model built the same way (seed 0) with the same switches, which the
deepcache and sliding-window test files hold against JAX. The joint config
is tests/test_torch_port_predict.py's (inner 16, mults (1, 2, 4, 8), 32²
patches, 3 steps) on one 48² frame (4 tiles).
"""

import json

import numpy as np
import pytest
import torch

from diffsplitting_tpu.utils.cli import parse_accel_flag as jax_parse_accel_flag
from diffsplitting_tpu_torch.data.io import load_tiff_stack, save_tiff_stack
from diffsplitting_tpu_torch.predict import main as predict_main
from diffsplitting_tpu_torch.predict import predict_frames
from diffsplitting_tpu_torch.serving import SplittingModel
from diffsplitting_tpu_torch.train.checkpoints import save_checkpoint
from diffsplitting_tpu_torch.utils.cli import parse_accel_flag

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_predict import PATCH, joint_opt


@pytest.mark.parametrize("value,default,casts", [
    ("4", 1, dict(second_cast=int)), ("4,2", 1, dict(second_cast=int)),
    ("auto", 1, dict(second_cast=int)), ("auto,2", 1, dict(second_cast=int)),
    ("5,", 1, dict(second_cast=int)), ("16", 0.1, {}), ("8,0", 0.1, {}),
    ("8,0.25", 0.1, {}),
])
def test_parse_accel_flag_matches_jax(value, default, casts):
    got = parse_accel_flag(value, default, **casts)
    want = jax_parse_accel_flag(value, default, **casts)
    assert got == want and [type(v) for v in got] == [type(v) for v in want]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A joint config, its seed-7 weights as a `.pth` and as a checkpoint
    prefix, a uint16 input TIFF and its self-statistics normalization."""
    tmp = tmp_path_factory.mktemp("predict")
    opt = joint_opt(tmp)
    opt["model"]["indi"]["noise_mode"] = "gaussian"
    config = tmp / "joint.json"
    config.write_text(json.dumps(opt))
    state = SplittingModel(opt, device="cpu", seed=7).nets.state_dict()
    weights = tmp / "joint_gen.pth"
    torch.save(state, weights)
    save_checkpoint(str(tmp / "ckpt"), "I5_E1", state, {"epoch": 1, "iter": 5})
    frames = np.random.default_rng(4).integers(0, 4000, size=(1, 48, 48)).astype(np.uint16)
    save_tiff_stack(str(tmp / "mixed.tif"), frames)
    m = np.quantile(frames.astype(np.float32).reshape(-1), 0.995)
    inp = ((frames.astype(np.float32) - m / 2) / (m / 2))[..., None].astype(np.float32)
    return dict(tmp=tmp, opt=opt, config=str(config), weights=str(weights), state=state,
                prefix=str(tmp / "ckpt" / "I5_E1"), input=str(tmp / "mixed.tif"), inp=inp, m=m)


def expected(served, **kw):
    """predict_frames on a model built as `main` builds it, de-normalized."""
    model = SplittingModel(served["opt"], device="cpu")
    model.nets.load_state_dict(served["state"])
    pred = predict_frames(model, served["inp"], PATCH, 8, **kw).numpy()
    m = served["m"]
    return np.clip(pred * (m / 2) + m / 2, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("flags,kw", [
    (["--deepcache", "2"], dict(deepcache=(2, 1))),
    (["--deepcache", "auto,1", "--resume"], dict(deepcache=("auto", 1))),
    (["--sliding_window", "2,0"], dict(sliding_window=(2, 0.0))),
    (["--sliding_window", "3"], dict(sliding_window=(3, 0.1))),
    (["--coalesce", "0", "--mmse", "2"], dict(coalesce=False, mmse=2)),
    (["--png_preview"], {}),
], ids=["deepcache", "deepcache_auto_resume", "window_tau0", "window", "coalesce0",
        "png_preview"])
def test_predict_main_with_accelerator_flags(served, tmp_path, flags, kw):
    weights = ["--weights", served["weights"]]
    if "--resume" in flags:
        flags = flags[:-1]
        weights = ["--resume", served["prefix"]]
    out = tmp_path / "pred"
    predict_main(["-c", served["config"], *weights, "--input", served["input"], "--out",
                  str(out), "--device", "cpu", *flags])
    want = expected(served, **kw)
    for c in range(2):
        got = load_tiff_stack(str(out / f"pred_ch{c}.tif"))
        assert got.shape == (1, 48, 48) and got.dtype == np.uint16
        np.testing.assert_array_equal(got, want[..., c])
    pngs = sorted(p.name for p in out.glob("*.png"))
    assert pngs == (["preview_ch0.png", "preview_ch1.png"] if "--png_preview" in flags else [])
    if pngs:
        import cv2

        img = cv2.imread(str(out / "preview_ch0.png"), cv2.IMREAD_UNCHANGED)
        assert img.shape == (48, 48) and img.dtype == np.uint8 and img.max() == 255


def test_weights_and_resume_are_exclusive(served, tmp_path):
    base = ["-c", served["config"], "--input", served["input"], "--out", str(tmp_path),
            "--device", "cpu"]
    for extra in ([], ["--weights", served["weights"], "--resume", served["prefix"]]):
        with pytest.raises(SystemExit):
            predict_main(base + extra)


def test_coalesce_off_matches_on_in_shape_and_finiteness(served):
    """Sequential MMSE chains draw other noise than one wider batch, so only
    their shapes and finiteness agree; with the noise off they agree in value."""
    model = SplittingModel(served["opt"], device="cpu")
    outs = [predict_frames(model, served["inp"], PATCH, 8, mmse=2, coalesce=c)
            for c in (True, False)]
    assert outs[0].shape == outs[1].shape == (1, 48, 48, 2)
    assert all(torch.isfinite(o).all() for o in outs)
    quiet = json.loads(json.dumps(served["opt"]))
    quiet["model"]["indi"]["noise_mode"] = "none"
    model = SplittingModel(quiet, device="cpu")
    a, b = (predict_frames(model, served["inp"], PATCH, 8, mmse=2, coalesce=c)
            for c in (True, False))
    assert np.abs((a - b).numpy()).max() <= 1e-5
