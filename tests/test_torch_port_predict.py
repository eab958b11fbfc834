"""The slice end to end: tiled joint-InDI prediction, JAX against the port.

A tiny joint config (the splitting UNet's widths: inner 16, 16 groups, mults
(1, 2, 4, 8); `indi.noise_mode: "none"`, so both sides run the same
deterministic chain) serves 1×64×64 frames in 32² patches. JAX runs
`predict_tiled` driven as the top-level predict.py drives it; the port runs
`predict_frames` on the JAX model's exported weights. Tolerance 2e-4 max abs
(f32; 2 nets × 3 steps of the UNet, sums in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.config import dict_to_nonedict
from diffsplitting_tpu.data import TileIndexManager as JaxTileIndexManager
from diffsplitting_tpu.data import TilingMode as JaxTilingMode
from diffsplitting_tpu.data import tiled_infer as jax_tiled
from diffsplitting_tpu.data.split_dataset import (
    compute_normalization_dict as jax_compute_normalization_dict,
)
from diffsplitting_tpu.train import DiffusionModel
from diffsplitting_tpu.utils.torch_export import save_reference_checkpoint
from diffsplitting_tpu_torch.data import TileIndexManager, TilingMode, tiled_infer
from diffsplitting_tpu_torch.data.io import load_tiff_stack, save_tiff_stack
from diffsplitting_tpu_torch.data.normalization import compute_normalization_dict
from diffsplitting_tpu_torch.predict import main as predict_main
from diffsplitting_tpu_torch.predict import predict_frames
from diffsplitting_tpu_torch.serving import SplittingModel
from diffsplitting_tpu_torch.utils.weights import load_reference_checkpoint, state_dict_from_jax

from tests.test_torch_port_unet import random_like

PATCH = 32
STEPS = 3


def joint_opt(tmp_path):
    return dict_to_nonedict({
        "name": "unittest",
        "phase": "val",
        "path": {"checkpoint": str(tmp_path), "resume_state": None},
        "datasets": {"patch_size": PATCH, "max_qval": 0.995},
        "model": {
            "which_model_G": "joint_indi",
            "loss_type": "l1",
            "lr_reduction": "mean",
            "unet": {"in_channel": 1, "out_channel": 1, "inner_channel": 16,
                     "norm_groups": 16, "channel_multiplier": [1, 2, 4, 8],
                     "attn_res": [], "res_blocks": 1, "dropout": 0},
            "beta_schedule": {
                "train": {"schedule": "linear", "n_timestep": 10,
                          "linear_start": 1e-6, "linear_end": 1e-2},
                "val": {"schedule": "linear", "n_timestep": STEPS,
                        "linear_start": 1e-6, "linear_end": 1e-2},
            },
            "diffusion": {"image_size": PATCH, "channels": 1, "conditional": False},
            "allow_full_translation": True,
            "indi": {"e": 0.01, "t_sampling_mode": "linear_indi", "linear_indi_a": 1.0,
                     "noise_mode": "none"},
        },
        "train": {"n_iter": 10, "optimizer": {"type": "adam", "lr": 1e-3}},
    })


def test_predict_frames_matches_jax_predict_tiled(tmp_path, monkeypatch):
    opt = joint_opt(tmp_path)
    frames = np.random.default_rng(0).normal(size=(1, 64, 64, 1)).astype(np.float32)

    # seeded random weights in place of flax's slow orthogonal init
    seeds = iter(range(100, 200))
    monkeypatch.setattr(
        "diffsplitting_tpu.train.trainer.init_on_host",
        lambda init_fn, *args: random_like(jax.eval_shape(init_fn, *args), next(seeds)))
    jmodel = DiffusionModel(opt, seed=0)
    jmodel.current_T = STEPS
    jmodel.schedule_phase = f"predict_{STEPS}"

    def infer_fn(tile_batch):  # as predict.py drives the model, --mmse 1
        jmodel.data = {"input": tile_batch}
        return np.asarray(jmodel.test(continuous=False, t_float_start=0.5))

    mng = JaxTileIndexManager((1, 64, 64), (1, PATCH // 2, PATCH // 2), (1, PATCH, PATCH),
                              JaxTilingMode.ShiftBoundary)
    want = jax_tiled.predict_tiled(infer_fn, frames, mng, batch_size=8)

    # weights cross as the JAX package exports them (a reference *_gen.pth)
    path = save_reference_checkpoint(str(tmp_path / "joint"), "joint_indi",
                                     jax.device_get(jmodel.params), jmodel.nets)
    sd = load_reference_checkpoint(path)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params))
    direct = state_dict_from_jax("joint_indi", params, opt["model"]["unet"])
    assert sorted(direct) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(direct[k].numpy(), sd[k].numpy())

    model = SplittingModel(opt, device="cpu")
    model.nets.load_state_dict(sd)
    got = predict_frames(model, frames, PATCH, batch_size=8).numpy()
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert np.abs(got - want).max() <= 2e-4

    # --mmse 2 of a noise-free chain averages two equal chains
    twice = predict_frames(model, frames, PATCH, batch_size=8, mmse=2).numpy()
    np.testing.assert_allclose(twice, got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("uint8_data", [False, True])
def test_normalization_matches_jax(uint8_data):
    rng = np.random.default_rng(3)
    data = {c: [rng.gamma(2.0, 300.0, size=(16, 16)).astype(np.float32) for _ in range(3)]
            for c in (0, 1)}
    want = jax_compute_normalization_dict(data, [1, 1], q_val=0.995, uint8_data=uint8_data)
    got = compute_normalization_dict(data, [1, 1], q_val=0.995, uint8_data=uint8_data)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_predict_cli_writes_denormalized_tiffs(tmp_path):
    """`python -m diffsplitting_tpu_torch.predict` on a TIFF: self-statistics
    normalization, tiled prediction, uint16 TIFF per channel."""
    opt = joint_opt(tmp_path)
    config = tmp_path / "joint.json"
    config.write_text(json.dumps(opt))
    weights = tmp_path / "joint_gen.pth"
    torch.save(SplittingModel(opt, device="cpu", seed=7).nets.state_dict(), weights)
    frames = np.random.default_rng(4).integers(0, 4000, size=(1, 64, 64)).astype(np.uint16)
    save_tiff_stack(str(tmp_path / "mixed.tif"), frames)

    out = tmp_path / "pred"
    predict_main(["-c", str(config), "--weights", str(weights), "--input",
                  str(tmp_path / "mixed.tif"), "--out", str(out), "--device", "cpu"])

    m = np.quantile(frames.astype(np.float32).reshape(-1), 0.995)
    inp = ((frames.astype(np.float32) - m / 2) / (m / 2))[..., None].astype(np.float32)
    model = SplittingModel(opt, device="cpu")
    model.nets.load_state_dict(load_reference_checkpoint(str(weights)))
    pred = predict_frames(model, inp, PATCH, batch_size=8).numpy()
    want = np.clip(pred * (m / 2) + m / 2, 0, 65535).astype(np.uint16)
    for c in range(2):
        got = load_tiff_stack(str(out / f"pred_ch{c}.tif"))
        assert got.shape == (1, 64, 64) and got.dtype == np.uint16
        assert np.abs(got.astype(np.int64) - want[..., c].astype(np.int64)).max() <= 1


@pytest.mark.parametrize("shape,grid,patch", [((3, 96, 96), 16, 32), ((2, 70, 50), 10, 20)])
def test_tiling_matches_jax(shape, grid, patch):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=shape + (2,)).astype(np.float32)
    args = (shape, (1, grid, grid), (1, patch, patch))
    jplan = jax_tiled.tile_plan(JaxTileIndexManager(*args, JaxTilingMode.ShiftBoundary))
    plan = tiled_infer.tile_plan(TileIndexManager(*args, TilingMode.ShiftBoundary))
    for key in ("ps", "lo", "hi"):
        np.testing.assert_array_equal(plan[key], jplan[key])

    jtiles = np.asarray(jax_tiled.extract_tiles(jnp.asarray(vol), jplan))
    tiles = tiled_infer.extract_tiles(torch.from_numpy(vol), plan)
    np.testing.assert_array_equal(tiles.numpy(), jtiles)

    preds = rng.normal(size=jtiles.shape).astype(np.float32)
    want = np.asarray(jax_tiled.stitch_tiles(jnp.asarray(preds), jplan))
    got = tiled_infer.stitch_tiles(torch.from_numpy(preds), plan).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiled_infer.stitch_tiles(tiles, plan).numpy(), vol)
