"""The port's time predictor against the JAX package's, on the CPU.

Small sizes: inner 8, 4 groups, mults (1, 2), one res block, 16² to 32²
(the mid block attends at N = 64 or 256, D = 16). Tolerances:

  * `TimePredictor` eval forward from JAX weights (`time_predictor_state_dict_from_jax`):
    max abs error <= 1e-5;
  * dropout: eval is the identity (exact); in train mode every element is 0
    or x/(1 − p), as flax's `nn.Dropout` gives, and the kept share is within
    0.01 of 1 − p on 2¹⁶ elements on both sides; one generator seed gives one
    mask (exact);
  * `compute_input_normalization_dict` and `TimePredictorDataset` items, in
    both input modes with noise, and `item_at_t`: equal exactly (the same
    numpy calls on the same seeded generator);
  * `ReduceLROnPlateau`: the same lr sequence (exact);
  * one classifier train step at dropout 0 against the JAX CLI's step (its
    loss, `value_and_grad`, `optax.inject_hyperparams(optax.adam)`): loss
    relative 2e-6; every gradient within 2e-5·max|g| of its tensor; each
    parameter's change within 1e-3·lr where |g| > 1e-3·max|g| of its tensor
    (Adam's first update is about lr·g/(|g| + eps), so an element with a
    gradient near zero may move by up to ±lr on a rounding difference: those
    are exempt and held to 2·lr), as in tests/test_torch_port_train.py;
  * `start_training` and the CLI on the CPU: a best checkpoint pair that
    reloads to the same outputs (exact);
  * the indi / joint-InDI train step at dropout > 0 runs, draws its masks
    from the trainer's generator (the same seed gives the same bits) and
    serves without dropout;
  * the new CLIs raise without CUDA unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from diffsplitting_tpu.data import TimePredictorDataset as JaxTPDataset
from diffsplitting_tpu.data.split_dataset import DataLocation as JaxLoc
from diffsplitting_tpu.data.time_predictor_dataset import (
    compute_input_normalization_dict as jax_input_norm)
from diffsplitting_tpu.models import TimePredictor as JaxTimePredictor
from diffsplitting_tpu_torch import time_prediction_training as tpt
from diffsplitting_tpu_torch.config import dict_to_nonedict
from diffsplitting_tpu_torch.data import (DataLocation, TimePredictorDataset,
                                          compute_input_normalization_dict)
from diffsplitting_tpu_torch.models import Dropout, TimePredictor, set_dropout_generator
from diffsplitting_tpu_torch.train import DiffusionModel
from diffsplitting_tpu_torch.train.optim import optax_adam
from diffsplitting_tpu_torch.utils.weights import time_predictor_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread, write_tiff  # noqa: F401
from tests.test_trainer import synth_batch, tiny_opt

KW = dict(in_channel=1, out_channel=1, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          attn_res=(), res_blocks=1)
UNET_OPT = {"channel_multiplier": [1, 2], "res_blocks": 1}
LR = 1e-3


@pytest.fixture(scope="module")
def jax_tp():
    """A JAX TimePredictor at 32² and its params (one init a file)."""
    net = JaxTimePredictor(dropout=0.0, image_size=32, **KW)
    params = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)))["params"]
    return net, jax.tree_util.tree_map(np.asarray, params)


def port_tp(params, dropout=0.0):
    net = TimePredictor(dropout=dropout, image_size=32, **KW)
    net.load_state_dict(time_predictor_state_dict_from_jax(params, UNET_OPT), strict=True)
    return net


def test_time_predictor_eval_forward_matches_jax(jax_tp):
    jnet, params = jax_tp
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    # the config's dropout does not act in eval mode
    net = port_tp(params, dropout=0.2).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3,)
    assert np.abs(got - want).max() <= 1e-5
    keys = set(net.state_dict())
    assert {"foreground_mask.conv.weight", "foreground_mask.conv.bias"} <= keys
    assert all(k.startswith(("unet.", "foreground_mask.")) for k in keys)
    assert not any(k.startswith("unet.time_mlp") for k in keys)  # cond_type 'none'


def test_dropout_sits_where_jax_puts_it():
    """One dropout a ResnetBlock, in its second Block (JAX blocks.py:127-128,
    :154); none in the first Block or the head; `block.2` holds no
    parameters, so the parameter names are those of a rate-0 net."""
    net = TimePredictor(dropout=0.2, image_size=16, **KW)
    drops = [n for n, m in net.named_modules() if isinstance(m, Dropout)]
    rbs = [n for n, _ in net.named_modules() if n.endswith("res_block")]
    assert drops == [f"{n}.block2.block.2" for n in rbs] and len(drops) == 8
    assert set(net.state_dict()) == set(TimePredictor(image_size=16, **KW).state_dict())


def test_dropout_semantics_match_flax():
    p = 0.2
    x = torch.randn(4, 8, 64, 32, generator=torch.Generator().manual_seed(0))
    drop = Dropout(p)
    drop.eval()
    assert drop(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(5)
    y = drop(x)
    kept = y != 0
    assert torch.equal(y[kept], (x / (1 - p))[kept])
    share = kept.float().mean().item()
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(x), y)  # the same generator state, the same mask

    jx = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    jy = np.asarray(fnn.Dropout(rate=p, deterministic=False).apply(
        {}, jx, rngs={"dropout": jax.random.PRNGKey(0)}))
    jkept = jy != 0
    np.testing.assert_array_equal(jy[jkept], (np.asarray(jx) / (1 - p))[jkept])
    assert abs(share - (1 - p)) <= 0.01 and abs(jkept.mean() - (1 - p)) <= 0.01


def test_time_predictor_dropout_draws_from_its_generator():
    net = TimePredictor(dropout=0.2, image_size=16, **KW).train()
    x = torch.randn(2, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    outs = []
    for _ in range(2):
        set_dropout_generator(net, torch.Generator().manual_seed(9))
        outs.append(net(x))
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        assert not torch.equal(net.eval()(x), outs[0])


# ------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def tp_tiffs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_tiffs")
    rng = np.random.default_rng(4)
    paths = []
    for c, hi in ((0, 2500), (1, 1800)):
        p = str(d / f"ch{c}.tif")
        write_tiff(p, [rng.integers(50, hi, (64, 64)).astype(np.uint16) for _ in range(3)])
        paths.append(p)
    return tuple(paths)


@pytest.fixture(scope="module")
def small_val_tiffs(tmp_path_factory):
    """Two copies of one 32² frame a channel: 8 items at patch 16."""
    d = tmp_path_factory.mktemp("tp_val")
    rng = np.random.default_rng(5)
    paths = []
    for c in (0, 1):
        p = str(d / f"val{c}.tif")
        frame = rng.integers(50, 1500, (32, 32)).astype(np.uint16)
        write_tiff(p, [frame, frame])
        paths.append(p)
    return tuple(paths)


def test_input_normalization_dict_matches_jax(tp_tiffs):
    ds = TimePredictorDataset("Hagen", DataLocation(channelwise_fpath=tp_tiffs), 32)
    for T in (100, 20):
        want = jax_input_norm(ds._data_dict, T, ds._mean_target, ds._std_target)
        got = compute_input_normalization_dict(ds._data_dict, T, ds._mean_target,
                                               ds._std_target)
        assert sorted(got) == sorted(want) == list(range(T + 1))
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("raw", [False, True])
def test_dataset_items_match_jax(tp_tiffs, raw):
    kw = dict(max_qval=0.99, channel_weights=[1.0, 1.0], enable_transforms=True,
              random_patching=True, gaussian_noise_std_factor=0.02, raw_mixture_inputs=raw,
              seed=11)
    jds = JaxTPDataset("Hagen", JaxLoc(channelwise_fpath=tp_tiffs), 32, **kw)
    pds = TimePredictorDataset("Hagen", DataLocation(channelwise_fpath=tp_tiffs), 32, **kw)
    assert len(pds) == len(jds) == 12
    for i in range(8):
        (jx, jt), (px, pt) = jds[i], pds[i]
        assert px.dtype == jx.dtype == np.float32 and pt.dtype == jt.dtype == np.float32
        np.testing.assert_array_equal(px, jx)
        assert pt == jt
    # the evaluation's per-t grid, with its own statistics
    for ds in (jds, pds):
        ds.fixed_t_norm_dict = jax_input_norm(ds._data_dict, 20, ds._mean_target,
                                              ds._std_target)
        ds._random_patching = False
    for i, (t_int, t) in enumerate([(0, 0.0), (7, 0.35), (20, 1.0)]):
        np.testing.assert_array_equal(pds.item_at_t(i, t, t_int), jds.item_at_t(i, t, t_int))


def test_reduce_lr_on_plateau_matches_jax():
    from time_prediction_training import ReduceLROnPlateau as JaxPlateau

    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.7] + [0.7] * 20
    for patience in (0, 1, 3):
        j, p = JaxPlateau(1e-3, patience), tpt.ReduceLROnPlateau(1e-3, patience)
        assert [p.step(m) for m in metrics] == [j.step(m) for m in metrics]


# ----------------------------------------------------------------- training
def test_classifier_train_step_matches_jax(jax_tp):
    jnet, params = jax_tp
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    y = rng.uniform(0, 1, size=(4,)).astype(np.float32)

    def loss_fn(p, x, y):
        pred = jnet.apply({"params": p}, x, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean((pred - y) ** 2)

    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)

    @jax.jit
    def step(p, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    loss, grads, new = step(params, jnp.asarray(x), jnp.asarray(y))
    after = time_predictor_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new), UNET_OPT)
    grads = time_predictor_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), UNET_OPT)

    net = port_tp(params).train()
    start = {k: v.detach().clone() for k, v in net.named_parameters()}
    got = tpt.train_step(net, optax_adam(net.parameters(), LR), torch.from_numpy(x),
                         torch.from_numpy(y), "l2")
    np.testing.assert_allclose(float(got), float(loss), rtol=2e-6)
    for name, p in net.named_parameters():
        g = grads[name].numpy()
        gmax = np.abs(g).max()
        assert np.abs(p.grad.numpy() - g).max() <= 2e-5 * gmax, name
        moved = np.abs((p.detach() - start[name]).numpy() - (after[name] - start[name]).numpy())
        exempt = np.abs(g) <= 1e-3 * gmax
        assert moved[~exempt].max(initial=0) <= 1e-3 * LR, name
        assert moved[exempt].max(initial=0) <= 2 * LR, name


def tp_opt(tmp_path, tiffs, val_tiffs, batch=4):
    return dict_to_nonedict({
        "name": "tp", "path": {"experiment_root": str(tmp_path / "exp")}, "enable_wandb": False,
        "datasets": {"upper_clip": False, "patch_size": 16, "max_qval": 1.0,
                     "channel_weights": [1.0, 1.0],
                     "train": {"name": "Hagen", "batch_size": batch,
                               "datapath": {"ch0": tiffs[0], "ch1": tiffs[1]},
                               "uncorrelated_channels": False,
                               "gaussian_noise_std_factor": 0.02},
                     "val": {"name": "Hagen",
                             "datapath": {"ch0": val_tiffs[0], "ch1": val_tiffs[1]}}},
        "model": {"loss_type": "l2", "which_model_G": "UnetClassifier",
                  "unet": {"in_channel": 1, "out_channel": 1, "inner_channel": 8,
                           "norm_groups": 4, "channel_multiplier": [1, 2], "attn_res": [],
                           "res_blocks": 1, "dropout": 0.2}},
        "train": {"num_epochs": 2, "optimizer": {"type": "adam", "lr": 1e-3},
                  "lr_scheduler_patience": 0},
    })


def test_start_training_writes_a_best_checkpoint_that_reloads(tmp_path, tp_tiffs):
    opt = tp_opt(tmp_path, tp_tiffs, tp_tiffs)
    net, best = tpt.start_training(opt, max_epochs=2, steps_per_epoch=2, device="cpu")
    assert np.isfinite(best) and best < 1e6
    prefix = str(tmp_path / "exp" / tpt.BEST_PREFIX)
    state = torch.load(prefix + "_opt.pth", weights_only=True)
    assert set(state) == {"epoch", "iter", "optimizer", "lr", "val_loss"}
    assert state["val_loss"] == best and state["iter"] in (2, 4)
    back = tpt.load_time_predictor(opt, prefix, "cpu")
    x = torch.randn(2, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    net.eval()
    if state["iter"] == 4:  # the last epoch was the best: the live weights
        with torch.no_grad():
            assert torch.equal(back(x), net(x))
    assert not back.training and all(not m.training for m in back.modules())


def test_empty_val_loader_falls_back_to_the_train_loss(tmp_path, tp_tiffs, small_val_tiffs,
                                                      caplog):
    # 8 val items (two copies of one 32² frame) at patch 16 < a batch of 16:
    # the val loader yields nothing, and the train epoch loss stands in
    opt = tp_opt(tmp_path, tp_tiffs, small_val_tiffs, batch=16)
    with caplog.at_level("WARNING", logger="base"):
        _, best = tpt.start_training(opt, max_epochs=1, steps_per_epoch=2, device="cpu")
    assert "validation loader is empty" in caplog.text
    state = torch.load(str(tmp_path / "exp" / tpt.BEST_PREFIX) + "_opt.pth", weights_only=True)
    assert np.isfinite(best) and state["val_loss"] == best and state["iter"] == 2


def test_cli_trains_on_the_cpu_and_refuses_without_cuda(tmp_path, tp_tiffs, monkeypatch):
    import json

    opt = tp_opt(tmp_path, tp_tiffs, tp_tiffs)
    opt["train"]["num_epochs"] = 1
    opt["path"] = {"root": "r", "log": "logs", "checkpoint": "ckpt", "resume_state": None}
    cfg = tmp_path / "tp.json"
    cfg.write_text(json.dumps(opt))
    out = tpt.main(["--config", str(cfg), "--rootdir", str(tmp_path / "runs"),
                    "--device", "cpu"])
    assert out["net"].unet.final_conv.block[3].weight.device.type == "cpu"
    assert (tmp_path / "runs").is_dir() and np.isfinite(out["best_val_loss"])
    import os
    assert os.path.isfile(out["checkpoint"] + "_gen.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.start_training(opt, max_epochs=1)


# --------------------------------------------------- the diffusion trainer
@pytest.mark.parametrize("which,kw", [("indi", dict(in_ch=2, out_ch=2)),
                                      ("joint_indi", dict(in_ch=1, out_ch=1, channels=1))])
def test_diffusion_train_step_with_dropout_runs(which, kw):
    """unet.dropout > 0 trains: the masks come from the trainer's generator
    (two models of one seed take the same step, bit for bit), dropout acts
    (the loss differs from the same step at rate 0 with the same t and
    noise) and `test` serves without it."""
    batch = synth_batch(out_ch=2)
    logs, nets = [], []
    for rate in (0.2, 0.2, 0.0):
        opt = tiny_opt(which, **kw)
        opt["model"]["unet"]["dropout"] = rate
        m = DiffusionModel(opt, device="cpu", seed=0)
        nets.append(m)
        m.feed_data(batch)
        g = torch.Generator().manual_seed(1)
        shape = (8, 16, 16, 1 if which == "joint_indi" else 2)
        draws = [(torch.full((8,), 0.5), torch.randn(shape, generator=g))
                 for _ in range(2 if which == "joint_indi" else 1)]
        m.optimize_parameters(draws)
        logs.append(m.get_current_log())
    assert np.isfinite(logs[0]["l_pix"]) and logs[0] == logs[1]
    assert logs[0]["l_pix"] != logs[2]["l_pix"]
    for name, p in nets[0].nets.named_parameters():
        assert torch.equal(p, dict(nets[1].nets.named_parameters())[name]), name
    # serving: eval mode, so the rate-0.2 net and a rate-0 net with its
    # weights give the same output, and the trainer's nets stay in train mode
    nets[2].nets.load_state_dict(nets[0].nets.state_dict())
    outs = []
    for m in (nets[0], nets[2]):
        m.set_new_noise_schedule(m.opt["model"]["beta_schedule"]["val"], "val")
        m._server.generator.manual_seed(3)
        m.feed_data(synth_batch(b=1))
        outs.append(m.test())
    assert torch.equal(outs[0], outs[1]) and nets[0].nets.training


@pytest.mark.parametrize("entry", ["time_prediction_training", "evaluate_time_predictor",
                                   "t_refinement_workflow", "quality_seed_sweep"])
def test_new_entry_points_need_cuda_unless_cpu_is_asked_for(entry, monkeypatch, tmp_path):
    """Each new CLI resolves its device first: `cuda` by default, which
    raises where CUDA is absent; `--device cpu` is the explicit way out (the
    seed sweep, a card-only protocol, has none)."""
    import importlib

    mod = importlib.import_module("diffsplitting_tpu_torch." + (
        entry if entry == "time_prediction_training" else "scripts." + entry))
    cfg = "configs/splitting_hagen_time_predictor.json"
    argv = {"time_prediction_training": ["--config", cfg],
            "evaluate_time_predictor": ["-c", cfg, "--resume", "missing"],
            "t_refinement_workflow": ["-c", "configs/splitting_hagen_indi_joint.json",
                                      "--resume", "missing"],
            "quality_seed_sweep": ["--workdir", str(tmp_path / "sweep")]}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    if entry == "quality_seed_sweep":
        assert not (tmp_path / "sweep").exists()  # raised before any run started


def test_quality_time_predictor_holds_the_jax_protocol(tmp_path):
    """The port's quality script trains on the JAX script's protocol: its
    frames, frame size and patch, and the time predictor config otherwise
    as the file has it (JAX scripts/quality_time_predictor.py)."""
    import json
    import os

    from diffsplitting_tpu.config.loader import load_json as jax_load_json
    from diffsplitting_tpu_torch.scripts import quality_time_predictor as qtp

    src = open(os.path.join(qtp.REPO, "scripts/quality_time_predictor.py")).read()
    assert f"make_stacks(data, frames={qtp.FRAMES}, size={qtp.SIZE})" in src
    assert f'opt["datasets"]["patch_size"] = {qtp.PATCH}' in src
    data = str(tmp_path / "data")
    with open(qtp.write_config(str(tmp_path), data, 60)) as f:
        got = json.load(f)
    want = jax_load_json(os.path.join(qtp.REPO, "configs/splitting_hagen_time_predictor.json"))
    for split in ("train", "val"):
        want["datasets"][split]["datapath"] = {"ch0": f"{data}/{split}/{split}_actin.tif",
                                               "ch1": f"{data}/{split}/{split}_mito.tif"}
    want["train"]["num_epochs"] = 60
    want["datasets"]["patch_size"] = 256
    assert got == want


@pytest.mark.parametrize("val_psnrs,collapsed", [([38.8, 40.4, 42.4, 43.5], False),
                                                 ([38.8, 40.4, 35.3, 41.0], True),
                                                 ([38.8, 40.4, 42.4, 35.5], False),
                                                 ([41.0, 38.0, 40.0, 35.9], True)])
def test_seed_sweep_counts_a_collapse(val_psnrs, collapsed):
    """A joint run collapsed where a validation PSNR after iteration 2000
    lies more than 5 dB under the best up to 2000."""
    from diffsplitting_tpu_torch.scripts.quality_seed_sweep import collapsed as rule

    assert rule(val_psnrs) is collapsed
