"""The port's data path against the JAX package's, on small synthetic TIFFs
(three 64² frames a channel, patch 32).

  * `SplitDataset` items and `NumpyLoader` batches: equal exactly (the same
    numpy calls drawing from the same seeded generators), across random and
    grid patching, flips, `uncorrelated_channels`,
    `input_from_normalized_target`, `target_channel_idx` and `upper_clip`;
  * `SplitDatasetTiledPred` items and `stitch_predictions`: equal exactly;
  * `augment`: equal exactly;
  * the device pool (`data/device_pool.py`, on CPU tensors here): by
    semantics, since torch cannot replay numpy's stream. Each patch is the
    crop at the offsets it drew, with offsets in [0, H - P); flips are
    paired; input and target equal `SplitDataset`'s normalization of the
    same crop within 1e-6 relative (float32 on the device against float64
    statistics before the cast in numpy); `uncorrelated_channels` draws the
    second frame independently;
  * the quality script's synthetic frames: equal exactly to the JAX
    script's for the same seed.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diffsplitting_tpu.data import NumpyLoader as JaxLoader
from diffsplitting_tpu.data import SplitDataset as JaxDataset
from diffsplitting_tpu.data import SplitDatasetTiledPred as JaxTiled
from diffsplitting_tpu.data import create_dataloader as jax_create_dataloader
from diffsplitting_tpu.data import stitch_predictions as jax_stitch
from diffsplitting_tpu.data.augment import augment as jax_augment
from diffsplitting_tpu.data.split_dataset import DataLocation as JaxLoc
from diffsplitting_tpu_torch.data import (DataLocation, NumpyLoader, SplitDataset,
                                          SplitDatasetTiledPred, create_dataloader, load_data,
                                          stitch_predictions)
from diffsplitting_tpu_torch.data.augment import augment
from diffsplitting_tpu_torch.data.device_pool import DevicePatchPool
from diffsplitting_tpu_torch.scripts import quality_joint_indi_synthetic as port_quality

ROOT = Path(__file__).resolve().parent.parent
P = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run small models. In a suite of several worker processes,
    torch's default of one intra-op thread a core oversubscribes the cores
    many times over and a small op waits on descheduled threads; one thread
    a worker keeps them fast. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tiff(path, frames):
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:])


@pytest.fixture(scope="module")
def tiffs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiffs")
    rng = np.random.default_rng(0)
    paths = []
    for c, hi in ((0, 2500), (1, 1800)):  # ch 0 reaches past the Hagen clip of 1993
        p = str(d / f"ch{c}.tif")
        write_tiff(p, rng.uniform(0, hi, (3, 64, 64)).astype(np.uint16))
        paths.append(p)
    return tuple(paths)


def both(cls_port, cls_jax, tiffs, **kw):
    return (cls_port("Hagen", DataLocation(channelwise_fpath=tiffs), P, **kw),
            cls_jax("Hagen", JaxLoc(channelwise_fpath=tiffs), P, **kw))


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


OPTIONS = [
    dict(random_patching=True, enable_transforms=True),
    dict(random_patching=True, enable_transforms=True, uncorrelated_channels=True,
         input_from_normalized_target=True),
    dict(random_patching=False, target_channel_idx=1, upper_clip=True, max_qval=0.9),
    dict(random_patching=True, channel_weights=[0.3, 0.7], target_channel_idx=0, seed=5),
]


@pytest.mark.parametrize("kw", OPTIONS)
def test_split_dataset_items_equal_jax(tiffs, kw):
    port, jax_ds = both(SplitDataset, JaxDataset, tiffs, **kw)
    assert len(port) == len(jax_ds) == 3 * 4
    for k, v in jax_ds.get_normalization_dict().items():
        assert np.array_equal(np.asarray(port.get_normalization_dict()[k]), np.asarray(v)), k
    for i in list(range(len(port))) * 2:
        assert_items_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_jax(tiffs, shuffle):
    port, jax_ds = both(SplitDataset, JaxDataset, tiffs, random_patching=True,
                        enable_transforms=True)
    a = NumpyLoader(port, batch_size=5, shuffle=shuffle, seed=3)
    b = JaxLoader(jax_ds, batch_size=5, shuffle=shuffle, seed=3)
    assert len(a) == len(b) == 3
    for _ in range(2):  # two epochs: the shuffle generator carries over
        got, want = list(a), list(b)
        assert len(got) == len(want) == 3
        for x, y in zip(got, want):
            assert_items_equal(x, y)


def test_create_dataloader_equal_jax(tiffs):
    port, jax_ds = both(SplitDataset, JaxDataset, tiffs, random_patching=True,
                        enable_transforms=True)
    for phase, opt in (("train", {"batch_size": 4, "use_shuffle": True, "data_len": 10}),
                       ("val", {"data_len": 3})):
        a = list(create_dataloader(port, opt, phase))
        b = list(jax_create_dataloader(jax_ds, opt, phase))
        assert len(a) == len(b) == (3 if phase == "train" else 3)
        for x, y in zip(a, b):
            assert_items_equal(x, y)
    with pytest.raises(NotImplementedError):
        create_dataloader(port, {}, "test")


def test_loader_forwards_dataset_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"item {i}")

    with pytest.raises(KeyError, match="item 0"):
        list(NumpyLoader(Broken(), batch_size=2))


def test_tiled_dataset_and_stitch_equal_jax(tiffs):
    port, jax_ds = both(SplitDatasetTiledPred, JaxTiled, tiffs,
                        input_from_normalized_target=True)
    fields = ("data_shape", "grid_shape", "patch_shape", "tiling_mode")
    assert len(port) == len(jax_ds)
    assert all(tuple(np.ravel(getattr(port.tile_manager, f))) ==
               tuple(np.ravel(getattr(jax_ds.tile_manager, f))) for f in fields)
    for i in range(len(port)):
        assert port.patch_location(i) == jax_ds.patch_location(i)
        assert_items_equal(port[i], jax_ds[i])
    preds = np.random.default_rng(1).normal(size=(len(port), P, P, 2)).astype(np.float32)
    got = stitch_predictions(preds, port.tile_manager)
    assert got.shape == (3, 64, 64, 2)
    assert np.array_equal(got, jax_stitch(preds, jax_ds.tile_manager))


def test_augment_equal_jax():
    imgs = [np.random.default_rng(i).normal(size=(8, 6, 2)) for i in range(2)]
    for seed in range(8):
        got = augment(imgs, split="train", rng=np.random.default_rng(seed))
        want = jax_augment(imgs, split="train", rng=np.random.default_rng(seed))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a, b) for a, b in zip(augment(imgs), imgs))


def test_cifar10_is_not_ported(tmp_path):
    """Named for the refusal it held before CIFAR-10 was ported; it now holds
    `load_data("cifar10", ...)` to JAX's channel dict on synthetic pickles
    (tests/test_torch_port_cifar10_check.py holds the rest)."""
    from diffsplitting_tpu.data.split_dataset import load_data as jax_load_data
    from tests.test_torch_port_cifar10_check import write_cifar

    d = write_cifar(tmp_path / "cifar", n_batches=1)
    got = load_data("cifar10", DataLocation(directory=d))
    want = jax_load_data("cifar10", JaxLoc(directory=d))
    assert sorted(got) == sorted(want) == [0, 1]
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def pool_of(tiffs, batch, **kw):
    ds = SplitDataset("Hagen", DataLocation(channelwise_fpath=tiffs), P, random_patching=True,
                      **kw)
    return ds, DevicePatchPool(ds, batch, seed=4, device="cpu")


@pytest.mark.parametrize("kw", [dict(enable_transforms=True),
                                dict(input_from_normalized_target=True, target_channel_idx=1,
                                     channel_weights=[0.25, 0.75])])
def test_device_pool_batches_are_dataset_crops(tiffs, kw):
    ds, pool = pool_of(tiffs, 64, **kw)
    state = pool.generator.get_state()
    drawn = pool.draw()
    pool.generator.set_state(state)
    loc = pool.sample_locations()
    assert all(torch.equal(drawn[k], pool.batch_at(loc)[k]) for k in drawn)
    H = W = 64
    assert ((loc["h"] >= 0) & (loc["h"] < H - P)).all()
    assert ((loc["w"] >= 0) & (loc["w"] < W - P)).all()
    assert torch.equal(loc["f1"], loc["f2"])
    flips = loc["flip"].float().mean().item()
    assert (0.25 < flips < 0.75) if kw.get("enable_transforms") else flips == 0.0
    for b in range(64):
        f, h, w = (int(loc[k][b]) for k in ("f1", "h", "w"))
        p1 = ds._data_dict[0][f][h:h + P, w:w + P].astype(np.float32)
        p2 = ds._data_dict[1][f][h:h + P, w:w + P].astype(np.float32)
        if bool(loc["flip"][b]):
            p1, p2 = p1[:, ::-1], p2[:, ::-1]
        target = ds.normalize_target(np.stack([p1, p2], axis=-1))
        wts = ds._channel_weights
        if ds._input_from_normalized_target:
            inp = wts[0] * target[..., :1] + wts[1] * target[..., 1:]
        else:
            inp = ds.normalize_inp((wts[0] * p1 + wts[1] * p2)[..., None])
        if ds._target_channel_idx is not None:
            c = ds._target_channel_idx
            target = target[..., c:c + 1]
        for name, want in (("input", inp), ("target", target)):
            got = drawn[name][b].numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0), name


def test_device_pool_uncorrelated_channels_draw_frames_independently(tiffs):
    _, pool = pool_of(tiffs, 3000, uncorrelated_channels=True)
    loc = pool.sample_locations()
    f1, f2 = loc["f1"].numpy(), loc["f2"].numpy()
    # 3 frames: independent draws coincide a third of the time (sd 0.0086)
    assert 0.29 < np.mean(f1 == f2) < 0.38
    joint = np.histogram2d(f1, f2, bins=3)[0] / len(f1)
    assert np.abs(joint - 1 / 9).max() < 0.03


def test_synthetic_frames_equal_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_quality", ROOT / "scripts" / "quality_joint_indi_synthetic.py")
    jax_quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_quality)
    for name in ("synth_actin", "synth_mito"):
        got = getattr(port_quality, name)(np.random.default_rng(2), 64)
        want = getattr(jax_quality, name)(np.random.default_rng(2), 64)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
