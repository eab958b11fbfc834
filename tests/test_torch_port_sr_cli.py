"""The port's SR data and CLIs against the JAX package's, on synthetic PNGs.

  * `prepare_data` (PNG dirs and LMDB, through tests/fake_lmdb.py as the
    JAX tests use it) writes the same images, bit for bit;
  * `LRHRDataset` gives the same items (train flips included, same seed),
    bit for bit;
  * infer.py and sample.py (val phase) on the CPU (`--device cpu`) on a tiny
    config (inner 8, 4 groups, mults (1, 2), 16², 4 steps) write the same
    files as the repository's top-level CLIs; the `_hr` and `_inf` images
    are equal bit for bit (the chains' noise differs: the packages draw
    from different generators);
  * eval.py prints the same PSNR / SSIM lines as the top-level eval.py on the
    same PNGs.
"""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from diffsplitting_tpu.data import lrhr_dataset as jax_lrhr
from diffsplitting_tpu.data import prepare_data as jax_prepare
from diffsplitting_tpu_torch import eval as port_eval, infer as port_infer, sample as port_sample
from diffsplitting_tpu_torch.config import load_json
from diffsplitting_tpu_torch.data import create_dataset, lrhr_dataset
from diffsplitting_tpu_torch.data import prepare_data

from tests import fake_lmdb
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)

SIZES = (4, 16)


def write_sources(src: Path):
    """Three seeded RGB PNGs of other sizes than the targets, so that
    prepare_data resizes and crops."""
    rng = np.random.default_rng(0)
    src.mkdir(parents=True)
    for i, (h, w) in enumerate([(40, 48), (24, 24), (50, 36)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(src / f"{i}.png")


@pytest.fixture(scope="module")
def lrhr_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lrhr")
    write_sources(tmp / "src")
    assert prepare_data.prepare(str(tmp / "src"), str(tmp / "root"), n_worker=1,
                                sizes=SIZES) == 3
    return tmp


def pngs(root: Path) -> dict:
    return {str(p.relative_to(root)): np.asarray(Image.open(p)) for p in sorted(root.rglob("*.png"))}


def test_prepare_data_matches_jax(lrhr_root, tmp_path, monkeypatch):
    src = lrhr_root / "src"
    jax_prepare.prepare(str(src), str(tmp_path / "jax"), n_worker=1, sizes=SIZES)
    prepare_data.main(["--path", str(src), "--out", str(tmp_path / "port"), "--size", "4,16",
                       "--n_worker", "2"])
    want, got = pngs(tmp_path / "jax"), pngs(tmp_path / "port_4_16")
    assert sorted(want) == sorted(got) and len(got) == 9
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["hr_16/00001.png"].shape == (16, 16, 3) and got["lr_4/00001.png"].shape == (4, 4, 3)

    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    jax_prepare.prepare(str(src), str(tmp_path / "jax_lmdb"), n_worker=1, sizes=SIZES,
                        lmdb_save=True)
    prepare_data.prepare(str(src), str(tmp_path / "port_lmdb"), n_worker=1, sizes=SIZES,
                         lmdb_save=True)
    stores = [fake_lmdb.open(str(tmp_path / d), readonly=True)._store
              for d in ("jax_lmdb", "port_lmdb")]
    assert stores[0] == stores[1] and stores[1][b"length"] == b"3"


@pytest.mark.parametrize("datatype,split,need_LR", [("img", "val", True), ("img", "train", False),
                                                    ("lmdb", "train", True)])
def test_lrhr_dataset_matches_jax(lrhr_root, tmp_path, monkeypatch, datatype, split, need_LR):
    root = str(lrhr_root / "root")
    if datatype == "lmdb":
        monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
        root = str(tmp_path / "db")
        prepare_data.prepare(str(lrhr_root / "src"), root, n_worker=1, sizes=SIZES,
                             lmdb_save=True)
    kw = dict(dataroot=root, datatype=datatype, l_resolution=4, r_resolution=16, split=split,
              data_len=-1, need_LR=need_LR)
    want, got = jax_lrhr.LRHRDataset(**kw), lrhr_dataset.LRHRDataset(**kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = want[i], got[i]
        assert sorted(a) == sorted(b) == sorted(["HR", "SR", "Index"] + (["LR"] if need_LR else []))
        for k in a:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    capped = create_dataset(dict(kw, mode="LRHR" if need_LR else "HR", data_len=2), split)
    assert len(capped) == 2 and ("LR" in capped[0]) == need_LR


def sr_config(tmp_path: Path, root: Path, which: str, conditional: bool) -> str:
    ds = {"name": "CelebaHQ", "datatype": "img", "dataroot": str(root), "l_resolution": 4,
          "r_resolution": 16, "batch_size": 2, "use_shuffle": True}
    cfg = {
        "name": f"{which}_cli", "phase": "val", "gpu_ids": [0],
        "path": {"root": str(tmp_path), "log": "logs", "results": "results",
                 "checkpoint": "checkpoint", "resume_state": None},
        "datasets": {"train": dict(ds, mode="HR", data_len=-1),
                     "val": dict(ds, mode="LRHR", data_len=2)},
        "model": {
            "which_model_G": which, "finetune_norm": False,
            "unet": {"in_channel": 6 if conditional else 3, "out_channel": 3,
                     "inner_channel": 8, "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": 0},
            "beta_schedule": {ph: {"schedule": "linear", "n_timestep": 4, "linear_start": 1e-6,
                                   "linear_end": 1e-2} for ph in ("train", "val")},
            "diffusion": {"image_size": 16, "channels": 3, "conditional": conditional},
        },
        "train": {"n_iter": 2, "val_freq": 10, "save_checkpoint_freq": 10, "print_freq": 1,
                  "optimizer": {"type": "adam", "lr": 1e-4}},
        "wandb": {"project": "cli"},
    }
    path = tmp_path / f"{which}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def run_jax_cli(module: str, argv: list, monkeypatch):
    """The repository's top-level CLI `module` in this process, with `argv`;
    the log handlers it adds are removed after."""
    import importlib

    before = {n: list(logging.getLogger(n).handlers) for n in (None, "val")}
    monkeypatch.setattr(sys, "argv", [module + ".py"] + argv)
    try:
        importlib.import_module(module).main()
    finally:
        for n, hs in before.items():
            for h in list(logging.getLogger(n).handlers):
                if h not in hs:
                    logging.getLogger(n).removeHandler(h)
                    h.close()


def results_of(rootdir: Path) -> Path:
    (res,) = [p for p in rootdir.rglob("results") if p.is_dir()]
    return res


def test_infer_and_eval_write_what_jax_writes(lrhr_root, tmp_path, monkeypatch, capsys):
    cfg = sr_config(tmp_path, lrhr_root / "root", "sr3", True)
    run_jax_cli("infer", ["-c", cfg, "-rootdir", str(tmp_path / "jax")], monkeypatch)
    out = port_infer.main(["-c", cfg, "-rootdir", str(tmp_path / "port"), "--device", "cpu"])
    want, got = pngs(results_of(tmp_path / "jax")), pngs(Path(out["results"]))
    assert sorted(got) == sorted(want) == sorted(
        f"0_{i}_{k}.png" for i in (1, 2) for k in ("hr", "inf", "sr", "sr_process"))
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith(("_hr.png", "_inf.png")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(out["seconds"]) == 2

    capsys.readouterr()
    run_jax_cli("eval", ["-p", str(results_of(tmp_path / "jax"))], monkeypatch)
    jax_lines = capsys.readouterr().out
    scores = port_eval.main(["-p", str(results_of(tmp_path / "jax"))])
    assert capsys.readouterr().out == jax_lines and "PSNR" in jax_lines
    assert scores["n"] == 2 and np.isfinite(scores["psnr"])


def test_sample_val_phase_writes_what_jax_writes(lrhr_root, tmp_path, monkeypatch):
    cfg = sr_config(tmp_path, lrhr_root / "root", "ddpm", False)
    run_jax_cli("sample", ["-c", cfg, "-p", "val", "-rootdir", str(tmp_path / "jax")],
                monkeypatch)
    out = port_sample.main(["-c", cfg, "-p", "val", "-rootdir", str(tmp_path / "port"),
                            "--device", "cpu"])
    want, got = pngs(results_of(tmp_path / "jax")), pngs(Path(out["results"]))
    assert sorted(got) == sorted(want) == sorted(
        f"0_{i}_{k}.png" for i in (1, 2) for k in ("sample", "sample_process"))
    for k in want:
        assert got[k].shape == want[k].shape, k


@pytest.mark.parametrize("flag", [["--w8a8"], ["--w8a8_sites", "all"]])
def test_cli_accelerator_flags_are_refused(flag, lrhr_root, tmp_path):
    """W8A8 (ROADMAP item 1g) is refused; --ddim, --deepcache and
    --sliding_window serve (tests/test_torch_port_sr_accelerators.py)."""
    cfg = sr_config(tmp_path, lrhr_root / "root", "sr3", True)
    for cli in (port_infer, port_sample):
        with pytest.raises(NotImplementedError, match="item 1g"):
            cli.main(["-c", cfg, "-p", "val", "-rootdir", str(tmp_path / "exp"), "--device",
                      "cpu"] + flag)
    assert not (tmp_path / "exp").exists()  # refused before any directory is made


def test_infer_refuses_bfloat16_config(tmp_path):
    """The JAX CLI's default config computes in bfloat16, which the port
    serves since models/precision.py was ported (tests/test_torch_port_sr512.py
    drives it). What infer.py still refuses, before any directory is made, is
    a compute_dtype the JAX package does not take: that config at float16."""
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads(json.dumps(load_json(str(root / "configs/sr_sr3_64_512.json"))))
    cfg["model"]["compute_dtype"] = "float16"
    path = tmp_path / "sr_sr3_64_512_float16.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        port_infer.main(["-c", str(path), "-rootdir", str(tmp_path / "exp"), "--device", "cpu"])
    assert not (tmp_path / "exp").exists()
