"""The quality protocols at other init seeds, on one card.

Two stages, the runs of each started together in processes of their own so
that they share the card:
  1. `quality_joint_indi_synthetic` at its defaults (16 frames of 1024²,
     patch 256, batch 8, 4000 iterations, pool seed 0) with the joint model's
     weights drawn from each init seed of JOINT_SEEDS, and
     `quality_time_predictor` for TP_EPOCHS epochs at each trainer seed of
     TP_SEEDS;
  2. `quality_t_refinement` (its protocol: 8 held-out frames of 1024² from
     seed 7, 256² crops, N = 10) with each joint model of stage 1 and the
     time predictor of trainer seed TREF_TP_SEED.
The seeds reach the models as the `seed` of `train.create_model` and of
`time_prediction_training.start_training`, which each run's process binds
before it starts; the CLIs take no seed flag.

Each run writes its output to `<workdir>/<run>.log`, its results to
`<workdir>/<run>.json` and its files under `<workdir>/<run>/`; the summary,
with a joint run counted as collapsed where a validation PSNR after
iteration 2000 lies more than 5 dB under the best up to 2000, goes to
`<workdir>/summary.json`. About 25 minutes on an H100.

  python -m diffsplitting_tpu_torch.scripts.quality_seed_sweep \\
      [--workdir build/quality_seed_sweep]
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import sys
from typing import Optional

from ..device import resolve_device
from .quality_joint_indi_synthetic import REPO

JOINT_SEEDS = (1, 2)
TP_SEEDS = (0, 1, 2)
TP_EPOCHS = 60
TREF_TP_SEED = 0
COLLAPSE_DB = 5.0


def joint_run(seed: int, workdir: str) -> dict:
    from .. import split
    from . import quality_joint_indi_synthetic

    split.create_model = functools.partial(split.create_model, seed=seed)
    out = quality_joint_indi_synthetic.main(["--workdir", workdir])
    return {"metrics": out["metrics"], "val_psnrs": [float(v) for v in out["val_psnrs"]],
            "checkpoint": out["checkpoint"], "config": f"{workdir}/cfg_joint_indi.json"}


def time_predictor_run(seed: int, workdir: str) -> dict:
    from .. import time_prediction_training
    from . import quality_time_predictor

    time_prediction_training.start_training = functools.partial(
        time_prediction_training.start_training, seed=seed)
    out = quality_time_predictor.main(["--epochs", str(TP_EPOCHS), "--workdir", workdir])
    return {"rmse": out["metrics"]["rmse"], "per_t": out["metrics"]["per_t"],
            "best_val_loss": float(out["best_val_loss"]), "checkpoint": out["checkpoint"],
            "config": f"{workdir}/cfg_tp.json"}


def t_refinement_run(joint: dict, time_predictor: dict, workdir: str) -> dict:
    from . import quality_t_refinement

    rows = quality_t_refinement.main(
        ["--joint-config", joint["config"], "--resume", joint["checkpoint"],
         "--time-config", time_predictor["config"], "--time-resume",
         time_predictor["checkpoint"], "--workdir", workdir])
    return {"rows": rows}


def _logged(name: str, workdir: str, fn, *args) -> None:
    """Runs fn(*args, <workdir>/<name>) with its output sent to
    <workdir>/<name>.log; writes its result to <workdir>/<name>.json."""
    with open(f"{workdir}/{name}.log", "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        result = fn(*args, f"{workdir}/{name}")
        sys.stdout.flush()
    with open(f"{workdir}/{name}.json", "w") as f:
        json.dump(result, f, indent=1)


def run_together(jobs: list, workdir: str) -> dict:
    """Starts every (name, fn, args) of `jobs` in a process of its own, waits
    for all, raises if one failed; returns their results by name."""
    ctx = multiprocessing.get_context("spawn")
    procs = [(name, ctx.Process(target=_logged, args=(name, workdir, fn, *args)))
             for name, fn, args in jobs]
    for _, p in procs:
        p.start()
    for _, p in procs:
        p.join()
    failed = [name for name, p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"runs {failed} failed: see their logs under {workdir}")
    results = {}
    for name, _ in procs:
        with open(f"{workdir}/{name}.json") as f:
            results[name] = json.load(f)
    return results


def collapsed(val_psnrs: list) -> bool:
    """Validation (every 1000 of 4000 iterations) falls more than COLLAPSE_DB
    under its best up to iteration 2000 at a later check."""
    return any(v < max(val_psnrs[:2]) - COLLAPSE_DB for v in val_psnrs[2:])


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "quality_seed_sweep"))
    args = ap.parse_args(argv)
    resolve_device(None)  # the card, or raise before any run starts
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)

    trained = run_together(
        [(f"joint_seed{s}", joint_run, (s,)) for s in JOINT_SEEDS]
        + [(f"tp_seed{s}", time_predictor_run, (s,)) for s in TP_SEEDS], workdir)
    tp = trained[f"tp_seed{TREF_TP_SEED}"]
    refined = run_together(
        [(f"tref_joint_seed{s}", t_refinement_run, (trained[f"joint_seed{s}"], tp))
         for s in JOINT_SEEDS], workdir)

    summary = {"joint": {}, "time_predictor": {}, "t_refinement": {}}
    for s in JOINT_SEEDS:
        run = trained[f"joint_seed{s}"]
        n1 = run["metrics"]["1"]
        summary["joint"][s] = {"psnr_ch0": n1["psnr_ch0"], "psnr_ch1": n1["psnr_ch1"],
                               "val_psnrs": run["val_psnrs"],
                               "collapsed": collapsed(run["val_psnrs"])}
        print(f"joint init seed {s}: N=1 {n1['psnr_ch0']!r} / {n1['psnr_ch1']!r} dB, "
              f"validation {run['val_psnrs']}, collapsed {summary['joint'][s]['collapsed']}")
    for s in TP_SEEDS:
        rmse = trained[f"tp_seed{s}"]["rmse"]
        summary["time_predictor"][s] = {"rmse": rmse}
        print(f"time predictor trainer seed {s}: RMSE {rmse!r}")
    for s in JOINT_SEEDS:
        rows = refined[f"tref_joint_seed{s}"]["rows"]
        summary["t_refinement"][s] = rows
        for r in rows:
            print(f"t-refinement, joint seed {s}, t_true {r['t_true']}: classifier t̂ "
                  f"{r['classifier_t']!r}, consensus t {r['consensus_t']!r}, refined − naive "
                  f"{r['psnr_refined_ch0'] - r['psnr_naive_ch0']!r} / "
                  f"{r['psnr_refined_ch1'] - r['psnr_naive_ch1']!r} dB")
    with open(f"{workdir}/summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    print("summary written to", f"{workdir}/summary.json")
    return summary


if __name__ == "__main__":
    main()
