"""The port's train-step options against the JAX package's `DiffusionModel`,
over four micro-steps of indi at tests/test_trainer.py's `tiny_opt` size.

Each case combines options, so that every one of them runs against the JAX
model at the cost of three compiles:
  * a float `grad_clip` below the gradient norm (optax's clip_by_global_norm),
    a cosine LR schedule with warmup, and the EMA with `step_start_ema: 2`;
  * `grad_clip: "auto"` (its warmup set to 2 on both sides, and factor 0.5 so
    that it clips), `accum_steps: 2`, a linear schedule with warmup;
  * a constant schedule with warmup.
t and the noise are replayed from the JAX keys (see test_torch_port_train).
Tolerances: logs relative 2e-6 (f32, another summation order); params and
the EMA after four steps within 3e-2·lr of JAX's, except the elements whose
first gradient is at most 1e-3 of its tensor's max (Adam's first update of
such an element may move by ±lr on a rounding difference), held to 8·lr.
"""

import functools

import numpy as np
import pytest

from diffsplitting_tpu.train import clipping as jax_clipping
from diffsplitting_tpu_torch.train import clipping

from tests.test_torch_port_train import (KW, LR, assert_logs_match, build_pair, step_both,
                                         to_port)
from tests.test_trainer import synth_batch, tiny_opt

CASES = {
    "clip_cosine_ema": (dict(grad_clip=0.3, schedule=dict(type="cosine", warmup=2,
                                                         decay_iters=6, end_factor=0.1)),
                        dict(enabled=True, step_start_ema=2, ema_decay=0.9)),
    "auto_accum_linear": (dict(grad_clip="auto", grad_clip_factor=0.5, accum_steps=2,
                               schedule=dict(type="linear", warmup=1, decay_iters=4,
                                             end_factor=0.2)), None),
    "constant_warmup": (dict(schedule=dict(type="constant", warmup=2)), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_options_match_jax_over_four_steps(case, monkeypatch):
    optimizer, ema = CASES[case]
    monkeypatch.setattr(jax_clipping, "clip_by_ema_norm",
                        functools.partial(jax_clipping.clip_by_ema_norm, warmup=2))
    monkeypatch.setattr(clipping, "ClipByEmaNorm",
                        functools.partial(clipping.ClipByEmaNorm, warmup=2))
    opt = tiny_opt("indi", **KW["indi"])
    opt["train"]["optimizer"].update(optimizer)
    if ema:
        opt["train"]["ema_scheduler"] = ema
    jm, port = build_pair(opt)
    batch = synth_batch(out_ch=2)
    exempt = {}
    for i in range(4):
        jlog, plog = step_both(jm, port, batch)
        assert_logs_match(jlog, plog)
        if i == 0:
            exempt = {n: np.abs(p.grad.numpy()) <= 1e-3 * np.abs(p.grad.numpy()).max()
                      for n, p in port.nets.named_parameters()}
    k = int(optimizer.get("accum_steps") or 1)
    assert port.global_step == jm.global_step == 4 and port.updates == 4 // k

    trees = [(port.nets, jm.params)] + ([(port.ema_nets, jm.ema_params)] if ema else [])
    for module, tree in trees:
        want = to_port(jm, tree)
        for name, p in module.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            ex = exempt[name]
            assert diff[~ex].max(initial=0) <= 3e-2 * LR, name
            assert diff[ex].max(initial=0) <= 8 * LR, name
    if case == "auto_accum_linear":
        assert port.clip.count == 2 and float(port.clip.ema) > 0
