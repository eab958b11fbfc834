"""The port's DDPM / SR3 serving accelerators against the JAX package's, on
the CPU: DeepCache (diffusion/deepcache.py), parallel-in-time sampling and
the sliding window (diffusion/parallel_sampling.py), the trainer's routing
of `test` / `sample` through them, and infer.py / sample.py's flags.

  * `cached_p_sample_loop` (SR3 conditional, DDPM unconditional) and
    `cached_ddim_sample_loop` at intervals 1 and 2 through a tiny UNet
    (inner 8, mults (1, 2), attention at 8², 16² images, depth 1), JAX's
    chain jitted once a model with its refresh flags traced; at interval 1
    each is the port's uncached chain bit for bit;
  * `ddpm_sample_parallel` after T sweeps and `ddpm_sample_sliding_window`
    at τ = 0 (W = 1 and 3; the sweep counts too, and at a large τ) through
    tests/test_torch_port_sr3.py's closed-form denoiser, for DDPM and with
    SR3's noise level; through that elementwise denoiser both are the port's
    exact chain from one generator bit for bit;
  * the trainer: config keys and setters, unset restores the exact chain,
    the window excludes DDIM and DeepCache, trajectory requests serve the
    exact chain, the EMA nets serve, indi ignores DDIM, `model.quant`
    serves W8A8 for every family (tests/test_ddim_serving.py,
    test_ddim_deepcache.py and test_deepcache_serving.py's contract);
  * infer.py and sample.py with `--ddim 2 --deepcache 1` write the files the
    top-level CLIs write with an accelerator on (their final frames only).

JAX's draws are replayed as injected noise: the initial draw from
split(rng)[1], then one a step from split(rng, n), or, for JAX's window, step
g's from fold_in(rng, g). Tolerance: max abs ≤ 1e-4·max|ref| + 1e-5 (f32 both
sides; sums in another order).
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import deepcache as jax_dc
from diffsplitting_tpu.diffusion import parallel_sampling as jax_ps
from diffsplitting_tpu_torch import infer as port_infer, sample as port_sample
from diffsplitting_tpu_torch.diffusion import ddim, deepcache as dc, parallel_sampling as ps
from diffsplitting_tpu_torch.train import DiffusionModel

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_ddim import B, C, close, condition, jax_t_cond, procs
from tests.test_torch_port_sr3 import chain_noise, flax_and_port, jax_denoiser, torch_denoiser
from tests.test_torch_port_sr_cli import lrhr_root, pngs, sr_config  # noqa: F401
from tests.test_trainer import tiny_opt

T = 8  # the schedule of tests/test_torch_port_ddim.py
S = 4
SHAPE = (B, 16, 16, C)
MODELS = [("sr3", True), ("ddpm", False)]
MODEL_IDS = ["sr3_cond", "ddpm_sample"]


def traced_t_cond(which, js):
    """SR3's noise level indexed in the trace, as JAX's serving passes it to
    the window (trainer.py:991-994); None (raw t) for DDPM."""
    return (lambda t: js.sqrt_alphas_cumprod_prev[t + 1]) if which == "sr3" else None


def x_of(cond):
    return torch.from_numpy(condition()) if cond else SHAPE


# ------------------------------------------------------------------ DeepCache


@pytest.fixture(scope="module")
def cached_chains():
    """For each model: the port's UNet and JAX's cached chain at intervals 1
    and 2, and for SR3 its cached DDIM chain, from one jit each with the
    flags traced."""
    out = {}
    for which, cond in MODELS:
        net, params, port = flax_and_port("noise_level" if which == "sr3" else "time",
                                          in_channel=2 * C if cond else C, seed=4)
        jp, _, js, _ = procs(which, cond)
        full, shallow, _ = jax_dc.make_cached_denoisers(net, {"params": params}, 1)
        x_in = jnp.asarray(condition()) if cond else SHAPE
        chain = jax.jit(lambda r, f: jax_dc.cached_p_sample_loop(
            jp, js, r, x_in, full, shallow, refresh_override=f))
        ddim_chain = jax.jit(lambda r, f: jax_dc.cached_ddim_sample_loop(
            jp, js, r, x_in, full, shallow, steps=S, eta=1.0, t_cond=jax_t_cond(which, js),
            refresh_override=f))
        rng = jax.random.PRNGKey(31)
        res = {}
        for interval in (1, 2):
            res["p", interval] = np.asarray(chain(rng, dc._refresh_flags(T, interval)))
            if which == "sr3":
                res["ddim", interval] = np.asarray(ddim_chain(rng,
                                                              dc._refresh_flags(S, interval)))
        out[which] = (port, rng, res)
    return out


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("which,cond", MODELS, ids=MODEL_IDS)
def test_cached_p_sample_loop_matches_jax(which, cond, interval, cached_chains):
    port, rng, want = cached_chains[which]
    _, tp, _, ts = procs(which, cond)
    noise = chain_noise(rng, SHAPE, T)
    full, shallow = dc.make_cached_denoisers(port, 1)
    got = dc.cached_p_sample_loop(tp, ts, x_of(cond), full, shallow, interval, noise=noise)
    close(got, want["p", interval])
    if interval == 1:
        assert torch.equal(got, tp.p_sample_loop(port, ts, x_of(cond), noise=noise))


@pytest.mark.parametrize("interval", [1, 2])
def test_cached_ddim_sample_loop_matches_jax(interval, cached_chains):
    which, cond = MODELS[0]
    port, rng, want = cached_chains[which]
    _, tp, _, ts = procs(which, cond)
    noise = chain_noise(rng, SHAPE, S)
    full, shallow = dc.make_cached_denoisers(port, 1)
    got = dc.cached_ddim_sample_loop(tp, ts, x_of(cond), full, shallow, S, 1.0, interval,
                                     noise=noise)
    close(got, want["ddim", interval])
    if interval == 1:
        assert torch.equal(got, ddim.ddim_sample_loop(tp, port, ts, x_of(cond), S, 1.0,
                                                      noise=noise))


def test_cached_loops_refuse_flags_without_a_first_refresh():
    _, tp, _, ts = procs("ddpm", False)
    with pytest.raises(ValueError, match="starting with a refresh"):
        dc.cached_p_sample_loop(tp, ts, SHAPE, None, None, refresh_override=[0] + [1] * (T - 1))


# ------------------------------------------------------------------ parallel sampling


@pytest.mark.parametrize("which,cond", [("ddpm", True), ("sr3", False)],
                         ids=["ddpm_cond", "sr3_sample"])
def test_ddpm_sample_parallel_after_T_sweeps(which, cond):
    jp, tp, js, ts = procs(which, cond)
    rng = jax.random.PRNGKey(41)
    x_in = jnp.asarray(condition()) if cond else SHAPE
    want = jax.jit(lambda r: jax_ps.ddpm_sample_parallel(
        jp, jax_denoiser, js, r, x_in, num_sweeps=T, t_cond=traced_t_cond(which, js)))(rng)
    got = ps.ddpm_sample_parallel(tp, torch_denoiser, ts, x_of(cond), num_sweeps=T,
                                  noise=chain_noise(rng, SHAPE, T))
    close(got, want)
    # the exact chain from one generator; the tolerance loop stops at T too
    g = [torch.Generator().manual_seed(2) for _ in range(3)]
    exact = tp.p_sample_loop(torch_denoiser, ts, x_of(cond), generator=g[0])
    assert torch.equal(ps.ddpm_sample_parallel(tp, torch_denoiser, ts, x_of(cond),
                                               num_sweeps=T, generator=g[1]), exact)
    assert torch.equal(ps.ddpm_sample_parallel(tp, torch_denoiser, ts, x_of(cond), tol=0.0,
                                               generator=g[2]), exact)


def window_noise(rng, shape, n):
    """The draws of JAX's window from `rng`: the initial image from
    split(rng)[1], step g's from fold_in(split(rng)[0], g)."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(rng, g), shape, jnp.float32)
              for g in range(n)]
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.mark.parametrize("which,window,tau", [("ddpm", 1, 0.0), ("ddpm", 3, 0.0),
                                              ("sr3", 3, 0.0), ("sr3", 3, 1e9)])
def test_ddpm_sliding_window_matches_jax(which, window, tau):
    jp, tp, js, ts = procs(which, True)
    rng = jax.random.PRNGKey(43)
    want, want_sweeps = jax.jit(lambda r, x: jax_ps.ddpm_sample_sliding_window(
        jp, jax_denoiser, js, r, x, window=window, tau=tau, t_cond=traced_t_cond(which, js)))(
        rng, jnp.asarray(condition()))
    got, sweeps = ps.ddpm_sample_sliding_window(tp, torch_denoiser, ts, x_of(True), window, tau,
                                                noise=window_noise(rng, SHAPE, T))
    assert sweeps == int(want_sweeps)
    if tau == 0.0:
        assert sweeps == T
        close(got, want)
        # τ = 0 is the exact chain from one generator
        g = [torch.Generator().manual_seed(4) for _ in range(2)]
        got, _ = ps.ddpm_sample_sliding_window(tp, torch_denoiser, ts, x_of(True), window, 0.0,
                                               generator=g[0])
        assert torch.equal(got, tp.p_sample_loop(torch_denoiser, ts, x_of(True), generator=g[1]))


# ------------------------------------------------------------------ the trainer


def sr_opt(which="sr3", conditional=True, **accel):
    opt = tiny_opt(which, conditional=conditional, in_ch=4 if conditional else 2, out_ch=2,
                   channels=2)
    opt["model"].update(accel)
    return opt


def served(opt, seed=0):
    m = DiffusionModel(opt, device="cpu", seed=seed)
    m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    if m.process.conditional:
        m.feed_data({"input": np.random.default_rng(5).normal(size=(1, 16, 16, 2))
                     .astype(np.float32)})
    return m


def serve(m, **kw):
    m.sample_generator.manual_seed(7)
    if m.process.conditional:
        return m.test(**kw)
    return m.sample(batch_size=1, **kw)


def direct(m, chain, *args, **kw):
    """`chain` on the model's serving UNet in eval mode, from the generator
    state `serve` starts from."""
    m.sample_generator.manual_seed(7)
    x_in = m.data["input"] if m.process.conditional else (1, 16, 16, 2)
    with m._serving_unet("test") as unet:
        return chain(m.process, unet, m.current_sched, x_in, *args,
                     generator=m.sample_generator, device=m.device)


def cached(depth):
    def run(process, unet, sched, x_in, *args, **kw):
        loop = dc.cached_ddim_sample_loop if len(args) == 3 else dc.cached_p_sample_loop
        return loop(process, sched, x_in, *dc.make_cached_denoisers(unet, depth), *args, **kw)
    return run


@pytest.mark.parametrize("which,cond", [("sr3", True), ("ddpm", False)],
                         ids=["sr3_test", "ddpm_sample"])
def test_config_keys_route_each_accelerator(which, cond):
    """Each config key serves its chain; DDIM × DeepCache resolves 'auto'
    over DDIM's S steps (2 of T = 4 here: interval 1), DeepCache alone over
    T (interval 2); set_*(None) restores the exact chain."""
    exact = serve(served(sr_opt(which, cond)))
    m = served(sr_opt(which, cond, ddim={"steps": 2}))
    assert m.ddim == (2, 0.0)
    got = serve(m)
    assert got.shape == (1, 16, 16, 2) and torch.equal(got, serve(m))  # η = 0: deterministic
    assert torch.equal(got, direct(m, ddim.ddim_sample_loop, 2, 0.0))
    m.set_deepcache("auto")
    assert torch.equal(serve(m), direct(m, cached(1), 2, 0.0, 1))
    m.set_ddim(None)
    assert torch.equal(serve(m), direct(m, cached(1), 2))
    m.set_deepcache(None)
    m.set_sliding_window(2, 0.0)
    assert torch.equal(serve(m), direct(m, lambda *a, **kw: ps.ddpm_sample_sliding_window(
        *a, **kw)[0], 2, 0.0))
    assert m.last_sliding_sweeps == 4
    m.set_sliding_window(None)
    assert torch.equal(serve(m), exact)

    m = served(sr_opt(which, cond, deepcache={"interval": 1, "depth": 1},
                      sliding_window={"window": 3}))
    assert (m.deepcache, m.sliding_window) == ((1, 1), (3, 0.1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve(m)
    m.set_deepcache(None)
    m.set_ddim(3, 1.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve(m)
    m.set_sliding_window(None)
    m.set_deepcache(1)
    # DeepCache at interval 1 is the uncached chain, bit for bit
    assert torch.equal(serve(m), direct(m, ddim.ddim_sample_loop, 3, 1.0))


def test_trajectory_requests_serve_the_exact_chain_with_one_warning(caplog):
    m = served(sr_opt(ddim={"steps": 2}, deepcache={"interval": 2}))
    exact = served(sr_opt())
    with caplog.at_level(logging.WARNING, logger="base"):
        for _ in range(2):
            frames = serve(m, continuous=True)
    assert frames.shape == (5, 1, 16, 16, 2)
    assert torch.equal(frames, serve(exact, continuous=True))
    for name in ("ddim", "deepcache"):
        assert sum(f"{name} ignores continuous" in r.message for r in caplog.records) == 1


def test_ema_nets_serve_through_the_accelerators():
    opt = sr_opt(ddim={"steps": 2, "eta": 0.5})
    opt["train"]["ema_scheduler"] = {"enabled": True, "ema_decay": 0.5, "step_start_ema": 0}
    m = served(opt)
    m.feed_data({"input": np.random.default_rng(1).normal(size=(2, 16, 16, 2)).astype(np.float32),
                 "target": np.random.default_rng(2).normal(size=(2, 16, 16, 2))
                 .astype(np.float32)})
    m.optimize_parameters()
    m.feed_data({"input": np.random.default_rng(5).normal(size=(1, 16, 16, 2))
                 .astype(np.float32)})
    got = serve(m)
    assert torch.equal(got, direct(m, ddim.ddim_sample_loop, 2, 0.5))
    with torch.no_grad():  # the EMA copy differs from the trained nets
        assert any(not torch.equal(a, b) for a, b in zip(m.ema_nets.parameters(),
                                                          m.nets.parameters()))
    m.use_ema = False
    assert not torch.equal(serve(m), got)


def test_indi_ignores_ddim():
    opt = tiny_opt("joint_indi", in_ch=1, out_ch=1, channels=1)
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 1)).astype(np.float32)
    outs = []
    for ddim_opt in (None, {"steps": 2}):
        opt["model"]["ddim"] = ddim_opt
        m = DiffusionModel(opt, device="cpu", seed=0)
        m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
        m.feed_data({"input": x})
        outs.append(m.test())
    assert m.ddim == (2, 0.0) and torch.equal(*outs)


@pytest.mark.parametrize("which", ["indi", "joint_indi", "sr3"])
def test_quant_serves_every_family(which):
    """`model.quant` serves the W8A8 nets for every family (the unconditional
    sr3 through `sample`), as JAX's trainer does; unset, the exact chain."""
    opt = tiny_opt(which, in_ch=2, out_ch=2)
    outs, kinds = [], []
    for quant in ({"bits": 8}, None):
        opt["model"]["quant"] = quant
        m = DiffusionModel(opt, device="cpu", seed=0)
        m.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
        if which == "sr3":
            m.sample_generator.manual_seed(0)
            outs.append(m.sample(2))
        else:
            m.feed_data({"input": np.random.default_rng(0).normal(size=(2, 16, 16, 2))
                         .astype(np.float32)})
            outs.append(m.test())
        assert torch.isfinite(outs[-1]).all()
        kinds.append(sorted(key[0] for key in m.switches._quant_nets))
    assert kinds == [["sample" if which == "sr3" else "test"], []]
    assert outs[0].shape == outs[1].shape and not torch.equal(*outs)


# ------------------------------------------------------------------ the CLIs


def test_infer_with_ddim_and_deepcache_writes_final_frames(lrhr_root, tmp_path):
    """JAX's infer.py writes `_sr`, `_hr` and `_inf` and no `_sr_process.png`
    with an accelerator on (infer.py:115-135)."""
    cfg = sr_config(tmp_path, lrhr_root / "root", "sr3", True)
    out = port_infer.main(["-c", cfg, "-rootdir", str(tmp_path / "port"), "--device", "cpu",
                           "--ddim", "2", "--deepcache", "1"])
    got = pngs(Path(out["results"]))
    assert sorted(got) == sorted(f"0_{i}_{k}.png" for i in (1, 2) for k in ("hr", "inf", "sr"))
    assert all(v.shape == (16, 16, 3) for v in got.values())
    assert (out["model"].ddim, out["model"].deepcache) == ((2, 0.0), (1, 1))


def test_sample_with_ddim_and_deepcache_writes_final_frames(lrhr_root, tmp_path):
    """JAX's sample.py writes `_sample.png` alone with an accelerator on
    (sample.py:91-93)."""
    cfg = sr_config(tmp_path, lrhr_root / "root", "ddpm", False)
    out = port_sample.main(["-c", cfg, "-p", "val", "-rootdir", str(tmp_path / "port"),
                            "--device", "cpu", "--ddim", "2", "--deepcache", "1"])
    got = pngs(Path(out["results"]))
    assert sorted(got) == [f"0_{i}_sample.png" for i in (1, 2)]
    assert all(v.shape == (16, 16, 3) for v in got.values())
