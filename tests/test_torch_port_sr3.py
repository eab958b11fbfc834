"""The port's SR3 and DDPM pieces against the JAX package's, on the same
numpy-seeded inputs and weights.

Small widths: inner 8, mults (1, 2), one res block, attention at 8² (the
second level and the mid block), 4 groups, 16² images, 3 output channels,
6 input channels when conditional.

  * the noise-level UNet (`use_affine_level` False and True) and the DDPM
    UNet against `UNet.apply`; max abs ≤ 1e-4·max|ref| + 1e-5 (f32 both
    sides, sums in another order);
  * the fused walk against JAX's fused walk (res_conv biases at zero: the
    JAX walk drops them) and against the unfused forward, both
    `use_affine_level` values; max abs ≤ 2e-4·max|ref| + 1e-5;
  * `p_sample`, `p_sample_loop` (final frame and trajectory) of conditional
    SR3 and DDPM, unconditional `sample`, DDPM's `interpolate` and both
    `p_losses`, with JAX's key draws replayed as injected noise (and t, γ),
    through a small closed-form denoiser that reads the condition and t:
    max abs ≤ 1e-5·max|ref| + 1e-6 (elementwise f32 on both sides); one SR3
    chain through the UNet, max abs ≤ 1e-4·max|ref| + 1e-5;
  * a reference-layout `.pth` (`module.` / `denoise_fn.` roots and the 12
    schedule buffers) written by JAX's utils/torch_export.py, loaded by the
    port, giving JAX's outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import DDPMProcess as JaxDDPM, SR3Process as JaxSR3
from diffsplitting_tpu.diffusion import build_ddpm_schedule as jax_schedule
from diffsplitting_tpu.experimental.fused_forward import fused_unet_apply
from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu.utils.torch_export import save_reference_checkpoint
from diffsplitting_tpu_torch.diffusion import DDPMProcess, SR3Process, build_ddpm_schedule
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.models import fused_forward as ff
from diffsplitting_tpu_torch.serving import InDINet
from diffsplitting_tpu_torch.utils.weights import (SCHEDULE_BUFFERS, load_reference_checkpoint,
                                                   unet_state_dict_from_jax)

from tests.test_torch_port_unet import random_flax_params

KW = dict(out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2), attn_res=(8,),
          res_blocks=1, image_size=16)
SCHED = {"schedule": "linear", "n_timestep": 6, "linear_start": 1e-3, "linear_end": 0.2}
C = 3


def close(got, want, rel, abs_):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + abs_, err


def flax_and_port(cond_type, use_affine_level=False, in_channel=6, seed=1, zero_res_bias=False):
    net = FlaxUNet(in_channel=in_channel, cond_type=cond_type, use_affine_level=use_affine_level,
                   **KW)
    params = random_flax_params(net, (1, 16, 16, in_channel), True, seed=seed)
    if zero_res_bias:
        params = jax.tree_util.tree_map(np.array, params)
        for name, block in params.items():
            rp = block.get("ResnetBlock_0", {}) if name.startswith("ResnetBlockWithAttn") else {}
            if "Conv_0" in rp:
                rp["Conv_0"]["bias"] = np.zeros_like(rp["Conv_0"]["bias"])
    port = UNet(in_channel=in_channel, cond_type=cond_type, use_affine_level=use_affine_level,
                **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, cond_type),
                         strict=True)
    return net, params, port


def inputs(B=2, in_channel=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 16, 16, in_channel)).astype(np.float32)
    level = rng.uniform(0.2, 1.0, size=(B,)).astype(np.float32)
    return x, level


UNETS = [("noise_level", False), ("noise_level", True), ("time", False)]
UNET_IDS = ["sr3", "sr3_affine", "ddpm"]


@functools.lru_cache(maxsize=None)
def flax_reference(cond_type, affine=False):
    """(flax net, params, port UNet, x, t, JAX's output) of one UNet at its
    seeded weights and inputs; built once and shared by the tests that read
    it."""
    net, params, port = flax_and_port(cond_type, affine)
    x, level = inputs()
    t = level if cond_type == "noise_level" else level * 5
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    return net, params, port, x, t, want


@pytest.mark.parametrize("cond_type,affine", UNETS, ids=UNET_IDS)
def test_unet_matches_flax(cond_type, affine):
    _, _, port, x, t, want = flax_reference(cond_type, affine)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == (2, 16, 16, 3)
    close(got, want, 1e-4, 1e-5)
    if cond_type == "noise_level":
        keys = port.state_dict()
        assert "noise_level_mlp.1.weight" in keys and "time_mlp.0.inv_freq" not in keys
        film = keys["downs.1.res_block.noise_func.noise_func.0.weight"]
        assert film.shape == ((2 if affine else 1) * 8, 8)


@pytest.mark.parametrize("affine", [False, True], ids=["additive", "affine"])
def test_fused_walk_matches_jax_fused_walk_and_unfused(affine):
    """The noise-level FiLM in the stat-carried walk: a bias from the block's
    linear with no swish, or (1 + γ, β) with `use_affine_level`."""
    net, params, port = flax_and_port("noise_level", affine, zero_res_bias=True, seed=2)
    x, level = inputs(seed=3)
    want = np.asarray(fused_unet_apply(net, {"params": params}, jnp.asarray(x),
                                       jnp.asarray(level)))
    xt, lt = torch.from_numpy(x), torch.from_numpy(level)
    got = ff.fused_unet_forward(port, xt, lt).numpy()
    close(got, want, 2e-4, 1e-5)
    port_b = flax_reference("noise_level", affine)[2]  # res_conv biases nonzero
    with torch.no_grad():
        close(ff.fused_unet_forward(port_b, xt, lt).numpy(), port_b(xt, lt).numpy(), 2e-4, 1e-5)


# ------------------------------------------------------------------ processes


def jax_denoiser(x, t):
    """A closed-form stand-in for the net, in both packages: it reads the
    noisy channels, the condition (when there is one) and t."""
    y = x[..., -C:]
    c = x[..., :C] if x.shape[-1] > C else 0.0
    return jnp.tanh(0.7 * y + 0.3 * c + 0.1 * t.reshape(-1, 1, 1, 1))


def torch_denoiser(x, t):
    y = x[..., -C:]
    c = x[..., :C] if x.shape[-1] > C else 0.0
    return torch.tanh(0.7 * y + 0.3 * c + 0.1 * t.reshape(-1, 1, 1, 1))


def processes(which, conditional=True):
    jcls, tcls = (JaxSR3, SR3Process) if which == "sr3" else (JaxDDPM, DDPMProcess)
    kw = dict(image_size=16, channels=C, loss_type="l1", lr_reduction="mean",
              conditional=conditional)
    return jcls(**kw), tcls(**kw), jax_schedule(SCHED), build_ddpm_schedule(SCHED)


def chain_noise(rng, shape, T):
    """The draws of a JAX chain from `rng`: the initial image, then one a step."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(rng, T)]
    return [torch.from_numpy(np.array(d)) for d in draws]


CHAIN_CASES = [("sr3", True), ("ddpm", True), ("sr3", False), ("ddpm", False)]
CHAIN_IDS = ["sr3_cond", "ddpm_cond", "sr3_sample", "ddpm_sample"]


@pytest.fixture(scope="module")
def jax_chains():
    """Each JAX chain's trajectory, jitted once for the module."""
    out = {}
    x = np.random.default_rng(7).uniform(-1, 1, size=(2, 16, 16, C)).astype(np.float32)
    for which, cond in CHAIN_CASES:
        jp, _, js, _ = processes(which, cond)
        rng = jax.random.PRNGKey(11)
        if cond:
            frames = jax.jit(lambda xi, r: jp.p_sample_loop(jax_denoiser, js, r, xi,
                                                            continuous=True))(jnp.asarray(x), rng)
        else:
            frames = jax.jit(lambda r: jp.sample(jax_denoiser, js, r, batch_size=2,
                                                 continuous=True))(rng)
        out[(which, cond)] = (x, rng, np.asarray(frames))
    return out


@pytest.mark.parametrize("which,cond", CHAIN_CASES, ids=CHAIN_IDS)
def test_p_sample_loop_matches_jax(which, cond, jax_chains):
    x, rng, want = jax_chains[(which, cond)]
    _, tp, _, ts = processes(which, cond)
    noise = chain_noise(rng, (2, 16, 16, C), SCHED["n_timestep"])
    if cond:
        frames = tp.p_sample_loop(torch_denoiser, ts, torch.from_numpy(x), continuous=True,
                                  noise=noise)
        final = tp.p_sample_loop(torch_denoiser, ts, torch.from_numpy(x), noise=noise)
    else:
        frames = tp.sample(torch_denoiser, ts, 2, continuous=True, noise=noise)
        final = tp.sample(torch_denoiser, ts, 2, noise=noise)
    # T = 6: 1 | (6 // 10) = 1, every step is a frame; frame 0 the tiled
    # condition, or the initial noise
    assert want.shape == frames.shape == (7, 2, 16, 16, C)
    close(frames.numpy(), want, 1e-5, 1e-6)
    assert torch.equal(final, frames[-1])
    np.testing.assert_array_equal(frames[0].numpy(), x if cond else noise[0].numpy())


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
def test_p_sample_matches_jax(which):
    jp, tp, js, ts = processes(which)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    cond = rng.uniform(-1, 1, size=(2, 16, 16, C)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    for t in (0, 3, 5):
        jt = t if which == "sr3" else jnp.full((2,), t, jnp.int32)
        want = jp.p_sample(jax_denoiser, js, key, jnp.asarray(x), jt,
                           condition_x=jnp.asarray(cond))
        tt = t if which == "sr3" else torch.full((2,), t, dtype=torch.long)
        got = tp.p_sample(torch_denoiser, ts, torch.from_numpy(x), tt, noise,
                          condition_x=torch.from_numpy(cond))
        close(got.numpy(), np.asarray(want), 1e-5, 1e-6)


def test_sr3_noise_level_is_the_next_cumulative_alpha():
    _, tp, js, ts = processes("sr3")
    for t in (0, 5):
        level = tp.noise_level(ts, t, 2, torch.float32)
        assert level.shape == (2,)
        np.testing.assert_array_equal(level.numpy(),
                                      np.full(2, np.asarray(js.sqrt_alphas_cumprod_prev)[t + 1]))


def test_ddpm_interpolate_matches_jax():
    jp, tp, js, ts = processes("ddpm", conditional=False)
    rng = np.random.default_rng(9)
    x1, x2 = (rng.uniform(-1, 1, size=(2, 16, 16, C)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(6)
    t = 4
    want = jax.jit(lambda a, b: jp.interpolate(jax_denoiser, js, key, a, b, t=t, lam=0.3))(
        jnp.asarray(x1), jnp.asarray(x2))
    r, n1, n2 = jax.random.split(key, 3)
    noise = [jax.random.normal(n1, x1.shape), jax.random.normal(n2, x1.shape)]
    noise += [jax.random.normal(k, x1.shape) for k in jax.random.split(r, t)]
    got = tp.interpolate(torch_denoiser, ts, torch.from_numpy(x1), torch.from_numpy(x2), t=t,
                         lam=0.3, noise=[torch.from_numpy(np.array(n)) for n in noise])
    close(got.numpy(), np.asarray(want), 1e-5, 1e-6)


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
def test_p_losses_match_jax_with_injected_draws(which):
    jp, tp, js, ts = processes(which)
    rng = np.random.default_rng(10)
    batch = {"target": rng.uniform(-1, 1, size=(3, 16, 16, C)).astype(np.float32),
             "input": rng.uniform(-1, 1, size=(3, 16, 16, C)).astype(np.float32)}
    key = jax.random.PRNGKey(12)
    want = jp.p_losses(jax_denoiser, js, key, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if which == "sr3":
        t_rng, g_rng, n_rng = jax.random.split(key, 3)
        t = jax.random.randint(t_rng, (), 1, SCHED["n_timestep"] + 1)
        lo, hi = js.sqrt_alphas_cumprod_prev[t - 1], js.sqrt_alphas_cumprod_prev[t]
        gamma = lo + jax.random.uniform(g_rng, (3,), jnp.float32) * (hi - lo)
        noise = jax.random.normal(n_rng, batch["target"].shape, jnp.float32)
        got = tp.p_losses(torch_denoiser, ts, tb, gamma=torch.from_numpy(np.array(gamma)),
                          noise=torch.from_numpy(np.array(noise)))
        # a drawn γ lies in [√ᾱ_{t-1}, √ᾱ_t] of the injected t
        g = torch.Generator().manual_seed(0)
        drawn = []
        tp.p_losses(lambda x, lv: drawn.append(lv) or torch_denoiser(x, lv), ts, tb, g, t=int(t))
        assert ((drawn[0] >= float(hi)) & (drawn[0] <= float(lo))).all()
    else:
        t_rng, n_rng = jax.random.split(key)
        t = jax.random.randint(t_rng, (3,), 0, SCHED["n_timestep"])
        noise = jax.random.normal(n_rng, batch["target"].shape, jnp.float32)
        got = tp.p_losses(torch_denoiser, ts, tb, t=torch.from_numpy(np.array(t)),
                          noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sr3_chain_through_the_unet_matches_jax():
    net, params, port = flax_and_port("noise_level", seed=5)
    jp, tp, js, ts = processes("sr3")
    sched = dict(SCHED, n_timestep=4)
    js, ts = jax_schedule(sched), build_ddpm_schedule(sched)
    x = np.random.default_rng(13).uniform(-1, 1, size=(1, 16, 16, C)).astype(np.float32)
    rng = jax.random.PRNGKey(14)
    den = lambda xx, tt: net.apply({"params": params}, xx, tt)  # noqa: E731
    want = jax.jit(lambda xi: jp.p_sample_loop(den, js, rng, xi, continuous=True))(
        jnp.asarray(x))
    got = tp.p_sample_loop(lambda xx, tt: port(xx, tt), ts, torch.from_numpy(x),
                           continuous=True, noise=chain_noise(rng, x.shape, 4))
    close(got.numpy(), np.asarray(want), 1e-4, 1e-5)


# ------------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("which,layout", [("sr3", "wrapper"), ("sr3", "module"),
                                          ("ddpm", "wrapper"), ("sr3", "raw")])
def test_reference_pth_loads_and_gives_jax_outputs(which, layout, tmp_path):
    cond_type = "noise_level" if which == "sr3" else "time"
    net, params, _, x, t, want = flax_reference(cond_type)
    path = save_reference_checkpoint(str(tmp_path / "I1_E1"), which, {"net": params},
                                     {"net": net}, jax_schedule(SCHED))
    sd = torch.load(path, weights_only=True)
    assert SCHEDULE_BUFFERS <= set(sd) and any(k.startswith("denoise_fn.") for k in sd)
    if layout == "module":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif layout == "raw":
        sd = {k[len("denoise_fn."):]: v for k, v in sd.items() if k.startswith("denoise_fn.")}
    if layout != "wrapper":
        path = str(tmp_path / f"{layout}_gen.pth")
        torch.save(sd, path)
    nets = InDINet(UNet(in_channel=6, cond_type=cond_type, **KW)).eval()
    nets.load_state_dict(load_reference_checkpoint(path, which), strict=True)
    with torch.no_grad():
        got = nets.denoise_fn(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    close(got, want, 1e-4, 1e-5)
