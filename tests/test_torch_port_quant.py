"""The port's W8A8 primitives and quantized UNet (ops/quant.py,
models/quant_unet.py) against the JAX package's, on the CPU.

The UNet is tests/test_quant_unet.py's (in 2, out 1, inner 8, 4 groups, mults
(1, 2), attention at 8², one res block, 16² inputs), its JAX params carried
across by `unet_state_dict_from_jax`; JAX's sites are mapped to the port's
module paths by the same export walk (each conv kernel tagged with its
index). The calibration batch is JAX's: the trainer's `_calib_inputs` for an
SR3 net at 'test', its noise injected into the port's `sr_calib_inputs`.

Held: `quantize_weight` bit for bit; the plain `int8_conv` and the card
route's gather and product (run here on CPU tensors: `torch._int_mm` has a
CPU version) int32-equal to JAX's `int8_conv`; `collect_act_absmax` within
1e-5 relative; the site counts of the default, 'all' and 'attn' coverage;
the W8A8 forward against JAX's `quant_unet_apply` at cond_type time,
noise_level and none, every site kind quantized, and each kind of site
alone against JAX's `quant_conv_apply` on the same input (f32 rounding:
max abs ≤ 1e-6·max). Within the forward, teacher-forced: each of JAX's
sites fires once, and JAX's `quant_conv_apply` on the input the port's
forward gave that site reads its output to the same 1e-6·max, which a
float forward or a miswired site misses by the W8A8 error. Tolerance of
the whole forward (the cascade case): its rel-L2 from JAX's W8A8
forward at most twice JAX's W8A8 error against the float forward, and the
port's own W8A8 error below JAX's test bound, 0.15. The float ops before
each quantized site sum in another order (XLA against torch; jitted or
not), so an activation within a rounding of a .5 step quantizes one int8
step apart, and each such flip moves the inputs of the later sites, where
more flip: on the same weights and inputs the two W8A8 forwards read 1e-7
apart where nothing flips and 0.005-0.041 where flips cascade, against a
W8A8 error of 0.025-0.06. Where the cascade decorrelates every rounding,
two forwards with independent errors ε from the float one differ by √2·ε;
twice ε bounds that.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.models.quant_unet import (collect_act_absmax as jax_collect,
                                                 iter_quant_sites as jax_sites, quant_unet_apply,
                                                 quantize_unet_params)
from diffsplitting_tpu.models.unet import UNet as JaxUNet
from diffsplitting_tpu.ops import quant as jax_quant
from diffsplitting_tpu.train.trainer import DiffusionModel as JaxDiffusionModel
from diffsplitting_tpu_torch.diffusion import SR3Process, build_ddpm_schedule
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.models.blocks import Conv2d
from diffsplitting_tpu_torch.models.quant_unet import (W8A8Conv2d, classify, collect_act_absmax,
                                                       is_quantized, iter_quant_sites,
                                                       quantize_unet)
from diffsplitting_tpu_torch.ops import quant
from diffsplitting_tpu_torch.serving import sr_calib_inputs
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread  # noqa: F401
from tests.test_torch_port_unet import random_flax_params

KW = dict(in_channel=2, out_channel=1, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16)
COND_TYPES = ["time", "noise_level", "none"]
SCHEDULE = {"schedule": "linear", "n_timestep": 8, "linear_start": 1e-4, "linear_end": 0.05}
CALIB = 4


def sites_map(params, cond_type):
    """JAX conv site path -> the port's module path, by the export walk:
    each conv kernel tagged with its index, exported, read back."""
    paths = []

    def tag(node, path):
        if isinstance(node, dict) and "kernel" in node and np.ndim(node["kernel"]) == 4:
            paths.append(path)
            return dict(node, kernel=np.full(np.shape(node["kernel"]), len(paths), np.float32))
        if isinstance(node, dict):
            return {k: tag(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return node

    sd = unet_state_dict_from_jax(tag(params, ""), KW["channel_mults"], 1, cond_type)
    out = {}
    for key, v in sd.items():
        if key.endswith(".weight") and v.ndim == 4:
            out[paths[int(v.flatten()[0]) - 1]] = key[:-len(".weight")]
    assert len(out) == len(paths)
    return out


@pytest.fixture(scope="module")
def calib():
    """JAX's SR3 calibration batch at 'test' (trainer `_calib_inputs`, its
    K rows of x_t at linspace(0, T-1, K) from PRNGKey(0xCA11B)) and its noise."""
    sched = build_ddpm_schedule(SCHEDULE)
    jsched = SimpleNamespace(num_timesteps=SCHEDULE["n_timestep"],
                             sqrt_alphas_cumprod_prev=sched.sqrt_alphas_cumprod_prev.numpy())
    rng = np.random.default_rng(0)
    cond = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    fake = SimpleNamespace(
        quant={"calib": CALIB}, which="sr3", current_sched=jsched,
        process=SimpleNamespace(conditional=True),
        data={"input": jnp.asarray(cond)},
        opt={"model": {"diffusion": {"channels": 1, "image_size": 16}}})
    x, t = JaxDiffusionModel._calib_inputs(fake, "net", "test")
    eps = jax.random.normal(jax.random.PRNGKey(0xCA11B), (CALIB, 16, 16, 1), jnp.float32)
    return SimpleNamespace(x=np.array(x), t=np.array(t), eps=np.array(eps), cond=cond,
                           sched=sched)


@pytest.fixture(scope="module")
def nets():
    """For each cond type: the JAX UNet, its params, the port UNet from them
    and the site map; and JAX's jitted calibration and W8A8 forwards."""
    out = {}
    for cond_type in COND_TYPES:
        jnet = JaxUNet(cond_type=cond_type, **KW)
        params = random_flax_params(jnet, (2, 16, 16, 2), cond_type != "none", seed=3)
        port = UNet(cond_type=cond_type, **KW).eval()
        port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, cond_type),
                             strict=True)
        out[cond_type] = SimpleNamespace(
            jnet=jnet, params=params, port=port, map=sites_map(params, cond_type),
            stats=jax.jit(lambda v, x, t, n=jnet: jax_collect(n, v, x, t)[1]),
            quant=jax.jit(lambda q, x, t, n=jnet: quant_unet_apply(n, {"params": q}, x, t)))
    return out


def time_of(cond_type, t):
    return None if cond_type == "none" else t


# ------------------------------------------------------------------ ops/quant.py


def test_quantize_weight_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(24, 16, 3, 3)) * rng.uniform(0.01, 3, size=(24, 1, 1, 1))
         ).astype(np.float32)
    w[3] = 0.0  # an all-zero channel: scale floored at 1e-12 / 127
    got_i8, got_scale = quant.quantize_weight(torch.from_numpy(w))
    want_i8, want_scale = jax_quant.quantize_weight(w.transpose(2, 3, 1, 0))  # HWIO
    np.testing.assert_array_equal(got_i8, np.asarray(want_i8).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got_scale, np.asarray(want_scale))
    assert got_i8.dtype == np.int8 and got_scale.dtype == np.float32


def test_quantize_act_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 8, 6, 6)) * 3).astype(np.float32)
    a_scale = np.float32(2.5 / 127)
    x[0, 0, 0, :4] = np.array([0.5, 1.5, -0.5, 2.5], np.float32) * a_scale  # ties
    got = quant.quantize_act(torch.from_numpy(x), quant.act_inverse(a_scale))
    want = jax_quant.quantize_act(jnp.asarray(x), jnp.float32(a_scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.abs().max()) == 127  # clipped


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)], ids=["3x3", "3x3_s2", "1x1"])
def test_int8_conv_int32_equal_to_jax(k, stride):
    """The plain version, and the card route's gather and product on CPU
    tensors, against JAX's int8 conv; 127·127 products at the widest K."""
    rng = np.random.default_rng(k + stride)
    x = rng.integers(-127, 128, size=(2, 48, 9, 10)).astype(np.int8)  # NCHW
    w = rng.integers(-127, 128, size=(16, 48, k, k)).astype(np.int8)  # OIHW
    x[0, :, 0, 0], w[0] = 127, 127
    want = np.asarray(jax_quant.int8_conv(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                          jnp.asarray(w.transpose(2, 3, 1, 0)), (stride, stride)))
    want = want.transpose(0, 3, 1, 2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = quant.int8_conv(xt, wt, stride)
    gathered = quant._int8_conv_cuda(xt, quant.int8_matrix(wt), k, stride)
    assert plain.dtype == gathered.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(gathered.numpy(), want)


def test_card_route_pads_rows_and_refuses_widths():
    """16 rows (a 4² map at batch 1, the CIFAR path's) are padded to the
    product's 17; a width that is not a multiple of 8 raises."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, size=(1, 16, 4, 4)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(8, 16, 3, 3)).astype(np.int8))
    got = quant._int8_conv_cuda(x, quant.int8_matrix(w), 3, 1)
    assert torch.equal(got, quant.int8_conv_reference(x, w, 1))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant._int8_conv_cuda(x, quant.int8_matrix(w[:6]), 3, 1)
    with pytest.raises(TypeError):
        quant.int8_conv(x.float(), w)


@pytest.mark.parametrize("k,stride,bias", [(3, 1, True), (3, 2, True), (1, 1, False)],
                         ids=["3x3", "3x3_s2", "1x1_no_bias"])
def test_w8a8_site_equals_jax_quant_conv_apply(k, stride, bias):
    """One W8A8Conv2d against JAX's quant_conv_apply on the same f32 input:
    quantize, int32 product, f32 dequantize and bias in JAX's order."""
    rng = np.random.default_rng(10 + k + stride)
    conv = Conv2d(16, 24, k, stride=stride, padding=k // 2, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.normal(size=(24, 16, k, k)).astype(np.float32)))
        if bias:
            conv.bias.copy_(torch.from_numpy(rng.normal(size=24).astype(np.float32)))
    x = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    site = W8A8Conv2d(conv, np.float32(np.abs(x).max() / 127))
    node = {"kernel_i8": jnp.asarray(site.weight_i8.numpy().transpose(2, 3, 1, 0)),
            "w_scale": jnp.asarray(site.w_scale.numpy()), "a_scale": jnp.float32(site.a_scale)}
    if bias:
        node["bias"] = jnp.asarray(conv.bias.detach().numpy())
    want = np.asarray(jax_quant.quant_conv_apply(node, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                                 (stride, stride))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = site(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ------------------------------------------------------------ models/quant_unet.py


def test_calibration_batch_equals_jax(calib):
    """`sr_calib_inputs` with JAX's draw injected gives JAX's batch."""
    x, t = sr_calib_inputs("sr3", SR3Process(16, channels=1, conditional=True), calib.sched,
                           "test", CALIB, torch.from_numpy(calib.cond[:1]), "cpu", calib.eps)
    np.testing.assert_allclose(x.numpy(), calib.x, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t.numpy(), calib.t)


@pytest.mark.parametrize("cond_type", COND_TYPES)
def test_act_absmax_matches_jax(nets, calib, cond_type):
    n = nets[cond_type]
    t = time_of(cond_type, calib.t)
    want = n.stats({"params": n.params}, jnp.asarray(calib.x), t)
    got = collect_act_absmax(n.port, torch.from_numpy(calib.x),
                             None if t is None else torch.from_numpy(t))
    assert sorted(got) == sorted(n.map.values())
    for jpath, port_path in n.map.items():
        np.testing.assert_allclose(got[port_path], float(want[jpath]), rtol=1e-5,
                                   err_msg=port_path)


@pytest.mark.parametrize("sites", ["default", "all", "attn"])
def test_site_counts_and_kinds_match_jax(nets, calib, sites):
    n = nets["noise_level"]
    wide = sites != "default"
    flags = dict(updown=wide, shortcut=wide, attn=sites == "attn")
    stats = collect_act_absmax(n.port, torch.from_numpy(calib.x), torch.from_numpy(calib.t))
    q = quantize_unet(n.port, stats, **flags)
    jstats = {j: stats[p] for j, p in n.map.items()}
    want = [n.map[j] for j, _ in jax_sites(quantize_unet_params(n.params, jstats, **flags))]
    got = [name for name, _ in iter_quant_sites(q)]
    assert sorted(got) == sorted(want)
    if sites == "default":
        assert len(got) == 16 and {classify(p) for p in got} == {"block"}
    assert is_quantized(q) and not is_quantized(n.port)
    # the source keeps its float convs; the copy shares every other tensor
    assert all(not isinstance(m, W8A8Conv2d) for m in n.port.modules())
    assert q.mid[0].attn.norm.weight is n.port.mid[0].attn.norm.weight


@pytest.mark.parametrize("cond_type", COND_TYPES)
def test_w8a8_forward_matches_jax(nets, calib, cond_type):
    n = nets[cond_type]
    t = time_of(cond_type, calib.t)
    tt = None if t is None else torch.from_numpy(t)
    stats = collect_act_absmax(n.port, torch.from_numpy(calib.x), tt)
    flags = dict(updown=True, shortcut=True, attn=True, stem=True, head=True)
    q = quantize_unet(n.port, stats, **flags)
    assert {classify(p) for p, _ in iter_quant_sites(q)} == {
        "block", "updown", "shortcut", "attn", "stem", "head"}
    qp = quantize_unet_params(n.params, {j: stats[p] for j, p in n.map.items()}, **flags)
    for (_, a), (jpath, b) in zip(sorted(iter_quant_sites(q)),
                                  sorted(jax_sites(qp), key=lambda s: n.map[s[0]])):
        assert a.a_scale == b["a_scale"], jpath
    x = np.random.default_rng(7).normal(size=(2, 16, 16, 2)).astype(np.float32)
    tx = None if t is None else t[:2]
    want = np.asarray(n.quant(qp, jnp.asarray(x), tx))
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, inp, out, p=p: seen.setdefault(p, []).append((inp[0].clone(), out.clone())))
        for p, m in iter_quant_sites(q)]
    with torch.no_grad():
        tt = None if tx is None else torch.from_numpy(tx)
        got = q(torch.from_numpy(x), tt).numpy()
        port_exact = n.port(torch.from_numpy(x), tt).numpy()
    for h in hooks:
        h.remove()

    # teacher-forced: every site of JAX's tree runs once in the port's
    # forward, and JAX's quant_conv_apply on that site's input, as the port's
    # forward gave it, reads the port's output within f32 rounding (the same
    # int8 activations, no flips); a float conv, a skipped site or one wired
    # to another site's weights and scales is off by the W8A8 error or more
    assert sorted(seen) == sorted(n.map[j] for j, _ in jax_sites(qp))
    for jpath, node in jax_sites(qp):
        (inp, out), = seen[n.map[jpath]]
        s = dict(iter_quant_sites(q))[n.map[jpath]].stride
        site = np.asarray(jax_quant.quant_conv_apply(
            node, jnp.asarray(inp.numpy().transpose(0, 2, 3, 1)), (s, s))).transpose(0, 3, 1, 2)
        assert site.shape == out.shape, jpath
        assert np.abs(out.numpy() - site).max() <= 1e-6 * np.abs(site).max(), jpath

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the float forward: the port's, equal to JAX's within 1e-4 of max
    # (tests/test_torch_port_unet.py)
    print(f"{cond_type}: port vs JAX W8A8 rel-L2 {rel(got, want):.3g}; W8A8 vs float, JAX "
          f"{rel(want, port_exact):.3g}, port {rel(got, port_exact):.3g}")
    assert got.shape == want.shape == (2, 16, 16, 1)
    assert rel(got, want) <= 2 * rel(want, port_exact) and rel(got, port_exact) < 0.15
