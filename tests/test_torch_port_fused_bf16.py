"""The port's conv+GroupNorm op and its fused walk at bfloat16, against the JAX
package on the CPU, from the same numpy-seeded inputs and weights.

  * The plain `conv_gn_reference` at bf16 x against JAX's `conv_gn_reference`
    at bf16 and, at the aligned widths where it runs, JAX's Pallas kernel
    (`conv_gn_fused(..., interpret=True)`) at bf16: no prologue, prologue,
    identity and projected residual, and a ragged width (12 and 20
    channels, which the bf16 kernel takes as they are: `conv_gn_takes` does
    not depend on the dtype). y within two bf16 steps (2^-6·|y|) plus
    1e-4·max|y|: both round an f32 sum once, summed in another order, and
    the prologue's swish (XLA's logistic against torch's sigmoid) can round
    an activated input to the next bf16 value; the statistics within 1e-5
    of Σ|y| (f32 sums over H·W pixels in another order).
  * The fused walk at bf16 on a noise-level UNet at inner 128 (its 128- and
    256-channel sites take JAX's Pallas kernel, in interpret mode; the
    port's 128-channel sites take the conv_gn kernel's plain version, its
    256-channel ones the library sites) against JAX's `fused_unet_apply` at
    bf16 with the res_conv biases at zero (the JAX walk drops them), and
    against the port's unfused bf16 forward: max abs ≤ 3e-2·max|ref|, mean
    abs ≤ 5e-3·max|ref|, the tolerance of the bf16 forward against JAX's in
    tests/test_torch_port_bf16.py (bf16 rounds at other places; the library
    sites' bf16 conv rounds before the bias is added, one rounding more than
    JAX's f32 accumulation). The fused walk with DSP_PRECAST's bf16 weights:
    bit for bit.
  * The port's infer.py with DSP_FUSED=1 on the cut sr_sr3_64_512 config of
    tests/test_torch_port_sr512.py, and sample.py on a tiny unconditional
    ddpm config at bf16 (the time FiLM): each serves through the fused walk
    and writes its images, with DSP_PRECAST=1 the same bits.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffsplitting_tpu.experimental import conv_gn as jax_conv_gn
from diffsplitting_tpu.experimental.fused_forward import fused_unet_apply
from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu_torch import infer
from diffsplitting_tpu_torch import sample as port_sample
from diffsplitting_tpu_torch.models import UNet, fused_unet_forward
from diffsplitting_tpu_torch.models import fused_forward as ff
from diffsplitting_tpu_torch.models.precision import cast_unet_params_for_inference
from diffsplitting_tpu_torch.ops import (FusedConvGN, conv_gn_fused, conv_gn_reference,
                                         conv_gn_takes)
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_sr_cli import lrhr_root, sr_config  # noqa: F401 (fixture)
from tests.test_torch_port_sr512 import cut_config  # noqa: F401 (fixture)
from tests.test_torch_port_unet import random_flax_params

TOL_FUSED_BF16 = dict(max=3e-2, mean=5e-3)  # of max|ref|


def _inputs(B, H, W, Cin, Cout, act, res, Cres=None, seed=0):
    """numpy f32 inputs: res is None, "identity" or "projected"."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    Cres = Cres or (Cin if res == "projected" else Cout)
    return dict(
        x=f(B, H, W, Cin), w=f(3, 3, Cin, Cout) * np.float32(0.1), b=f(Cout) * np.float32(0.1),
        scale=f(B, Cin) * np.float32(0.2) + 1 if act else None,
        shift=f(B, Cin) * np.float32(0.5) if act else None,
        residual=f(B, H, W, Cres) if res else None,
        w_skip=f(Cres, Cout) * np.float32(0.1) if res == "projected" else None)


# x and the residual bf16 on both sides; w, b, w_skip, scale, shift f32 (the
# parameters as the walks pass them)
_BF16 = ("x", "residual")


def _torch(args):
    out = {k: None if v is None else torch.from_numpy(v) for k, v in args.items()}
    return {k: v.bfloat16() if k in _BF16 and v is not None else v for k, v in out.items()}


def _jax(args):
    out = {k: None if v is None else jnp.asarray(v) for k, v in args.items()}
    return {k: v.astype(jnp.bfloat16) if k in _BF16 and v is not None else v
            for k, v in out.items()}


def _assert_close(got, want):
    y, s, q = got
    y_ref, s_ref, q_ref = (np.asarray(a) for a in want)
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    assert s.dtype == q.dtype == torch.float32 and s_ref.dtype == np.float32
    y, y_ref = y.float().numpy(), y_ref.astype(np.float32)
    err = np.abs(y - y_ref)
    assert (err <= 2.0 ** -6 * np.abs(y_ref) + 1e-4 * np.abs(y_ref).max()).all(), err.max()
    total = np.abs(y_ref).sum(axis=(1, 2))
    assert (np.abs(s.numpy() - s_ref) <= 1e-5 * total + 1e-4).all()
    assert (np.abs(q.numpy() - q_ref) <= 1e-5 * q_ref + 1e-4).all()


@pytest.mark.parametrize("mode", ["no_prologue", "prologue", "identity", "projected",
                                  "ragged_identity", "ragged_projected"])
def test_reference_bf16_matches_jax(mode):
    Cin, Cout = (12, 20) if mode.startswith("ragged") else (48, 32)
    res = mode.rsplit("_", 1)[-1] if mode.endswith(("identity", "projected")) else None
    args = _inputs(2, 6, 5, Cin, Cout, mode != "no_prologue", res, seed=Cin + len(mode))
    got = conv_gn_reference(**_torch(args))
    _assert_close(got, jax_conv_gn.conv_gn_reference(**_jax(args)))

    # a ragged width is a site of the kernel at either dtype; on a CPU
    # tensor the wrapper runs the plain version and launches nothing
    Cres = 0 if res is None else args["residual"].shape[-1]
    assert conv_gn_takes(Cin, Cout, Cres)
    before = FusedConvGN.launches, FusedConvGN.launches_bf16
    fused = conv_gn_fused(**_torch(args))
    assert (FusedConvGN.launches, FusedConvGN.launches_bf16) == before
    for a, b in zip(fused, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "B,H,W,Cin,Cout,act,res,Cres",
    [  # aligned shapes, where JAX's Pallas kernel runs (tests/test_conv_gn.py)
        (2, 16, 8, 128, 128, False, None, None),
        (1, 16, 8, 128, 128, True, None, None),
        (1, 16, 8, 128, 128, True, "identity", None),
        (1, 8, 8, 128, 128, True, "projected", 256),
    ],
)
def test_reference_bf16_matches_jax_pallas_kernel(B, H, W, Cin, Cout, act, res, Cres):
    args = _inputs(B, H, W, Cin, Cout, act, res, Cres, seed=3)
    want = jax_conv_gn.conv_gn_fused(**_jax(args), interpret=True)
    _assert_close(conv_gn_fused(**_torch(args)), want)


@pytest.mark.parametrize("change,error", [
    (dict(x="float16"), "float32"), (dict(residual="float32"), "bfloat16 residual"),
    (dict(scale="bfloat16"), "float32 scale"), (dict(w="float16"), "float32 or bfloat16 w")])
def test_wrapper_refuses_other_types_at_bf16(change, error):
    args = _torch(_inputs(1, 4, 4, 8, 4, True, "identity"))
    for k, dt in change.items():
        args[k] = args[k].to(getattr(torch, dt))
    with pytest.raises(TypeError, match=error):
        conv_gn_fused(**args)


# ------------------------------------------------------------------ the walk

KW = dict(in_channel=2, out_channel=2, inner_channel=128, norm_groups=32, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16, cond_type="noise_level")


def _zero_res_conv_biases(params):
    """Copy of a flax UNet's params with every ResnetBlock's 1×1 res_conv bias
    at zero (the only bias the JAX fused walk drops)."""
    out = jax.tree_util.tree_map(np.array, params)
    n = 0
    for name, block in out.items():
        rp = block.get("ResnetBlock_0", {}) if name.startswith("ResnetBlockWithAttn") else {}
        if "Conv_0" in rp:
            rp["Conv_0"]["bias"] = np.zeros_like(rp["Conv_0"]["bias"])
            n += 1
    assert n == 5  # 128 -> 256 down; 512, 384 -> 256 and 384, 256 -> 128 up
    return out


# (Cin, Cout, Cres) of KW's conv sites in walk order: two a ResnetBlock (the
# second with the block's input as its residual; down 16², down 8², mid ×2,
# up 8² ×2), one the upsample, then up 16² ×2
SITES = [(128, 128, 0), (128, 128, 128), (128, 256, 0), (256, 256, 128),
         (256, 256, 0), (256, 256, 256), (256, 256, 0), (256, 256, 256),
         (512, 256, 0), (256, 256, 512), (384, 256, 0), (256, 256, 384), (256, 256, 0),
         (384, 128, 0), (128, 128, 384), (256, 128, 0), (128, 128, 256)]


@pytest.fixture(scope="module", params=[False, True], ids=["additive", "affine"])
def walks(request):
    """(JAX's fused walk at bf16, the port's fused walk, its unfused forward,
    the port's UNet and inputs) at KW, seeded weights."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    t = rng.uniform(0.2, 0.9, size=(2,)).astype(np.float32)
    net = FlaxUNet(dtype=jnp.bfloat16, use_affine_level=request.param, **KW)
    params = _zero_res_conv_biases(random_flax_params(net, x.shape, True, seed=8))
    want = np.asarray(fused_unet_apply(net, {"params": params}, jnp.asarray(x), jnp.asarray(t),
                                       interpret=True))
    port = UNet(dtype=torch.bfloat16, use_affine_level=request.param, **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, "noise_level"),
                         strict=True)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    ff.ConvSitePlan.kernel = ff.ConvSitePlan.library = 0
    got = fused_unet_forward(port, xt, tt)
    plan = ff.ConvSitePlan.kernel, ff.ConvSitePlan.library
    with torch.no_grad():
        unfused = port(xt, tt)
    return dict(jax=want, fused=got, unfused=unfused.numpy(), plan=plan, port=port, x=xt, t=tt)


def _within(got, want):
    err = np.abs(got - want)
    m = np.abs(want).max()
    return err.max() <= TOL_FUSED_BF16["max"] * m and err.mean() <= TOL_FUSED_BF16["mean"] * m


def test_fused_walk_bf16_matches_jax_fused_walk(walks):
    got = walks["fused"]
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 2)
    # 4 sites on the kernel's plain version (Cout 128, Cin and Cres at most
    # 256), 13 on library ops
    assert walks["plan"] == (4, 13) == (sum(conv_gn_takes(*s) for s in SITES),
                                        sum(not conv_gn_takes(*s) for s in SITES))
    assert _within(got.numpy(), walks["jax"])


def test_fused_walk_bf16_matches_unfused_bf16_forward(walks):
    assert _within(walks["fused"].numpy(), walks["unfused"])


def test_fused_walk_bf16_precast_is_bit_identical(walks):
    cast = cast_unet_params_for_inference(walks["port"])
    assert cast.final_conv.block[3].weight.dtype == torch.bfloat16
    assert torch.equal(fused_unet_forward(cast, walks["x"], walks["t"]), walks["fused"])


# ------------------------------------------------------------------ infer.py


def test_infer_py_serves_the_cut_config_fused(cut_config, monkeypatch):  # noqa: F811
    """DSP_FUSED=1 on sr_sr3_64_512 cut (inner 16, 64², 3 val steps): the
    chain runs through the fused walk at bf16 and writes the config's files;
    with DSP_PRECAST=1 too, the same bits."""
    path, _ = cut_config
    opt = json.loads(Path(path).read_text())
    monkeypatch.setenv("DSP_FUSED", "1")
    ff.ConvSitePlan.kernel = ff.ConvSitePlan.library = 0
    run = infer.main(["-c", str(path), "--device", "cpu"])
    steps = opt["model"]["beta_schedule"]["val"]["n_timestep"]
    net = run["model"].nets.denoise_fn
    assert net.compute_dtype == torch.bfloat16
    # inner 16, widths 16 ... 256: sites with Cout 256, or Cin or Cres above
    # 256, on library ops, the rest on the kernel's plain version
    per_forward = (ff.ConvSitePlan.kernel // steps, ff.ConvSitePlan.library // steps)
    assert sum(per_forward) == 38 and per_forward[0] > 0 and per_forward[1] > 0
    assert (ff.ConvSitePlan.kernel, ff.ConvSitePlan.library) == (per_forward[0] * steps,
                                                                per_forward[1] * steps)
    results = Path(run["results"])
    assert sorted(p.name for p in results.glob("*.png")) == [
        "0_1_hr.png", "0_1_inf.png", "0_1_sr.png", "0_1_sr_process.png"]
    assert np.asarray(Image.open(results / "0_1_sr.png")).shape == (64, 64, 3)
    assert torch.isfinite(run["model"].prediction).all()

    monkeypatch.setenv("DSP_PRECAST", "1")
    precast = infer.main(["-c", str(path), "--device", "cpu"])
    torch.testing.assert_close(precast["model"].prediction, run["model"].prediction,
                               rtol=0, atol=0)


def test_sample_py_serves_a_bf16_ddpm_fused(lrhr_root, tmp_path, monkeypatch):  # noqa: F811
    """An unconditional ddpm (cond_type 'time') at compute_dtype bfloat16
    through sample.py with DSP_FUSED=1: the fused walk serves both items and
    the images are written; with DSP_PRECAST=1, the same bits."""
    path = Path(sr_config(tmp_path, lrhr_root / "root", "ddpm", False))
    cfg = json.loads(path.read_text())
    cfg["model"]["compute_dtype"] = "bfloat16"
    path.write_text(json.dumps(cfg))
    monkeypatch.setenv("DSP_FUSED", "1")
    runs = []
    for precast in ("0", "1"):
        monkeypatch.setenv("DSP_PRECAST", precast)
        ff.ConvSitePlan.kernel = ff.ConvSitePlan.library = 0
        runs.append(port_sample.main(["-c", str(path), "-p", "val", "-rootdir",
                                      str(tmp_path / f"precast{precast}"), "--device", "cpu"]))
        # 2 items x 4 steps x 17 sites (inner 8, mults (1, 2), one res block:
        # 2 down, 4 mid, 4 + 1 + 4 up), all on the kernel's plain version
        assert (ff.ConvSitePlan.kernel, ff.ConvSitePlan.library) == (2 * 4 * 17, 0)
    results = Path(runs[0]["results"])
    assert sorted(p.name for p in results.rglob("*.png")) == sorted(
        f"0_{i}_{k}.png" for i in (1, 2) for k in ("sample", "sample_process"))
    assert runs[0]["model"].nets.denoise_fn.compute_dtype == torch.bfloat16
    assert torch.isfinite(runs[0]["model"].prediction).all()
    torch.testing.assert_close(runs[1]["model"].prediction, runs[0]["model"].prediction,
                               rtol=0, atol=0)
