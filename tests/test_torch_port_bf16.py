"""The port at `compute_dtype: bfloat16` and with `remat`, against the JAX
package on the CPU, from the same numpy-seeded weights and inputs.

Small UNet: 6 channels in, 3 out, inner 8, 4 groups, mults (1, 2, 4, 8) (four
levels, widths 8 ... 64), one res block, attention at 8² and in the mid block
(4², D = 64), 32² images; cond_type 'noise_level' (sr3) and 'time' (indi).

Tolerances (bf16 rounds at other places in the two frameworks: XLA may keep
f32 between fused elementwise ops, torch rounds after each):
  * the plain GroupNorm+Swish and attention at bf16 against JAX's references
    at bf16: elementwise within one bf16 step (2^-7·|ref|) and, for
    attention, max abs <= 2^-7·max|ref| (measured: equal but for 3 of 65,536
    values at C = 2048 and 1.2e-4 at D = 1024). JAX's Pallas attention kernel
    (interpret mode) at bf16 against the port's plain version on the same
    values made f32, rounded to bf16: max abs <= 2^-6·max|ref|, the kernel's
    own P rounding (measured 3.9e-3 to 7.8e-3 at max|ref| 0.8 to 1.3);
  * the bf16 UNet forward against JAX's bf16 forward: the dtype at the output
    of every Conv, Dense, GroupNorm, Block, ResnetBlock, SelfAttention,
    ResnetBlockWithAttn, Down/Upsample and embedding equal, module kind by
    module kind; values within max abs 3e-2·max|ref| and mean abs
    5e-3·max|ref| (measured 1.29e-2 and 2.4e-3; JAX's own bf16 forward is
    1.1e-2 to 1.2e-2 from its f32 forward);
  * the precast forward and the remat gradients: bit for bit;
  * the sr3 train step at bf16 with remat: see `test_sr3_bf16_train_step`.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu.ops.attention import _pallas_forward as jax_pallas_attention
from diffsplitting_tpu.ops.attention import attention_reference as jax_attention
from diffsplitting_tpu.ops.groupnorm import group_norm_swish_reference as jax_gn_swish
from diffsplitting_tpu_torch.models import UNet, set_dropout_generator
from diffsplitting_tpu_torch.models import blocks
from diffsplitting_tpu_torch.models.precision import (cast_unet_params_for_inference,
                                                      compute_dtype)
from diffsplitting_tpu_torch.ops import attention_reference, group_norm_swish_reference
from diffsplitting_tpu_torch.serving import check_compute_dtype, unet_kwargs
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_unet import random_flax_params

KW = dict(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2, 4, 8),
          attn_res=(8,), res_blocks=1, image_size=32)
BF16_STEP = 2.0 ** -7  # one step of bf16's 8-bit significand, relative


def inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 32, 32, 6)).astype(np.float32)
    t = rng.uniform(0.2, 1.0, size=(B,)).astype(np.float32)
    return x, t


def pair(cond_type, seed=1, dtype=jnp.bfloat16, **extra):
    """(flax net, its params, the port's UNet at the same weights)."""
    net = FlaxUNet(cond_type=cond_type, dtype=dtype, **extra, **KW)
    params = random_flax_params(net, (1, 32, 32, 6), True, seed=seed)
    port = UNet(cond_type=cond_type, dtype=None if dtype is None else torch.bfloat16, **extra,
                **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, cond_type),
                         strict=True)
    return net, params, port


# ------------------------------------------------------------------ plain versions


@pytest.mark.parametrize("C", [64, 1536, 2048])
def test_plain_group_norm_swish_bf16_matches_jax(C):
    rng = np.random.default_rng(C)
    x = (rng.normal(size=(2, 4, 4, C)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.normal(size=(2, C)).astype(np.float32)
    want = np.asarray(jax_gn_swish(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
                                   jnp.asarray(bias), 16))
    got = group_norm_swish_reference(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                                     torch.from_numpy(bias), 16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want, got = want.astype(np.float32), got.float().numpy()
    assert (np.abs(got - want) <= BF16_STEP * np.abs(want)).all()


@pytest.mark.parametrize("N,D", [(64, 16), (100, 64), (64, 1024)])
def test_plain_attention_bf16_matches_jax(N, D):
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(2, N, 1, D)).astype(np.float32) for _ in range(3))
    scale = 1 / np.sqrt(D)
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tq = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    want = np.asarray(jax_attention(*jq, scale)).astype(np.float32)
    got = attention_reference(*tq, scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= BF16_STEP * np.abs(want).max()
    # what the CUDA kernel computes: JAX's Pallas kernel (f32 scores and
    # softmax, P rounded to bf16) against the port's plain version on the
    # same bf16 values made f32
    pallas = np.asarray(jax_pallas_attention(*jq, scale, interpret=True)).astype(np.float32)
    exact = attention_reference(*[a.float() for a in tq], scale).bfloat16().float().numpy()
    assert np.abs(pallas - exact).max() <= 2 * BF16_STEP * np.abs(exact).max()


# ------------------------------------------------------------------ the UNet


def test_precast_forward_is_bit_identical():
    _, _, port = pair("noise_level")
    x, t = (torch.from_numpy(a) for a in inputs())
    cast = cast_unet_params_for_inference(port)
    for name, p in cast.named_parameters():
        owner = cast.get_submodule(name.rsplit(".", 1)[0])
        want = torch.bfloat16 if isinstance(owner, (torch.nn.Conv2d, torch.nn.Linear)) else \
            torch.float32
        assert p.dtype == want, name
    assert "block.0" in next(n for n, p in cast.named_parameters() if p.dtype == torch.float32)
    assert all(p.dtype == torch.float32 for p in port.parameters())  # the original is untouched
    with torch.no_grad():
        assert torch.equal(cast(x, t), port(x, t))


# flax module class -> the port's
KINDS = {"Conv": "Conv2d", "Dense": "Linear", "GroupNorm": "GroupNorm", "Block": "Block",
         "ResnetBlock": "ResnetBlock", "SelfAttention": "SelfAttention",
         "ResnetBlockWithAttn": "ResnetBlockWithAttn", "Downsample": "Downsample",
         "Upsample": "Upsample", "TimeEmbedding": "TimeEmbedding",
         "PositionalEncoding": "PositionalEncoding"}


def jax_output_dtypes(net, params, x, t):
    _, state = jax.jit(lambda p, x, t: net.apply(p, x, t, capture_intermediates=True,
                                                 mutable=["intermediates"]))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t))
    out = collections.Counter()
    for path, leaf in jax.tree_util.tree_leaves_with_path(state["intermediates"]):
        if len(path) < 3:  # the UNet's own output
            continue
        kind = path[-3].key.rsplit("_", 1)[0]  # [..., module, '__call__', 0]
        if kind in KINDS:
            out[(KINDS[kind], str(leaf.dtype))] += 1
    return out


def port_output_dtypes(port, x, t):
    out = collections.Counter()

    def hook(m, _, y):
        out[(type(m).__name__, str(y.dtype).replace("torch.", ""))] += 1

    handles = [m.register_forward_hook(hook) for m in port.modules()
               if type(m).__name__ in KINDS.values()]
    try:
        with torch.no_grad():
            y = port(torch.from_numpy(x), torch.from_numpy(t))
    finally:
        for h in handles:
            h.remove()
    return out, y.numpy()


@pytest.mark.parametrize("cond_type", ["noise_level", "time"], ids=["sr3", "indi"])
def test_bf16_unet_matches_jax(cond_type):
    net, params, port = pair(cond_type)
    x, t = inputs()
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    dtypes, got = port_output_dtypes(port, x, t)
    # every cast point: the output dtype of each kind of module, counted
    assert dtypes == jax_output_dtypes(net, params, x, t)
    assert dtypes[("GroupNorm", "float32")] == 4 and dtypes[("Conv2d", "bfloat16")] > 20
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, 32, 32, 3)
    err = np.abs(got - want)
    m = np.abs(want).max()
    assert err.max() <= 3e-2 * m and err.mean() <= 5e-3 * m


def test_config_compute_dtype_and_remat():
    model_opt = {"unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                          "norm_groups": 4, "channel_multiplier": [1, 2], "attn_res": [], "res_blocks": 1,
                          "dropout": 0},
                 "diffusion": {"image_size": 16}, "compute_dtype": "bfloat16", "remat": True,
                 "remat_min_res": 8}
    kw = unet_kwargs(model_opt, "noise_level")
    assert (kw["dtype"], kw["remat"], kw["remat_min_res"]) == (torch.bfloat16, True, 8)
    net = UNet(**kw)
    # 16² and 8²: every block (2 down, 2 mid, 4 up) at a resolution >= 8
    assert [b.remat for b in net.modules() if isinstance(b, blocks.ResnetBlockWithAttn)] == \
        [True] * 8
    kw["remat_min_res"] = 16
    assert [b.remat for b in UNet(**kw).modules()
            if isinstance(b, blocks.ResnetBlockWithAttn)] == [True] + [False] * 5 + [True] * 2
    assert compute_dtype({}) is None and compute_dtype({"compute_dtype": "float32"}) is None
    with pytest.raises(NotImplementedError, match="float16"):
        check_compute_dtype({"compute_dtype": "float16"})


# ------------------------------------------------------------------ remat


def grads_of(net, x, t, w, seed):
    set_dropout_generator(net, torch.Generator().manual_seed(seed))
    net.zero_grad(set_to_none=True)
    out = net(x, t)
    (out * w).sum().backward()
    gen = next(m.generator for m in net.modules() if isinstance(m, blocks.Dropout))
    return {n: p.grad.clone() for n, p in net.named_parameters()}, out.detach(), gen.get_state()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_gradients_equal_plain_bit_for_bit(dtype):
    """Dropout 0.2 everywhere: the recompute must replay the forward's masks
    (drawn from the explicit generator, which checkpoint does not restore),
    and leave the generator where the forward left it."""
    kw = dict(KW, cond_type="noise_level", dropout=0.2, dtype=dtype)
    plain = UNet(**kw).train()
    remat = UNet(remat=True, **kw).train()
    remat.load_state_dict(plain.state_dict())
    x, t = (torch.from_numpy(a) for a in inputs())
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32))
    g_plain, out_plain, gen_plain = grads_of(plain, x, t, w, seed=3)
    g_remat, out_remat, gen_remat = grads_of(remat, x, t, w, seed=3)
    assert torch.equal(out_plain, out_remat) and torch.equal(gen_plain, gen_remat)
    assert g_plain.keys() == g_remat.keys()
    for name in g_plain:
        assert torch.equal(g_plain[name], g_remat[name]), name
    assert set(plain.state_dict()) == set(remat.state_dict())


def jax_remat_sites(net, params, x, t):
    """(H, C) of the input of each block JAX rematerializes, in call order:
    the activation operand (batch-leading, 4-D) of each remat eqn."""
    jx = jax.make_jaxpr(lambda p, x, t: net.apply(p, x, t))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t))
    sites = []
    for e in jx.jaxpr.eqns:
        if "remat" in e.primitive.name or "checkpoint" in e.primitive.name:
            acts = [v.aval.shape for v in e.invars
                    if len(getattr(v.aval, "shape", ())) == 4 and v.aval.shape[0] == x.shape[0]]
            assert len(acts) == 1, acts
            sites.append((acts[0][1], acts[0][3]))
    return sites


def port_remat_sites(port, x, t):
    sites = []

    def hook(m, args):
        if m.remat:
            sites.append((args[0].shape[2], args[0].shape[1]))

    handles = [m.register_forward_pre_hook(hook) for m in port.modules()
               if isinstance(m, blocks.ResnetBlockWithAttn)]
    try:
        with torch.no_grad():
            port(torch.from_numpy(x), torch.from_numpy(t))
    finally:
        for h in handles:
            h.remove()
    return sites


@pytest.mark.parametrize("min_res", [0, 8, 16, 64])
def test_remat_min_res_wraps_the_blocks_jax_wraps(min_res):
    net, params, port = pair("noise_level", remat=True, remat_min_res=min_res)
    x, t = inputs(B=5)  # a batch no kernel dim equals
    want = jax_remat_sites(net, params, x, t)
    assert port_remat_sites(port, x, t) == want
    assert len(want) == {0: 14, 8: 9, 16: 6, 64: 0}[min_res]


def test_jax_remat_params_load_and_give_the_same_forward():
    """JAX pins the plain block names under nn.remat, so its params load into
    the port's UNet with or without remat, and both forwards match JAX's."""
    net, params, port = pair("time", remat=True)
    plain = UNet(cond_type="time", dtype=torch.bfloat16, **KW).eval()
    plain.load_state_dict(port.state_dict(), strict=True)
    x, t = inputs(seed=4)
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t))
        assert torch.equal(got, plain(torch.from_numpy(x), torch.from_numpy(t)))
    err = np.abs(got.numpy() - want)
    m = np.abs(want).max()
    assert err.max() <= 3e-2 * m and err.mean() <= 5e-3 * m


# ------------------------------------------------------------------ the train step


def test_sr3_bf16_train_step():
    """One sr3 step at bf16 with remat (tests/test_torch_port_sr_train.py's
    tiny conditional model, batch 8, 16², JAX's t, γ and noise injected)
    against JAX's bf16 step, and both against JAX's f32 step from the same
    weights. Tolerances, from the measured spread of bf16 itself:
      * loss: relative 1e-3 (measured 9e-5); pre-clip grad_norm: relative
        5e-2 (measured 2.6e-2; JAX's bf16 is 2.0e-2 from its f32);
      * gradients, per tensor, relative L2 error: median over tensors <= 0.1
        (measured 0.049), each <= 0.15 against JAX's bf16 gradient or its f32
        one. JAX's bf16 bias gradient of the last conv sums 2,048 terms in
        bf16 and is 0.47 from its f32 gradient (256 against 490); the port's
        is 0.012 from it;
      * parameters after the step: within 1e-4·lr of JAX's where |g| >
        0.1·max|g| (Adam's step is lr·g/(|g| + eps) there; measured
        6.8e-6·lr), every element within 2·lr (where the two bf16 gradients
        differ in sign) and the rounding of p ± lr: 2.01·lr."""
    from tests.test_torch_port_sr_train import jax_first_grads, opt_for, step_both
    from tests.test_torch_port_train import LR, build_pair, params_of, to_port
    from tests.test_trainer import synth_batch

    batch = synth_batch(in_ch=2, out_ch=2)
    steps = {}
    for dtype in ("bfloat16", None):
        opt = opt_for("sr3")
        opt["model"]["compute_dtype"] = dtype
        opt["model"]["remat"] = dtype is not None
        jm, port = build_pair(opt)
        start = params_of(port)
        jlog, plog = step_both(jm, port, batch)
        steps[dtype] = (jm, port, jlog, plog, to_port(jm, jax_first_grads(jm)))
    jm, port, jlog, plog, jgrads = steps["bfloat16"]
    f32_grads = steps[None][4]
    net = port.nets.denoise_fn
    assert net.compute_dtype == torch.bfloat16 and all(
        b.remat for b in net.modules() if isinstance(b, blocks.ResnetBlockWithAttn))
    assert abs(plog["l_pix"] - jlog["l_pix"]) <= 1e-3 * abs(jlog["l_pix"])
    assert abs(plog["grad_norm"] - jlog["grad_norm"]) <= 5e-2 * jlog["grad_norm"]

    after = to_port(jm, jm.params)
    rel = []
    for name, p in port.nets.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        g, want, exact = p.grad.numpy(), jgrads[name].numpy(), f32_grads[name].numpy()
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        rel.append(err)
        assert min(err, np.linalg.norm(g - exact) / np.linalg.norm(exact)) <= 0.15, name
        moved = np.abs((p.detach().numpy() - start[name]) - (after[name].numpy() - start[name]))
        big = np.abs(want) > 0.1 * np.abs(want).max()
        assert moved[big].max(initial=0) <= 1e-4 * LR, name
        assert moved.max() <= 2.01 * LR, name  # opposite signs: ±lr, plus p's rounding
    assert np.median(rel) <= 0.1
