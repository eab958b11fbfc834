"""The port's GroupNorm+Swish and attention ops against the JAX package.

The plain versions (what a CPU tensor runs) are held against the JAX
references and the Pallas kernels in interpret mode, on the same numpy
inputs; the autograd backward is held against jax.grad of the reference.
Tolerance 1e-5 max abs: both sides compute in f32 and differ only in the
order of their sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.experimental.groupnorm_pallas import _pallas_forward as gn_pallas
from diffsplitting_tpu.ops.attention import _pallas_forward as attn_pallas
from diffsplitting_tpu.ops.attention import attention_reference as jax_attention
from diffsplitting_tpu.ops.groupnorm import group_norm_swish_reference as jax_gn
from diffsplitting_tpu_torch.ops import (
    FusedAttention,
    FusedGroupNormSwish,
    attention_reference,
    fused_attention,
    fused_group_norm_swish,
    group_norm_swish_reference,
    head_dim_route,
)

TOL = 1e-5


def _gn_inputs(cs, G=4, seed=0):
    rng = np.random.default_rng(seed)
    C = cs * G
    x = (rng.normal(size=(2, 8, 8, C)) * 1.5 + 0.3).astype(np.float32)
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    return x, scale, bias, G


@pytest.mark.parametrize("cs", [1, 3, 8])
def test_group_norm_swish_matches_jax_reference_and_pallas(cs):
    x, scale, bias, G = _gn_inputs(cs)
    got = group_norm_swish_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                     torch.from_numpy(bias), G).numpy()
    want = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G))
    pallas = np.asarray(gn_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G,
                                  1e-5, interpret=True))
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - pallas).max() <= TOL


def test_fused_group_norm_swish_on_cpu_runs_plain_version_and_backward():
    x, scale, bias, G = _gn_inputs(3, seed=1)
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    before = FusedGroupNormSwish.launches
    y = fused_group_norm_swish(tx, ts, tb, G)
    assert FusedGroupNormSwish.launches == before  # a CPU tensor launches nothing
    np.testing.assert_array_equal(
        y.detach().numpy(), group_norm_swish_reference(tx, ts, tb, G).detach().numpy())
    (y ** 2).sum().backward()

    grads = jax.grad(lambda a, s, b: jnp.sum(jax_gn(a, s, b, G) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    for t, g in zip((tx, ts, tb), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def _qkv(seed=0, B=2, N=16, H=2, D=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3)]


def test_attention_matches_jax_reference_and_pallas():
    q, k, v = _qkv()
    scale = 1.0 / np.sqrt(16)
    got = attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_attention(jq, jk, jv, scale))
    pallas = np.asarray(attn_pallas(jq, jk, jv, scale, interpret=True))
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - pallas).max() <= TOL


def test_fused_attention_on_cpu_runs_plain_version_and_backward():
    q, k, v = _qkv(seed=1, B=1, N=8, H=1, D=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = FusedAttention.launches
    out = fused_attention(tq, tk, tv, 0.5)
    assert FusedAttention.launches == before
    (out ** 2).sum().backward()
    grads = jax.grad(lambda a, b, c: jnp.sum(jax_attention(a, b, c, 0.5) ** 2),
                     argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,route", [(128, "d128"), (256, "wide"), (384, "wide"), (512, "wide"),
                                     (640, "wide"), (768, "wide"), (896, "wide"), (1024, "wide"),
                                     (12, "narrow"), (16, "narrow"), (64, "narrow"),
                                     (68, "narrow"), (192, "wide"), (1020, "wide"), (4, "narrow"),
                                     (124, "narrow"), (132, "wide"), (900, "wide")])
def test_attention_kernel_is_picked_by_head_dim(D, route):
    assert head_dim_route(D) == route


@pytest.mark.parametrize("D", [0, 66, 1028, 2048])
def test_attention_kernels_refuse_other_head_dims(D):
    with pytest.raises(ValueError, match="head dim"):
        head_dim_route(D)
