"""The port's UNet against the flax UNet on the same weights and inputs.

Small joint-InDI shape: 1 channel in and out, inner 16, 16 groups, mults
(1, 2, 4, 8), one res block, image 32, so the mid block attends at 4×4 with
C = 128. Tolerance: max abs ≤ 1e-4·max|ref| + 1e-5 (f32 on both sides; the
convolutions and GroupNorm sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu.utils.torch_export import flax_unet_to_torch_state_dict
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

KW = dict(in_channel=1, out_channel=1, inner_channel=16, norm_groups=16,
          channel_mults=(1, 2, 4, 8), attn_res=(), res_blocks=1, image_size=32)


def random_like(shapes, seed: int = 0):
    """Seeded numpy arrays for a tree of shapes: kernels N(0, 1/fan_in),
    vectors 1 + N(0, 0.1²), so that norm scales and biases are non-trivial."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2:
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def random_flax_params(net, x_shape, with_time: bool, seed: int = 0):
    """Random params of the flax net's shapes, without flax's init (its
    orthogonal init takes seconds per net on the CPU)."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1,) + x_shape[1:]),
                            jnp.zeros((1,)) if with_time else None)["params"]
    return random_like(shapes, seed)


@pytest.mark.parametrize("cond_type", ["time", "none"])
def test_unet_matches_flax(cond_type):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.5, 0.25], np.float32) if cond_type == "time" else None

    net = FlaxUNet(cond_type=cond_type, **KW)
    params = random_flax_params(net, x.shape, t is not None, seed=1)
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x),
                                         None if t is None else jnp.asarray(t)))

    port = UNet(cond_type=cond_type, **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1, cond_type),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if t is None else torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5

    # the JAX package's export names the same keys and values
    exported = flax_unet_to_torch_state_dict({"params": params}, net)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in exported.items()}, strict=True)
    with torch.no_grad():
        again = port(torch.from_numpy(x), None if t is None else torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(again, got)
    assert "mid.0.attn.qkv.weight" in exported
