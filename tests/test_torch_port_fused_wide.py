"""The port's fused walk at widths the conv_gn kernel does not take, against
the JAX package's fused walk and the port's unfused forward.

configs/splitting_cifar10_indi.json's UNet with inner_channel 32 (mults
(1, 2, 4, 8): widths 32 ... 256, 16 groups, one res block; 1 channel in and
out here, image 32): the deepest level's convs have Cout 256, the decoder's
first concat Cin 512 and later ones Cin and Cres 384, beyond the kernel's
Cin, Cres <= 256 and Cout <= 128. Before the walk planned its sites by shape
it raised there (`conv_gn_fused` still does). The JAX walk plans its own
sites (`_plan_conv`: its Pallas kernel in interpret mode where every width is
a multiple of 128, XLA elsewhere) and drops the res_conv bias, so it is
compared with those biases at zero. Tolerance as in test_torch_port_fused:
max abs <= 2e-4·max|ref| + 1e-5 (f32; carried GroupNorm statistics summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsplitting_tpu.experimental.fused_forward import fused_unet_apply
from diffsplitting_tpu.models import UNet as FlaxUNet
from diffsplitting_tpu_torch.models import UNet
from diffsplitting_tpu_torch.models import fused_forward as ff
from diffsplitting_tpu_torch.ops import conv_gn_fused
from diffsplitting_tpu_torch.utils.weights import unet_state_dict_from_jax

from tests.test_torch_port_fused import _close, _zero_res_conv_biases
from tests.test_torch_port_unet import random_flax_params

KW = dict(in_channel=1, out_channel=1, inner_channel=32, norm_groups=16,
          channel_mults=(1, 2, 4, 8), attn_res=(), res_blocks=1, image_size=32)
# (Cin, Cout, Cres) of every conv site in walk order; Cres 0 without a
# residual; the upsample convs have no prologue
SITES = [(32, 32, 0), (32, 32, 32), (32, 64, 0), (64, 64, 32), (64, 128, 0), (128, 128, 64),
         (128, 256, 0), (256, 256, 128), (256, 256, 0), (256, 256, 256), (256, 256, 0),
         (256, 256, 256), (512, 256, 0), (256, 256, 512), (384, 256, 0), (256, 256, 384),
         (256, 256, 0), (384, 128, 0), (128, 128, 384), (192, 128, 0), (128, 128, 192),
         (128, 128, 0), (192, 64, 0), (64, 64, 192), (96, 64, 0), (64, 64, 96), (64, 64, 0),
         (96, 32, 0), (32, 32, 96), (64, 32, 0), (32, 32, 64)]


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, size=(2,)).astype(np.float32)
    net = FlaxUNet(cond_type="time", **KW)
    params = _zero_res_conv_biases(random_flax_params(net, x.shape, True, seed=11))
    port = UNet(cond_type="time", **KW).eval()
    port.load_state_dict(unet_state_dict_from_jax(params, KW["channel_mults"], 1), strict=True)
    return net, params, port, x, t


def test_conv_gn_fused_still_refuses_wide_sites():
    x = torch.zeros(1, 4, 4, 512)
    with pytest.raises(ValueError, match="Cin=512"):
        conv_gn_fused(x, torch.zeros(3, 3, 512, 256), torch.zeros(256))


def test_fused_walk_plans_wide_sites_and_matches_jax(wide, monkeypatch):
    net, params, port, x, t = wide
    seen = []
    site = ff.conv_site

    def record(x_, K, bias, scale=None, shift=None, residual=None, w_skip=None):
        seen.append((x_.shape[-1], K.shape[-1], 0 if residual is None else residual.shape[-1]))
        return site(x_, K, bias, scale, shift, residual, w_skip)

    monkeypatch.setattr(ff, "conv_site", record)
    monkeypatch.setattr(ff.ConvSitePlan, "kernel", 0)
    monkeypatch.setattr(ff.ConvSitePlan, "library", 0)
    with torch.no_grad():
        got = ff.fused_unet_forward(port, torch.from_numpy(x), torch.from_numpy(t)).numpy()
        unfused = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert seen == SITES
    library = [s for s in SITES if s[1] > 128 or max(s[0], s[2]) > 256]
    assert all(s in library for s in SITES if s[1] == 256 or s[0] == 512)
    assert (ff.ConvSitePlan.kernel, ff.ConvSitePlan.library) == (18, 13) == (
        len(SITES) - len(library), len(library))

    want = np.asarray(fused_unet_apply(net, {"params": params}, jnp.asarray(x), jnp.asarray(t),
                                       interpret=True))
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert _close(got, want)
    assert _close(got, unfused)
