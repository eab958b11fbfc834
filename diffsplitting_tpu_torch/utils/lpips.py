"""LPIPS (AlexNet backbone), the perceptual distance of the evaluation.

Counterpart: diffsplitting_tpu/utils/lpips.py. The reference's notebook
reports LPIPS(alex) beside PSNR through the `lpips` package: AlexNet
features of both images after its fixed input shift and scale, each layer
unit-normalized over channels, the squared difference weighted by the
learned 1×1 "lin" head, averaged over space and summed over the 5 layers.

No weights ship with the repository and none may be fetched: the weights load
from a local `.npz` (the JAX package's layout: `conv{i}/kernel` HWIO,
`conv{i}/bias`, `lin{i}/weight`, so one file serves both packages) or a torch
`.pth` holding the torchvision-AlexNet `features.*` and the lpips `lin*`
state dicts. `random_lpips_params` keeps the pipeline testable without them.

The parameters here are a dict of tensors in torch's layout:
`conv{i}` {'weight' (O, I, k, k), 'bias' (O,)}, `lin{i}` {'weight' (C,)}.
Inputs are NHWC RGB in [-1, 1], as in the lpips package and in JAX.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

# lpips.ScalingLayer constants (input normalization in [-1, 1] space)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

# AlexNet feature extractor: (out_ch, kernel, stride, pad, maxpool_before)
ALEX_CFG = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)
FEATURE_CHANNELS = tuple(c[0] for c in ALEX_CFG)
TORCHVISION_CONVS = (0, 3, 6, 8, 10)  # features.{j} of torchvision's AlexNet

Params = Dict[str, Dict[str, torch.Tensor]]


def random_lpips_params(generator: torch.Generator, dtype=torch.float32, device=None) -> Params:
    """Random weights with the production structure (JAX's scheme: normal
    kernels scaled by 1/√(k²·Cin), zero biases, |normal|·0.01 lin heads,
    which are trained non-negative), for tests and dry runs."""
    params, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(ALEX_CFG):
        w = torch.randn(out_ch, in_ch, k, k, generator=generator, dtype=dtype)
        params[f"conv{i}"] = {"weight": (w / np.sqrt(k * k * in_ch)).to(device),
                              "bias": torch.zeros(out_ch, dtype=dtype, device=device)}
        lin = torch.randn(out_ch, generator=generator, dtype=dtype).abs() * 0.01
        params[f"lin{i}"] = {"weight": lin.to(device)}
        in_ch = out_ch
    return params


def alex_features(params: Params, x):
    """x (B, H, W, 3) in [-1, 1] -> the 5 post-ReLU feature maps (NCHW)."""
    shift = torch.tensor(SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(SCALE, dtype=x.dtype, device=x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for i, (_, _, stride, pad, pool_before) in enumerate(ALEX_CFG):
        if pool_before:
            h = F.max_pool2d(h, 3, 2)
        p = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, p["weight"], p["bias"], stride=stride, padding=pad))
        feats.append(h)
    return feats


def _unit_normalize(f, eps: float = 1e-10):
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + eps)


def lpips(params: Params, img1, img2):
    """LPIPS distance of each batch element: (B, H, W, 3) × 2 in [-1, 1] ->
    (B,)."""
    total = 0.0
    for i, (a, b) in enumerate(zip(alex_features(params, img1), alex_features(params, img2))):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        w = params[f"lin{i}"]["weight"]  # (C,): a 1x1 conv to one map
        total = total + (d * w[:, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total


def lpips_grayscale(params: Params, img1, img2):
    """One-channel images replicated to RGB, as the notebook feeds the
    microscopy channels."""
    return lpips(params, img1.repeat(1, 1, 1, 3), img2.repeat(1, 1, 1, 3))


# --------------------------------------------------------------- weight IO
def save_lpips_weights(params: Params, path: str) -> None:
    """npz in the JAX package's layout (`conv{i}/kernel` HWIO)."""
    flat = {}
    for i in range(len(ALEX_CFG)):
        conv = params[f"conv{i}"]
        flat[f"conv{i}/kernel"] = conv["weight"].detach().cpu().numpy().transpose(2, 3, 1, 0)
        flat[f"conv{i}/bias"] = conv["bias"].detach().cpu().numpy()
        flat[f"lin{i}/weight"] = params[f"lin{i}"]["weight"].detach().cpu().numpy()
    np.savez(path, **flat)


def _validate(params: Params) -> None:
    in_ch = 3
    for i, (out_ch, k, _, _, _) in enumerate(ALEX_CFG):
        shape = tuple(params[f"conv{i}"]["weight"].shape)
        if shape != (out_ch, in_ch, k, k):
            raise ValueError(f"conv{i} weight {shape} != {(out_ch, in_ch, k, k)}")
        if tuple(params[f"lin{i}"]["weight"].shape) != (out_ch,):
            raise ValueError(f"lin{i} weight is not ({out_ch},)")
        in_ch = out_ch


def _params_from_npz(flat) -> Params:
    params = {}
    for i in range(len(ALEX_CFG)):
        kernel = np.asarray(flat[f"conv{i}/kernel"])  # HWIO
        params[f"conv{i}"] = {"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                              "bias": torch.from_numpy(np.asarray(flat[f"conv{i}/bias"]))}
        params[f"lin{i}"] = {"weight": torch.from_numpy(np.asarray(flat[f"lin{i}/weight"]))}
    _validate(params)
    return params


def params_from_torch_state_dicts(alexnet_sd: Mapping, lpips_sd: Mapping) -> Params:
    """torchvision-AlexNet `features.{0,3,6,8,10}.{weight,bias}` (OIHW) and
    lpips `lin{i}.model.1.weight` ((1, C, 1, 1)) state dicts -> params."""
    params = {}
    for i, j in enumerate(TORCHVISION_CONVS):
        params[f"conv{i}"] = {
            "weight": torch.as_tensor(alexnet_sd[f"features.{j}.weight"]).float(),
            "bias": torch.as_tensor(alexnet_sd[f"features.{j}.bias"]).float()}
        lin = torch.as_tensor(lpips_sd[f"lin{i}.model.1.weight"]).float().reshape(-1)
        params[f"lin{i}"] = {"weight": lin}
    _validate(params)
    return params


def load_lpips_weights(path: str, device=None) -> Params:
    """From `.npz` (the JAX layout) or a torch `.pth` / `.pt` holding
    {'alexnet': <features state dict>, 'lpips': <lin state dict>} (or one
    flat dict with both naming schemes), onto `device`."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npz"):
        with np.load(path) as flat:
            params = _params_from_npz(flat)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "alexnet" in sd and "lpips" in sd:
            params = params_from_torch_state_dicts(sd["alexnet"], sd["lpips"])
        else:
            params = params_from_torch_state_dicts(sd, sd)
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}
