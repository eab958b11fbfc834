"""Weights into the port: the JAX package's params, or a reference `*_gen.pth`.

Counterpart: diffsplitting_tpu/utils/torch_export.py (the UNet walk and the
diffusion-wrapper layout), copied so the port imports nothing of the JAX
package. Trained JAX weights reach the port either as the params tree
(nested dicts of numpy arrays, e.g. `jax.device_get(model.params)`) through
`state_dict_from_jax`, or through JAX `DiffusionModel.export_torch`, whose
`*_gen.pth` `load_reference_checkpoint` reads.

Layouts: flax Conv HWIO → torch OIHW; flax Dense (in, out) → torch
(out, in); Block gn_scale/gn_bias → `block.0.weight/bias`.

The state dict is the diffusion wrapper's:
  * indi — `denoise_fn.<unet keys>`;
  * joint_indi — `indi1.denoise_fn.*`, `indi2.denoise_fn.*` and the scalars
    `alpha_param`, `offset_param`, `scale_param`.
The time predictor's (`time_predictor_state_dict_from_jax`) is the port's
`TimePredictor`: `unet.<unet keys>` (cond_type 'none') and
`foreground_mask.conv.*`, named after the JAX module.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

JOINT_EXTRAS = ("alpha_param", "offset_param", "scale_param")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _conv(out: Dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _dense(out: Dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _block(out: Dict, name: str, p: Mapping) -> None:
    out[f"{name}.block.0.weight"] = _t(p["gn_scale"])
    out[f"{name}.block.0.bias"] = _t(p["gn_bias"])
    _conv(out, f"{name}.block.3", p["Conv_0"])


def _rbwa(out: Dict, name: str, p: Mapping, cond_type: str) -> None:
    rp = p["ResnetBlock_0"]
    _block(out, f"{name}.res_block.block1", rp["Block_0"])
    _block(out, f"{name}.res_block.block2", rp["Block_1"])
    if cond_type == "time":
        _dense(out, f"{name}.res_block.mlp.1", rp["Dense_0"])
    if "Conv_0" in rp:  # dim_in != dim_out
        _conv(out, f"{name}.res_block.res_conv", rp["Conv_0"])
    if "SelfAttention_0" in p:
        ap = p["SelfAttention_0"]
        out[f"{name}.attn.norm.weight"] = _t(ap["GroupNorm_0"]["scale"])
        out[f"{name}.attn.norm.bias"] = _t(ap["GroupNorm_0"]["bias"])
        _conv(out, f"{name}.attn.qkv", ap["Conv_0"])
        _conv(out, f"{name}.attn.out", ap["Conv_1"])


def unet_state_dict_from_jax(params: Mapping, channel_mults, res_blocks: int,
                             cond_type: str = "time") -> Dict[str, torch.Tensor]:
    """One flax UNet's params → the port UNet's (reference-named) state dict."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    if cond_type == "time":
        _dense(out, "time_mlp.1", params["Dense_0"])
        _dense(out, "time_mlp.3", params["Dense_1"])
        dim = np.asarray(params["Dense_0"]["kernel"]).shape[0]
        out["time_mlp.0.inv_freq"] = _t(
            np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim)))

    num_mults = len(channel_mults)
    rb_i = down_i = up_i = 0
    _conv(out, "downs.0", params["Conv_0"])
    t_i = 1
    for ind in range(num_mults):
        for _ in range(res_blocks):
            _rbwa(out, f"downs.{t_i}", params[f"ResnetBlockWithAttn_{rb_i}"], cond_type)
            rb_i += 1
            t_i += 1
        if ind != num_mults - 1:
            _conv(out, f"downs.{t_i}.conv", params[f"Downsample_{down_i}"]["Conv_0"])
            down_i += 1
            t_i += 1

    for m in range(2):
        _rbwa(out, f"mid.{m}", params[f"ResnetBlockWithAttn_{rb_i}"], cond_type)
        rb_i += 1

    t_i = 0
    for ind in reversed(range(num_mults)):
        for _ in range(res_blocks + 1):
            _rbwa(out, f"ups.{t_i}", params[f"ResnetBlockWithAttn_{rb_i}"], cond_type)
            rb_i += 1
            t_i += 1
        if ind >= 1:
            _conv(out, f"ups.{t_i}.conv", params[f"Upsample_{up_i}"]["Conv_0"])
            up_i += 1
            t_i += 1

    _block(out, "final_conv", params["Block_0"])
    return out


def state_dict_from_jax(which: str, params: Mapping, unet_opt: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's params ({'net'} or {'net_ch1', 'net_ch2', 'extra'})
    → the port's diffusion-wrapper state dict. `unet_opt` is the config's
    `model.unet` section."""
    mults = tuple(unet_opt["channel_multiplier"])
    res_blocks = int(unet_opt["res_blocks"])
    if which == "indi":
        return {f"denoise_fn.{k}": v for k, v in
                unet_state_dict_from_jax(params["net"], mults, res_blocks).items()}
    if which == "joint_indi":
        sd = {k: _t(params["extra"][k]) for k in JOINT_EXTRAS}
        for role, root in (("net_ch1", "indi1"), ("net_ch2", "indi2")):
            for k, v in unet_state_dict_from_jax(params[role], mults, res_blocks).items():
                sd[f"{root}.denoise_fn.{k}"] = v
        return sd
    raise NotImplementedError(f"which_model_G={which!r} is not ported")


def time_predictor_state_dict_from_jax(params: Mapping, unet_opt: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """The JAX TimePredictor's params (`UNet_0`, `ForegroundMask_0`) → the
    port's `TimePredictor` state dict. `unet_opt` is the config's
    `model.unet` section."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    sd = {f"unet.{k}": v for k, v in unet_state_dict_from_jax(
        params["UNet_0"], tuple(unet_opt["channel_multiplier"]), int(unet_opt["res_blocks"]),
        cond_type="none").items()}
    _conv(sd, "foreground_mask.conv", params["ForegroundMask_0"]["Conv_0"])
    return sd


def load_reference_checkpoint(path: str, which: str = "joint_indi") -> Dict[str, torch.Tensor]:
    """Read a `*_gen.pth` in the reference layout (or the JAX package's
    export) as a CPU state dict: joint_indi by default, or indi."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if which == "joint_indi":
        missing = [k for k in JOINT_EXTRAS if k not in sd]
        roots = ("indi1.denoise_fn.", "indi2.denoise_fn.")
    elif which == "indi":
        missing, roots = [], ("denoise_fn.",)
    else:
        raise NotImplementedError(f"which_model_G={which!r} is not ported")
    missing += [r + "*" for r in roots if not any(k.startswith(r) for k in sd)]
    if missing:
        raise KeyError(f"{path} is not a {which} checkpoint: missing {missing}")
    return sd
