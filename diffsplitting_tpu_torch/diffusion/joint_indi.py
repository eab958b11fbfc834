"""Joint InDI — two bridge models, one per fluorescence channel.

Counterpart: diffsplitting_tpu/diffusion/joint_indi.py:
  * training (`p_losses`): net 1 sees {target: ch0, input: ch1}, net 2 the
    swap; the loss is the mean of the two per-channel losses (plus
    w_input_loss · 0, as in the reference). t is drawn by the `custom_t`
    variant (t in (0, 0.5], snapped to 0.5), or by `full_translation` (t in
    (0, 1), snapped to 0.5) when `allow_full_translation`;
  * `extra_param_logs`: the logged-but-unused alpha/offset/scale scalars;
  * `inference`: net 1 inverts from t_float_start (default 0.5), net 2 from
    1 − t_float_start, and the two outputs are concatenated on channels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .indi import DenoiseFn, InDIProcess


class JointInDIProcess:
    def __init__(self, out_channel: int = 1, e: float = 0.01, noise_mode: str = "gaussian",
                 num_timesteps: Optional[int] = None, val_num_timesteps: Optional[int] = None,
                 loss_type: str = "l1", lr_reduction: Optional[str] = None,
                 conditional: bool = False, t_sampling_mode: str = "linear_indi",
                 linear_indi_a: float = 1.0, w_input_loss: float = 0.0,
                 allow_full_translation: bool = False):
        kw = dict(out_channel=out_channel, e=e, noise_mode=noise_mode,
                  num_timesteps=num_timesteps, val_num_timesteps=val_num_timesteps,
                  loss_type=loss_type, lr_reduction=lr_reduction, conditional=conditional,
                  t_sampling_mode=t_sampling_mode, linear_indi_a=linear_indi_a,
                  t_variant="full_translation" if allow_full_translation else "custom_t")
        self.indi1 = InDIProcess(**kw)
        self.indi2 = InDIProcess(**kw)
        self.w_input_loss = w_input_loss
        self.num_timesteps = num_timesteps
        self.val_num_timesteps = val_num_timesteps
        self.out_channel = out_channel

    @staticmethod
    def extra_param_logs(nets) -> dict:
        """alpha (through a sigmoid), offset and scale of the nets module."""
        return {"alpha": torch.sigmoid(nets.alpha_param).detach(),
                "offset": nets.offset_param.detach(), "scale": nets.scale_param.detach()}

    def p_losses(self, denoise_fn_ch1: DenoiseFn, denoise_fn_ch2: DenoiseFn, batch,
                 num_timesteps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, draws=None):
        """Returns (loss, {'loss_splitting': ...}); batch['target'] is NHWC
        with 2 channels. `draws`, when given, is ((t, noise) for net 1,
        (t, noise) for net 2); otherwise both come from `generator`, net 1's
        first."""
        T = num_timesteps if num_timesteps is not None else self.num_timesteps
        target = batch["target"]
        x_in_ch1 = {"target": target[..., 0:1], "input": target[..., 1:2]}
        x_in_ch2 = {"target": target[..., 1:2], "input": target[..., 0:1]}
        (t1, n1), (t2, n2) = draws if draws is not None else ((None, None), (None, None))
        recon1 = self.indi1.get_prediction_during_training(denoise_fn_ch1, x_in_ch1, T,
                                                           generator, t1, n1)
        recon2 = self.indi2.get_prediction_during_training(denoise_fn_ch2, x_in_ch2, T,
                                                           generator, t2, n2)
        loss_ch1 = self.indi1.loss_fn(x_in_ch1["target"], recon1)
        loss_ch2 = self.indi2.loss_fn(x_in_ch2["target"], recon2)
        loss_splitting = (loss_ch1 + loss_ch2) / 2
        loss = loss_splitting + self.w_input_loss * 0.0
        return loss, {"loss_splitting": loss_splitting.detach()}

    def inference(self, denoise_fn_ch1: DenoiseFn, denoise_fn_ch2: DenoiseFn, x_in,
                  num_timesteps: Optional[int] = None, t_float_start: float = 0.5,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None):
        """`noise`, when given, is (noise for net 1, noise for net 2)."""
        n1, n2 = noise if noise is not None else (None, None)
        ch1 = self.indi1.inference(denoise_fn_ch1, x_in, num_timesteps, t_float_start,
                                   generator, n1)
        ch2 = self.indi2.inference(denoise_fn_ch2, x_in, num_timesteps, 1 - t_float_start,
                                   generator, n2)
        return torch.cat([ch1, ch2], dim=-1)
