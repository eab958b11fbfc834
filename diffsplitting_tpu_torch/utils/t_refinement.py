"""Inference-time estimation of the mixing fraction t for joint-InDI splitting.

Counterpart: diffsplitting_tpu/utils/t_refinement.py
(`get_channel_estimates`, `estimate_time_using_PSNR`), with the same
semantics:

  1. the time classifier predicts t̂ from the mixed input; indi_1 (which
     recovers channel 1) starts at 1 − t̂, indi_2 at t̂;
  2. each direction inverts each sample in ONE bridge step from its own start
     time, with the same noise for every sample of a direction (JAX reuses
     one key a direction for every sample): here one draw a direction, taken
     from `generator` (indi_1's first) or injected as `noise`;
  3. on the grid t ∈ {0, 0.05, …, 0.95} the remix t·ch1 + (1−t)·ch2 is scored
     by RangeInvariantPsnr against the input; each sample takes its argmax t,
     and the consensus is the argmax of the mean over samples.

`times`, when given, gathers the host seconds of each stage ('classifier',
'one_step', 'psnr_grid'); every stage ends by reading its result back to the
host, so the times hold the device's work.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .psnr import RangeInvariantPsnr


def _add_time(times: Optional[dict], key: str, t0: float) -> None:
    if times is not None:
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0


def one_step_noise(indi, inp: torch.Tensor, generator: Optional[torch.Generator]):
    """The two draws (initial, step) of a one-step inversion of one sample of
    `inp`, shaped as `indi.inference` draws them."""
    shape = (1, *inp.shape[1:3], inp.shape[3] * indi.out_channel)
    return [torch.randn(shape, generator=generator, device=inp.device, dtype=inp.dtype)
            for _ in range(2)]


@torch.no_grad()
def get_channel_estimates(inp: torch.Tensor, indi_1, indi_2, denoise_1: Callable,
                          denoise_2: Callable, time_classifier: Callable,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Tuple[Sequence[torch.Tensor],
                                                Sequence[torch.Tensor]]] = None,
                          times: Optional[dict] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-step bridge inversions of both channels at the classifier's t.

    inp: (B, H, W, 1) normalized input on the device. Returns (pred1, pred2,
    pred_t_2) as numpy: (B, H, W, 1) twice and the classifier's (B,) t."""
    t0 = time.perf_counter()
    pred_t_2 = np.asarray(torch.as_tensor(time_classifier(inp)).float().cpu())
    _add_time(times, "classifier", t0)
    pred_t_1 = 1.0 - pred_t_2

    t0 = time.perf_counter()
    if noise is None:
        noise = (one_step_noise(indi_1, inp, generator), one_step_noise(indi_2, inp, generator))
    n1, n2 = noise
    pred1, pred2 = [], []
    for b in range(inp.shape[0]):
        x = inp[b: b + 1]
        pred1.append(indi_1.inference(denoise_1, x, 1, float(pred_t_1[b]), noise=n1))
        pred2.append(indi_2.inference(denoise_2, x, 1, float(pred_t_2[b]), noise=n2))
    pred1 = torch.cat(pred1).cpu().numpy()
    pred2 = torch.cat(pred2).cpu().numpy()
    _add_time(times, "one_step", t0)
    return pred1, pred2, pred_t_2


def psnr_grid(inp, pred1: np.ndarray, pred2: np.ndarray, t_step: float = 0.05
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(t_list, psnr_matrix (T, B)): RangeInvariantPsnr of each remix
    t·pred1 + (1−t)·pred2 against the input."""
    gt = np.asarray(torch.as_tensor(inp).cpu())[..., 0]
    p1, p2 = pred1[..., 0], pred2[..., 0]
    t_list = np.arange(0, 1.0, t_step)
    rows = [RangeInvariantPsnr(gt, p1 * t + p2 * (1 - t)) for t in t_list]
    return t_list, np.stack(rows)


def estimate_time_using_PSNR(inp: torch.Tensor, indi_1, indi_2, denoise_1: Callable,
                             denoise_2: Callable, time_classifier: Callable,
                             generator: Optional[torch.Generator] = None,
                             t_step: float = 0.05, noise=None,
                             times: Optional[dict] = None) -> Tuple[np.ndarray, float]:
    """Returns (per_sample_t, consensus_t) for a (B, H, W, 1) normalized
    mixed input."""
    pred1, pred2, _ = get_channel_estimates(inp, indi_1, indi_2, denoise_1, denoise_2,
                                            time_classifier, generator, noise, times)
    t0 = time.perf_counter()
    t_list, psnr_matrix = psnr_grid(inp, pred1, pred2, t_step)
    per_sample_t = t_list[psnr_matrix.argmax(axis=0)]
    consensus_t = float(t_list[psnr_matrix.mean(axis=1).argmax()])
    _add_time(times, "psnr_grid", t0)
    return per_sample_t, consensus_t
