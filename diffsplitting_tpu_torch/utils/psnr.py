"""Batch PSNR and range-invariant PSNR, in numpy.

Counterpart: diffsplitting_tpu/utils/psnr.py (`PSNR`, `RangeInvariantPsnr`,
`zero_mean`, `fix_range`, `fix`), which computes the same formulas in jnp:
  * PSNR: per-image range = max - min of the ground truth unless given;
  * RangeInvariantPsnr: the ground truth zero-meaned and scaled by its std,
    the prediction fitted to it by a least-squares scale (`fix_range`), range
    (max - min)/std.
Here the sums run in float64.
"""

from __future__ import annotations

import numpy as np


def _as_batch2d(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 3:
        raise ValueError("Images must be in shape: (batch, H, W)")
    return x.reshape(x.shape[0], -1)


def zero_mean(x):
    return x - np.mean(x, axis=1, keepdims=True)


def fix_range(gt, x):
    a = np.sum(gt * x, axis=1, keepdims=True) / np.sum(x * x, axis=1, keepdims=True)
    return x * a


def fix(gt, x):
    gt_ = zero_mean(gt)
    return fix_range(gt_, zero_mean(x))


def _psnr_internal(gt, pred, range_=None):
    if range_ is None:
        range_ = np.max(gt, axis=1) - np.min(gt, axis=1)
    mse = np.mean((gt - pred) ** 2, axis=1)
    return 20 * np.log10(range_ / np.sqrt(mse))


def PSNR(gt, pred, range_=None) -> np.ndarray:
    return _psnr_internal(_as_batch2d(gt), _as_batch2d(pred), range_=range_)


def RangeInvariantPsnr(gt, pred) -> np.ndarray:
    """Scale-invariant PSNR for grayscale stacks (batch, H, W)."""
    gt = _as_batch2d(gt)
    pred = _as_batch2d(pred)
    std = np.std(gt, axis=1)
    ra = (np.max(gt, axis=1) - np.min(gt, axis=1)) / std
    gt_ = zero_mean(gt) / std[:, None]
    return _psnr_internal(zero_mean(gt_), fix(gt_, pred), ra)
