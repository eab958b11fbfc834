"""The time predictor's data: mixtures of the two normalized channels at a
drawn fraction t, with t as the label.

Counterpart: diffsplitting_tpu/data/time_predictor_dataset.py
(`compute_input_normalization_dict`, `TimePredictorDataset`). The numpy
calls, and the order in which an item draws from the dataset's
`np.random.default_rng(seed)` (location, flip, t, noise), are the same, so
for the same files and seed the items are bit-identical to the JAX
package's.

  * `compute_input_normalization_dict`: per t on the grid {0..T}/T, the min
    and max over all frames of t·ch0 + (1−t)·ch1 of the normalized channels.
  * `__getitem__`: t = k/100 with k drawn from {0..99}; the input is
    t·ch0 + (1−t)·ch1 of the normalized patch pair, min-max rescaled to
    [−1, 1] with the statistics of that t unless `raw_mixture_inputs`, plus
    Gaussian noise of std `gaussian_noise_std_factor`·std(input) when set.
    Returns (input HWC float32, t float32).
  * `item_at_t`: the mixture at a fixed t (the evaluation's per-t grid),
    rescaled with `fixed_t_norm_dict` when set.
"""

from __future__ import annotations

import numpy as np

from .split_dataset import SplitDataset


def compute_input_normalization_dict(data_dict, n_timesteps, mean_target, std_target):
    """{t_int: [min, max]} of the t-mixture over all frames (normalized)."""
    mean = np.asarray(mean_target).reshape(-1)
    std = np.asarray(std_target).reshape(-1)
    ch0 = [(np.asarray(x) - mean[0]) / std[0] for x in data_dict[0]]
    ch1 = [(np.asarray(x) - mean[1]) / std[1] for x in data_dict[1]]

    ts = np.arange(0, n_timesteps + 1) / n_timesteps
    mins = np.full(len(ts), 1e10)
    maxs = np.full(len(ts), -1e10)
    for a, b in zip(ch0, ch1):
        # t·a + (1−t)·b per pixel, 8 values of t at a time to bound memory
        flat_a = a.reshape(-1)
        flat_b = b.reshape(-1)
        for i in range(0, len(ts), 8):
            sub = ts[i: i + 8, None]
            mix = sub * flat_a[None, :] + (1 - sub) * flat_b[None, :]
            mins[i: i + 8] = np.minimum(mins[i: i + 8], mix.min(axis=1))
            maxs[i: i + 8] = np.maximum(maxs[i: i + 8], mix.max(axis=1))
    return {t_int: [mins[t_int], maxs[t_int]] for t_int in range(n_timesteps + 1)}


class TimePredictorDataset(SplitDataset):
    def __init__(self, *args, step_size=0.05, gaussian_noise_std_factor=None,
                 raw_mixture_inputs=False, **kwargs):
        """`raw_mixture_inputs` trains on t·ch0 + (1−t)·ch1 as it is, the
        input the t-refinement workflow serves, instead of the per-t min-max
        rescale. `step_size` is accepted and unused, as in JAX."""
        self._gaussian_noise_std_factor = gaussian_noise_std_factor
        self._raw_mixture_inputs = bool(raw_mixture_inputs)
        super().__init__(*args, **kwargs)
        self._num_timesteps = 100
        self.input_normalization_dict = compute_input_normalization_dict(
            self._data_dict, self._num_timesteps, self._mean_target, self._std_target
        )

    def sample_t(self):
        t_int = int(self._rng.integers(0, self._num_timesteps))
        return t_int / self._num_timesteps, t_int

    def min_max_normalize(self, img, t_int):
        t_min, t_max = self.input_normalization_dict[t_int]
        return 2 * (img - t_min) / (t_max - t_min) - 1

    def item_at_t(self, index, t: float, t_int: int):
        """The mixture at a fixed t, min-max rescaled with
        `fixed_t_norm_dict[t_int]` when that is set (the statistics of the
        caller's grid), else with the T = 100 statistics."""
        fidx, h_idx, w_idx = self._get_location(index)
        P = self._patch_size
        patch1 = np.asarray(self._data_dict[0][fidx][h_idx: h_idx + P, w_idx: w_idx + P])
        patch2 = np.asarray(self._data_dict[1][fidx][h_idx: h_idx + P, w_idx: w_idx + P])
        if patch1.ndim == 2:
            patch1 = patch1[..., None]
            patch2 = patch2[..., None]
        target = self.normalize_target(
            np.concatenate([patch1, patch2], axis=-1).astype(np.float32)
        )
        nC = patch1.shape[-1]
        inp = t * target[..., 0:nC] + (1 - t) * target[..., nC: 2 * nC]
        norm = getattr(self, "fixed_t_norm_dict", self.input_normalization_dict)
        t_min, t_max = norm[t_int]
        return (2 * (inp - t_min) / (t_max - t_min) - 1).astype(np.float32)

    def __getitem__(self, index):
        fidx, h_idx, w_idx = self._get_location(index)
        img1 = self._data_dict[0][fidx]
        if self._uncorrelated_channels:
            fidx = int(self._rng.integers(0, self._frameN))
        img2 = self._data_dict[1][fidx]
        if img1.shape != img2.shape:
            raise ValueError("Images must have the same shape")

        P = self._patch_size
        patch1 = np.asarray(img1[h_idx: h_idx + P, w_idx: w_idx + P]).astype(np.float32)
        patch2 = np.asarray(img2[h_idx: h_idx + P, w_idx: w_idx + P]).astype(np.float32)
        if self._enable_transforms:
            patch1, patch2 = self._augment(patch1, patch2)
        if patch1.ndim == 2:
            patch1 = patch1[..., None]
            patch2 = patch2[..., None]

        target = np.concatenate([patch1, patch2], axis=-1)
        target = self.normalize_target(target)
        nC = patch1.shape[-1]
        patch1, patch2 = target[..., 0:nC], target[..., nC: 2 * nC]

        t, t_int = self.sample_t()
        inp = t * patch1 + (1 - t) * patch2
        if not self._raw_mixture_inputs:
            inp = self.min_max_normalize(inp, t_int)

        if self._gaussian_noise_std_factor is not None:
            inp = inp + self._rng.normal(
                0, self._gaussian_noise_std_factor * inp.std(), inp.shape
            ).astype(np.float32)

        return inp.astype(np.float32), np.float32(t)
