"""SplitDataset: the fluorescence-splitting training and validation data
(host-side numpy, HWC).

Counterpart: diffsplitting_tpu/data/split_dataset.py (`DataLocation`,
`load_data`, `SplitDataset`). The numpy calls, and the order in which
`_get_location`, `_augment` and `__getitem__` draw from
`np.random.default_rng(seed)`, are the same, so for the same files and seed
the items are bit-identical to the JAX package's.

  * DataLocation: exactly one of fpath / channelwise_fpath / directory.
  * Hagen TIFF channel loaders with the upper clip of 1993.0.
  * Patching: grid (`patch_location`) or random; `uncorrelated_channels`
    draws channel 2 from a random frame; paired horizontal flip with p = 0.5.
  * __getitem__: target = concat(channel patches) normalized by the target
    statistics; input = the weighted raw sum normalized by the input
    statistics, or the weighted sum of the normalized target when
    `input_from_normalized_target` (the joint-InDI path).

  * CIFAR-10 (`data_type="cifar10"`, `data/cifar10.py`): the pickles in
    `DataLocation(directory=...)`, classes 1 (automobile) and 7 (horse) as
    the two channels, HWC uint8 frames normalized by the uint8 statistics
    (max 255 a channel). configs/splitting_cifar10_indi.json trains on it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cifar10 import load_train_val_data
from .io import load_tiff_stack
from .normalization import compute_normalization_dict

# the reference's clip for the Hagen TIFFs
HAGEN_UPPER_CLIP_DEFAULT = 1993.0

# the CIFAR-10 splitting classes: 1 = automobile, 7 = horse
CIFAR_SPLIT_LABELS = [1, 7]


@dataclass
class DataLocation:
    fpath: str = ""
    channelwise_fpath: Tuple[str, ...] = ()
    directory: str = ""

    def __post_init__(self):
        provided = [bool(self.fpath), bool(len(self.channelwise_fpath)), bool(self.directory)]
        if sum(provided) != 1:
            raise ValueError("Exactly one of fpath, channelwise_fpath, directory must be provided")


def _load_channelwise(fpaths, upper_clip_value: Optional[float]):
    if len(fpaths) != 2:
        raise ValueError("Only two channelwise fpaths are supported")
    data_ch0 = load_tiff_stack(fpaths[0]).astype(np.float32)
    data_ch1 = load_tiff_stack(fpaths[1]).astype(np.float32)
    if upper_clip_value is not None:
        data_ch0 = np.minimum(data_ch0, upper_clip_value)
        data_ch1 = np.minimum(data_ch1, upper_clip_value)
    return {0: [x for x in data_ch0], 1: [x for x in data_ch1]}


def _load_single_fpath(fpath: str):
    if not os.path.exists(fpath):
        raise FileNotFoundError(f"Path {fpath} does not exist")
    data = load_tiff_stack(fpath)
    return {0: [x for x in data[..., 0]], 1: [x for x in data[..., 1]]}


def load_data(
    data_type: str,
    dataloc: DataLocation,
    upper_clip_value: Optional[float] = HAGEN_UPPER_CLIP_DEFAULT,
) -> Dict[int, List[np.ndarray]]:
    if data_type == "cifar10":
        return load_train_val_data(dataloc.directory, CIFAR_SPLIT_LABELS)
    if dataloc.fpath:
        return _load_single_fpath(dataloc.fpath)
    if len(dataloc.channelwise_fpath) > 0:
        return _load_channelwise(dataloc.channelwise_fpath, upper_clip_value)
    raise ValueError("unsupported data location")


class SplitDataset:
    """Map-style dataset yielding {'input': HWC, 'target': HWC} float32."""

    def __init__(
        self,
        data_type: str,
        data_location: DataLocation,
        patch_size: int,
        target_channel_idx: Optional[int] = None,
        random_patching: bool = False,
        enable_transforms: bool = False,
        max_qval: float = 0.98,
        normalization_dict: Optional[dict] = None,
        uncorrelated_channels: bool = False,
        channel_weights: Optional[List[float]] = None,
        input_from_normalized_target: bool = False,
        upper_clip: bool = False,
        hagen_upper_clip: Optional[float] = HAGEN_UPPER_CLIP_DEFAULT,
        seed: int = 0,
    ):
        if data_type not in ("cifar10", "Hagen"):
            raise ValueError("data_type must be cifar10 or Hagen")

        self._patch_size = patch_size
        self._data_location = data_location
        self._channel_weights = channel_weights if channel_weights is not None else [1, 1]
        self._input_from_normalized_target = input_from_normalized_target
        self._data_dict = load_data(
            data_type, data_location,
            upper_clip_value=hagen_upper_clip if data_type == "Hagen" else None,
        )
        self._frameN = min(len(self._data_dict[0]), len(self._data_dict[1]))
        self._target_channel_idx = target_channel_idx
        self._random_patching = random_patching
        self._uncorrelated_channels = uncorrelated_channels
        self._max_qval = max_qval
        self._enable_transforms = enable_transforms
        self._rng = np.random.default_rng(seed)

        if normalization_dict is None:
            normalization_dict = compute_normalization_dict(
                self._data_dict,
                self._channel_weights,
                q_val=self._max_qval,
                uint8_data=data_type == "cifar10",
            )

        if upper_clip:
            self._data_dict[0] = [
                np.clip(x, 0, normalization_dict["target0_max"]) for x in self._data_dict[0]
            ]
            self._data_dict[1] = [
                np.clip(x, 0, normalization_dict["target1_max"]) for x in self._data_dict[1]
            ]

        for key in ("mean_input", "std_input", "mean_target", "std_target"):
            if key not in normalization_dict:
                raise KeyError(f"{key} must be provided")

        self._mean_inp = normalization_dict["mean_input"]
        self._std_inp = normalization_dict["std_input"]
        self._mean_target = np.asarray(normalization_dict["mean_target"]).reshape(1, 1, -1)
        self._std_target = np.asarray(normalization_dict["std_target"]).reshape(1, 1, -1)
        self._target0_max = normalization_dict.get("target0_max")
        self._target1_max = normalization_dict.get("target1_max")
        self._input_max = normalization_dict.get("input_max")

    # ------------------------------------------------------------------ stats
    def get_normalization_dict(self):
        return {
            "mean_input": self._mean_inp,
            "std_input": self._std_inp,
            "mean_target": self._mean_target,
            "std_target": self._std_target,
            "target0_max": self._target0_max,
            "target1_max": self._target1_max,
            "input_max": self._input_max,
        }

    def normalize_inp(self, inp):
        return ((inp - self._mean_inp) / self._std_inp).astype(np.float32)

    def normalize_target(self, target):
        return ((target - self._mean_target) / self._std_target).astype(np.float32)

    # --------------------------------------------------------------- indexing
    def frame_shape(self):
        return self._data_dict[0][0].shape[:2]

    def patch_count_per_frame(self):
        h, w = self.frame_shape()
        return (h // self._patch_size) * (w // self._patch_size)

    def __len__(self):
        return self._frameN * self.patch_count_per_frame()

    def frame_idx(self, index):
        return index // self.patch_count_per_frame()

    def patch_location(self, index):
        """(frame_idx, h_start, w_start) for grid patching."""
        fidx = self.frame_idx(index)
        index = index % self.patch_count_per_frame()
        h, w = self.frame_shape()
        h_idx = index // (h // self._patch_size)
        w_idx = index % (w // self._patch_size)
        return fidx, h_idx * self._patch_size, w_idx * self._patch_size

    def _get_location(self, index):
        if self._random_patching:
            fidx = int(self._rng.integers(0, self._frameN))
            h, w = self.frame_shape()
            h_idx = int(self._rng.integers(0, h - self._patch_size)) if h > self._patch_size else 0
            w_idx = int(self._rng.integers(0, w - self._patch_size)) if w > self._patch_size else 0
            return fidx, h_idx, w_idx
        return self.patch_location(index)

    # ------------------------------------------------------------------ items
    def _augment(self, patch1, patch2):
        """Paired horizontal flip with p = 0.5."""
        if self._rng.random() < 0.5:
            patch1 = patch1[:, ::-1].copy()
            patch2 = patch2[:, ::-1].copy()
        return patch1, patch2

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

        if patch1.ndim == 2:  # grayscale -> HWC
            patch1 = patch1[..., None]
            patch2 = patch2[..., None]

        target = np.concatenate([patch1, patch2], axis=-1)
        target = self.normalize_target(target)

        nC = patch1.shape[-1]
        if self._input_from_normalized_target:
            inp = (
                self._channel_weights[0] * target[..., 0:nC]
                + self._channel_weights[1] * target[..., nC: 2 * nC]
            )
        else:
            inp = self._channel_weights[0] * patch1 + self._channel_weights[1] * patch2
            inp = self.normalize_inp(inp)

        if self._target_channel_idx is None:
            return {"input": inp, "target": target}
        c = self._target_channel_idx
        return {"input": inp, "target": target[..., c: c + 1]}
