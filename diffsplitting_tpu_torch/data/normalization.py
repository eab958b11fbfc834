"""Quantile-max normalization statistics.

Counterpart: diffsplitting_tpu/data/split_dataset.py `compute_normalization_dict`.
"""

from __future__ import annotations

import numpy as np


def compute_normalization_dict(data_dict, channel_weights, q_val=1.0, uint8_data=False):
    """x -> (x - max/2)/(max/2) ∈ [-1, 1] statistics per target channel and
    for the weighted-sum input."""
    if uint8_data:
        tar_max = 255.0
        inp_max = tar_max * float(np.sum(channel_weights))
        img_shape = data_dict[0][0].shape
        nC = 1 if len(img_shape) == 2 else img_shape[-1]  # HWC
        return {
            "mean_input": inp_max / 2,
            "std_input": inp_max / 2,
            "mean_target": np.array([tar_max / 2] * nC + [tar_max / 2] * nC),
            "std_target": np.array([tar_max / 2] * nC + [tar_max / 2] * nC),
            "target0_max": tar_max,
            "target1_max": tar_max,
            "input_max": inp_max,
        }

    tar1 = np.concatenate([np.asarray(x).reshape(-1) for x in data_dict[0]])
    tar2 = np.concatenate([np.asarray(x).reshape(-1) for x in data_dict[1]])
    tar1_max = np.quantile(tar1, q_val)
    tar2_max = np.quantile(tar2, q_val)
    inp_max = np.quantile(tar1 * channel_weights[0] + tar2 * channel_weights[1], q_val)
    return {
        "mean_input": inp_max / 2,
        "std_input": inp_max / 2,
        "mean_target": np.array([tar1_max / 2, tar2_max / 2]),
        "std_target": np.array([tar1_max / 2, tar2_max / 2]),
        "target0_max": tar1_max,
        "target1_max": tar2_max,
        "input_max": inp_max,
    }
