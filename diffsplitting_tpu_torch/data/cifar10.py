"""CIFAR-10 pickle loading for the synthetic splitting task.

Counterpart: diffsplitting_tpu/data/cifar10.py. Each pickle batch holds
b'data' (N, 3072) uint8 and b'labels'; the splitting task puts two label
classes (`split_dataset.CIFAR_SPLIT_LABELS`) into a channel dict. Images are
HWC, as JAX returns them.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, List

import numpy as np


def unpickle(file):
    with open(file, "rb") as fo:
        return pickle.load(fo, encoding="bytes")


def load_cifar10_file(fpath: str):
    data = unpickle(fpath)
    imgs = data[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # HWC
    labels = np.array(data[b"labels"])
    return imgs, labels


def load_train_val_data(datadir: str, label_idx_list: List[int]) -> Dict[int, np.ndarray]:
    """Channel dict {0: images of the first class, 1: of the second, ...}
    (HWC uint8), over every pickle in `datadir` in name order."""
    fpaths = [os.path.join(datadir, f) for f in sorted(os.listdir(datadir))]
    data = defaultdict(list)
    for fpath in fpaths:
        imgs, labels = load_cifar10_file(fpath)
        for i, label in enumerate(label_idx_list):
            idx = np.where(labels == label)[0]
            data[i].append(imgs[idx])
    return {i: np.concatenate(data[i], axis=0) for i in range(len(label_idx_list))}
