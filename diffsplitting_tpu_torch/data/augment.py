"""Paired numpy augmentations for HWC images.

Counterpart: diffsplitting_tpu/data/augment.py: hflip / vflip / rot90
applied coherently to a list of images, with the coins drawn in the same
order from the same numpy generator.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def augment(
    img_list: List[np.ndarray],
    hflip: bool = True,
    rot: bool = True,
    split: str = "val",
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """Randomly flip/rotate a list of HWC images with shared coin flips."""
    rng = rng or np.random.default_rng()
    do_h = hflip and split == "train" and rng.random() < 0.5
    do_v = rot and split == "train" and rng.random() < 0.5
    do_r = rot and split == "train" and rng.random() < 0.5

    def one(img):
        if do_h:
            img = img[:, ::-1]
        if do_v:
            img = img[::-1]
        if do_r:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    return [one(i) for i in img_list]
