"""TIFF stack IO. Counterpart: diffsplitting_tpu/data/io.py. PIL is imported
where it is used, so the package imports on a machine without it."""

from __future__ import annotations

import numpy as np


def load_tiff_stack(path: str) -> np.ndarray:
    """Read a (possibly multi-frame) TIFF into (N, H, W[, C]) numpy."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [np.asarray(frame.copy()) for frame in ImageSequence.Iterator(im)]
    if len(frames) == 1:
        arr = frames[0]
        return arr[None] if arr.ndim == 2 else arr
    return np.stack(frames, axis=0)


def save_tiff_stack(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    frames = [Image.fromarray(a) for a in arr]
    frames[0].save(path, save_all=True, append_images=frames[1:])
