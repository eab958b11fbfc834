"""Stitch per-tile predictions (numpy) back into full-size frames.

Counterpart: diffsplitting_tpu/data/stitcher.py (`stitch_predictions`):
each tile contributes its central grid region; in ShiftBoundary mode a tile
whose patch touches the data edge extends its contribution to the edge.
Predictions are channel-last (N, *spatial, C); the output is
(*data_shape, C). `data/tiled_infer.py` does the same on the device.
"""

from __future__ import annotations

import numpy as np

from .tiling import TileIndexManager, TilingMode


def stitch_predictions(predictions: np.ndarray, idx_manager: TileIndexManager) -> np.ndarray:
    """predictions: (num_tiles, *patch_spatial, C) -> (*data_shape, C)."""
    mng = idx_manager
    n_channels = predictions.shape[-1]
    output = np.zeros(tuple(mng.data_shape) + (n_channels,), dtype=predictions.dtype)

    grid = np.asarray(mng.grid_shape, dtype=int)
    patch = np.asarray(mng.patch_shape, dtype=int)
    offset = np.asarray(mng.patch_offset(), dtype=int)
    data = np.asarray(mng.data_shape, dtype=int)

    for tile_idx in range(predictions.shape[0]):
        gs = np.asarray(mng.get_location_from_dataset_idx(tile_idx), dtype=int)
        ge = gs + grid
        ps = gs - offset
        pe = ps + patch

        vgs = np.maximum(gs, 0)
        vge = np.minimum(ge, data)
        if not (np.all(vgs == gs) and np.all(vge == ge)):
            raise ValueError(f"tile {tile_idx}'s grid region leaves the data")

        if mng.tiling_mode == TilingMode.ShiftBoundary:
            # edge tiles extend to the data border
            vgs = np.where(ps == 0, 0, vgs)
            vge = np.where(pe == data, data, vge)

        rs = vgs - ps
        re = rs + (vge - vgs)

        dst = tuple(slice(int(a), int(b)) for a, b in zip(vgs, vge))
        # tiles drop trivial leading dims ((1, P, P) patches give (P, P, C)
        # tiles): align the ranks before slicing
        tile = predictions[tile_idx]
        while tile.ndim < len(data) + 1:
            tile = tile[None]
        src = tuple(slice(int(a), int(b)) for a, b in zip(rs, re))
        output[dst] = tile[src]

    return output
