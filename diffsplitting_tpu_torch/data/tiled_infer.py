"""Tiled prediction on the device: tile extraction, batched inference, stitch.

Counterpart: diffsplitting_tpu/data/tiled_infer.py. The plan (per-tile patch
starts and owned regions) is computed on the host with numpy; extraction is
one gather on the device, and the stitch writes each tile's owned region
[lo, hi) (its central grid region, extended to the frame border for edge
tiles, ShiftBoundary semantics) into the canvas in plan order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .tiling import TileIndexManager, TilingMode


def tile_plan(mng: TileIndexManager) -> dict:
    """Per-tile coordinates for a (F, H, W) tile manager: arrays of shape
    (n_tiles, 3) holding patch starts `ps` and the owned region [lo, hi)
    relative to the patch start."""
    n = mng.total_grid_count()
    grid = np.asarray(mng.grid_shape, dtype=np.int64)
    patch = np.asarray(mng.patch_shape, dtype=np.int64)
    offset = np.asarray(mng.patch_offset(), dtype=np.int64)
    data = np.asarray(mng.data_shape, dtype=np.int64)

    ps_list, lo_list, hi_list = [], [], []
    for i in range(n):
        gs = np.asarray(mng.get_location_from_dataset_idx(i), dtype=np.int64)
        ps = gs - offset
        pe = ps + patch
        vgs, vge = gs.copy(), gs + grid
        if mng.tiling_mode == TilingMode.ShiftBoundary:
            vgs = np.where(ps == 0, 0, vgs)
            vge = np.where(pe == data, data, vge)
        ps_list.append(ps)
        lo_list.append(vgs - ps)
        hi_list.append(vge - ps)
    return {
        "ps": np.stack(ps_list),
        "lo": np.stack(lo_list),
        "hi": np.stack(hi_list),
        "patch": tuple(int(p) for p in patch),
        "data_shape": tuple(int(d) for d in data),
    }


def extract_tiles(frames: torch.Tensor, plan: dict) -> torch.Tensor:
    """(F, H, W, C) -> (n_tiles, pH, pW, C), one gather on frames' device."""
    pF, pH, pW = plan["patch"]
    if pF != 1:
        raise ValueError("one frame per tile")
    ps = torch.as_tensor(plan["ps"], device=frames.device)
    rows = ps[:, 1, None] + torch.arange(pH, device=frames.device)  # (n, pH)
    cols = ps[:, 2, None] + torch.arange(pW, device=frames.device)  # (n, pW)
    return frames[ps[:, 0, None, None], rows[:, :, None], cols[:, None, :]]


def stitch_tiles(tiles: torch.Tensor, plan: dict) -> torch.Tensor:
    """(n_tiles, pH, pW, C) -> (F, H, W, C): each tile writes the region it
    owns, in plan order."""
    F, H, W = plan["data_shape"]
    canvas = torch.zeros((F, H, W, tiles.shape[-1]), dtype=tiles.dtype, device=tiles.device)
    for tile, (f, y, x), (_, ly, lx), (_, hy, hx) in zip(
            tiles, plan["ps"].tolist(), plan["lo"].tolist(), plan["hi"].tolist()):
        canvas[f, y + ly:y + hy, x + lx:x + hx] = tile[ly:hy, lx:hx]
    return canvas


def predict_tiled(infer_fn: Callable[[torch.Tensor], torch.Tensor], frames: torch.Tensor,
                  mng: TileIndexManager, batch_size: int = 8) -> torch.Tensor:
    """Extract tiles -> infer_fn over batches -> stitch, all on frames' device.

    infer_fn: (B, pH, pW, Cin) -> (B, pH, pW, Cout). The last batch is padded
    by repeating the last tile. Returns the stitched (F, H, W, Cout) canvas."""
    plan = tile_plan(mng)
    tiles = extract_tiles(frames, plan)
    n = tiles.shape[0]
    pad = (-n) % batch_size
    if pad:
        tiles = torch.cat([tiles, tiles[-1:].expand(pad, *tiles.shape[1:])], dim=0)
    preds = torch.cat([infer_fn(tiles[i:i + batch_size])
                       for i in range(0, n + pad, batch_size)], dim=0)[:n]
    return stitch_tiles(preds, plan)
