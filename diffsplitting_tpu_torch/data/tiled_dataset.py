"""SplitDataset over the tiles of full frames, for tiled prediction.

Counterpart: diffsplitting_tpu/data/tiled_dataset.py
(`SplitDatasetTiledPred`): a TileIndexManager with grid = patch/2
(ShiftBoundary) places the patches; `__len__` is the tile count.
"""

from __future__ import annotations

from .split_dataset import SplitDataset
from .tiling import TileIndexManager, TilingMode


class SplitDatasetTiledPred(SplitDataset):
    def __init__(self, *args, grid_size=None, **kwargs):
        super().__init__(*args, **kwargs)
        if grid_size is None:
            grid_size = self._patch_size // 2
        H, W = self.frame_shape()
        self.tile_manager = TileIndexManager(
            data_shape=(self._frameN, H, W),
            grid_shape=(1, grid_size, grid_size),
            patch_shape=(1, self._patch_size, self._patch_size),
            tiling_mode=TilingMode.ShiftBoundary,
        )

    def __len__(self):
        return self.tile_manager.total_grid_count()

    def patch_location(self, index):
        f, h, w = self.tile_manager.get_patch_location_from_dataset_idx(index)
        return f, h, w
