"""N-D overlapping-tile index arithmetic for tiled prediction.

Counterpart: diffsplitting_tpu/data/tiling.py (TileIndexManager, TilingMode),
copied so the port imports nothing of the JAX package. Per dimension d with
grid g, patch p and data n:
  * trivial dims (g == p == 1) tile every coordinate;
  * PadBoundary: ceil(n/g) grids, grid k starts at k*g;
  * TrimBoundary: floor((n-(p-g))/g) grids, grid k starts at k*g + (p-g)/2;
  * ShiftBoundary: ceil((n-(p-g))/g) grids; the LAST grid is shifted inward so
    its patch exactly touches the data boundary: start = n - g - (p-g)/2.
Dataset index <-> grid coordinates use row-major ordering with stride(d) =
prod over later dims of their grid counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


class TilingMode:
    TrimBoundary = 0
    PadBoundary = 1
    ShiftBoundary = 2


@dataclass
class TileIndexManager:
    data_shape: tuple
    grid_shape: tuple
    patch_shape: tuple
    tiling_mode: int = TilingMode.ShiftBoundary

    def __post_init__(self):
        nd = len(self.data_shape)
        assert len(self.grid_shape) == nd and len(self.patch_shape) == nd, (
            f"data {self.data_shape}, grid {self.grid_shape}, patch {self.patch_shape} "
            "must share rank"
        )
        excess = np.array(self.patch_shape) - np.array(self.grid_shape)
        if np.any(excess < 0):
            raise ValueError(f"patch {self.patch_shape} must cover grid {self.grid_shape}")
        if np.any(excess % 2 != 0):
            raise ValueError(f"patch-grid excess must be even, got {excess}")
        self._excess = excess
        self._grid_counts = np.array(
            [self._dim_grid_count(d) for d in range(nd)], dtype=np.int64
        )
        # row-major strides: stride[d] = prod(grid_counts[d+1:])
        self._strides = np.ones(nd, dtype=np.int64)
        for d in range(nd - 2, -1, -1):
            self._strides[d] = self._strides[d + 1] * self._grid_counts[d + 1]

    # -------------------------------------------------------------- counts
    def patch_offset(self):
        return self._excess // 2

    def _trivial(self, dim) -> bool:
        return self.grid_shape[dim] == 1 and self.patch_shape[dim] == 1

    def _dim_grid_count(self, dim: int) -> int:
        n, g = self.data_shape[dim], self.grid_shape[dim]
        if self._trivial(dim):
            return n
        excess = self.patch_shape[dim] - g
        if self.tiling_mode == TilingMode.PadBoundary:
            return int(np.ceil(n / g))
        if self.tiling_mode == TilingMode.ShiftBoundary:
            return int(np.ceil((n - excess) / g))
        return int(np.floor((n - excess) / g))

    def get_individual_dim_grid_count(self, dim: int) -> int:
        return int(self._grid_counts[dim])

    def grid_count(self, dim: int) -> int:
        """Stride of `dim` in the flat dataset index (reference naming)."""
        return int(self._strides[dim])

    def total_grid_count(self) -> int:
        return int(self._grid_counts.prod())

    # ------------------------------------------------------- coord <-> index
    def get_grid_index(self, dim: int, coordinate: int) -> int:
        """Grid index owning `coordinate` along `dim`."""
        assert 0 <= coordinate < self.data_shape[dim], (
            f"coordinate {coordinate} out of bounds for {self.data_shape}"
        )
        g = self.grid_shape[dim]
        if self._trivial(dim):
            return coordinate
        if self.tiling_mode == TilingMode.PadBoundary:
            return int(coordinate // g)
        half_excess = (self.patch_shape[dim] - g) // 2
        if self.tiling_mode == TilingMode.ShiftBoundary:
            # the shifted last grid starts at n - g - half_excess
            if coordinate + g + half_excess == self.data_shape[dim]:
                return self.get_individual_dim_grid_count(dim) - 1
        return max(0, int(np.floor((coordinate - half_excess) / g)))

    def get_gridstart_location_from_dim_index(self, dim: int, dim_index: int) -> int:
        assert 0 <= dim_index < self.get_individual_dim_grid_count(dim), (
            f"dim index {dim_index} out of bounds along {dim}"
        )
        g = self.grid_shape[dim]
        if self._trivial(dim):
            return dim_index
        if self.tiling_mode == TilingMode.PadBoundary:
            return dim_index * g
        half_excess = (self.patch_shape[dim] - g) // 2
        if (
            self.tiling_mode == TilingMode.ShiftBoundary
            and dim_index == self.get_individual_dim_grid_count(dim) - 1
        ):
            # boundary grid shifted so the patch covers the data edge exactly
            return self.data_shape[dim] - g - half_excess
        return dim_index * g + half_excess

    def dataset_idx_from_grid_idx(self, grid_idx: tuple) -> int:
        assert len(grid_idx) == len(self.data_shape)
        return int(np.dot(np.asarray(grid_idx, dtype=np.int64), self._strides))

    def get_dataset_idx_from_grid_location(self, location: tuple) -> int:
        grid_idx = tuple(self.get_grid_index(d, location[d]) for d in range(len(location)))
        return self.dataset_idx_from_grid_idx(grid_idx)

    def grid_idx_from_dataset_idx(self, dataset_idx: int) -> Tuple[int, ...]:
        out = []
        for d in range(len(self.data_shape)):
            out.append(int(dataset_idx // self._strides[d]))
            dataset_idx = int(dataset_idx % self._strides[d])
        return tuple(out)

    def get_location_from_dataset_idx(self, dataset_idx: int) -> Tuple[int, ...]:
        """Grid-start coordinates of the tile `dataset_idx`."""
        gidx = self.grid_idx_from_dataset_idx(dataset_idx)
        return tuple(
            self.get_gridstart_location_from_dim_index(d, gidx[d])
            for d in range(len(self.data_shape))
        )

    def get_patch_location_from_dataset_idx(self, dataset_idx: int) -> Tuple[int, ...]:
        """Patch-start (may be negative at the data boundary)."""
        loc = np.array(self.get_location_from_dataset_idx(dataset_idx))
        return tuple(loc - self.patch_offset())

    # ------------------------------------------------------------- boundaries
    def on_boundary(self, dataset_idx: int, dim: int, only_end: bool = False) -> bool:
        if dim > 0:
            dataset_idx = dataset_idx % self._strides[dim - 1]
        dim_index = dataset_idx // self._strides[dim]
        last = self.get_individual_dim_grid_count(dim) - 1
        if only_end:
            return dim_index == last
        return dim_index == 0 or dim_index == last

    def next_grid_along_dim(self, dataset_idx: int, dim: int) -> Optional[int]:
        new_idx = dataset_idx + self.grid_count(dim)
        return None if new_idx >= self.total_grid_count() else new_idx

    def prev_grid_along_dim(self, dataset_idx: int, dim: int) -> Optional[int]:
        new_idx = dataset_idx - self.grid_count(dim)
        return None if new_idx < 0 else new_idx
