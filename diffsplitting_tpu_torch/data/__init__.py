from .tiled_infer import extract_tiles, predict_tiled, stitch_tiles, tile_plan
from .tiling import TileIndexManager, TilingMode

__all__ = [
    "TileIndexManager",
    "TilingMode",
    "extract_tiles",
    "predict_tiled",
    "stitch_tiles",
    "tile_plan",
]
