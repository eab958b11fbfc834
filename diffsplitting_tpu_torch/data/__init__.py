from .loader import NumpyLoader
from .split_dataset import DataLocation, SplitDataset, load_data
from .stitcher import stitch_predictions
from .tiled_dataset import SplitDatasetTiledPred
from .time_predictor_dataset import TimePredictorDataset, compute_input_normalization_dict
from .tiled_infer import extract_tiles, predict_tiled, stitch_tiles, tile_plan
from .tiling import TileIndexManager, TilingMode


def create_dataloader(dataset, dataset_opt, phase):
    """Counterpart: diffsplitting_tpu/data/__init__.py `create_dataloader`.
    Train honours batch_size and use_shuffle; val is batch 1, unshuffled.
    `data_len` (the debug shrink, the train-time val cap) caps the epoch."""
    data_len = dataset_opt.get("data_len") if hasattr(dataset_opt, "get") else None
    if data_len is not None and int(data_len) <= 0:
        data_len = None
    if phase == "train":
        return NumpyLoader(
            dataset,
            batch_size=dataset_opt["batch_size"],
            shuffle=bool(dataset_opt.get("use_shuffle", True)),
            data_len=data_len,
        )
    if phase == "val":
        return NumpyLoader(dataset, batch_size=1, shuffle=False, data_len=data_len)
    raise NotImplementedError(f"Dataloader [{phase}] is not found.")


def create_dataset(dataset_opt, phase):
    """The SR dataset of a config's `datasets.<phase>` section (mode 'LRHR'
    also returns the LR image). Counterpart:
    diffsplitting_tpu/data/__init__.py `create_dataset`."""
    from .lrhr_dataset import LRHRDataset

    return LRHRDataset(
        dataroot=dataset_opt["dataroot"],
        datatype=dataset_opt["datatype"],
        l_resolution=dataset_opt["l_resolution"],
        r_resolution=dataset_opt["r_resolution"],
        split=phase,
        data_len=dataset_opt["data_len"],
        need_LR=(dataset_opt["mode"] == "LRHR"),
    )


__all__ = [
    "DataLocation",
    "NumpyLoader",
    "SplitDataset",
    "SplitDatasetTiledPred",
    "TileIndexManager",
    "TilingMode",
    "TimePredictorDataset",
    "compute_input_normalization_dict",
    "create_dataloader",
    "create_dataset",
    "extract_tiles",
    "load_data",
    "predict_tiled",
    "stitch_predictions",
    "stitch_tiles",
    "tile_plan",
]
