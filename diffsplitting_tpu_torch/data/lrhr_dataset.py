"""LR/HR super-resolution dataset (PNG dirs or LMDB), HWC in [-1, 1].

Counterpart: diffsplitting_tpu/data/lrhr_dataset.py, copied so the port
imports nothing of the JAX package: the PNG layout
`<root>/{lr_L, hr_R, sr_L_R}/` or an LMDB keyed `hr_{res}_{idx:05d}` etc.;
samples are {'HR', 'SR'[, 'LR'], 'Index'} as float32 numpy in [-1, 1]
(PIL reads the images); training flips LR/SR/HR together, horizontally, with
probability 1/2, from `np.random.default_rng(seed)` as JAX does.

`lmdb` is imported only when the datatype asks for it.
"""

from __future__ import annotations

import os
import random
from io import BytesIO

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".JPG", ".JPEG", ".PNG")


def get_paths_from_images(path: str):
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if fname.endswith(IMG_EXTENSIONS):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return sorted(images)


def _to_unit(img) -> np.ndarray:
    """PIL -> HWC float32 in [0,1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class LRHRDataset:
    def __init__(
        self,
        dataroot,
        datatype,
        l_resolution=16,
        r_resolution=128,
        split="train",
        data_len=-1,
        need_LR=False,
        seed=0,
    ):
        self.datatype = datatype
        self.l_res = l_resolution
        self.r_res = r_resolution
        self.data_len = data_len
        self.need_LR = need_LR
        self.split = split
        self._rng = np.random.default_rng(seed)

        if datatype == "lmdb":
            import lmdb  # optional dependency

            self.env = lmdb.open(
                dataroot, readonly=True, lock=False, readahead=False, meminit=False
            )
            with self.env.begin(write=False) as txn:
                self.dataset_len = int(txn.get("length".encode("utf-8")))
        elif datatype == "img":
            self.sr_path = get_paths_from_images(
                f"{dataroot}/sr_{l_resolution}_{r_resolution}"
            )
            self.hr_path = get_paths_from_images(f"{dataroot}/hr_{r_resolution}")
            if self.need_LR:
                self.lr_path = get_paths_from_images(f"{dataroot}/lr_{l_resolution}")
            self.dataset_len = len(self.hr_path)
        else:
            raise NotImplementedError(f"data_type [{datatype}] is not recognized.")

        if self.data_len <= 0:
            self.data_len = self.dataset_len
        else:
            self.data_len = min(self.data_len, self.dataset_len)

    def __len__(self):
        return self.data_len

    def _read_lmdb(self, index):
        from PIL import Image

        with self.env.begin(write=False) as txn:
            def get(key):
                return txn.get(key.encode("utf-8"))

            hr = get(f"hr_{self.r_res}_{str(index).zfill(5)}")
            sr = get(f"sr_{self.l_res}_{self.r_res}_{str(index).zfill(5)}")
            lr = get(f"lr_{self.l_res}_{str(index).zfill(5)}") if self.need_LR else None
            while hr is None or sr is None:
                index = random.randint(0, self.data_len - 1)
                hr = get(f"hr_{self.r_res}_{str(index).zfill(5)}")
                sr = get(f"sr_{self.l_res}_{self.r_res}_{str(index).zfill(5)}")
                if self.need_LR:
                    lr = get(f"lr_{self.l_res}_{str(index).zfill(5)}")
            img_HR = Image.open(BytesIO(hr)).convert("RGB")
            img_SR = Image.open(BytesIO(sr)).convert("RGB")
            img_LR = Image.open(BytesIO(lr)).convert("RGB") if self.need_LR else None
        return img_HR, img_SR, img_LR

    def __getitem__(self, index):
        from PIL import Image

        if self.datatype == "lmdb":
            img_HR, img_SR, img_LR = self._read_lmdb(index)
        else:
            img_HR = Image.open(self.hr_path[index]).convert("RGB")
            img_SR = Image.open(self.sr_path[index]).convert("RGB")
            img_LR = Image.open(self.lr_path[index]).convert("RGB") if self.need_LR else None

        imgs = [_to_unit(i) for i in ([img_LR] if self.need_LR else []) + [img_SR, img_HR]]
        if self.split == "train" and self._rng.random() < 0.5:
            imgs = [im[:, ::-1].copy() for im in imgs]
        imgs = [im * 2.0 - 1.0 for im in imgs]  # [-1, 1]

        if self.need_LR:
            lr, sr, hr = imgs
            return {"LR": lr, "HR": hr, "SR": sr, "Index": np.int64(index)}
        sr, hr = imgs
        return {"HR": hr, "SR": sr, "Index": np.int64(index)}
