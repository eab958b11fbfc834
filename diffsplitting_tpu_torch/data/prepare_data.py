"""Offline SR dataset preparation: LR / HR / bicubic-SR triplets.

Counterpart: diffsplitting_tpu/data/prepare_data.py, copied so the port
imports nothing of the JAX package. Each source image is resized (shorter
side) and center-cropped to l_res and to r_res with PIL's bicubic filter, the
LR upsampled back to r_res bicubically, and the three written to
`lr_<l>/`, `hr_<r>/`, `sr_<l>_<r>/` PNG dirs (or an LMDB keyed
`lr_{l}_{idx:05d}` / `hr_{r}_{idx:05d}` / `sr_{l}_{r}_{idx:05d}` plus
'length'), through a pool of `n_worker` spawned processes.

    python -m diffsplitting_tpu_torch.data.prepare_data --path <images> --out <root> \
        [--size 16,128] [--n_worker 4] [--lmdb]
"""

from __future__ import annotations

import argparse
import contextlib
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from io import BytesIO
from pathlib import Path


def _resize_and_center_crop(img, size, resample):
    from PIL import Image

    if img.size[0] != size:
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), resample)
        w, h = img.size
        left = (w - size) // 2
        top = (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return img


def _png_bytes(img) -> bytes:
    buf = BytesIO()
    img.save(buf, format="png")
    return buf.getvalue()


def process_one(args):
    fpath, out_path, sizes, lmdb_save = args
    from PIL import Image

    img = Image.open(fpath).convert("RGB")
    lr = _resize_and_center_crop(img, sizes[0], Image.BICUBIC)
    hr = _resize_and_center_crop(img, sizes[1], Image.BICUBIC)
    sr = lr.resize((sizes[1], sizes[1]), Image.BICUBIC)

    stem = Path(fpath).stem.zfill(5)
    if lmdb_save:
        return stem, _png_bytes(lr), _png_bytes(hr), _png_bytes(sr)
    lr.save(f"{out_path}/lr_{sizes[0]}/{stem}.png")
    hr.save(f"{out_path}/hr_{sizes[1]}/{stem}.png")
    sr.save(f"{out_path}/sr_{sizes[0]}_{sizes[1]}/{stem}.png")
    return stem, None, None, None


def prepare(img_path, out_path, n_worker=4, sizes=(16, 128), lmdb_save=False):
    files = sorted(
        str(p) for p in Path(img_path).iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp", ".ppm")
    )
    os.makedirs(out_path, exist_ok=True)
    env = None
    if lmdb_save:
        import lmdb  # optional

        env = lmdb.open(out_path, map_size=1024**4, readahead=False)
    else:
        os.makedirs(f"{out_path}/lr_{sizes[0]}", exist_ok=True)
        os.makedirs(f"{out_path}/hr_{sizes[1]}", exist_ok=True)
        os.makedirs(f"{out_path}/sr_{sizes[0]}_{sizes[1]}", exist_ok=True)

    jobs = [(f, out_path, sizes, lmdb_save) for f in files]
    total = 0
    # spawned workers: a forked child of a process with threads can deadlock
    with (ProcessPoolExecutor(max_workers=n_worker, mp_context=mp.get_context("spawn"))
          if n_worker > 1 else contextlib.nullcontext()) as pool:
        results = pool.map(process_one, jobs) if pool is not None else map(process_one, jobs)
        for stem, lr_b, hr_b, sr_b in results:
            total += 1
            if lmdb_save:
                with env.begin(write=True) as txn:
                    txn.put(f"lr_{sizes[0]}_{stem}".encode(), lr_b)
                    txn.put(f"hr_{sizes[1]}_{stem}".encode(), hr_b)
                    txn.put(f"sr_{sizes[0]}_{sizes[1]}_{stem}".encode(), sr_b)
                    txn.put(b"length", str(total).encode())
    return total


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", "-p", type=str, required=True)
    parser.add_argument("--out", "-o", type=str, required=True)
    parser.add_argument("--size", type=str, default="16,128")
    parser.add_argument("--n_worker", type=int, default=4)
    parser.add_argument("--lmdb", action="store_true")
    args = parser.parse_args(argv)
    sizes = tuple(int(s) for s in args.size.split(","))
    out = args.out + (f"_{sizes[0]}_{sizes[1]}" if not args.out.endswith(str(sizes[1])) else "")
    n = prepare(args.path, out, n_worker=args.n_worker, sizes=sizes, lmdb_save=args.lmdb)
    print(f"prepared {n} images -> {out}")


if __name__ == "__main__":
    main()
