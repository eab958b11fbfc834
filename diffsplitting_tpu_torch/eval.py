"""PSNR / SSIM over a results directory of super-resolution PNGs.

Counterpart: the repository's top-level eval.py:

  python -m diffsplitting_tpu_torch.eval -p <results dir>

Pairs `*_hr.png` with `*_sr.png` by sorted order (their prefixes must
match), prints every 20th pair's PSNR and SSIM and the averages, through
`utils/metrics.py` on the host (uint8 images read by PIL). No device is used.
"""

from __future__ import annotations

import argparse
import glob
from typing import Optional

import numpy as np
from PIL import Image

from .utils.metrics import calculate_psnr, calculate_ssim


def main(argv: Optional[list] = None) -> dict:
    """Runs the CLI; returns {'psnr', 'ssim'} (the averages, None when the
    directory holds no pair) and 'n' (the pairs)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", type=str, default="experiments/results")
    args = parser.parse_args(argv)

    real_names = sorted(glob.glob(f"{args.path}/*_hr.png"))
    fake_names = sorted(glob.glob(f"{args.path}/*_sr.png"))

    avg_psnr, avg_ssim, idx = 0.0, 0.0, 0
    for rname, fname in zip(real_names, fake_names):
        idx += 1
        ridx = rname.rsplit("_hr", 1)[0]
        fidx = fname.rsplit("_sr", 1)[0]
        if ridx != fidx:
            raise ValueError(f"Image ridx:{ridx}!=fidx:{fidx}")
        hr_img = np.array(Image.open(rname))
        sr_img = np.array(Image.open(fname))
        psnr = calculate_psnr(sr_img, hr_img)
        ssim = calculate_ssim(sr_img, hr_img)
        avg_psnr += psnr
        avg_ssim += ssim
        if idx % 20 == 0:
            print(f"Image:{idx}, PSNR:{psnr:.4f}, SSIM:{ssim:.4f}")

    if not idx:
        return {"psnr": None, "ssim": None, "n": 0}
    print("# Validation # PSNR: {:.4e}".format(avg_psnr / idx))
    print("# Validation # SSIM: {:.4e}".format(avg_ssim / idx))
    return {"psnr": avg_psnr / idx, "ssim": avg_ssim / idx, "n": idx}


if __name__ == "__main__":
    main()
