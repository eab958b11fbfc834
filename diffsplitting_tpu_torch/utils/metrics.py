"""Image export and MATLAB-style PSNR/SSIM metrics.

Counterpart: diffsplitting_tpu/utils/metrics.py, copied (OpenCV writes the
PNGs and filters for SSIM, as there):
  * tensor2img: [-1, 1] -> uint8; a 4-D batch becomes a grid of √N images a
    row with 2-pixel borders (torchvision's make_grid geometry).
  * save_img: multi-channel (2/6-channel) outputs are tiled side by side by
    channel group before writing.
  * calculate_psnr on [0,255]; calculate_ssim with the 11x11 sigma=1.5
    gaussian window and the valid-region crop, as MATLAB computes it.

Inputs are channel-last (HWC) numpy arrays.
"""

from __future__ import annotations

import math

import numpy as np


def _to_numpy(t):
    return np.asarray(t)


def _make_grid(batch_hwc: np.ndarray) -> np.ndarray:
    """(N, H, W, C) -> one image of √N tiles a row on zeros, each inset by
    p = 2 pixels: ((H + p)·rows + p, (W + p)·cols + p, C)."""
    padding = 2
    n, h, w, c = batch_hwc.shape
    ncols = min(int(math.sqrt(n)) or 1, n)
    nrows = int(math.ceil(n / ncols))
    hp, wp = h + padding, w + padding
    grid = np.zeros((hp * nrows + padding, wp * ncols + padding, c), dtype=batch_hwc.dtype)
    for i in range(n):
        r, cc = divmod(i, ncols)
        y, x = r * hp + padding, cc * wp + padding
        grid[y: y + h, x: x + w] = batch_hwc[i]
    return grid


def tensor2img(tensor):
    """NHWC / HWC / HW array in [-1, 1] -> HWC (or HW) image in [0, 255]
    uint8."""
    img = np.squeeze(_to_numpy(tensor).astype(np.float32))
    img = (np.clip(img, -1, 1) + 1) / 2
    if img.ndim == 4:
        img = _make_grid(img)
    elif img.ndim not in (2, 3):
        raise TypeError(f"Only 4D/3D/2D supported, got ndim={img.ndim}")
    return (img * 255.0).round().astype(np.uint8)


def save_img(img, img_path, mode="RGB"):
    """Write an image; multi-channel HWC stacks are tiled horizontally.

    img: (H, W, C) with C ∈ {1,3} written directly; C ∈ {2,6,...} splits into
    C//3 (RGB) or C (gray) panels laid out side-by-side.
    """
    import cv2

    img = _to_numpy(img)
    if img.ndim != 3:
        raise ValueError(f"img shape is {img.shape}")
    h, w, c = img.shape
    if c not in (1, 3):
        if mode == "RGB":
            panels = c // 3
            img = img.reshape(h, w, panels, 3)
            img = img.transpose(0, 2, 1, 3).reshape(h, panels * w, 3)
        else:
            img = img.transpose(0, 2, 1).reshape(h, c * w, 1)
    if mode == "RGB":
        cv2.imwrite(img_path, img.astype(np.uint8))
    else:
        cv2.imwrite(img_path, img)


def calculate_psnr(img1, img2):
    """PSNR on [0,255] images."""
    img1 = _to_numpy(img1).astype(np.float64)
    img2 = _to_numpy(img2).astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


_SSIM_WIN = 11
_SSIM_SIGMA = 1.5


def _gaussian_window(size: int = _SSIM_WIN, sigma: float = _SSIM_SIGMA) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM of one 2-D [0,255] plane (11×11 gaussian, σ=1.5,
    valid-region crop)."""
    import cv2

    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)
    win = _gaussian_window()
    half = _SSIM_WIN // 2

    def blur(a):
        return cv2.filter2D(a, -1, win)[half:-half, half:-half]

    mu_x, mu_y = blur(x), blur(y)
    var_x = blur(x * x) - mu_x * mu_x
    var_y = blur(y * y) - mu_y * mu_y
    cov = blur(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    return float((num / den).mean())


def calculate_ssim(img1, img2):
    """MATLAB-compatible SSIM on [0,255] images (HW or HWC, any C).

    Per-channel SSIM averaged over channels (accepts the 2/6-channel
    splitting outputs).
    """
    img1 = _to_numpy(img1)
    img2 = _to_numpy(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        return float(
            np.mean(
                [_ssim_single(img1[..., c], img2[..., c]) for c in range(img1.shape[2])]
            )
        )
    raise ValueError("Wrong input image dimensions.")
