"""Image grids on numpy arrays (view_neti_tpu/utils/vis.py), without PIL:
images are (H, W, C) arrays, resized through data/image_io."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from view_neti_tpu_torch.data import image_io


def get_image_grid(images: Sequence[np.ndarray],
                   cols: Optional[int] = None) -> np.ndarray:
    """Tile (H, W, 3) uint8 images row-major into one image, each in a
    cell of the largest height and width, black elsewhere."""
    n = len(images)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    return grid


def downsample_image(img: np.ndarray, factor: float) -> np.ndarray:
    """img (H, W, 3) uint8 scaled by factor (antialiased bilinear)."""
    return image_io.resize_pil(img, max(1, int(img.shape[1] * factor)),
                               max(1, int(img.shape[0] * factor)),
                               mode="bilinear")


def make_grid_np(imgs: np.ndarray, nrow: int, padding: int = 2,
                 pad_value: float = 0.0) -> np.ndarray:
    """torchvision.utils.make_grid for NHWC arrays: (N, H, W, C) ->
    (H_grid, W_grid, C) with `nrow` images per row."""
    n, h, w, c = imgs.shape
    ncol = int(np.ceil(n / nrow))
    H = ncol * (h + padding) + padding
    W = nrow * (w + padding) + padding
    grid = np.full((H, W, c), pad_value, imgs.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = imgs[i]
    return grid


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """float [0, 1] (clipped) or uint8 (H, W, C) -> uint8."""
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
