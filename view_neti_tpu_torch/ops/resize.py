"""Exact 2x nearest upsampling on NHWC tensors (view_neti_tpu/ops/resize.py):
diffusers' Upsample2D interpolate(scale_factor=2, mode="nearest")."""
from __future__ import annotations

import torch


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), exact nearest-neighbour."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)
