"""Convolutions on NHWC tensors.

The models keep the JAX package's NHWC layout. A contiguous NHWC tensor
permuted to NCHW is a channels_last tensor, which cuDNN convolves without
a layout copy; permuting the channels_last result back gives NHWC again.
"""
from __future__ import annotations

import torch
from torch import nn


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an nn.Conv2d to a (B, H, W, C) tensor, returning (B, H', W', C')."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def conv3x3_hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A 3x3 conv's OIHW weight as the (3, 3, Cin, Cout) kernel that the
    fused conv (ops/fused_conv.py) takes."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()
