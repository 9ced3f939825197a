"""GroupNorm and LayerNorm with fp32 statistics, on NHWC tensors.

The port's counterpart of view_neti_tpu/ops/norm.py. Statistics are fp32
whatever the compute dtype, with the same one-pass variance
max(E[x^2] - E[x]^2, 0), and `fold=True` returns the per-(B, C) affine
(a, b) with normalize(x) == x*a + b that the fused conv kernel
(ops/fused_conv.py) consumes. Parameters stay fp32 (`weight`, `bias`, the
diffusers key names); the output takes the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def group_norm_fold(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float):
    """(B, ..., C) -> per-(B, C) fp32 (a, b) with normalize(x) = x*a + b."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    x32 = x.reshape(B, -1, G, C // G).float()
    mean = x32.mean(dim=(1, 3), keepdim=True)
    mean2 = x32.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps) * weight.float().reshape(1, 1, G, C // G)
    b = bias.float().reshape(1, 1, G, C // G) - mean * a
    return a.reshape(B, C), b.reshape(B, C)


class GroupNorm(nn.Module):
    """GroupNorm over the last (channel) axis of an NHWC tensor."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, fold: bool = False):
        a, b = group_norm_fold(x, self.num_groups, self.weight, self.bias,
                               self.eps)
        if fold:
            return a, b
        B, C = x.shape[0], x.shape[-1]
        y = x.reshape(B, -1, C).float() * a[:, None, :] + b[:, None, :]
        return y.reshape(x.shape).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and statistics, output in the input's
    dtype (flax nn.LayerNorm(dtype=compute) semantics)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)
