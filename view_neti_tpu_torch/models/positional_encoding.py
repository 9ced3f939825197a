"""Positional encodings for the NeTI mappers
(view_neti_tpu/models/positional_encoding.py).

The frequency matrices are fixed data. JAX draws them with threefry and
PyTorch with Philox, so the two packages never draw the same matrix from
one seed: parity runs carry the JAX matrix across as data
(weight_port.from_jax_mapper).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def make_fourier_freqs(seed: int, dim: int, sigmas: Sequence[float],
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Random Fourier frequency matrix (dim // 2, len(sigmas)); column i is
    N(0, sigmas[i]^2)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((dim // 2, len(sigmas)), generator=g)
    return (w * torch.tensor(sigmas, dtype=torch.float32)[None, :]).to(device)


def fourier_encode(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[sin(x wᵀ); cos(x wᵀ)] feature map. w: (dim//2, nfeats); x: (B,
    nfeats) in [-1, 1]. Returns (B, dim)."""
    if x.dim() == 1:
        x = x[:, None]
    proj = x @ w.T
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def make_neti_freqs(seed: int, sigma_t: float, sigma_l: float,
                    num_w: int = 1024,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Legacy NeTI (t, l) frequency matrix, (num_w, 2)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((num_w, 2), generator=g)
    return (w * torch.tensor([sigma_t, sigma_l])[None, :]).to(device)


def neti_encode(w: torch.Tensor, t: torch.Tensor, l: torch.Tensor
                ) -> torch.Tensor:
    """Legacy NeTI encoding of raw (t, l): unit-norm [sin; cos] features,
    (B, 2 * num_w)."""
    x = torch.stack([t, l], dim=-1).float()
    proj = x @ w.T
    v = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def neti_init_layer(w: torch.Tensor, num_time_anchors: int, num_layers: int
                    ) -> torch.Tensor:
    """Anchor-based init of the legacy input projection: one encoded anchor
    per (t_anchor, l_anchor) pair, (num_time_anchors * num_layers,
    2 * num_w)."""
    t_anchors = np.arange(0, 1000, 1000 // num_time_anchors)
    ts = torch.tensor([float(t) for t in t_anchors for _ in range(num_layers)],
                      device=w.device)
    ls = torch.tensor([float(l) for _ in t_anchors for l in range(num_layers)],
                      device=w.device)
    return neti_encode(w, ts, ls)


def basic_encode(t: torch.Tensor, l: torch.Tensor,
                 num_denoising_timesteps: int = 1000,
                 num_unet_layers: int = 16) -> torch.Tensor:
    """Scale raw (t, l) to [-1, 1], (B, 2)."""
    tn = t.float() / (num_denoising_timesteps - 1) * 2 - 1
    ln = l.float() / (num_unet_layers - 1) * 2 - 1
    return torch.stack([tn, ln], dim=-1)
