"""Image quality metrics: masked MSE and PSNR, SSIM and LPIPS (VGG16)
(view_neti_tpu/ops/metrics.py).

The reference's DTU protocol: metrics at 300x400 on object-masked images,
PSNR = -10 / ln(10) * ln(masked MSE), SSIM with skimage's defaults (a
uniform 7x7 window, data range 1, the sample covariance), LPIPS on a VGG16
backbone. Tensors are NHWC in [0, 1] (LPIPS: [-1, 1]) on any device; the
JAX package computes these outside any Pallas kernel, and so does the
port: plain torch ops.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from view_neti_tpu_torch.utils.device import resolve_device


def masked_mse(pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked pixels: pred, gt (..., H, W, C) in [0, 1], mask
    broadcastable and binary."""
    mask = mask.float()
    num = torch.sum((pred - gt) ** 2 * mask, dim=(-3, -2, -1))
    den = torch.clamp(torch.sum(mask * torch.ones_like(pred),
                                dim=(-3, -2, -1)), min=1.0)
    return num / den


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """-10 / ln(10) * ln(mse), the reference's masked PSNR."""
    return -10.0 / math.log(10.0) * torch.log(torch.clamp(mse, min=1e-12))


def masked_psnr(pred, gt, mask) -> torch.Tensor:
    return psnr_from_mse(masked_mse(pred, gt, mask))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Mean SSIM of (..., H, W, C) images over the valid (unpadded) region:
    skimage's uniform filter as two VALID box passes (a mean over win_size
    rows, then over win_size columns), K1 0.01, K2 0.03 and the N / (N - 1)
    covariance normalisation. A (H, W, C) input gives a scalar."""
    a, b = a.float(), b.float()
    squeeze = a.dim() == 3
    if squeeze:
        a, b = a[None], b[None]
    lead = a.shape[:-3]
    a = a.reshape((-1,) + tuple(a.shape[-3:]))
    b = b.reshape((-1,) + tuple(b.shape[-3:]))
    nd = win_size * win_size
    cov_norm = nd / (nd - 1)

    def box(x):
        # (B, H, W, C) -> (B, C, H, W): pooling is per channel, and a mean
        # pool never runs through TF32
        y = x.permute(0, 3, 1, 2)
        y = F.avg_pool2d(y, (win_size, 1), stride=1)
        return F.avg_pool2d(y, (1, win_size), stride=1)

    ux, uy = box(a), box(b)
    uxx, uyy, uxy = box(a * a), box(b * b), box(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    out = s.mean(dim=(1, 2, 3)).reshape(lead)
    return out[0] if squeeze else out


# --------------------------------------------------------------------------
# LPIPS (VGG16 backbone and linear heads)
# --------------------------------------------------------------------------

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# the feature taps: after the ReLU of these convolutions (relu1_2 ...
# relu5_3)
LPIPS_TAPS = (1, 3, 6, 9, 12)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 conv tower (conv0 ... conv12), NHWC in, the five LPIPS
    feature taps out (NCHW)."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, c in enumerate(s for s in VGG16_CFG if s != "M"):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, c, 3, padding=1))
            c_in = c

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        taps, i = [], 0
        for spec in VGG16_CFG:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in LPIPS_TAPS:
                taps.append(x)
            i += 1
        return taps


class LPIPS(nn.Module):
    """The LPIPS distance of two NHWC batches in [-1, 1]: VGG16 features,
    unit-normalised per pixel (x / (||x|| + 1e-10), the lpips package's
    normalize_tensor), squared differences weighted per channel (lin0 ...
    lin4) and averaged over the pixels, summed over the five taps. The
    convolutions run in fp32 (no TF32), as the metric's definition."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        widths = [c for c in VGG16_CFG if c != "M"]
        for i, c in enumerate(widths[t] for t in LPIPS_TAPS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE),
                             persistent=False)

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            fa = self.vgg((a.float() - self.shift) / self.scale)
            fb = self.vgg((b.float() - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.sqrt(torch.sum(xa ** 2, dim=1, keepdim=True))
                       + 1e-10)
            nb = xb / (torch.sqrt(torch.sum(xb ** 2, dim=1, keepdim=True))
                       + 1e-10)
            w = getattr(self, f"lin{i}")
            d = torch.sum((na - nb) ** 2 * w[None, :, None, None], dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def make_lpips(weights_path: Optional[str] = None, seed: int = 0,
               device=None) -> LPIPS:
    """The LPIPS module on `device` (None: the card). weights_path: an .npz
    in the JAX package's export format (weight_port.load_lpips_npz); None
    draws the VGG weights from a generator seeded with `seed` (He-normal
    kernels, zero biases, unit heads), good for relative comparisons
    only."""
    model = LPIPS()
    if weights_path is not None:
        from view_neti_tpu_torch.weight_port import load_lpips_npz
        model.load_state_dict(load_lpips_npz(weights_path), strict=True)
    else:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in model.vgg.children():
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
                m.bias.zero_()
    return model.to(resolve_device(device)).eval().requires_grad_(False)
