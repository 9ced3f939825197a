"""Training augmentation on the card, inside the train step
(view_neti_tpu/ops/device_augment.py).

The host decodes and resizes each image once (uint8 bases, data/dataset.py);
the step turns a batch of bases into the network's input: [-1, 1]
normalisation, ColorJitter, RandomGrayscale, GaussianBlur and one fused
warp for RandomRotation, RandomResizedCrop and the horizontal flip.

The port computes the JAX function on the same random numbers. JAX draws
them inside the step from a key; torch's generators never give JAX's bits,
so here they are data: an `AugmentDraws` record, which
`sample_augment_draws` fills on the generator's device and the tests fill
from a JAX key. Every op runs batched over B: the jitter ops in each
sample's permuted order (JAX's lax.switch under vmap) become the four ops
on the whole batch followed by a per-sample gather; no op reads a value
back to the host, so the augmentation never waits for the card.

The warp is JAX's two-pass factorisation of the affine map: a per-row
fractional shift (the shear), then a resample along the row, once along
W and once along H, and the rotation's fill wherever the exact source
coordinate leaves the image. JAX resamples with a dense interpolation
matrix whose rows hold two non-zero taps; the port gathers those two taps
and weights them with the same values, so it runs no matmul (and TF32
cannot touch it). Everything is fp32 but the rotation's cos and sin.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from view_neti_tpu_torch.data.augment import AUGMENTATION_PRESETS

LUMA = (0.299, 0.587, 0.114)    # ITU-R 601, PIL's "L"
CROP_TRIES = 10                 # torchvision RandomResizedCrop's attempts


@dataclass(frozen=True)
class AugmentSpec:
    """The augmentation of a preset (data/augment.py) plus the mode-0
    horizontal flip."""
    jitter_p: float = 0.0
    jitter_strength: Tuple[float, float, float, float] = (.04, .04, .04, .04)
    gray_p: float = 0.0
    blur_p: float = 0.0
    blur_sigma: Tuple[float, float] = (0.1, 0.2)
    rot_p: float = 0.0
    rot_degrees: float = 10.0
    crop_p: float = 0.0
    crop_scale: Tuple[float, float] = (0.85, 1.15)
    crop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    flip_p: float = 0.0
    fill: float = 1.0 / 255.0

    @property
    def identity(self) -> bool:
        return (self.jitter_p == 0 and self.gray_p == 0 and self.blur_p == 0
                and self.rot_p == 0 and self.crop_p == 0
                and self.flip_p == 0)


def from_augmentation_key(augmentation_key: int,
                          flip_p: float = 0.0) -> Optional[AugmentSpec]:
    """The spec of a preset (None when it does nothing)."""
    if augmentation_key == 0:
        spec = AugmentSpec(flip_p=flip_p)
        return None if spec.identity else spec
    if augmentation_key not in AUGMENTATION_PRESETS:
        raise ValueError(f"unknown augmentation_key {augmentation_key}")
    p = AUGMENTATION_PRESETS[augmentation_key]
    spec = AugmentSpec(
        jitter_p=0.75, flip_p=flip_p,
        gray_p=p.get("gray_p", 0.0),
        blur_p=p["blur_p"],
        rot_p=p.get("rot_p", 0.0),
        crop_p=1.0 if p.get("crop_scale") else 0.0,
        crop_scale=p.get("crop_scale", (0.85, 1.15)))
    return None if spec.identity else spec


@dataclass
class AugmentDraws:
    """Every random number of a batch's augmentation, (B,) per field unless
    stated: the jitter's brightness, contrast and saturation factors, hue
    shift, op order (B, 4) and applied flag; the grayscale flag; the blur
    sigma and flag; the rotation angle in radians, already 0 where the
    rotation is not applied; the crop box (top, left, height, width) in
    pixels of the rotated image, the whole image where there is no crop;
    the horizontal-flip flag."""
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    jitter_order: torch.Tensor
    jitter_applied: torch.Tensor
    gray_applied: torch.Tensor
    blur_sigma: torch.Tensor
    blur_applied: torch.Tensor
    theta: torch.Tensor
    crop_i: torch.Tensor
    crop_j: torch.Tensor
    crop_h: torch.Tensor
    crop_w: torch.Tensor
    flip: torch.Tensor

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one IEEE division on every device. PyTorch's CUDA
    kernel multiplies by the reciprocal when the divisor is a host scalar,
    which can round one bit away from the host's (and JAX's) quotient; a
    divisor on the device keeps the division."""
    return x / x.new_full((), c)


def _uniform(generator, lo: float, hi: float, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def sample_crop_box(generator: torch.Generator, spec: AugmentSpec, B: int,
                    H: int, W: int):
    """RandomResizedCrop boxes with torchvision's rule, as the JAX sampler
    draws them: 10 (area, log-aspect) draws per sample, the first that fits
    the image wins; if none fits, the largest crop with the aspect clamped
    into crop_ratio, centred. Returns (i, j, bh, bw), each (B,)."""
    areas = H * W * _uniform(generator, spec.crop_scale[0],
                             spec.crop_scale[1], (B, CROP_TRIES))
    log_r = _uniform(generator, math.log(spec.crop_ratio[0]),
                     math.log(spec.crop_ratio[1]), (B, CROP_TRIES))
    aspects = torch.exp(log_r)
    bws = torch.sqrt(areas * aspects)
    bhs = torch.sqrt(areas / aspects)
    valid = (bws <= W) & (bhs <= H) & (bws >= 8.0) & (bhs >= 8.0)
    pick = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    r0, r1 = spec.crop_ratio
    in_ratio = W / H
    if in_ratio < r0:
        fb_w, fb_h = float(W), W / r0
    elif in_ratio > r1:
        fb_w, fb_h = H * r1, float(H)
    else:
        fb_w, fb_h = float(W), float(H)
    bw = torch.where(any_valid, bws.gather(1, pick)[:, 0],
                     torch.full_like(any_valid, fb_w, dtype=torch.float32))
    bh = torch.where(any_valid, bhs.gather(1, pick)[:, 0],
                     torch.full_like(any_valid, fb_h, dtype=torch.float32))
    ui = _uniform(generator, 0.0, 1.0, (B,))
    uj = _uniform(generator, 0.0, 1.0, (B,))
    # torchvision places a successful draw uniformly, centres the fallback
    i = torch.where(any_valid, ui * (H - bh), (H - bh) * 0.5)
    j = torch.where(any_valid, uj * (W - bw), (W - bw) * 0.5)
    return i, j, bh, bw


def sample_augment_draws(generator: torch.Generator, spec: AugmentSpec,
                         B: int, H: int, W: int) -> AugmentDraws:
    """A batch's draws on the generator's device, in a fixed order, so that
    they are a function of the generator's seed alone."""
    dev = generator.device
    b, c, s, h = spec.jitter_strength
    brightness = _uniform(generator, max(0.0, 1 - b), 1 + b, (B,))
    contrast = _uniform(generator, max(0.0, 1 - c), 1 + c, (B,))
    saturation = _uniform(generator, max(0.0, 1 - s), 1 + s, (B,))
    hue = _uniform(generator, -h, h, (B,))
    order = torch.argsort(torch.rand((B, 4), generator=generator,
                                     device=dev), dim=1)
    jitter_applied = _uniform(generator, 0.0, 1.0, (B,)) < spec.jitter_p
    gray_applied = _uniform(generator, 0.0, 1.0, (B,)) < spec.gray_p
    blur_sigma = _uniform(generator, spec.blur_sigma[0], spec.blur_sigma[1],
                          (B,))
    blur_applied = _uniform(generator, 0.0, 1.0, (B,)) < spec.blur_p
    theta = _uniform(generator, -spec.rot_degrees, spec.rot_degrees,
                     (B,)) * (math.pi / 180.0)
    rot_on = _uniform(generator, 0.0, 1.0, (B,)) < spec.rot_p
    theta = torch.where(rot_on, theta, torch.zeros_like(theta))
    full = (torch.zeros(B, device=dev), torch.zeros(B, device=dev),
            torch.full((B,), float(H), device=dev),
            torch.full((B,), float(W), device=dev))
    if spec.crop_p > 0:
        box = sample_crop_box(generator, spec, B, H, W)
        crop_on = _uniform(generator, 0.0, 1.0, (B,)) < spec.crop_p
        box = tuple(torch.where(crop_on, x, f) for x, f in zip(box, full))
    else:
        box = full
    flip = _uniform(generator, 0.0, 1.0, (B,)) < spec.flip_p
    return AugmentDraws(brightness, contrast, saturation, hue, order,
                        jitter_applied, gray_applied, blur_sigma,
                        blur_applied, theta, *box, flip)


# --------------------------------------------------------- colour ops ----
# x: (B, H, W, 3) fp32 in [0, 1]; per-sample factors broadcast as (B, 1, 1, 1)

def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _luma(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2]


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    c = maxc - minc
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(_div(h, 6.0), 1.0),
                    torch.zeros_like(h))
    s = torch.where(maxc > 0,
                    c / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices, default):
        out = default
        for k in reversed(range(5)):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([v, q, p, p, t], v),
                        select([t, v, v, q, p], p),
                        select([p, p, t, v, v], q)], dim=-1)


def _jitter_ops(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    """The four jitter ops on the whole batch, stacked: (4, B, H, W, 3)."""
    brightness = torch.clamp(x * _per_sample(d.brightness), 0.0, 1.0)
    # PIL's Contrast blends toward the rounded uint8 mean of the grayscale
    mean = _div(torch.round(_luma(x).mean(dim=(1, 2)) * 255.0), 255.0)
    mean = _per_sample(mean)
    contrast = torch.clamp(mean + _per_sample(d.contrast) * (x - mean),
                           0.0, 1.0)
    g = _luma(x)[..., None]
    saturation = torch.clamp(g + _per_sample(d.saturation) * (x - g),
                             0.0, 1.0)
    hh, ss, vv = _rgb_to_hsv(x)
    hue = _hsv_to_rgb(torch.remainder(hh + d.hue.reshape(-1, 1, 1), 1.0),
                      ss, vv)
    return torch.stack([brightness, contrast, saturation, hue])


def _color_jitter(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)
    out = x
    for k in range(4):
        out = _jitter_ops(out, d)[d.jitter_order[:, k], rows]
    return torch.where(_per_sample(d.jitter_applied), out, x)


def _grayscale(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    g = torch.clamp(_luma(x), 0.0, 1.0)[..., None]
    return torch.where(_per_sample(d.gray_applied), g.expand_as(x), x)


def _gaussian_blur(x: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    """3-tap separable gaussian with edge padding (the presets' sigma <=
    0.2 px puts taps beyond +-1 under 1e-5 of the total)."""
    sigma = d.blur_sigma
    w1 = torch.exp(-0.5 / (sigma * sigma))
    total = w1 + 1.0 + w1
    w0 = _per_sample(w1 / total)
    wc = _per_sample(1.0 / total)
    xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    xv = w0 * xp[:, :-2] + wc * xp[:, 1:-1] + w0 * xp[:, 2:]
    xp = torch.cat([xv[:, :, :1], xv, xv[:, :, -1:]], dim=2)
    xh = w0 * xp[:, :, :-2] + wc * xp[:, :, 1:-1] + w0 * xp[:, :, 2:]
    return torch.where(_per_sample(d.blur_applied), xh, x)


# ------------------------------------------------------------- warp ----

def _shift_rows(x: torch.Tensor, d: torch.Tensor, pad: int) -> torch.Tensor:
    """x: (B, R, N, C); out[b, r, n] = x[b, r, n + d[b, r]], linear between
    the two nearest columns, edge-clamped, with the shift clamped to
    [-pad, pad] (JAX's padded dynamic slice)."""
    B, R, N, C = x.shape
    k = torch.floor(d)
    f = (d - k)[..., None, None]
    ki = torch.clamp(k.to(torch.int64) + pad, 0, 2 * pad)
    cols = ki[..., None] - pad + torch.arange(N + 1, device=x.device)
    cols = torch.clamp(cols, 0, N - 1)
    sl = torch.gather(x, 2, cols[..., None].expand(B, R, N + 1, C))
    return (1.0 - f) * sl[:, :, :N] + f * sl[:, :, 1:]


def _resample(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x: (B, R, N, C); out[b, r, o] samples x[b, r] at column pos[b, o]
    (clamped into the row) by the two taps of JAX's interpolation matrix
    row max(0, 1 - |pos - s|)."""
    B, R, N, C = x.shape
    posc = torch.clamp(pos, 0.0, N - 1.0)
    s0 = torch.floor(posc)
    w0 = torch.clamp(1.0 - torch.abs(posc - s0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(posc - (s0 + 1.0)), min=0.0)
    w1 = torch.where(s0 + 1.0 <= N - 1.0, w1, torch.zeros_like(w1))
    i0 = s0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=N - 1)
    shape = (B, R, pos.shape[1], C)
    a = torch.gather(x, 2, i0[:, None, :, None].expand(shape))
    b = torch.gather(x, 2, i1[:, None, :, None].expand(shape))
    return w0[:, None, :, None] * a + w1[:, None, :, None] * b


def _affine_warp(x: torch.Tensor, d: AugmentDraws, rot_degrees: float,
                 fill: float) -> torch.Tensor:
    """Flip, rotate about the centre and crop+resize in one resampling
    (JAX _apply_affine); rot_degrees bounds |theta| and sizes the shear
    pads (0: no shear pass)."""
    B, H, W, _ = x.shape
    dev = x.device
    # source coordinates of output pixel (x, y), per sample:
    #   xr = sw x + tx, yr = sh y + ty (crop + resize, half-pixel centres)
    #   xb0 = cx + cos (xr - cx) + sin (yr - cy)
    #   yb = cy - sin (xr - cx) + cos (yr - cy)
    #   xb = flip ? (W - 1) - xb0 : xb0
    sw, sh = _div(d.crop_w, W), _div(d.crop_h, H)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    tx = d.crop_j + 0.5 * sw - 0.5
    ty = d.crop_i + 0.5 * sh - 0.5
    # cos and sin in fp64, rounded to fp32: the libraries of the card and
    # the host then agree to the bit, and the fill mask below (a threshold)
    # cannot flip between them
    theta = d.theta.to(torch.float64)
    cos_t = torch.cos(theta).to(torch.float32)
    sin_t = torch.sin(theta).to(torch.float32)
    sign = torch.where(d.flip, -1.0, 1.0)
    fconst = torch.where(d.flip, float(W - 1), 0.0)
    a00 = sign * cos_t * sw
    a01 = sign * sin_t * sh
    c0 = fconst + sign * (cx + cos_t * (tx - cx) + sin_t * (ty - cy))
    a10 = -sin_t * sw
    a11 = cos_t * sh
    c1 = cy - sin_t * (tx - cx) + cos_t * (ty - cy)

    # pass H: T[r, xo] = img[r, e00 xo + e01 r + e0] over source rows r
    a11s = torch.where(torch.abs(a11) < 1e-6, torch.full_like(a11, 1e-6),
                       a11)
    e01 = a01 / a11s
    e00 = a00 - e01 * a10
    e0 = c0 - e01 * c1
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    if rot_degrees > 0:
        pad_h = int(math.ceil(math.tan(math.radians(rot_degrees))
                              * H / 2.0)) + 2
        s_h = _shift_rows(x, e01[:, None] * (rows - cy), pad_h)
    else:
        s_h = x
    pos_x = e00[:, None] * cols + (e0 + e01 * cy)[:, None]
    t = _resample(s_h, pos_x)                        # (B, H, W, C)

    # pass V: out[y, xo] = T[a11 y + a10 (xo - cx) + (c1 + a10 cx), xo]
    tt = t.transpose(1, 2)                           # (B, W, H, C)
    if rot_degrees > 0:
        pad_v = int(math.ceil(math.sin(math.radians(rot_degrees))
                              * W / 2.0)) + 2
        s_v = _shift_rows(tt, a10[:, None] * (cols - cx), pad_v)
    else:
        s_v = tt
    pos_y = a11[:, None] * rows + (c1 + a10 * cx)[:, None]
    out = _resample(s_v, pos_y).transpose(1, 2)      # (B, H, W, C)

    # the rotation's fill wherever the exact source coordinate leaves the
    # image (PIL rotate's fillcolor)
    yo, xo = rows[:, None], cols[None, :]

    def ps(v):
        return v.reshape(-1, 1, 1)

    xb = ps(a00) * xo + ps(a01) * yo + ps(c0)
    yb = ps(a10) * xo + ps(a11) * yo + ps(c1)
    valid = (xb > -0.5) & (xb < W - 0.5) & (yb > -0.5) & (yb < H - 0.5)
    return torch.where(valid[..., None], out, torch.full_like(out, fill))


def augment_batch(spec: AugmentSpec, draws: AugmentDraws,
                  imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) fp32 in [-1, 1], augmented in the
    order of every preset: jitter, grayscale, blur, then the fused flip,
    rotation and crop."""
    if spec.rot_p > 0 and spec.rot_degrees >= 45.0:
        # the two-pass shear's bound is tan(theta); the presets use 10
        raise ValueError(
            f"device rotation supports |degrees| < 45 (got "
            f"{spec.rot_degrees})")
    x = imgs_u8.to(torch.float32) * (1.0 / 255.0)
    if spec.jitter_p > 0:
        x = _color_jitter(x, draws)
    if spec.gray_p > 0:
        x = _grayscale(x, draws)
    if spec.blur_p > 0:
        x = _gaussian_blur(x, draws)
    if spec.rot_p > 0 or spec.crop_p > 0 or spec.flip_p > 0:
        x = _affine_warp(x, draws,
                         spec.rot_degrees if spec.rot_p > 0 else 0.0,
                         spec.fill)
    return x * 2.0 - 1.0
