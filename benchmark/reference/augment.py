"""Augmentation preset 7 in plain PyTorch: ColorJitter (0.04 each, in a
drawn order), GaussianBlur, and one warp for RandomRotation (10 degrees),
RandomResizedCrop (scale 0.70-1.30) and the flip, in float32.

A frozen copy of the arithmetic of the recipe's augmentation on the
device (ColorJitter and PIL's Contrast toward the rounded grey mean, a
3-tap blur, the two-pass shear factorisation of the affine warp with
two-tap resampling and the rotation's fill). It takes the draws that the
run's step was fed (`d`: a record with the fields brightness, contrast,
saturation, hue, jitter_order, jitter_applied, gray_applied, blur_sigma,
blur_applied, theta, crop_i, crop_j, crop_h, crop_w, flip) and a spec
(jitter_p, gray_p, blur_p, rot_p, rot_degrees, crop_p, flip_p, fill).
"""
from __future__ import annotations

import math

import torch

LUMA = (0.299, 0.587, 0.114)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one IEEE division (a divisor on the device keeps it one)."""
    return x / x.new_full((), c)


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


def _jitter_ops(x: torch.Tensor, d) -> torch.Tensor:
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


def _color_jitter(x: torch.Tensor, d) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)
    out = x
    for k in range(4):
        out = _jitter_ops(out, d)[d.jitter_order[:, k], rows]
    return torch.where(_per_sample(d.jitter_applied), out, x)


def _grayscale(x: torch.Tensor, d) -> torch.Tensor:
    g = torch.clamp(_luma(x), 0.0, 1.0)[..., None]
    return torch.where(_per_sample(d.gray_applied), g.expand_as(x), x)


def _gaussian_blur(x: torch.Tensor, d) -> torch.Tensor:
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


def _affine_warp(x: torch.Tensor, d, rot_degrees: float,
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


def augment_batch(spec, draws,
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
