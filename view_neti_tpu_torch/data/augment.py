"""The augmentation presets (view_neti_tpu/data/augment.py:119-128) and
their host pipeline (view_neti_tpu/data/augment.py:18-160).

One preset table serves ops/device_augment.py, which runs the presets on
the card inside the train step, and the host pipeline below, which the
dataset runs when the Coach has no augmentation on the card
(data.device_augment false, or the llff passthrough's images of several
sizes).

Op order is fixed for every preset: jitter, grayscale, blur, rotation,
crop. Common parameters: jitter p = 0.75 with strength 0.04 x 4, blur
sigma (0.1, 0.2), rotation +-10 degrees with fill 1/255, crop p = 1 with
aspect ratio (3/4, 4/3) (reference training/dataset.py:238-316).

The host pipeline computes what the JAX package's PIL pipeline computes,
on uint8 (H, W, 3) numpy images (or CPU torch tensors), from the same
numpy generator consumed in the same order: the four jitter factors then
a permutation of the four ops, each step's uniform() < p, the crop's
tries. The arithmetic is Pillow's:
  * ImageEnhance (brightness, contrast, colour): Image.blend in float32,
    truncated and clipped to uint8; the contrast's mean is the rounded
    mean of the L image; L is ITU-R 601-2 in 16-bit fixed point;
  * the hue shift: Pillow's RGB->HSV->RGB conversions (float32 and double
    steps as its C code takes them);
  * GaussianBlur: Pillow's three extended-box passes per axis in 24-bit
    fixed point, each rounded to uint8;
  * rotate(BILINEAR, fillcolor=(1, 1, 1)): Pillow's affine matrix, pixel
    centres, double-precision bilinear taps truncated to uint8, and the
    fill where the source point leaves the image;
  * the crop: the integer box, resized by the port's compiled copy of
    the JAX package's native bilinear resize (csrc/bilinear_resize.cpp,
    native/imageproc.cpp's arithmetic: float32 taps, a float32
    intermediate, + 0.5 and truncation), built with native/Makefile's
    flags, so that its multiply-adds contract into FMAs as that build's
    do on the same machine.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np

AUGMENTATION_PRESETS = {
    1: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75, crop_scale=(0.850, 1.15)),
    2: dict(gray_p=0.1, blur_p=0.10),
    3: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75),
    4: dict(gray_p=0.1, blur_p=0.10, crop_scale=(0.850, 1.15)),
    5: dict(blur_p=0.25, crop_scale=(0.950, 1.05)),
    6: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75, crop_scale=(0.70, 1.3)),
    7: dict(blur_p=0.2, rot_p=0.75, crop_scale=(0.70, 1.3)),
    8: dict(gray_p=0.1, blur_p=0.10),
}

F32 = np.float32


# ---- Pillow's pixel arithmetic ---------------------------------------------
def luma(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8: Pillow's RGB -> L, (19595 R + 38470 G + 7471 B +
    0x8000) >> 16."""
    x = img.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def blend(degenerate, img: np.ndarray, alpha: float) -> np.ndarray:
    """Image.blend(degenerate, img, alpha): in1 + alpha (in2 - in1) in
    float32, truncated, clipped to [0, 255]."""
    a = F32(alpha)
    d = np.asarray(degenerate).astype(np.int32)
    diff = (img.astype(np.int32) - d).astype(F32)
    out = d.astype(F32) + a * diff
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def brightness(img: np.ndarray, f: float) -> np.ndarray:
    return blend(np.zeros((), np.uint8), img, f)


def contrast(img: np.ndarray, f: float) -> np.ndarray:
    """Against a gray image at the mean of L, int(mean + 0.5) (ImageStat
    sums the histogram in Python)."""
    hist = np.bincount(luma(img).ravel(), minlength=256)
    mean = int(float((hist * np.arange(256)).sum()) / float(hist.sum())
               + 0.5)
    return blend(np.full((), mean, np.uint8), img, f)


def saturation(img: np.ndarray, f: float) -> np.ndarray:
    return blend(luma(img)[..., None], img, f)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Pillow's rgb2hsv: float32 ratios, the hue offset and fmod in
    double, each channel truncated to uint8."""
    x = img.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(-1)
    minc = x.min(-1)
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(F32)
    s = cr / np.where(grey, 1, maxc).astype(F32)
    rc = (maxc - r).astype(F32) / cr
    gc = (maxc - g).astype(F32) / cr
    bc = (maxc - b).astype(F32) / cr
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc,
                          (2.0 + rc.astype(np.float64)
                           - bc.astype(np.float64)).astype(F32),
                          (4.0 + gc.astype(np.float64)
                           - rc.astype(np.float64)).astype(F32)))
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(F32)
    uh = np.clip(np.trunc(h.astype(np.float64) * 255.0), 0, 255)
    us = np.clip(np.trunc(s.astype(np.float64) * 255.0), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], -1)
    return out.astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C's round() for x >= 0."""
    fl = np.floor(x)
    return np.where(x - fl >= 0.5, fl + 1, fl)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's hsv2rgb: the sector and remainder in double, float32 f and
    s / 255, each of p, q, t rounded half away from zero."""
    h = hsv[..., 0].astype(F32).astype(np.float64)
    s = hsv[..., 1]
    v = hsv[..., 2].astype(np.float64)
    i = np.floor(h * 6.0 / 255.0)
    f = (h * 6.0 / 255.0 - i).astype(F32)
    fs = (s.astype(F32).astype(np.float64) / 255.0).astype(F32)
    fs64 = fs.astype(np.float64)
    p = _round_half_away(v * (1.0 - fs64))
    q = _round_half_away(v * (1.0 - (fs * f).astype(np.float64)))
    t = _round_half_away(v * (1.0 - fs64 * (1.0 - f.astype(np.float64))))
    p, q, t = (np.clip(c, 0, 255) for c in (p, q, t))
    sector = i.astype(np.int64) % 6
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q))
    rgb = [np.select([sector == k for k in range(6)],
                     [table[k][c] for k in range(6)]) for c in range(3)]
    out = np.stack(rgb, -1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return out.astype(np.uint8)


def hue(img: np.ndarray, shift: float) -> np.ndarray:
    """The JAX package's hue op: the HSV hue channel plus int(shift *
    255), mod 256."""
    hsv = rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
    return hsv_to_rgb(hsv.astype(np.uint8))


def grayscale(img: np.ndarray) -> np.ndarray:
    return np.repeat(luma(img)[..., None], 3, axis=-1)


def _box_blur_radius(sigma: float, passes: int = 3) -> np.float32:
    """Pillow's _gaussian_blur_radius: the extended box's radius, in its
    float32 (and double) steps."""
    radius = F32(sigma)
    sigma2 = F32(radius * radius / F32(passes))
    L = F32(math.sqrt(12.0 * float(sigma2) + 1.0))
    lo = F32(math.floor((float(L) - 1.0) / 2.0))
    a = F32(F32(F32(2) * lo + F32(1))
            * F32(F32(lo * F32(lo + F32(1))) - F32(F32(3) * sigma2)))
    a = F32(a / F32(F32(6) * F32(sigma2 - F32(F32(lo + F32(1))
                                              * F32(lo + F32(1))))))
    return F32(lo + a)


def _box_blur_rows(x: np.ndarray, radius: np.float32) -> np.ndarray:
    """One ImagingHorizontalBoxBlur pass along axis 1 of (H, W, C) uint8:
    (ww * box sum + fw * (the two pixels past the box) + 2^23) >> 24,
    edges repeated."""
    r = int(radius)
    ww = int(F32(16777216.0) / F32(radius * F32(2) + F32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    W = x.shape[1]
    if r == 0:
        # the presets' sigmas (0.1-0.2) give a box of one pixel; the sum
        # stays below 2^32: (ww + 2 fw) * 255 + 2^23 <= 2^24 * 255 + 2^23
        left = np.concatenate([x[:, :1], x[:, :-1]], 1).astype(np.uint32)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1).astype(np.uint32)
        acc = (x.astype(np.uint32) * np.uint32(ww)
               + (left + right) * np.uint32(fw) + np.uint32(1 << 23))
        return (acc >> 24).astype(np.uint8)
    idx = np.clip(np.arange(-r - 1, W + r + 1), 0, W - 1)
    p = x[:, idx].astype(np.int64)
    c = np.concatenate([np.zeros_like(p[:, :1]), np.cumsum(p, 1)], 1)
    box = c[:, 2 * r + 2:2 * r + 2 + W] - c[:, 1:1 + W]
    far = p[:, :W] + p[:, 2 * r + 2:2 * r + 2 + W]
    return ((box * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def box_blur(img: np.ndarray, sigma: float, passes: int = 3) -> np.ndarray:
    """ImageFilter.GaussianBlur(sigma): three passes along the rows, then
    three along the columns."""
    radius = _box_blur_radius(sigma, passes)
    x = img
    for _ in range(passes):
        x = _box_blur_rows(x, radius)
    x = x.transpose(1, 0, 2)
    for _ in range(passes):
        x = _box_blur_rows(x, radius)
    return np.ascontiguousarray(x.transpose(1, 0, 2))


def rotate(img: np.ndarray, angle: float, fill: int = 1) -> np.ndarray:
    """Image.rotate(angle, BILINEAR, fillcolor=(fill,) * 3): the output
    pixel centre (x + .5, y + .5) maps through Pillow's rounded affine
    matrix; points outside [0, W) x [0, H) take the fill; the rest
    interpolate the four neighbours (edges repeated) in double and
    truncate."""
    H, W = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and W == H:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    cx, cy = W / 2, H / 2
    rad = -math.radians(angle)
    a, b, d, e = (round(math.cos(rad), 15), round(math.sin(rad), 15),
                  round(-math.sin(rad), 15), round(math.cos(rad), 15))
    c = a * -cx + b * -cy + 0.0 + cx
    f = d * -cx + e * -cy + 0.0 + cy
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xin, yin = xx + 0.5, yy + 0.5
    sx = a * xin + b * yin + c
    sy = d * xin + e * yin + f
    inside = (sx >= 0.0) & (sx < W) & (sy >= 0.0) & (sy < H)
    sx, sy = sx - 0.5, sy - 0.5
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    dx = (sx - x0)[..., None]
    dy = (sy - y0)[..., None]
    xa, xb = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    ya, yb = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    src = img.astype(np.float64)

    def row(y):
        left, right = src[y, xa], src[y, xb]
        return left + (right - left) * dx

    v1, v2 = row(ya), row(yb)
    out = np.trunc(v1 + (v2 - v1) * dy)
    out = np.where(inside[..., None], out, fill)
    return out.astype(np.uint8)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding: the float32 product is exact
    in float64, the sum rounds there and then to float32 (a double
    rounding that a single FMA can differ from only at ties)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _native_taps(sn: int, dn: int):
    """The bilinear taps of native/imageproc.cpp's make_taps, in float32:
    (first source index (dn,), weights (dn, max_taps))."""
    scale = F32(F32(sn) / F32(dn))
    filt = max(scale, F32(1.0))
    support = F32(F32(1.0) * filt)
    max_taps = int(math.ceil(support)) * 2 + 1
    x = np.arange(dn)
    center = _fma((x.astype(F32) + F32(0.5)), scale, F32(-0.5))
    x0 = np.clip(np.floor(center - support).astype(np.int64) + 1, 0, sn - 1)
    x1 = np.minimum(np.ceil(center + support).astype(np.int64) + 1, sn)
    w = np.zeros((dn, max_taps), F32)
    wsum = np.zeros(dn, F32)
    for k in range(max_taps):
        d = (center - (x0 + k).astype(F32)) / filt
        wk = np.maximum(F32(0.0), F32(1.0) - np.abs(d)).astype(F32)
        wk = np.where(k < x1 - x0, wk, F32(0.0))
        w[:, k] = wk
        wsum = wsum + wk
    w = np.where((wsum > 0)[:, None], w / np.where(wsum > 0, wsum, 1)[:, None],
                 w).astype(F32)
    return x0, w


def native_bilinear_resize_plain(img: np.ndarray, out_h: int, out_w: int
                                 ) -> np.ndarray:
    """The plain numpy version of native_bilinear_resize: a float32
    horizontal pass, a float32 vertical pass, each tap added in order,
    then + 0.5, clipped and truncated, with every multiply-add of the
    tap centres and of both passes fused. It cannot know which
    multiply-adds a given build of the native library contracts (that
    is the compiler's choice, per machine), so it can differ from the
    compiled resize by a level where a sum rounds across a .5; nothing on
    the crop's path calls it."""
    sh, sw = img.shape[:2]
    x0, wx = _native_taps(sw, out_w)
    y0, wy = _native_taps(sh, out_h)
    src = img.astype(F32)
    tmp = np.zeros((sh, out_w, img.shape[2]), F32)
    for k in range(wx.shape[1]):
        cols = np.minimum(x0 + k, sw - 1)
        tmp = _fma(wx[None, :, k, None], src[:, cols], tmp)
    acc = np.zeros((out_h, out_w, img.shape[2]), F32)
    for k in range(wy.shape[1]):
        rows = np.minimum(y0 + k, sh - 1)
        acc = _fma(wy[:, k, None, None], tmp[rows], acc)
    return np.clip(acc + F32(0.5), 0, 255).astype(np.uint8)


def native_bilinear_resize(img: np.ndarray, out_h: int, out_w: int
                           ) -> np.ndarray:
    """native.resize(img, out_h, out_w, "bilinear") of the JAX package,
    uint8 (H, W, C) -> (out_h, out_w, C), by the compiled helper
    csrc/bilinear_resize.cpp (built on first use with -march=native;
    raises if the build fails)."""
    from view_neti_tpu_torch.ops import build
    fn = build.host_library("bilinear_resize").bilinear_resize_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = None
    src = np.ascontiguousarray(img, np.uint8)
    h, w, c = src.shape
    if min(h, w, c, out_h, out_w) < 1:
        raise ValueError(f"cannot resize a {h}x{w}x{c} image to "
                         f"{out_h}x{out_w}")
    out = np.empty((out_h, out_w, c), np.uint8)
    fn(src.ctypes.data, h, w, c, out.ctypes.data, out_h, out_w)
    return out


# ---- the random ops (the JAX package's, draw for draw) ----------------------
def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness_: float, contrast_: float, saturation_: float,
                 hue_: float) -> np.ndarray:
    """torchvision's ColorJitter as the JAX package draws and applies it:
    each factor ~ U[max(0, 1 - v), 1 + v], the hue shift ~ U[-h, h], the
    ops in rng.permutation order. The JAX package's enhance ops are
    closures over one variable that each draw reassigns, so all three run
    with the last factor drawn; the port does the same, so that its stream
    is the JAX package's."""
    factor, enhance = None, []
    for fn, v in ((brightness, brightness_), (contrast, contrast_),
                  (saturation, saturation_)):
        if v > 0:
            factor = rng.uniform(max(0.0, 1 - v), 1 + v)
            enhance.append(fn)
    # each op reads `factor` when it runs, after the last draw
    ops: List[Callable[[np.ndarray], np.ndarray]] = [
        (lambda im, fn=fn: fn(im, factor)) for fn in enhance]
    if hue_ > 0:
        shift = rng.uniform(-hue_, hue_)
        ops.append(lambda im: hue(im, shift))
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def random_grayscale(img: np.ndarray, rng: np.random.Generator,
                     p: float) -> np.ndarray:
    return grayscale(img) if rng.uniform() < p else img


def gaussian_blur(img: np.ndarray, rng: np.random.Generator,
                  sigma_range: Tuple[float, float]) -> np.ndarray:
    return box_blur(img, rng.uniform(*sigma_range))


def random_rotation(img: np.ndarray, rng: np.random.Generator,
                    degrees: float, fill: int = 1) -> np.ndarray:
    return rotate(img, rng.uniform(-degrees, degrees), fill)


def random_resized_crop(img: np.ndarray, rng: np.random.Generator,
                        size: Tuple[int, int], scale: Tuple[float, float],
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> np.ndarray:
    """torchvision's RandomResizedCrop (size (h, w)) as the JAX package
    draws it: up to 10 tries, then the centre crop."""
    H, W = img.shape[:2]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = rng.integers(0, H - h + 1)
            j = rng.integers(0, W - w + 1)
            return native_bilinear_resize(img[i:i + h, j:j + w], *size)
    scale_f = min(W / size[1], H / size[0])
    w, h = int(size[1] * scale_f), int(size[0] * scale_f)
    j, i = (W - w) // 2, (H - h) // 2
    return native_bilinear_resize(img[i:i + h, j:j + w], *size)


@dataclass
class _Step:
    p: float
    fn: Callable[[np.random.Generator, np.ndarray], np.ndarray]


def build_augmentations(augmentation_key: int, size: Tuple[int, int]
                        ) -> List[_Step]:
    """The host pipeline of a preset; size (h, w) is the crop's output."""
    if augmentation_key not in AUGMENTATION_PRESETS:
        raise ValueError(f"unknown augmentation_key {augmentation_key}")
    p = AUGMENTATION_PRESETS[augmentation_key]
    steps = [_Step(0.75, lambda rng, im: color_jitter(
        im, rng, 0.04, 0.04, 0.04, 0.04))]
    if p.get("gray_p"):
        steps.append(_Step(p["gray_p"], lambda rng, im: grayscale(im)))
    steps.append(_Step(p["blur_p"], lambda rng, im: gaussian_blur(
        im, rng, (0.1, 0.2))))
    if p.get("rot_p"):
        steps.append(_Step(p["rot_p"], lambda rng, im: random_rotation(
            im, rng, 10, fill=1)))
    if p.get("crop_scale"):
        crop_scale = p["crop_scale"]
        steps.append(_Step(1.0, lambda rng, im: random_resized_crop(
            im, rng, size, crop_scale)))
    return steps


def apply_augmentations(img, steps: Sequence[_Step],
                        rng: np.random.Generator):
    """Run the steps on a uint8 (H, W, 3) image, numpy or a CPU torch
    tensor (returned as the same kind); a step with p < 1 first draws
    rng.uniform()."""
    as_torch = not isinstance(img, np.ndarray)
    x = img.numpy() if as_torch else img
    for step in steps:
        if step.p >= 1.0 or rng.uniform() < step.p:
            x = step.fn(rng, x)
    if as_torch:
        import torch
        return torch.from_numpy(np.ascontiguousarray(x))
    return x
