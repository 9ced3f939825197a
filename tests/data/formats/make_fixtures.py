"""Write the image-format fixtures of the port's tests, and their manifest
(the shape and the sha256 of PIL's convert("RGB") decode of each file).

    python tests/data/formats/make_fixtures.py

teapot/: 512x512 mode-0 training views, one per format, from the views of
tests/data/jpeg/make_fixtures.py (view 5 onwards):
  view_5_progressive.jpg   progressive 4:2:0 (Pillow's 10-scan script)
  view_6_cmyk_prog.jpg     progressive CMYK (Adobe APP14, transform 0)
  view_7_ycck.jpg          baseline CMYK with the APP14 transform patched
                           to 2: the decoder reads it as YCCK
  view_8_adam7.png         8-bit RGB, Adam7 interlaced
  view_9_rgb16.png         16-bit RGB (the view in the high byte)
  view_10_arith.jpg ...      arithmetic-coded and lossless JPEG views,
  view_13_lossless_gray.jpg  with the small arith/ and lossless/ files:
                             make_arith_lossless.py (`fixtures`)
ycck_45x37.jpg: a small YCCK file, patched the same way.
smoothing_5scans.jpg: the first 5 scans of a progressive file and an EOI;
its coefficients stay unrefined, so libjpeg's block smoothing runs.

Pillow writes neither Adam7 nor 16-bit colour PNGs, so `png_bytes` here
writes PNGs of every color type, bit depth and interlacing with zlib and
numpy (all five row filters).
"""
import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _jpeg_views():
    spec = importlib.util.spec_from_file_location(
        "jpeg_fixtures", HERE.parent / "jpeg" / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.view


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """Rows (h, rowbytes) uint8 filtered, row y with filter type
    (first_kind + y) % 5, each row led by its type byte."""
    h, n = rows.shape
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp] if n > bpp else a[:, bpp:]
    c = np.zeros_like(x)
    c[:, bpp:] = up[:, :-bpp] if n > bpp else c[:, bpp:]
    preds = (np.zeros_like(x), a, up, (a + up) >> 1, _paeth(a, up, c))
    kinds = (first_kind + np.arange(h)) % 5
    out = np.empty((h, 1 + n), np.uint8)
    out[:, 0] = kinds
    for y in range(h):
        out[y, 1:] = (x[y] - preds[kinds[y]][y]) & 0xFF
    return out.tobytes()


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples (h, w, c) -> the PNG's packed rows (h, rowbytes) uint8:
    16-bit big-endian, sub-byte samples from the high bit."""
    h, w, c = samples.shape
    if depth == 16:
        v = samples.astype(np.uint16).reshape(h, w * c)
        return np.stack([v >> 8, v & 0xFF], -1).reshape(
            h, 2 * w * c).astype(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    v = samples.reshape(h, w).astype(np.uint8)
    bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(samples: np.ndarray, color: int, depth: int,
              interlace: bool = False, palette=None) -> bytes:
    """A PNG of samples (h, w, c) (palette indices for color type 3), any
    legal bit depth, Adam7 when `interlace`. Every pass starts its filter
    cycle at another type."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == COLOR_CHANNELS[color]
    bpp = max(1, c * depth // 8)
    body = b""
    for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:                     # an empty pass writes no bytes
            body += filter_rows(pack_rows(sub, depth), bpp, i)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(body, 9))
            + _chunk(b"IEND", b""))


def jpeg_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def as_ycck(data: bytes) -> bytes:
    """A CMYK JPEG with its Adobe APP14 transform byte set to 2 (YCCK)."""
    i = data.index(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe" and data[i + 15] == 0
    return data[:i + 15] + b"\x02" + data[i + 16:]


def first_scans(data: bytes, n: int) -> bytes:
    """The file up to its (n+1)-th SOS segment, and an EOI: its first n
    scans. (0xFFDA never occurs inside entropy-coded data: a 0xFF there is
    followed by 0x00 or a restart marker.)"""
    starts, i = [], data.index(b"\xff\xda")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\xff\xda", i + 2)
    assert len(starts) > n
    return data[:starts[n]] + b"\xff\xd9"


def _arith_lossless():
    spec = importlib.util.spec_from_file_location(
        "arith_lossless", HERE / "make_arith_lossless.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_all() -> dict:
    view = _jpeg_views()
    for sub in ("teapot", "arith", "lossless"):
        (HERE / sub).mkdir(exist_ok=True)
    files = {
        "teapot/view_5_progressive.jpg": jpeg_bytes(
            Image.fromarray(view(5)), quality=90, subsampling=2,
            progressive=True),
        "teapot/view_6_cmyk_prog.jpg": jpeg_bytes(
            Image.fromarray(view(6)).convert("CMYK"), quality=90,
            progressive=True),
        "teapot/view_7_ycck.jpg": as_ycck(jpeg_bytes(
            Image.fromarray(view(7)).convert("CMYK"), quality=90)),
        "teapot/view_8_adam7.png": png_bytes(view(8), 2, 8, interlace=True),
        "ycck_45x37.jpg": as_ycck(jpeg_bytes(
            Image.fromarray(view(3, 37, 45)).convert("CMYK"), quality=85)),
        "smoothing_5scans.jpg": first_scans(jpeg_bytes(
            Image.fromarray(view(4, 96, 128)), quality=75, subsampling=2,
            progressive=True), 5),
    }
    hi = view(9).astype(np.uint16)
    y, x = np.mgrid[0:512, 0:512]
    low = ((x * 5 + y * 3) % 256).astype(np.uint16)[..., None]
    files["teapot/view_9_rgb16.png"] = png_bytes((hi << 8) | low, 2, 16)
    files.update(_arith_lossless().fixtures(view))
    manifest = {}
    for rel in sorted(files):
        (HERE / rel).write_bytes(files[rel])
        rgb = np.asarray(Image.open(HERE / rel).convert("RGB"))
        manifest[rel] = {
            "shape": list(rgb.shape),
            "sha256_rgb": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1)
                                        + "\n")
    return manifest


if __name__ == "__main__":
    write_all()
