"""Image reading and writing and the deterministic resizes, without PIL
(the machine with the card has none).

read_rgb reads a PNG or a JPEG, told apart by their first bytes, as PIL's
Image.open(p).convert("RGB") gives it, bit for bit:
  * PNG: every color type and bit depth (gray of 1, 2, 4, 8 and 16 bits,
    gray+alpha, RGB and RGBA of 8 and 16, palette images of 1-8), with or
    without Adam7 interlacing; tRNS ignored, as convert("RGB") ignores it.
    Low-bit gray is scaled to 0..255, 16-bit gray clipped at 255 (PIL's
    I;16), the other 16-bit types keep their high byte. The chunks are
    parsed here, the IDAT stream inflated with zlib and the rows (each
    Adam7 pass its own image) unfiltered by a compiled host helper
    (csrc/png_unfilter.cpp). `unfilter_plain` is the same unfilter in
    numpy, the reference the tests hold the helper to; the decode never
    falls back to it.
  * JPEG: baseline, extended-sequential and progressive files, Huffman-
    or arithmetic-coded, and lossless Huffman-coded files, with 8-bit
    samples, gray, YCbCr, RGB, CMYK or YCCK at any integral sampling,
    decoded by a compiled host helper (csrc/jpeg_decode.cpp) with
    libjpeg-turbo's arithmetic, its block smoothing of unrefined
    progressive files and Pillow's CMYK->RGB, up to the first EOI.
    Lossless arithmetic-coded, hierarchical and 12-bit files raise, as do
    lossless files marked YCbCr (Pillow's libjpeg-turbo refuses them).
Both helpers are built with the host compiler at first use. Every reading
error is an ImageError that names the file.

write_png writes the direct-colour formats with any PNG row filter.
resize_u8 is the datasets' deterministic resize: torch's antialiased
bicubic (PIL's kernel, a = -0.5) rounded to uint8, within one level of
PIL's BICUBIC resize and of the JAX package's native one. resize_pil is
the evaluation's: PIL's BICUBIC (or BILINEAR) resampling, computed as
Pillow computes it, bit for bit, where the JAX package calls PIL.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # PNG color type -> channels
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}
FILTERS = ("none", "sub", "up", "average", "paeth")


class ImageError(ValueError):
    """A file the readers cannot decode; the message names the file and
    the reason."""


class PNGError(ImageError):
    pass


class JPEGError(ImageError):
    pass


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + length]
        crc = struct.unpack(">I", data[i + 8 + length:i + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"bad CRC in chunk {kind!r}")
        yield kind, body
        i += 12 + length
        if kind == b"IEND":
            return
    raise PNGError("no IEND chunk")


def _png_parts(data: bytes):
    """(IHDR fields, inflated IDAT bytes, PLTE entries (N, 3) or None)."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if header is None:
        raise PNGError("no IHDR chunk")
    return header, zlib.decompress(b"".join(idat)), palette


def parse_png(data: bytes) -> Tuple[int, int, int, bytes]:
    """(height, width, channels, inflated filtered rows) of an 8-bit,
    non-interlaced direct-colour PNG."""
    (width, height, depth, color, _, _, interlace), raw, _ = _png_parts(data)
    if depth != 8 or color not in CHANNELS or interlace:
        raise PNGError(f"not an 8-bit non-interlaced direct-colour PNG: bit "
                       f"depth {depth}, color type {color}, interlace "
                       f"{interlace}")
    channels = CHANNELS[color]
    if len(raw) != height * (1 + width * channels):
        raise PNGError("IDAT size does not match the header")
    return height, width, channels, raw


def _unfilter(raw, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """(height, rowbytes) uint8 by the compiled helper; raw: the filtered
    rows (bytes or a memoryview)."""
    from view_neti_tpu_torch.ops import build
    if len(raw) != height * (1 + rowbytes):
        raise PNGError("filtered rows do not match the image size")
    fn = build.host_library("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int
    out = np.empty((height, rowbytes), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    err = fn(src.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if err:
        raise PNGError(f"unknown filter type in row {err - 1}")
    return out


# the bit depths each PNG color type allows, and the Adam7 passes as
# (x0, y0, dx, dy)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Unfiltered rows (h, rowbytes) -> samples (h, width, channels):
    uint16 at 16 bits (big-endian in the file), else uint8 values below
    2**depth (sub-byte samples packed from the high bit)."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(
            h, width, channels)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits.reshape(h, width, depth) * weights).sum(-1)
        return rows.astype(np.uint8)[..., None]
    return rows.reshape(h, width, channels)


def _decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 of a PNG of any color type, bit depth and
    interlacing, C its channels (3 for a palette image), reduced to 8 bits
    as PIL's convert("RGB") reduces them: gray of 1, 2 or 4 bits scaled to
    0..255 (x255, x85, x17), 16-bit gray clipped at 255 (PIL's I;16), the
    other 16-bit types' high byte. Each Adam7 pass is its own filtered
    image, and an empty pass has no bytes at all."""
    (width, height, depth, color, _, _, interlace), raw, palette = \
        _png_parts(data)
    if color not in DEPTHS or depth not in DEPTHS[color]:
        raise PNGError(f"invalid PNG: bit depth {depth} with color type "
                       f"{color}")
    if interlace > 1:
        raise PNGError(f"unknown interlace method {interlace}")
    if color == 3 and palette is None:
        raise PNGError("palette PNG without a PLTE chunk")
    channels = 1 if color == 3 else CHANNELS[color]
    bpp = max(1, channels * depth // 8)
    samples = np.empty((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
    view, off = memoryview(raw), 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        w = max(0, (width - x0 + dx - 1) // dx)
        h = max(0, (height - y0 + dy - 1) // dy)
        if not (w and h):
            continue
        rowbytes = (w * channels * depth + 7) // 8
        n = h * (1 + rowbytes)
        rows = _unfilter(view[off:off + n], h, rowbytes, bpp)
        samples[y0::dy, x0::dx] = _unpack(rows, w, channels, depth)
        off += n
    if off != len(raw):
        raise PNGError("IDAT size does not match the header")
    if color == 3:
        idx = samples[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise PNGError("palette index out of range")
        return palette[idx]
    if depth == 16:
        if color == 0:
            return np.minimum(samples, 255).astype(np.uint8)
        return (samples >> 8).astype(np.uint8)
    if color == 0 and depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def unfilter_compiled(raw: bytes, height: int, width: int,
                      channels: int) -> np.ndarray:
    """(height, width, channels) uint8 by the compiled helper."""
    return _unfilter(raw, height, width * channels,
                     channels).reshape(height, width, channels)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: bytes, height: int, width: int,
                   channels: int) -> np.ndarray:
    """The same unfilter in numpy. A pixel depends on its left, upper and
    upper-left neighbours, so the pixels of one anti-diagonal are
    independent: the loop runs over the width + height - 1 diagonals."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + width * channels)
    kind = rows[:, 0].astype(np.int64)
    if (kind > 4).any():
        raise PNGError(f"unknown filter type in row "
                       f"{int(np.argmax(kind > 4))}")
    filt = rows[:, 1:].reshape(height, width, channels).astype(np.int64)
    out = np.zeros((height + 1, width + 1, channels), np.int64)
    for d in range(height + width - 1):
        y = np.arange(max(0, d - width + 1), min(height, d + 1))
        x = d - y
        a = out[y + 1, x]        # left
        b = out[y, x + 1]        # up
        c = out[y, x]            # up-left
        k = kind[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """(H, W, C) uint8, C the file's channels (1, 2, 3 or 4), or 3 for a
    palette image (its colours), in 8 bits as _decode_png reduces them."""
    return _decode_png(Path(path).read_bytes())


def _jpeg_call(fn_name: str, data: bytes, out: np.ndarray) -> None:
    """Call the compiled JPEG helper's jpeg_header (out: int32 dims) or
    jpeg_decode (out: the image); raise JPEGError with its message."""
    from view_neti_tpu_torch.ops import build
    fn = getattr(build.host_library("jpeg_decode"), fn_name)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_char_p, ctypes.c_int64]
    fn.restype = ctypes.c_int
    err = ctypes.create_string_buffer(256)
    if fn(data, len(data), out.ctypes.data, err, len(err)):
        raise JPEGError(err.value.decode())


def _jpeg_dims(data: bytes) -> Tuple[int, int, int]:
    """(height, width, channels) from the JPEG's headers."""
    dims = np.zeros(3, np.int32)
    _jpeg_call("jpeg_header", data, dims)
    return int(dims[0]), int(dims[1]), int(dims[2])


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 of a JPEG, C 1 (gray) or 3 (RGB, from YCbCr, RGB,
    CMYK or YCCK), by the compiled helper."""
    out = np.empty(_jpeg_dims(data), np.uint8)
    _jpeg_call("jpeg_decode", data, out)
    return out


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 from a four-component JPEG's stored samples
    (..., 4), as the compiled decoder converts them: Pillow's inverted
    CMYK ("CMYK;I") and its CMYK->RGB."""
    from view_neti_tpu_torch.ops import build
    cmyk = np.ascontiguousarray(cmyk, np.uint8)
    out = np.empty(cmyk.shape[:-1] + (3,), np.uint8)
    fn = build.host_library("jpeg_decode").jpeg_cmyk_to_rgb
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    fn.restype = None
    fn(cmyk.ctypes.data, out.ctypes.data, cmyk.size // 4)
    return out


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 as PIL's convert("RGB") gives it: gray replicated,
    alpha dropped."""
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_rgb(path: Union[str, Path]) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG or a JPEG, chosen by the file's first
    bytes, not its suffix."""
    data = Path(path).read_bytes()
    try:
        if data[:8] == SIGNATURE:
            return to_rgb(_decode_png(data))
        if data[:2] == b"\xff\xd8":
            return to_rgb(decode_jpeg(data))
        raise ImageError("neither a PNG nor a JPEG file")
    except ImageError as e:
        raise type(e)(f"{path}: {e}") from None
    except zlib.error as e:
        raise PNGError(f"{path}: corrupt PNG data ({e})") from None


def image_size(path: Union[str, Path]) -> Tuple[int, int]:
    """(height, width) of a PNG or a JPEG from its header alone."""
    data = Path(path).read_bytes()
    if data[:8] == SIGNATURE:
        width, height = struct.unpack(">II", data[16:24])
        return height, width
    if data[:2] == b"\xff\xd8":
        try:
            return _jpeg_dims(data)[:2]
        except JPEGError as e:
            raise JPEGError(f"{path}: {e}") from None
    raise ImageError(f"{path}: neither a PNG nor a JPEG file")


def filter_rows(img: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """The filtered rows (H, 1 + W * C) of img (H, W, C) uint8, row y with
    filter kinds[y] (0-4). Filtering reads only the raw image, so each
    filter runs at once on all the rows that use it (in int16, wide
    enough for every predictor)."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int16)
    kinds = np.asarray(kinds, np.int64)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    out = np.empty((H, 1 + W * C), np.uint8)
    out[:, 0] = kinds
    for kind in range(len(FILTERS)):
        rows = np.flatnonzero(kinds == kind)
        if not rows.size:
            continue
        cur, b = x[rows], up[rows]
        a = np.zeros_like(cur)
        a[:, C:] = cur[:, :-C]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            c = np.zeros_like(cur)
            c[:, C:] = b[:, :-C]
            pred = _paeth(a, b, c)
        out[rows, 1:] = (cur - pred) & 0xFF
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray,
               filters: Optional[Union[int, Sequence[int]]] = None
               ) -> bytes:
    """PNG bytes of img (H, W) or (H, W, C) uint8, C in 1-4. filters: one
    filter type for every row, a sequence of one per row, or None for
    cycling through all five."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PNGError("write_png takes uint8 images")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in COLOR_TYPE:
        raise PNGError(f"{C} channels")
    if filters is None:
        kinds = np.arange(H) % len(FILTERS)
    elif isinstance(filters, int):
        kinds = np.full(H, filters)
    else:
        kinds = np.asarray(filters)
    rows = filter_rows(img, kinds)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, COLOR_TYPE[C], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Optional[Union[int, Sequence[int]]] = None) -> None:
    Path(path).write_bytes(encode_png(img, filters))


# PIL's resampling arithmetic (Pillow's libImaging/Resample.c): weights
# normalised in float64, quantised to PRECISION_BITS, a 32-bit accumulator
# rounded half up and clipped to uint8 after each of the two passes
# (horizontal first)
PRECISION_BITS = 22
_SUPPORT = {"bicubic": 2.0, "bilinear": 1.0}


def _kernel(mode: str, x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    if mode == "bilinear":
        return np.where(x < 1.0, 1.0 - x, 0.0)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_rows(x: torch.Tensor, out_size: int, mode: str
                   ) -> torch.Tensor:
    """x (N, M) int32 -> (out_size, M): each output row a weighted sum of
    the input rows under the (widened, when reducing) kernel."""
    n = x.shape[0]
    scale = n / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[mode] * filterscale
    taps = np.arange(int(np.ceil(support)) * 2 + 1)
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n) - xmin
    w = _kernel(mode, (taps[None] + xmin[:, None] - center[:, None] + 0.5)
                / filterscale)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = w.sum(1, keepdims=True)
    w = w / np.where(total != 0, total, 1.0)
    k = np.where(w < 0, -0.5 + w * (1 << PRECISION_BITS),
                 0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)
    idx = torch.from_numpy(np.minimum(xmin[:, None] + taps[None], n - 1))
    k = torch.from_numpy(k)
    acc = torch.full((out_size, x.shape[1]), 1 << (PRECISION_BITS - 1),
                     dtype=torch.int32)
    for t in range(len(taps)):
        acc += x.index_select(0, idx[:, t]) * k[:, t, None]
    return torch.clamp(acc >> PRECISION_BITS, 0, 255)


def resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8 by antialiased bicubic
    interpolation on the CPU, rounded and clamped."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=(height, width), mode="bicubic",
                      antialias=True, align_corners=False)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def resize_pil(img: np.ndarray, width: int, height: int,
               mode: str = "bicubic") -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as PIL's
    Image.resize((width, height), BICUBIC or BILINEAR) computes it, to the
    bit: the same weights, fixed-point sums and per-pass rounding."""
    H, W, C = img.shape
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    if W != width:
        x = _resample_rows(x.permute(1, 0, 2).reshape(W, H * C), width,
                           mode).reshape(width, H, C).permute(1, 0, 2)
    if H != height:
        x = _resample_rows(x.reshape(H, width * C), height,
                           mode).reshape(height, width, C)
    return x.to(torch.uint8).contiguous().numpy()
