"""Writers of arithmetic-coded and lossless JPEG, and the fixtures of both
(make_fixtures.py calls `fixtures` and adds them to its manifest).

Pillow writes neither kind. `arith_bytes` compiles arith_writer.c against
the system libjpeg with gcc (into a temporary directory, once a process)
and runs it; the fixtures it writes are committed, so reading them needs
neither. `lossless_bytes` writes lossless JPEG (ITU-T T.81 Annex H,
SOF3) with numpy: the point transform, the seven predictors (the first
row of each restart interval from the left, starting at 2^(P - Pt - 1),
the first column from above), differences modulo 2^16, one Huffman table
of the difference categories (0-16, 16 meaning 32768 without extra bits)
optimised as libjpeg optimises its tables, interleaved or one scan per
component, restart intervals, and the colour markings (JFIF, Adobe APP14,
component ids).
"""
import functools
import heapq
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


# ------------------------------------------------------- arithmetic ----

@functools.lru_cache(maxsize=None)
def _writer() -> str:
    out = Path(tempfile.mkdtemp(prefix="arith_writer_")) / "arith_writer"
    subprocess.run(["gcc", "-O2", "-o", str(out), str(HERE / "arith_writer.c"),
                    "-ljpeg"], check=True)
    return str(out)


def arith_bytes(img: np.ndarray, sampling=(2, 2), quality: int = 90,
                progressive: bool = False, restart: int = 0,
                dac=(0, 1, 5)) -> bytes:
    """An arithmetic-coded JPEG of img ((h, w, 3) RGB or (h, w) gray):
    luma sampling (h, v) with 1x1 chroma, SOF10 with libjpeg's simple
    progression when `progressive`, a restart interval in MCUs, and the
    DC conditioning L, U and the AC conditioning Kx of every table."""
    img = np.ascontiguousarray(img, np.uint8)
    nc = 1 if img.ndim == 2 else img.shape[2]
    args = [img.shape[1], img.shape[0], nc, *sampling, quality,
            int(progressive), restart, *dac]
    return subprocess.run([_writer(), *map(str, args)], input=img.tobytes(),
                          capture_output=True, check=True).stdout


# --------------------------------------------------------- lossless ----

def optimal_table(freq):
    """(bits[1..16], values) of libjpeg's jpeg_gen_optimal_table for the
    symbol counts freq (a reserved code keeps every code from being all
    ones; lengths are limited to 16 as in T.81 K.2)."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1
    codesize, others = [0] * 257, [-1] * 257
    heap = [(f, -i) for i, f in enumerate(freq) if f]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, c1 = heapq.heappop(heap)
        f2, c2 = heapq.heappop(heap)
        c1, c2 = -c1, -c2
        heapq.heappush(heap, (f1 + f2, -c1))
        for c in (c1, c2):
            codesize[c] += 1
            while others[c] >= 0:
                c = others[c]
                codesize[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    values = [j for size in range(1, 33) for j in range(256)
              if codesize[j] == size]
    return bits[1:17], values


def predict(R: np.ndarray, psv: int, pt: int, first_rows: np.ndarray,
            precision: int = 8) -> np.ndarray:
    """The prediction of every sample of the plane R (int64, reconstructed
    values): a first row (row 0 and the first row of a restart interval)
    from the left, its first sample 2^(P - Pt - 1); the first column from
    above; the rest by predictor psv."""
    P = np.empty_like(R)
    Ra = np.zeros_like(R)
    Ra[:, 1:] = R[:, :-1]
    Rb = np.zeros_like(R)
    Rb[1:] = R[:-1]
    Rc = np.zeros_like(R)
    Rc[1:, 1:] = R[:-1, :-1]
    P[:] = {1: Ra, 2: Rb, 3: Rc, 4: Ra + Rb - Rc, 5: Ra + ((Rb - Rc) >> 1),
            6: Rb + ((Ra - Rc) >> 1), 7: (Ra + Rb) >> 1}[psv]
    P[:, 0] = Rb[:, 0]
    P[first_rows] = Ra[first_rows]
    P[first_rows, 0] = 1 << (precision - pt - 1)
    return P


def _bits_of(diff: np.ndarray):
    """The category and extra bits of each difference (modulo 2^16)."""
    d = diff.astype(np.int64)
    d = np.where(d >= 32768, d - 65536, d)
    s = np.where(d == -32768, 16, np.frexp(np.abs(d))[1]).astype(np.int64)
    extra = np.where(d >= 0, d, d + (1 << np.minimum(s, 15)) - 1)
    extra = np.where(s == 16, 0, extra) & ((1 << np.minimum(s, 15)) - 1)
    return s, np.where(s == 16, 0, s), extra


def _pack(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bit strings (value, length <= 32) in order, padded with 1-bits
    to a byte and byte-stuffed."""
    if len(codes) == 0:
        return b""
    shifts = np.arange(31, -1, -1, dtype=np.uint64)
    bits = (codes.astype(np.uint64)[:, None] >> shifts) & 1
    keep = np.arange(32)[None, :] >= (32 - lengths)[:, None]
    flat = bits[keep].astype(np.uint8)
    flat = np.concatenate([flat, np.ones((-len(flat)) % 8, np.uint8)])
    data = np.packbits(flat)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def lossless_bytes(planes, psv: int, pt: int = 0, ids=None, sampling=None,
                   jfif: bool = False, adobe=None, restart: int = 0,
                   separate_scans: bool = False, inject=(), size=None,
                   precision: int = 8) -> bytes:
    """A lossless JPEG (SOF3) of `planes`: an (h, w) gray or (h, w, c)
    image, or a list of component planes with `sampling` [(h, v), ...] at
    their downsampled sizes. psv: the predictor (1-7); pt: the point
    transform; ids: the component ids (1, 2, 3... by default); jfif: an
    APP0 JFIF segment; adobe: the Adobe APP14 transform (None: no APP14);
    restart: the restart interval in MCUs; separate_scans: one scan per
    component; inject: (component, y, x) samples whose reconstruction is
    moved by 32768 (a difference of category 16); size: the image's
    (height, width) when the first component is subsampled."""
    if isinstance(planes, np.ndarray):
        img = planes if planes.ndim == 3 else planes[..., None]
        planes = [img[..., i] for i in range(img.shape[2])]
        sampling = [(1, 1)] * len(planes)
    nc = len(planes)
    ids = list(ids or range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = size or (planes[0].shape[0] * vmax // sampling[0][1],
                             planes[0].shape[1] * hmax // sampling[0][0])
    # each component's reconstructed values and differences
    recon = []
    for ci, p in enumerate(planes):
        R = (p.astype(np.int64) >> pt)
        for c, y, x in inject:
            if c == ci:
                R[y, x] = (R[y, x] + 32768) & 0xFFFF
        recon.append(R)

    def scan(comps):
        """The differences of one scan over comps in MCU order, a row of
        MCUs a row, as (shape, categories, extra bit counts, extra bits,
        MCU rows a restart interval)."""
        if len(comps) == 1:      # an MCU is one sample
            mcus_y, mcus_x = planes[comps[0]].shape
        else:
            mcus_x = -(-width // hmax)
            mcus_y = -(-height // vmax)
        if restart:
            assert restart % mcus_x == 0, "restarts split an MCU row"
        rows_per = restart // mcus_x
        order_s = []
        for ci in comps:
            h, v = sampling[ci] if len(comps) > 1 else (1, 1)
            R = recon[ci]
            first = np.zeros(R.shape[0], bool)
            first[0] = True
            if rows_per:
                first[::rows_per * v] = True
            diff = (R - predict(R, psv, pt, first, precision)) & 0xFFFF
            # pad to the MCU grid with zero differences
            full = np.zeros((mcus_y * v, mcus_x * h), np.int64)
            full[:diff.shape[0], :diff.shape[1]] = diff
            # (mcu_y, mcu_x, v, h) in MCU order
            blk = full.reshape(mcus_y, v, mcus_x, h).transpose(0, 2, 1, 3)
            order_s.append(blk.reshape(mcus_y, mcus_x, v * h))
        diffs = np.concatenate(order_s, axis=2).reshape(mcus_y, -1)
        cats, nbits, extra = _bits_of(diffs)
        return diffs.shape, cats, nbits, extra, rows_per

    scans = ([[ci] for ci in range(nc)] if separate_scans or nc == 1
             else [list(range(nc))])
    coded = [scan(s) for s in scans]
    freq = np.bincount(np.concatenate([c[1].ravel() for c in coded]),
                       minlength=17)
    bits, values = optimal_table(freq.tolist())
    # canonical codes of the table
    code_of, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    code_arr = np.array([code_of.get(s, (0, 0))[0] for s in range(17)],
                        np.uint64)
    len_arr = np.array([code_of.get(s, (0, 0))[1] for s in range(17)],
                       np.int64)
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                      adobe))
    out += _segment(0xC3, struct.pack(">BHHB", precision, height, width, nc)
                    + b"".join(struct.pack(">BBB", ids[i], (h << 4) | v, 0)
                               for i, (h, v) in enumerate(sampling)))
    out += _segment(0xC4, bytes([0x00]) + bytes(bits) + bytes(values))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for comps, (shape, cats, nbits, extra, rows_per) in zip(scans, coded):
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0x00]) for ci in comps) + bytes([psv, 0, pt]))
        value = (code_arr[cats] << nbits.astype(np.uint64)) | extra.astype(
            np.uint64)
        length = len_arr[cats] + nbits
        step = rows_per or shape[0]
        for n, r0 in enumerate(range(0, shape[0], step)):
            if n:
                out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            out += _pack(value[r0:r0 + step].ravel(),
                         length[r0:r0 + step].ravel())
    return out + b"\xff\xd9"


# --------------------------------------------------------- fixtures ----

SMALL = (37, 45)                 # (height, width) of the small fixtures
SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def fixtures(view) -> dict:
    """The fixtures by path under tests/data/formats/: view(i, h, w) is
    tests/data/jpeg/make_fixtures.py's synthetic view.

    teapot/view_10_arith.jpg          arithmetic sequential 4:2:0
    teapot/view_11_arith_prog.jpg     arithmetic progressive 4:4:4, a
                                      restart every 32 MCUs
    teapot/view_12_lossless_rgb.jpg   lossless RGB (Adobe transform 0),
                                      predictor 1
    teapot/view_13_lossless_gray.jpg  lossless gray, predictor 7, Pt 1
    arith/{seq,prog}_{444,422,420,gray}[_rst].jpg  45x37, without and with
                                      a restart every 2 MCUs
    arith/{seq,prog}_dac.jpg          4:2:0 with DC conditioning L = 2,
                                      U = 5 and AC Kx = 12, restarts
    lossless/rgb_p{1-7}.jpg           45x37, predictor 1-7, Pt = psv % 3,
                                      marked RGB by Adobe transform 0 (odd
                                      predictors) or by no marker
    lossless/gray_p{1-7}.jpg          Pt = (psv + 1) % 3, a JFIF marker
                                      on the odd predictors
    lossless/rgb_rst_separate.jpg     one scan per component, predictor
                                      4, a restart every 2 rows
    """
    from PIL import Image
    h, w = SMALL
    out = {
        "teapot/view_10_arith.jpg": arith_bytes(view(10), (2, 2), 90),
        "teapot/view_11_arith_prog.jpg": arith_bytes(
            view(11), (1, 1), 90, progressive=True, restart=32),
        "teapot/view_12_lossless_rgb.jpg": lossless_bytes(view(12), 1,
                                                          adobe=0),
        "teapot/view_13_lossless_gray.jpg": lossless_bytes(np.asarray(
            Image.fromarray(view(13)).convert("L")), 7, pt=1),
    }
    img = view(14, h, w)
    for prog in (False, True):
        kind = "prog" if prog else "seq"
        for name, sampling in [*SAMPLINGS.items(), ("gray", (1, 1))]:
            src = img[..., 1] if name == "gray" else img
            for rst in (0, 2):
                out[f"arith/{kind}_{name}{'_rst' if rst else ''}.jpg"] = (
                    arith_bytes(src, sampling, 85, prog, rst))
        out[f"arith/{kind}_dac.jpg"] = arith_bytes(img, (2, 2), 85, prog, 3,
                                                   dac=(2, 5, 12))
    for psv in range(1, 8):
        out[f"lossless/rgb_p{psv}.jpg"] = lossless_bytes(
            view(15 + psv, h, w), psv, pt=psv % 3,
            adobe=0 if psv % 2 else None)
        out[f"lossless/gray_p{psv}.jpg"] = lossless_bytes(
            view(15 + psv, h, w)[..., 0], psv, pt=(psv + 1) % 3,
            jfif=bool(psv % 2))
    out["lossless/rgb_rst_separate.jpg"] = lossless_bytes(
        view(23, h, w), 4, adobe=0, restart=2 * w, separate_scans=True)
    return out
