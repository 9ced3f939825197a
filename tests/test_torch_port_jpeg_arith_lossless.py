"""The port's arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG
decoding (csrc/jpeg_decode.cpp through data/image_io.py) against Pillow's
Image.open(p).convert("RGB"), with a limit of 0 levels: sequential and
progressive arithmetic coding at every sampling, with restarts and with
DAC conditioning; lossless files of all seven predictors and point
transforms 0-2, gray, RGB and CMYK, one scan or one per component,
subsampled, with restarts and with a difference of category 16; corrupt
and truncated data, files without an EOI, and the files Pillow refuses,
refused with the file and the fault named. The writers are
tests/data/formats/make_arith_lossless.py's (the arithmetic one compiles
arith_writer.c against the system libjpeg)."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from view_neti_tpu_torch.data import image_io

MAX_LEVELS = 0          # every decode equals Pillow's
FORMATS = Path(__file__).resolve().parent / "data" / "formats"
_spec = importlib.util.spec_from_file_location(
    "arith_lossless", FORMATS / "make_arith_lossless.py")
al = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(al)

SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "gray": (1, 1)}


def textured(h, w, seed):
    """Waves, a gradient and noise: AC energy in every block."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + seed),
                    128 + 100 * np.cos(y / 5.0), (x * 3 + y * 2) % 256], -1)
    return np.clip(img + r.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def write(tmp_path, data, name="x.jpg"):
    p = tmp_path / name
    p.write_bytes(data)
    return p


def assert_like_pil(path):
    want = np.asarray(Image.open(path).convert("RGB")).astype(int)
    got = image_io.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= MAX_LEVELS
    assert image_io.image_size(path) == want.shape[:2]
    return got


def pil_outcome(path):
    """Pillow's decode of the file, or None where it raises."""
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except (OSError, SyntaxError, ValueError):
        return None


def assert_same_outcome(path, words=("truncated", "corrupt")):
    """The port decodes the file as Pillow does, or refuses it where
    Pillow does, naming the file and the fault."""
    want = pil_outcome(path)
    if want is None:
        with pytest.raises(image_io.ImageError) as err:
            image_io.read_rgb(path)
        assert str(path) in str(err.value)
        assert any(w in str(err.value) for w in words), str(err.value)
        return False
    np.testing.assert_array_equal(image_io.read_rgb(path), want)
    return True


def arith_image(sampling, hw, seed):
    img = textured(*hw, seed)
    return img[..., 1] if sampling == "gray" else img


# ------------------------------------------------------- arithmetic ----

@pytest.mark.parametrize("restart", [0, 2], ids=["no_rst", "rst2"])
@pytest.mark.parametrize("progressive", [False, True], ids=["seq", "prog"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_arithmetic(tmp_path, sampling, progressive, restart):
    """SOF9 and SOF10 (libjpeg's progression: DC first and refinement,
    spectral bands, AC refinement) at an odd, a small and a 1x1 size, with
    and without a restart every 2 MCUs (statistics, coder and DC
    predictions reset)."""
    for hw in ((37, 45), (9, 17), (1, 1)):
        data = al.arith_bytes(arith_image(sampling, hw, sum(hw)),
                              SAMPLINGS[sampling], 80, progressive, restart)
        assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
        assert b"\xff\xcc" in data and (b"\xff\xdd" in data) == bool(restart)
        assert_like_pil(write(tmp_path, data))


@pytest.mark.parametrize("dac", [(0, 0, 1), (1, 1, 0), (2, 5, 12),
                                 (0, 15, 63), (5, 9, 40)],
                         ids=lambda d: "L{}_U{}_K{}".format(*d))
def test_arithmetic_conditioning(tmp_path, dac):
    """DAC segments with other DC conditioning bounds (L, U) and AC
    split points (Kx) than the defaults 0, 1, 5, sequential and
    progressive."""
    img = textured(40, 56, sum(dac))
    for progressive in (False, True):
        assert_like_pil(write(tmp_path, al.arith_bytes(
            img, (2, 2), 90, progressive, 0, dac=dac)))


@pytest.mark.parametrize("quality", [5, 50, 100])
def test_arithmetic_quality(tmp_path, quality):
    """Coarse and fine quantisation: long runs of zeros, and large
    magnitudes through the X2.. magnitude bins."""
    for progressive in (False, True):
        assert_like_pil(write(tmp_path, al.arith_bytes(
            textured(48, 64, quality), (2, 2), quality, progressive)))


def test_arithmetic_file_larger_than_pillows_read_block(tmp_path):
    """Pillow feeds libjpeg 64 KiB at a time, and libjpeg's arithmetic
    decoder cannot wait for more input, so Pillow refuses a larger
    arithmetic-coded file; read whole (a larger decodermaxblock), it
    decodes, and the port gives that decode."""
    img = np.random.RandomState(3).randint(0, 256, (300, 300, 3)).astype(
        np.uint8)
    p = write(tmp_path, al.arith_bytes(img, (1, 1), 95))
    assert p.stat().st_size > 65536
    assert pil_outcome(p) is None
    im = Image.open(p)
    im.decodermaxblock = p.stat().st_size + 1
    np.testing.assert_array_equal(image_io.read_rgb(p),
                                  np.asarray(im.convert("RGB")))


def _pil_c_idct(paths):
    """Pillow's decode of each file in a fresh process with libjpeg-turbo's
    SIMD disabled (JSIMD_FORCENONE=1): libjpeg's C arithmetic, which the
    port follows, where its 16-bit SIMD IDCT wraps on the out-of-range
    coefficients of corrupt data. {path: array or None}."""
    code = (
        "import json, sys, numpy as np\n"
        "from PIL import Image\n"
        "out = {}\n"
        "for p in json.loads(sys.argv[1]):\n"
        "    try:\n"
        "        np.save(p + '.npy', np.asarray(Image.open(p).convert("
        "'RGB')))\n"
        "        out[p] = True\n"
        "    except (OSError, SyntaxError, ValueError):\n"
        "        out[p] = False\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, JSIMD_FORCENONE="1")
    res = subprocess.run([sys.executable, "-c", code,
                          json.dumps([str(p) for p in paths])],
                         capture_output=True, text=True, env=env, check=True)
    done = json.loads(res.stdout.strip().splitlines()[-1])
    return {p: np.load(f"{p}.npy") if done[str(p)] else None for p in paths}


@pytest.mark.parametrize("progressive", [False, True], ids=["seq", "prog"])
@pytest.mark.parametrize("coding", ["arithmetic", "huffman"])
def test_corrupt_entropy_coded_data(tmp_path, coding, progressive):
    """One byte of the entropy-coded data changed, 40 ways, with a restart
    every 2 MCUs. Arithmetic: a bad code (a magnitude past 2^15 or a run
    past the band) stops its restart interval's decoding. Huffman: a code
    no table holds decodes as 0, and once a marker cuts the data the rest
    of the interval's MCUs are left as they are. libjpeg only warns about
    either; the port gives libjpeg's image, or refuses where Pillow
    does."""
    img = textured(37, 45, 11)
    if coding == "arithmetic":
        data = al.arith_bytes(img, (2, 2), 85, progressive, 2)
    else:
        src = tmp_path / "src.jpg"
        Image.fromarray(img).save(src, "JPEG", quality=85, subsampling=2,
                                  progressive=progressive,
                                  restart_marker_blocks=2)
        data = src.read_bytes()
    rng = np.random.RandomState(int(progressive))
    paths = []
    first = data.index(b"\xff\xda")
    while len(paths) < 40:
        i = rng.randint(first + 14, len(data) - 2)
        v = rng.randint(0, 255)
        if 0xFF in (data[i - 1], data[i], v):
            continue
        paths.append(write(tmp_path, data[:i] + bytes([v]) + data[i + 1:],
                           f"c{len(paths)}.jpg"))
    want = _pil_c_idct(paths)
    decoded = 0
    for p in paths:
        if want[p] is None:
            with pytest.raises(image_io.ImageError) as err:
                image_io.read_rgb(p)
            assert str(p) in str(err.value)
        else:
            np.testing.assert_array_equal(image_io.read_rgb(p), want[p])
            decoded += 1
    assert decoded >= 20


@pytest.mark.parametrize("progressive", [False, True], ids=["seq", "prog"])
def test_truncated_arithmetic_data(tmp_path, progressive):
    """Cut inside the first scan, in the middle, before the EOI and
    inside it: Pillow raises, and the port refuses, naming the file."""
    data = al.arith_bytes(textured(37, 45, 12), (2, 2), 85, progressive, 2)
    first = data.index(b"\xff\xda")
    for cut in (first + 20, len(data) // 2, len(data) - 2, len(data) - 1):
        assert not assert_same_outcome(write(tmp_path, data[:cut]))


# --------------------------------------------------------- lossless ----

@pytest.mark.parametrize("pt", [0, 1, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless(tmp_path, psv, pt):
    """Every predictor and point transform: RGB marked by an Adobe
    transform 0, by the ids 'R', 'G', 'B' and by no marker at all
    (libjpeg-turbo takes an unmarked lossless file as RGB), and gray; with
    a restart every 2 rows on some (each interval's first row predicted
    from the left again). The samples come back shifted left by Pt."""
    img = textured(37, 45, 7 * psv + pt)
    for kw in (dict(adobe=0), dict(ids=(82, 71, 66), restart=90), {}):
        got = assert_like_pil(write(tmp_path, al.lossless_bytes(
            img, psv, pt, **kw)))
        np.testing.assert_array_equal(got, (img >> pt) << pt)
    gray = img[..., 0]
    for kw in (dict(jfif=True), dict(restart=90)):
        got = assert_like_pil(write(tmp_path, al.lossless_bytes(
            gray, psv, pt, **kw)))
        np.testing.assert_array_equal(got[..., 0], (gray >> pt) << pt)


def _subsampled(sampling, hw, seed):
    rng = np.random.RandomState(seed)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return [rng.randint(0, 256, (-(-hw[0] * v // vmax),
                                 -(-hw[1] * h // hmax))).astype(np.uint8)
            for h, v in sampling]


LAYOUTS = {
    "separate_scans": dict(separate_scans=True),
    "separate_scans_rst": dict(separate_scans=True, restart=45),
    "cmyk": dict(cmyk=True, adobe=0),
    "cmyk_unmarked": dict(cmyk=True),
    "category_16": dict(inject=[(0, 3, 4), (2, 0, 0), (1, 36, 44)]),
    "category_16_pt2": dict(inject=[(1, 5, 0)], pt=2, restart=45),
    "h2v2_chroma_1x1": dict(sampling=[(2, 2), (1, 1), (1, 1)]),
    "h2v1_chroma_1x1": dict(sampling=[(2, 1), (1, 1), (1, 1)]),
    "h1v2_chroma_1x1": dict(sampling=[(1, 2), (1, 1), (1, 1)]),
    "h2v2_green": dict(sampling=[(1, 1), (2, 2), (1, 1)], restart=23),
    "gray_h2v2": dict(sampling=[(2, 2)]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lossless_layouts(tmp_path, layout):
    """One scan per component (with restarts), CMYK (Pillow's inverted
    CMYK and CMYK->RGB), differences of category 16 (32768 with no extra
    bits: the reconstruction wraps modulo 2^16 and the samples keep its
    low 8 bits), and subsampled components, upsampled by replication."""
    kw = dict(LAYOUTS[layout])
    psv, pt = 6, kw.pop("pt", 0)
    if kw.pop("cmyk", False):
        img = np.concatenate([textured(37, 45, 1), textured(37, 45, 2)[
            ..., :1]], -1)
        assert_like_pil(write(tmp_path, al.lossless_bytes(img, psv, pt,
                                                          **kw)))
        return
    if "sampling" in kw:
        planes = _subsampled(kw["sampling"], (37, 45), len(layout))
        data = al.lossless_bytes(planes, psv, pt, size=(37, 45), adobe=0,
                                 **kw)
    else:
        data = al.lossless_bytes(textured(37, 45, 3), psv, pt, adobe=0, **kw)
    assert_like_pil(write(tmp_path, data))


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def _refused_cases():
    img = textured(37, 45, 5)
    rgb = al.lossless_bytes(img, 1, adobe=0, restart=90)
    gray = al.lossless_bytes(img[..., 0], 1)
    cmyk = np.concatenate([img, img[..., :1]], -1)
    return {
        "ycbcr_jfif": (al.lossless_bytes(img, 1, jfif=True), "YCbCr"),
        "ycbcr_adobe1": (al.lossless_bytes(img, 1, adobe=1), "YCbCr"),
        "ycck": (al.lossless_bytes(cmyk, 1, adobe=2), "YCCK"),
        # a restart every 20 MCUs, where a row holds 45
        "restart_splits_a_row": (_patched(rgb, b"\xff\xdd", 5, 20),
                                 "restart interval"),
        "predictor_0": (_patched(gray, b"\xff\xda", 7, 0), "lossless scan"),
        "predictor_8": (_patched(gray, b"\xff\xda", 7, 8), "lossless scan"),
        "point_transform_8": (_patched(gray, b"\xff\xda", 9, 8),
                              "lossless scan"),
        "precision_12": (_patched(gray, b"\xff\xc3", 4, 12), "12-bit"),
        "lossless_arithmetic": (_patched(gray, b"\xff\xc3", 1, 0xCB),
                                "lossless arithmetic"),
        "category_17_table": (_patched(gray, b"\xff\xc4", 21, 17),
                              "category above 16"),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_lossless_files_pillow_refuses(tmp_path, case):
    """Lossless files marked YCbCr or YCCK (libjpeg-turbo converts no
    lossless data), a restart interval that splits a row of MCUs, scan
    parameters out of range, other precisions than 8 bits, SOF11 and a
    table of categories past 16: Pillow raises, and the port refuses,
    naming the file and the fault."""
    data, words = _refused_cases()[case]
    p = write(tmp_path, data)
    assert pil_outcome(p) is None
    with pytest.raises(image_io.ImageError) as err:
        image_io.read_rgb(p)
    assert str(p) in str(err.value) and words in str(err.value), str(
        err.value)


@pytest.mark.parametrize("separate", [False, True], ids=["one_scan",
                                                         "three_scans"])
def test_truncated_and_corrupt_lossless_data(tmp_path, separate):
    """Cut at 25 places (mid-data, at the EOI, inside it) and one byte
    changed 25 ways: the port follows libjpeg's reading step for step, so
    it refuses where Pillow raises (data that ends before a marker, which
    libjpeg's lookahead of 57 bits reaches) and otherwise gives Pillow's
    image (after a cut by a marker, zero differences from restarted
    predictors; a code no table holds, 0)."""
    img = textured(37, 45, 9)
    data = al.lossless_bytes(img, 4, adobe=0, restart=90,
                             separate_scans=separate)
    rng = np.random.RandomState(int(separate))
    first = data.index(b"\xff\xda")
    cuts = sorted(set(rng.randint(first + 10, len(data), 22).tolist()
                      + [len(data) - 3, len(data) - 2, len(data) - 1]))
    outcomes = [assert_same_outcome(write(tmp_path, data[:c], f"t{c}.jpg"))
                for c in cuts]
    assert not all(outcomes)
    changed = 0
    while changed < 25:
        i = rng.randint(first + 12, len(data) - 2)
        v = rng.randint(0, 255)
        if 0xFF in (data[i - 1], data[i], v):
            continue
        assert_same_outcome(write(tmp_path, data[:i] + bytes([v])
                                  + data[i + 1:], f"c{changed}.jpg"))
        changed += 1


@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic",
                                  "lossless"])
def test_files_without_an_eoi(tmp_path, kind):
    """The EOI cut off, or its last byte: a progressive file is read to
    its EOI before any row comes out, so Pillow raises; a file of one
    scan raises where libjpeg's lookahead runs out of data before the
    scan ends. The port does the same, on 12 images of random sizes."""
    rng = np.random.RandomState(len(kind))
    for t in range(12):
        h, w = rng.randint(8, 60, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if kind == "lossless":
            data = al.lossless_bytes(img, 1 + t % 7, adobe=0)
        elif kind == "arithmetic":
            data = al.arith_bytes(img, (2, 2), 70, bool(t % 2))
        else:
            p = tmp_path / "src.jpg"
            Image.fromarray(img).save(p, "JPEG", quality=int(30 + 5 * t),
                                      progressive=kind == "progressive")
            data = p.read_bytes()
        for cut in (1, 2):
            assert_same_outcome(write(tmp_path, data[:-cut], f"{t}_{cut}.jpg"))
