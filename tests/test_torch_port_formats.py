"""The port's image reader (data/image_io.py, csrc/jpeg_decode.cpp and
csrc/png_unfilter.cpp) on every PNG and JPEG format PIL opens, against
PIL's Image.open(p).convert("RGB"), bit for bit: progressive JPEG at every
sampling with and without restarts, CMYK and YCCK, libjpeg's block
smoothing on every cut of a scan script, a second image after the first
EOI; Adam7 PNG at every color type and bit depth down to 1x1, 16-bit and
low-bit PNG; image_size on each; the committed fixtures (arithmetic-coded
and lossless JPEG among them) against their manifest; and the mode-0
dataset on a folder of mixed formats against the JAX package's."""
import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from view_neti_tpu.data import dataset as jdataset
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok

from view_neti_tpu_torch.data import dataset as tdataset
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.tokenizer import FallbackTokenizer as TTok

DATA = Path(__file__).resolve().parent / "data"
FORMATS = DATA / "formats"
_spec = importlib.util.spec_from_file_location(
    "formats_fixtures", FORMATS / "make_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


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
    want = np.asarray(Image.open(path).convert("RGB"))
    got = image_io.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_io.image_size(path) == want.shape[:2]
    return got


def pil_image(img, sampling):
    if sampling == "gray":
        return Image.fromarray(img[..., 0]), {}
    return Image.fromarray(img), {"subsampling": {"444": 0, "422": 1,
                                                  "420": 2}[sampling]}


# -------------------------------------------------------------- JPEG ----

@pytest.mark.parametrize("restarts", [0, 2], ids=["no_rst", "rst2"])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_progressive(tmp_path, sampling, restarts):
    """Pillow's progressive script (DC first and refinement, spectral
    selection, AC first and refinement scans) at an odd and a tiny size;
    restarts every 2 MCUs (EOB runs and DC predictors reset)."""
    for hw in ((37, 45), (9, 17)):
        im, kw = pil_image(textured(*hw, sum(hw)), sampling)
        if restarts:
            kw["restart_marker_blocks"] = restarts
        data = fx.jpeg_bytes(im, quality=80, progressive=True, **kw)
        assert b"\xff\xc2" in data and (b"\xff\xdd" in data) == bool(
            restarts)
        assert_like_pil(write(tmp_path, data))


@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("kind", ["cmyk", "cmyk_no_app14", "ycck"])
def test_four_component(tmp_path, kind, progressive, subsampling):
    """CMYK as Pillow writes it (Adobe APP14, transform 0), without the
    APP14 (still CMYK) and patched to transform 2 (YCCK): libjpeg's
    conversion, Pillow's inverted CMYK and its CMYK->RGB."""
    im = Image.fromarray(textured(37, 45, 4)).convert("CMYK")
    data = fx.jpeg_bytes(im, quality=85, progressive=progressive,
                         subsampling=subsampling)
    if kind == "ycck":
        data = fx.as_ycck(data)
    elif kind == "cmyk_no_app14":
        i = data.index(b"\xff\xee")
        data = data[:i] + data[i + 2 + int.from_bytes(data[i + 2:i + 4],
                                                      "big"):]
        assert b"Adobe" not in data
    p = write(tmp_path, data)
    assert Image.open(p).mode == "CMYK"
    assert_like_pil(p)


def test_cmyk_to_rgb_is_pillows_for_every_c_and_k():
    """All 65,536 (c, k) pairs, a different c in each channel, through
    Image.frombytes("CMYK") and convert("RGB"): the decoder reads the
    stored samples as inverted CMYK, so it is given 255 - Pillow's."""
    c, k = np.meshgrid(np.arange(256), np.arange(256))
    pil = np.stack([c, 255 - c, (c * 7) % 256, k], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("CMYK", (256, 256),
                                      pil.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(image_io.cmyk_to_rgb(255 - pil), want)


@pytest.mark.parametrize("hw", [(40, 24), (17, 9), (96, 130)])
@pytest.mark.parametrize("sampling", ["420", "444", "gray", "cmyk"])
def test_block_smoothing_on_every_cut_of_the_scan_script(tmp_path,
                                                         sampling, hw):
    """The first k scans of a progressive file and an EOI, for every k:
    the DC or low AC coefficients stay unrefined, so libjpeg smooths
    (from the DC values alone while no AC scan has come); narrow
    components and a partial last iMCU row included."""
    img = textured(*hw, 5)
    if sampling == "cmyk":
        im, kw = Image.fromarray(img).convert("CMYK"), {}
    else:
        im, kw = pil_image(img, sampling)
    full = fx.jpeg_bytes(im, quality=75, progressive=True, **kw)
    n = full.count(b"\xff\xda")
    assert n >= 6
    for k in range(1, n):
        assert_like_pil(write(tmp_path, fx.first_scans(full, k)))


def test_block_smoothing_fixture():
    """The committed file of Pillow's first 5 scans: smoothed as libjpeg
    smooths it."""
    p = FORMATS / "smoothing_5scans.jpg"
    assert p.read_bytes().count(b"\xff\xda") == 5
    assert_like_pil(p)


def test_decoding_stops_at_the_first_eoi(tmp_path):
    """An MPO as Pillow writes it (two frames, named .jpg) and two JPEGs
    back to back: the first image, as PIL's convert("RGB") takes frame
    0."""
    a, b = textured(24, 32, 1), textured(24, 32, 2)[::-1]
    p = tmp_path / "phone.jpg"
    Image.fromarray(a).save(p, "MPO", save_all=True,
                            append_images=[Image.fromarray(b)])
    assert Image.open(p).format == "MPO" and Image.open(p).n_frames == 2
    assert_like_pil(p)
    first = fx.jpeg_bytes(Image.fromarray(a), quality=90, progressive=True)
    second = fx.jpeg_bytes(Image.fromarray(b), quality=90)
    q = write(tmp_path, first + second)
    np.testing.assert_array_equal(assert_like_pil(q),
                                  image_io.read_rgb(write(tmp_path, first,
                                                          "first.jpg")))


def without_dht(data: bytes) -> bytes:
    """The JPEG with its Huffman-table segments before the first scan
    removed, as a motion-JPEG frame comes."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + n]
        i += n
    return bytes(out + data[i:])


@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_standard_huffman_tables_when_a_file_has_none(tmp_path, sampling):
    """Pillow writes K.3's standard tables; without them in the file,
    libjpeg installs the same ones, and so does the port."""
    im, kw = pil_image(textured(37, 45, 6), sampling)
    data = fx.jpeg_bytes(im, quality=80, **kw)
    bare = without_dht(data)
    assert b"\xff\xc4" in data and b"\xff\xc4" not in bare
    np.testing.assert_array_equal(
        assert_like_pil(write(tmp_path, bare)),
        np.asarray(Image.open(write(tmp_path, data, "y.jpg")).convert("RGB")))


# --------------------------------------------------------------- PNG ----

ADAM7_FORMATS = ([(0, d) for d in (1, 2, 4, 8, 16)]
                 + [(t, d) for t in (4, 2, 6) for d in (8, 16)]
                 + [(3, d) for d in (1, 2, 4, 8)])


def samples_for(color, depth, hw, seed):
    """Random samples of the format, and a palette for color type 3; 16-bit
    gray has half its rows at or below 255 (PIL clips the rest)."""
    rng = np.random.RandomState(seed)
    c = fx.COLOR_CHANNELS[color]
    s = rng.randint(0, 1 << depth, hw + (c,))
    if color == 0 and depth == 16:
        s[::2] = rng.randint(0, 256, s[::2].shape)
    palette = (rng.randint(0, 256, (1 << depth, 3)) if color == 3
               else None)
    return s, palette


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 5), (9, 17), (37, 45)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("color,depth", ADAM7_FORMATS,
                         ids=[f"ct{t}_{d}bit" for t, d in ADAM7_FORMATS])
def test_adam7(tmp_path, color, depth, hw):
    """Adam7 at every color type and depth: seven passes, each filtered
    on its own (all five filters), empty passes without bytes, sub-byte
    rows packed per pass row. The non-interlaced file gives the same."""
    s, palette = samples_for(color, depth, hw, depth * 7 + color + hw[1])
    p = write(tmp_path, fx.png_bytes(s, color, depth, True, palette),
              "i.png")
    assert Image.open(p).info.get("interlace") == 1
    got = assert_like_pil(p)
    flat = write(tmp_path, fx.png_bytes(s, color, depth, False, palette),
                 "n.png")
    np.testing.assert_array_equal(image_io.read_rgb(flat), got)


@pytest.mark.parametrize("color", [0, 4, 2, 6],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_16_bit(tmp_path, color):
    """Gray clipped at 255 (2732 -> 255), the others' high byte."""
    s, _ = samples_for(color, 16, (23, 31), color)
    s[0, 0, 0] = 2732
    got = assert_like_pil(write(tmp_path, fx.png_bytes(s, color, 16),
                                "w.png"))
    first = s[..., :1] if color in (0, 4) else s[..., :3]
    want = np.minimum(first, 255) if color == 0 else first >> 8
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))
    if color == 0:
        assert got[0, 0, 0] == 255


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray(tmp_path, depth):
    """1, 2 and 4-bit gray scaled by 255, 85 and 17."""
    s, _ = samples_for(0, depth, (13, 29), depth)
    got = assert_like_pil(write(tmp_path, fx.png_bytes(s, 0, depth),
                                "g.png"))
    np.testing.assert_array_equal(
        got[..., 0], s[..., 0] * (255 // ((1 << depth) - 1)))


# ---------------------------------------------------------- fixtures ----

def _manifest():
    return json.loads((FORMATS / "manifest.json").read_text())


@pytest.mark.parametrize("rel", sorted(_manifest()))
def test_committed_fixtures(rel):
    """Each committed fixture decodes to the RGB image PIL gave when it was
    written (tests/data/formats/make_fixtures.py), and its header gives its
    size."""
    want = _manifest()[rel]
    got = image_io.read_rgb(FORMATS / rel)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256_rgb"]
    assert list(image_io.image_size(FORMATS / rel)) == want["shape"][:2]
    assert_like_pil(FORMATS / rel)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mode0_dataset_on_a_mixed_folder_equals_jax(tmp_path, one_thread):
    """The mode-0 training folder of the card's run (the five baseline
    JPEGs and one 512x512 view per other format: progressive, CMYK and
    YCCK JPEG, Adam7 and 16-bit PNG, arithmetic-coded sequential and
    progressive JPEG, lossless RGB and gray JPEG): the same files, captions
    and ids as the JAX TextualInversionDataset, every decode equal to
    PIL's, bases within one level of JAX's (the two packages' resizes
    differ by a level), and with JAX's bases in the port's cache every
    flipped example's pixels exactly."""
    folder = tmp_path / "teapot"
    shutil.copytree(DATA / "jpeg" / "teapot", folder)
    for p in sorted((FORMATS / "teapot").iterdir()):
        shutil.copy(p, folder / p.name)
    kw = dict(data_root=folder, camera_representation="spherical",
              learnable_mode=0, placeholder_object_token="<t>", size=64,
              repeats=2, flip_p=0.5, seed=3)
    j = jdataset.TextualInversionDataset(tokenizer=JTok(), **kw)
    t = tdataset.TextualInversionDataset(tokenizer=TTok(), **kw)
    assert [p.name for p in t.image_paths] == [p.name
                                               for p in j.image_paths]
    assert t.num_images == 14
    names = [p.name for p in t.image_paths]
    assert {"view_10_arith.jpg", "view_11_arith_prog.jpg",
            "view_12_lossless_rgb.jpg", "view_13_lossless_gray.jpg"} <= set(
                names)
    for p in t.image_paths:
        assert_like_pil(p)
        want = np.asarray(j._load_base(p)).astype(int)
        assert np.abs(t._load_base(p).astype(int) - want).max() <= 1
        t._base_cache[str(p)] = np.asarray(j._load_base(p))
    for i in range(len(t)):
        je, te = j[i], t[i]
        assert set(te) == set(je)
        for k in je:
            np.testing.assert_array_equal(np.asarray(te[k]),
                                          np.asarray(je[k]), err_msg=k)
