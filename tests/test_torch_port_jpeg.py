"""The port's JPEG decoder (csrc/jpeg_decode.cpp through
data/image_io.py) and palette PNGs against PIL's Image.open(p).convert(
"RGB"), bit for bit: every sampling PIL writes, three qualities,
optimised Huffman tables, restart intervals, gray, odd and tiny sizes,
APPn/COM segments; the committed fixtures against their manifest; the
files it refuses, with errors that name the file. Arithmetic-coded and
lossless files are tests/test_torch_port_jpeg_arith_lossless.py's."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageCms

from view_neti_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def smooth(h, w, seed):
    """Gradients and waves with noise: every block has AC energy."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + seed),
                    128 + 100 * np.cos(y / 5.0), (x * 3 + y * 2) % 256], -1)
    img = img + r.randn(h, w, 3) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def assert_like_pil(path):
    want = np.asarray(Image.open(path).convert("RGB"))
    got = image_io.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def save(tmp_path, img, name="x.jpg", **kw):
    p = tmp_path / name
    Image.fromarray(img).save(p, "JPEG", **kw)
    return p


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])   # 4:4:4, 4:2:2, 4:2:0
def test_sampling_and_quality(tmp_path, subsampling, quality):
    assert_like_pil(save(tmp_path, smooth(37, 45, quality),
                         quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("quality", [30, 95])
def test_gray(tmp_path, quality):
    p = save(tmp_path, smooth(29, 35, 1)[..., 0], quality=quality)
    assert Image.open(p).mode == "L"
    assert_like_pil(p)


@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (389, 517)])
def test_odd_and_tiny_sizes(tmp_path, hw, subsampling):
    """Partial MCUs, the h2v2 context rows at the first and last MCU row,
    and chroma planes of 1 or 2 samples (no fancy upsampling there)."""
    assert_like_pil(save(tmp_path, smooth(*hw, sum(hw)), quality=85,
                         subsampling=subsampling))


@pytest.mark.parametrize("kw", [dict(optimize=True),
                                dict(restart_marker_blocks=3),
                                dict(restart_marker_rows=1)],
                         ids=["optimize", "rst_blocks", "rst_rows"])
def test_tables_and_restarts(tmp_path, kw):
    """Optimised (custom) Huffman tables; DRI intervals of 3 MCUs and of
    one MCU row (the DC predictors reset at each RST)."""
    assert_like_pil(save(tmp_path, smooth(64, 48, 7), quality=90,
                         subsampling=2, **kw))


def test_exif_icc_and_comment_are_skipped(tmp_path):
    """APP1 (EXIF with an orientation, which is not applied), APP2 (ICC)
    and COM segments."""
    exif = Image.Exif()
    exif[0x0112] = 6
    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    p = save(tmp_path, smooth(33, 41, 3), quality=80, exif=exif.tobytes(),
             icc_profile=icc, comment=b"a comment")
    assert_like_pil(p)


def test_magic_bytes_decide_not_the_suffix(tmp_path):
    p = save(tmp_path, smooth(16, 24, 5), name="really_a_jpeg.png")
    assert_like_pil(p)


def _manifest():
    return json.loads((FIXTURES / "manifest.json").read_text())


@pytest.mark.parametrize("rel", sorted(_manifest()))
def test_committed_fixtures(rel):
    """The committed JPEGs decode to the RGB images PIL gave when they
    were written (tests/data/jpeg/make_fixtures.py)."""
    want = _manifest()[rel]
    got = image_io.read_rgb(FIXTURES / rel)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256_rgb"]
    assert_like_pil(FIXTURES / rel)


def test_refused_files_name_the_file_and_the_feature(tmp_path):
    """Lossless arithmetic-coded (SOF11), hierarchical arithmetic-coded
    (SOF13), hierarchical and 12-bit files (a baseline file's SOF0 marker
    or its precision byte patched: nothing here writes such files), a
    truncated file and a GIF."""
    img = smooth(40, 40, 2)
    data = save(tmp_path, img, "whole.jpg", quality=90).read_bytes()
    sof = data.index(b"\xff\xc0")
    cases = {}
    for feature, at, byte in (("lossless arithmetic", sof + 1, 0xCB),
                              ("hierarchical arithmetic", sof + 1, 0xCD),
                              ("hierarchical", sof + 1, 0xC5),
                              ("12-bit", sof + 4, 12)):
        patched = bytearray(data)
        assert patched[at] in (0xC0, 8)
        patched[at] = byte
        cases[feature] = tmp_path / f"{feature}.jpg"
        cases[feature].write_bytes(bytes(patched))
    cases["truncated"] = tmp_path / "cut.jpg"
    cases["truncated"].write_bytes(data[:len(data) // 2])
    cases["neither a PNG nor a JPEG"] = tmp_path / "text.jpg"
    cases["neither a PNG nor a JPEG"].write_bytes(b"GIF89a" + bytes(40))
    for feature, path in cases.items():
        with pytest.raises(image_io.ImageError) as err:
            image_io.read_rgb(path)
        assert str(path) in str(err.value)
        assert feature in str(err.value), (feature, str(err.value))
    # PIL refuses the truncated file too
    with pytest.raises(OSError):
        Image.open(cases["truncated"]).convert("RGB")


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_palette_pngs(tmp_path, colors):
    """Palette PNGs at 1, 2, 4 and 8 bits, with a tRNS chunk that
    convert("RGB") ignores."""
    p = tmp_path / "p.png"
    im = Image.fromarray(smooth(23, 37, colors)).quantize(colors)
    im.save(p, transparency=0)
    assert Image.open(p).mode == "P"
    assert_like_pil(p)
