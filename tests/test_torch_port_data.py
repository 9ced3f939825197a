"""The port's host data path against PIL, PyYAML and the JAX package: the
PNG reader and writer (data/image_io.py and its compiled unfilter), the
deterministic bases of every DTU preprocess key, the dataset's and
loader's stream of captions, ids and image indices, and the config files.
"""
import glob
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from view_neti_tpu import config as jconfig
from view_neti_tpu.data import dataset as jdataset
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok

from view_neti_tpu_torch import config as tconfig
from view_neti_tpu_torch.data import dataset as tdataset
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.tokenizer import FallbackTokenizer as TTok
from view_neti_tpu_torch.utils import yaml_subset

import test_dataset

CONFIGS = sorted(glob.glob(str(Path(__file__).resolve().parents[1]
                               / "input_configs" / "*.yaml")))

# ----------------------------------------------------------------- PNG ----


@pytest.fixture(scope="module")
def pil_pngs(tmp_path_factory):
    """PIL-written noise PNGs: gray, RGB and RGBA at 17x13 and 1600x1200
    (PIL picks Sub, Up and Paeth rows for noise)."""
    d = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(0)
    files = {}
    for h, w in ((13, 17), (1200, 1600)):
        for mode, c in (("L", 1), ("RGB", 3), ("RGBA", 4)):
            arr = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
            p = d / f"{mode}_{w}x{h}.png"
            Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(p)
            files[(mode, w)] = (p, arr)
    return files


@pytest.mark.parametrize("width", [17, 1600])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_matches_pil(pil_pngs, mode, width):
    """The compiled and the numpy unfilter give PIL's decode exactly."""
    path, arr = pil_pngs[(mode, width)]
    h, w, c, raw = image_io.parse_png(path.read_bytes())
    assert (h, w, c) == arr.shape
    compiled = image_io.unfilter_compiled(raw, h, w, c)
    plain = image_io.unfilter_plain(raw, h, w, c)
    want = np.asarray(Image.open(path)).reshape(arr.shape)
    np.testing.assert_array_equal(compiled, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(image_io.read_png(path), arr)
    rgb = image_io.read_rgb(path)
    np.testing.assert_array_equal(
        rgb, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_decodes_identically_in_pil(tmp_path, filters, channels):
    """Every filter type (None: all five cycling over the rows) and every
    channel count: PIL and both of the port's unfilters read back the
    written image exactly."""
    arr = np.random.RandomState(channels).randint(
        0, 256, (23, 31, channels)).astype(np.uint8)
    p = tmp_path / "w.png"
    image_io.write_png(p, arr, filters=filters)
    pil = np.asarray(Image.open(p)).reshape(arr.shape)
    np.testing.assert_array_equal(pil, arr)
    h, w, c, raw = image_io.parse_png(p.read_bytes())
    kinds = np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]
    assert set(kinds) == ({filters} if filters is not None
                          else {0, 1, 2, 3, 4})
    np.testing.assert_array_equal(image_io.unfilter_plain(raw, h, w, c), arr)
    np.testing.assert_array_equal(image_io.read_png(p), arr)


def test_png_reader_rejects_what_it_does_not_decode(tmp_path):
    """Invalid bit depths (gray at 3 bits, RGB at 4) and a broken CRC."""
    good = image_io.encode_png(np.zeros((4, 4, 3), np.uint8))
    for depth, color in ((3, 0), (4, 2)):
        ihdr = struct.pack(">IIBBBBB", 4, 4, depth, color, 0, 0, 0)
        p = tmp_path / f"d{depth}_c{color}.png"
        p.write_bytes(good[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr
                      + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
                      + good[33:])
        with pytest.raises(image_io.PNGError, match="bit depth"):
            image_io.read_png(p)
    bad = bytearray(image_io.encode_png(np.zeros((4, 4, 3), np.uint8)))
    bad[-20] ^= 0xFF      # inside the IDAT chunk: its CRC no longer holds
    with pytest.raises(image_io.PNGError):
        image_io.parse_png(bytes(bad))


def test_resize_is_within_one_level_of_pil():
    """The deterministic resize against PIL's BICUBIC on noise and on a
    smooth image, 1600x1200 -> 512x384."""
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:1200, 0:1600]
    smooth = np.stack([(xx / 1600 * 255), (yy / 1200 * 255),
                       128 + 100 * np.sin(xx / 90.0)], -1).astype(np.uint8)
    for img in (rng.randint(0, 256, (1200, 1600, 3)).astype(np.uint8),
                smooth):
        got = image_io.resize_u8(img, 512, 384).astype(int)
        want = np.asarray(Image.fromarray(img).resize(
            (512, 384), Image.Resampling.BICUBIC)).astype(int)
        assert np.abs(got - want).max() <= 1


# --------------------------------------------------------------- bases ----

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """One 1600x1200 DTU scan image and a square-branch folder holding the
    same image, written by PIL."""
    root = tmp_path_factory.mktemp("bases")
    dtu = root / "dtu" / "Rectified" / "scan1"
    cal = root / "dtu" / "Calibration" / "cal18"
    dtu.mkdir(parents=True)
    cal.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i in range(1, 50):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    yy, xx = np.mgrid[0:1200, 0:1600]
    img = np.stack([xx % 256, (yy * 3) % 256, (xx + yy) % 256], -1)
    img = np.clip(img + rng.randint(-20, 20, img.shape), 0, 255).astype(
        np.uint8)
    Image.fromarray(img).save(dtu / "rect_026_3_r5000.png")
    square = root / "objects"
    square.mkdir()
    Image.fromarray(img).save(square / "thing.png")
    return dtu, cal, square


@pytest.mark.parametrize("key", [-1, 0, 1, 2, "square"])
def test_bases_are_within_one_level_of_jax(scan, key):
    """_load_base of the port against the JAX package's for DTU preprocess
    keys -1, 0, 1, 2 and the square branch (resolution 64)."""
    dtu, cal, square = scan
    root, mode = (square, 0) if key == "square" else (dtu, 2)
    kw = dict(data_root=root, camera_representation="dtu-12d",
              learnable_mode=mode, placeholder_object_token="<o>",
              dtu_subset=1, size=64, repeats=1,
              dtu_preprocess_key=0 if key == "square" else key,
              calibration_dir=str(cal), flip_p=0.0)
    j = jdataset.TextualInversionDataset(tokenizer=JTok(), **kw)
    t = tdataset.TextualInversionDataset(tokenizer=TTok(), **kw)
    path = t.image_paths[0]
    want = j._load_base(path)
    got = t._load_base(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if key != "square":
        assert got.shape[:2] == tuple(reversed(tdataset.DTU_SIZES[key]))


# -------------------------------------------------------------- stream ----

def _pair(tmp_path, mode, aug):
    root = test_dataset._make_dtu_tree(tmp_path, size=(64, 48))
    kw = dict(data_root=root / "Rectified" / "scan114",
              camera_representation="dtu-12d", learnable_mode=mode,
              placeholder_object_token="<obj>", dtu_subset=0, repeats=4,
              calibration_dir=str(root / "Calibration" / "cal18"),
              fixed_object_token_or_path="teapot" if mode == 1 else None,
              augmentation_key=aug, seed=11)
    out = []
    for cls, tok in ((jdataset.TextualInversionDataset, JTok()),
                     (tdataset.TextualInversionDataset, TTok())):
        ds = cls(tokenizer=tok, **kw)
        tok.add_tokens(ds.placeholder_tokens)
        ds.skip_pixels = True
        out.append(ds)
    return out


def _assert_same_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "texts":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("mode,aug", [(1, 0), (2, 7)])
def test_dataset_and_loader_stream_equals_jax(tmp_path, mode, aug):
    """Captions, token ids, placeholder ids, image indices and their order
    over two epochs, and after a start_batch fast-forward: exactly the JAX
    package's."""
    j, t = _pair(tmp_path, mode, aug)
    assert t.placeholder_tokens == j.placeholder_tokens
    assert t.image_paths == j.image_paths and t.num_images == 3
    for i in range(len(t)):
        je, te = j[i], t[i]
        assert set(te) == set(je)
        for k in je:
            np.testing.assert_array_equal(np.asarray(te[k]),
                                          np.asarray(je[k]), err_msg=k)
    jl = jdataset.DataLoader(j, batch_size=3, seed=4)
    tl = tdataset.DataLoader(t, batch_size=3, seed=4)
    assert tl.batches_per_epoch == jl.batches_per_epoch == 4
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 4
        for a, b in zip(jb, tb):
            _assert_same_batches(a, b)
    jf = list(jdataset.DataLoader(j, batch_size=3, seed=4, start_batch=5))
    tf = list(tdataset.DataLoader(t, batch_size=3, seed=4, start_batch=5))
    assert len(tf) == len(jf) == 3
    for a, b in zip(jf, tf):
        _assert_same_batches(a, b)


def test_mode0_folder_examples_match_jax(tmp_path):
    """Mode 0 on a PNG folder with the host flip: captions and ids exactly,
    the flipped [-1, 1] pixels within one level of JAX's."""
    rng = np.random.RandomState(2)
    for n in range(3):
        Image.fromarray(rng.randint(0, 256, (40, 56, 3)).astype(
            np.uint8)).save(tmp_path / f"img{n}.png")
    kw = dict(data_root=tmp_path, camera_representation="spherical",
              learnable_mode=0, placeholder_object_token="<t>", size=32,
              repeats=2, flip_p=0.5, seed=3)
    pair = []
    for cls, tok in ((jdataset.TextualInversionDataset, JTok()),
                     (tdataset.TextualInversionDataset, TTok())):
        ds = cls(tokenizer=tok, **kw)
        tok.add_tokens(ds.placeholder_tokens)
        pair.append(ds)
    j, t = pair
    for i in range(len(t)):
        je, te = j[i], t[i]
        assert te["text"] == je["text"]
        np.testing.assert_array_equal(te["input_ids"], je["input_ids"])
        assert te["input_ids_placeholder_object"] == \
            je["input_ids_placeholder_object"]
        assert te["pixel_values"].shape == (32, 32, 3)
        assert np.abs(te["pixel_values"] - je["pixel_values"]).max() \
            <= 1 / 127.5 + 1e-6


# ------------------------------------------------------------- configs ----

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_yaml_reader_equals_safe_load(path):
    text = Path(path).read_text()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_config_decode_encode_and_dump_match_jax(path, tmp_path):
    """decode then encode equals the JAX package's on each config, and the
    port's dump_config, read by yaml.safe_load, equals JAX's encode."""
    data = yaml.safe_load(Path(path).read_text())
    cls = "InferenceConfig" if "inference" in path else "RunConfig"
    want = jconfig.encode(jconfig.decode(getattr(jconfig, cls), data))
    cfg = tconfig.decode(getattr(tconfig, cls), data)
    assert tconfig.encode(cfg) == want
    out = tmp_path / "config.yaml"
    tconfig.dump_config(cfg, out)
    assert yaml.safe_load(out.read_text()) == want


def test_yaml_scalars_resolve_as_safe_load():
    """The YAML 1.1 traps: 1e-3 is a string, bare no is False, 010 is
    octal, 1:30 sexagesimal; and the CLI keeps yes/no strings."""
    cases = ["a: 1e-3", "a: 1.0e-3", "a: no", "a: Off", "a: 010", "a: 0x1f",
             "a: 1_000", "a: 1:30", "a: .5", "a: -.inf", "a: ~", "a:",
             "a: 'it''s'", 'a: "t\\tab"', "a: <object>  # c", "a: x#y",
             "a:\n- 1\n- b", "a:\n  - x: 1\n    y: [1, {z: 2}]\n  - 3",
             "a: {b: [1, 2], c: 'd'}", "a: [1,\n  2]"]
    for c in cases:
        assert yaml_subset.loads(c) == yaml.safe_load(c), c
    cfg = tconfig.parse_cli(["--optim.mixed_precision", "no",
                             "--optim.learning_rate", "2e-3",
                             "--eval.validation_seeds=[4, 5]",
                             "--eval.num_validation_images", "2"])
    jcfg = jconfig.parse_cli(["--optim.mixed_precision", "no",
                              "--optim.learning_rate", "2e-3",
                              "--eval.validation_seeds=[4, 5]",
                              "--eval.num_validation_images", "2"])
    assert tconfig.encode(cfg) == jconfig.encode(jcfg)
    assert cfg.optim.mixed_precision == "no"
    assert cfg.optim.learning_rate == 2e-3
