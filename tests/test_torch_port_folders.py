"""Other datasets' folders in the port against the JAX package: spherical
view tokens (their order, captions, ids and the view table's deg_freedom),
the llff passthrough's bases, the host-augmented pixel stream
(data.device_augment false), and two tiny train-CLI runs: the mode-0
recipe on the committed JPEG fixtures and a spherical mode-2 run on an
llff folder with host augmentation."""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from view_neti_tpu.data import dataset as jdataset
from view_neti_tpu.models import view_tokens as jvt
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok

from view_neti_tpu_torch import train as ttrain
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import dataset as tdataset
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.models import view_tokens as tvt
from view_neti_tpu_torch.tokenizer import FallbackTokenizer as TTok
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training.coach import Coach

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
# phi strings whose lexicographic order is not their numeric order
PHIS = ["0", "45", "90", "135", "180", "225", "270", "315", "22p5"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_views(root, names, sizes=((24, 32),), seed=0):
    """PNG views written by the port's writer, the i-th at sizes[i % n]
    (h, w)."""
    root.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    for i, name in enumerate(names):
        h, w = sizes[i % len(sizes)]
        image_io.write_png(root / name,
                           rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return root


def spherical_names(kind):
    if kind == "phi":
        return [f"obj___0_{p}_1.png" for p in PHIS]
    return [f"obj___{t}_{p}_1.png" for t in ("10", "-5") for p in PHIS[:4]]


def pair(root, **kw):
    out = []
    for cls, tok in ((jdataset.TextualInversionDataset, JTok()),
                     (tdataset.TextualInversionDataset, TTok())):
        ds = cls(data_root=root, tokenizer=tok, **kw)
        tok.add_tokens(ds.placeholder_tokens)
        out.append(ds)
    return out


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("kind", ["phi", "theta-phi"])
def test_spherical_tokens_and_stream_equal_jax(tmp_path, kind, mode):
    root = write_views(tmp_path / "views", spherical_names(kind))
    j, t = pair(root, camera_representation="spherical", learnable_mode=mode,
                placeholder_object_token="<obj>", repeats=3, seed=5,
                fixed_object_token_or_path="teapot" if mode == 1 else None)
    assert t.placeholder_view_tokens == j.placeholder_view_tokens
    assert t.placeholder_tokens == j.placeholder_tokens
    assert [str(p) for p in t.image_paths] == [str(p) for p in j.image_paths]
    if kind == "phi":
        # ordered by phi, not by the string
        assert t.placeholder_view_tokens[:3] == [
            "<view_0_0_1>", "<view_0_22p5_1>", "<view_0_45_1>"]
    ids = list(range(100, 100 + len(t.placeholder_view_tokens)))
    jt = jvt.build_view_token_table(j.placeholder_view_tokens, ids)
    tt = tvt.build_view_token_table(t.placeholder_view_tokens, ids)
    assert tt.deg_freedom == jt.deg_freedom == kind
    for field in ("params_raw", "mins", "maxs", "token_ids"):
        np.testing.assert_array_equal(getattr(tt, field), getattr(jt, field))
    j.skip_pixels = t.skip_pixels = True
    for i in range(len(t)):
        je, te = j[i], t[i]
        assert set(te) == set(je)
        for k in je:
            np.testing.assert_array_equal(np.asarray(te[k]),
                                          np.asarray(je[k]), err_msg=k)
    jl = jdataset.DataLoader(j, batch_size=4, seed=2)
    tl = tdataset.DataLoader(t, batch_size=4, seed=2)
    for _ in range(2):
        for a, b in zip(list(jl), list(tl)):
            assert a["texts"] == b["texts"]
            for k in ("input_ids", "input_ids_placeholder_view",
                      "image_idxs"):
                np.testing.assert_array_equal(a[k], b[k])


def test_llff_bases_keep_the_decoded_size(tmp_path):
    """A data root holding "llff": no resize, PNG and JPEG, any size."""
    root = write_views(tmp_path / "llff" / "fern",
                       [f"obj___0_{p}_1.png" for p in PHIS[:3]],
                       sizes=((24, 32), (31, 17)))
    Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (21, 27, 3)).astype(np.uint8)).save(
        root / "obj___0_300_1.jpg", quality=90)
    j, t = pair(root, camera_representation="spherical", learnable_mode=2,
                placeholder_object_token="<obj>", repeats=1)
    assert not t.uniform_base_shape and not j.uniform_base_shape
    shapes = set()
    for p in t.image_paths:
        want = j._load_base(p)
        got = t._load_base(p)
        np.testing.assert_array_equal(got, want)
        shapes.add(got.shape)
        assert got.shape[:2] == image_io.image_size(p)
    assert len(shapes) == 3


@pytest.mark.parametrize("key", [2, 3, 8])
def test_host_pixel_stream_equals_jax_on_an_llff_folder(tmp_path, key):
    """Spherical mode 2 with data.device_augment false: ds[i]
    ["pixel_values"], the preset's host pipeline drawn from each example's
    generator, exactly the JAX package's (presets that keep the size: the
    JAX package asserts it)."""
    root = write_views(tmp_path / "llff" / "obj",
                       [f"obj___0_{p}_1.png" for p in PHIS[:4]],
                       sizes=((30, 42),), seed=key)
    j, t = pair(root, camera_representation="spherical", learnable_mode=2,
                placeholder_object_token="<obj>", repeats=3, seed=key,
                augmentation_key=key)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in range(len(t)):
            np.testing.assert_array_equal(t[i]["pixel_values"],
                                          j[i]["pixel_values"])


@pytest.mark.parametrize("key", [4, 7])
def test_host_pixel_stream_equals_jax_with_the_flip_and_a_crop(tmp_path,
                                                               key):
    """Mode 0 with the flip and a cropping preset on the same bases (the
    two packages' base resizes differ by a level, so the port's cache
    holds JAX's bases): every example's pixels exactly."""
    root = write_views(tmp_path / "folder", [f"im{i}.png" for i in range(3)],
                       sizes=((40, 56),), seed=key)
    j, t = pair(root, camera_representation="spherical", learnable_mode=0,
                placeholder_object_token="<t>", size=32, repeats=4,
                flip_p=0.5, seed=key, augmentation_key=key)
    for p in t.image_paths:
        t._base_cache[str(p)] = np.asarray(j._load_base(p))
    flipped = 0
    for i in range(len(t)):
        want = j[i]["pixel_values"]
        np.testing.assert_array_equal(t[i]["pixel_values"], want)
        assert want.shape == (32, 32, 3)
        rng = np.random.default_rng((key, 0, i))
        rng.integers(len(t.templates))
        flipped += rng.uniform() < 0.5
    assert 0 < flipped < len(t)


def _tiny_llff_cfg(root, exp_dir, key):
    return decode(RunConfig, {
        "learnable_mode": 2,
        "model": {"arch_view_net": 15, "word_embedding_dim": 32},
        "data": {"camera_representation": "spherical",
                 "train_data_dir": str(root), "augmentation_key": key,
                 "device_augment": False, "repeats": 10},
        "log": {"exp_dir": str(exp_dir), "save_dataset_images": False,
                "report_to": "none"},
        "eval": {"validation_prompts": None},
        "optim": {"mixed_precision": "no", "max_train_steps": 1}})


def test_llff_folder_of_several_sizes_needs_a_cropping_preset(tmp_path):
    root = write_views(tmp_path / "llff" / "obj",
                       [f"obj___0_{p}_1.png" for p in PHIS[:4]],
                       sizes=((30, 42), (42, 30)))
    with pytest.raises(ValueError, match="cannot be stacked"):
        Coach(_tiny_llff_cfg(root, tmp_path / "run", 3),
              arch=tbuilder.tiny_arch(), device="cpu")
    ds = tdataset.TextualInversionDataset(
        data_root=root, tokenizer=TTok(), camera_representation="spherical",
        learnable_mode=2, augmentation_key=7)
    ds.check_host_batches()           # preset 7 crops to one size


def test_train_cli_mode0_on_the_jpeg_fixtures(tmp_path, monkeypatch):
    """input_configs/train_mode0.yaml on a copy of the committed JPEGs:
    the flip on the card's path (here the CPU), two steps, a validation
    round and the checkpoints."""
    folder = tmp_path / "teapot"
    shutil.copytree(FIXTURES / "teapot", folder)
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    monkeypatch.delenv("SD_WEIGHTS_DIR", raising=False)
    out = ttrain.main([
        "--config_path", str(ROOT / "input_configs" / "train_mode0.yaml"),
        "--log.exp_dir", str(tmp_path / "runs"), "--log.report_to", "none",
        "--data.train_data_dir", str(folder), "--optim.max_train_steps", "2",
        "--debug", "true", "--eval.validation_steps", "2",
        "--log.save_steps", "2", "--eval.validation_prompts",
        '["A photo of a {}"]'], device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    run = tmp_path / "runs" / "teapot"
    assert (run / "mapper-steps-2_object.msgpack").exists()
    assert (run / "learned_embeds-steps-2.msgpack").exists()
    # one prompt across the default three seeds, at the tiny resolution
    sheet = image_io.read_rgb(run / "val-images-2.png")
    assert sheet.shape == (16, 3 * 16, 3)


def test_train_cli_spherical_mode2_with_host_augmentation(tmp_path,
                                                          monkeypatch):
    """input_configs/train.yaml turned to a spherical llff folder with
    data.device_augment false and preset 3: two steps and the prompt-sheet
    validation of its phi tokens."""
    root = write_views(tmp_path / "llff" / "obj",
                       [f"obj___0_{p}_1.png" for p in PHIS[:5]],
                       sizes=((32, 32),))
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    monkeypatch.delenv("SD_WEIGHTS_DIR", raising=False)
    out = ttrain.main([
        "--config_path", str(ROOT / "input_configs" / "train.yaml"),
        "--log.exp_dir", str(tmp_path / "runs"), "--log.report_to", "none",
        "--data.train_data_dir", str(root),
        "--data.camera_representation", "spherical",
        "--data.device_augment", "false", "--data.augmentation_key", "3",
        "--optim.max_train_steps", "2", "--debug", "true",
        "--eval.validation_steps", "2", "--log.save_steps", "2"],
        device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    run = tmp_path / "runs" / "train"
    assert (run / "mapper-steps-2_view.msgpack").exists()
    sheet = image_io.read_rgb(run / "val-image-2.png")
    # a row without a view token and one per phi token, two seeds each
    assert sheet.shape == (6 * 32, 2 * 32, 3)
