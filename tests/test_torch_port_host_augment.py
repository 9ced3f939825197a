"""The port's host augmentation (data/augment.py) against the JAX
package's PIL pipeline (view_neti_tpu/data/augment.py) from the same
numpy generator: after every op and every preset the generators' states
are equal, and the pixels are equal, bit for bit (the bound every op is
held to is 0 levels)."""
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from view_neti_tpu.data import augment as jaug
from view_neti_tpu.data import native
from view_neti_tpu_torch.data import augment as taug

MAX_LEVELS = 0     # every host op equals Pillow's (and the native resize)


def image(seed, h=61, w=83):
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 3 % 256, y * 4 % 256, (x + y) * 2 % 256], -1)
    return np.clip(img + r.randn(h, w, 3) * 40, 0, 255).astype(np.uint8)


def pair(seed):
    return (np.random.default_rng((seed, 1, 2)),
            np.random.default_rng((seed, 1, 2)))


def assert_same(got, want_pil, rng_t, rng_j):
    want = np.asarray(want_pil)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= MAX_LEVELS


@pytest.fixture(autouse=True)
def needs_native():
    # the JAX crop resizes through its native library when it is built,
    # which the port reproduces; without it the JAX package falls back to
    # PIL's resize
    assert native.available()


@pytest.mark.parametrize("strength", [0.04, 0.6])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter(seed, strength):
    """The four factors and the permutation drawn in the JAX order; the
    enhance blends (clipping at strength 0.6) and the HSV hue shift."""
    img = image(seed)
    rt, rj = pair(seed)
    got = taug.color_jitter(img, rt, *(strength,) * 4)
    want = jaug.color_jitter(Image.fromarray(img), rj, *(strength,) * 4)
    assert_same(got, want, rt, rj)


def test_hsv_round_trip_on_every_hue_of_a_colour_cube():
    """Pillow's RGB->HSV and HSV->RGB on a 64^3 lattice of colours."""
    v = np.arange(0, 256, 4, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(512, 512,
                                                                    3)
    np.testing.assert_array_equal(
        taug.rgb_to_hsv(rgb), np.asarray(Image.fromarray(rgb).convert("HSV")))
    np.testing.assert_array_equal(
        taug.hsv_to_rgb(rgb),
        np.asarray(Image.fromarray(rgb, "HSV").convert("RGB")))


@pytest.mark.parametrize("seed", [0, 5])
def test_random_grayscale(seed):
    img = image(seed)
    for _ in range(4):
        rt, rj = pair(seed)
        got = taug.random_grayscale(img, rt, 0.5)
        want = jaug.random_grayscale(Image.fromarray(img), rj, 0.5)
        assert_same(got, want, rt, rj)
        seed += 10


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gaussian_blur(seed):
    img = image(seed)
    rt, rj = pair(seed)
    got = taug.gaussian_blur(img, rt, (0.1, 0.2))
    want = jaug.gaussian_blur(Image.fromarray(img), rj, (0.1, 0.2))
    assert_same(got, want, rt, rj)
    # wider boxes than the presets draw
    for sigma in (0.7, 2.5):
        np.testing.assert_array_equal(
            taug.box_blur(img, sigma),
            np.asarray(Image.fromarray(img).filter(
                ImageFilter.GaussianBlur(sigma))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_rotation(seed):
    img = image(seed)
    rt, rj = pair(seed)
    got = taug.random_rotation(img, rt, 10, fill=1)
    want = jaug.random_rotation(Image.fromarray(img), rj, 10, fill=1)
    assert_same(got, want, rt, rj)


@pytest.mark.parametrize("scale", [(0.7, 1.3), (0.95, 1.05), (2.0, 3.0)],
                         ids=["preset7", "preset5", "centre_fallback"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop(seed, scale):
    """The tries and their integers draws, the centre crop when no try
    fits, and the native bilinear resize to (h, w)."""
    img = image(seed, 75, 101)
    rt, rj = pair(seed)
    got = taug.random_resized_crop(img, rt, (48, 40), scale)
    want = jaug.random_resized_crop(Image.fromarray(img), rj, (48, 40),
                                    scale)
    assert_same(got, want, rt, rj)


RESIZE_SHAPES = [(97, 131, 64, 64), (50, 60, 300, 20), (200, 170, 97, 131)]
# the plain numpy resize fuses every multiply-add; a build of the native
# library may leave some unfused, which moves a sum that rounds across .5
# by one level
PLAIN_MAX_LEVELS = 1


@pytest.mark.parametrize("shape", RESIZE_SHAPES)
def test_native_bilinear_resize(shape):
    """The compiled crop resize (csrc/bilinear_resize.cpp, built with
    native/Makefile's flags) against the JAX package's native.resize, bit
    for bit."""
    h, w, oh, ow = shape
    img = image(h, h, w)
    np.testing.assert_array_equal(taug.native_bilinear_resize(img, oh, ow),
                                  native.resize(img, oh, ow, mode="bilinear"))


def test_native_bilinear_resize_on_random_shapes():
    """The compiled crop resize against native.resize, bit for bit, at 300
    random sizes from 1 to 299 a side, up and down."""
    rng = np.random.default_rng(13)
    for _ in range(300):
        h, w, oh, ow = map(int, rng.integers(1, 300, 4))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            taug.native_bilinear_resize(img, oh, ow),
            native.resize(img, oh, ow, mode="bilinear"), err_msg=str(
                (h, w, oh, ow)))


@pytest.mark.parametrize("shape", RESIZE_SHAPES)
def test_plain_bilinear_resize_is_within_a_level(shape):
    """The plain numpy version within PLAIN_MAX_LEVELS of the compiled
    resize."""
    h, w, oh, ow = shape
    img = image(h, h, w)
    got = taug.native_bilinear_resize_plain(img, oh, ow).astype(int)
    want = taug.native_bilinear_resize(img, oh, ow).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PLAIN_MAX_LEVELS


@pytest.mark.parametrize("key", range(1, 9))
def test_presets(key):
    """Each preset's whole pipeline, five examples, the generator's state
    after each."""
    img = image(key, 64, 80)
    size = (48, 56)
    ours = taug.build_augmentations(key, size)
    theirs = jaug.build_augmentations(key, size)
    assert [s.p for s in ours] == [s.p for s in theirs]
    for i in range(5):
        rt, rj = pair(100 * key + i)
        got = taug.apply_augmentations(img, ours, rt)
        want = jaug.apply_augmentations(Image.fromarray(img), theirs, rj)
        assert_same(got, want, rt, rj)


def test_apply_takes_cpu_torch_tensors():
    img = image(9, 40, 48)
    steps = taug.build_augmentations(7, (32, 32))
    a = taug.apply_augmentations(img, steps, np.random.default_rng(4))
    b = taug.apply_augmentations(torch.from_numpy(img), steps,
                                 np.random.default_rng(4))
    assert isinstance(b, torch.Tensor)
    np.testing.assert_array_equal(b.numpy(), a)
