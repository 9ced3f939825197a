"""The port's image metrics and grids against the JAX package's
(view_neti_tpu/ops/metrics.py, view_neti_tpu/utils/vis.py), on the CPU:
masked MSE, PSNR and SSIM to 1e-5, LPIPS to 1e-4 with the VGG weights of
JAX's own init carried across (and through the .npz export format), and
the grids exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from view_neti_tpu import weight_port as jwp
from view_neti_tpu.ops import metrics as jm
from view_neti_tpu.utils import vis as jvis

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.ops import metrics as tm
from view_neti_tpu_torch.utils import vis as tvis


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, shape=(2, 3, 40, 48, 3)):
    """Ground truth in [0, 1], a prediction near it, a binary mask."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(*shape).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    mask = (rng.rand(*shape[:-1], 1) > 0.3).astype(np.float32)
    return pred, gt, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_mse_and_psnr_match_jax(seed):
    pred, gt, mask = _images(seed)
    want = np.asarray(jm.masked_mse(pred, gt, mask))
    got = tm.masked_mse(*_t(pred, gt, mask)).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(tm.psnr_from_mse(torch.from_numpy(want))
                               .numpy(), np.asarray(jm.psnr_from_mse(want)),
                               rtol=1e-5)
    np.testing.assert_allclose(tm.masked_psnr(*_t(pred, gt, mask)).numpy(),
                               np.asarray(jm.masked_psnr(pred, gt, mask)),
                               rtol=1e-5)
    # an empty mask divides by 1, as the JAX function does
    zero = np.zeros_like(mask)
    np.testing.assert_array_equal(tm.masked_mse(*_t(pred, gt, zero)).numpy(),
                                  np.asarray(jm.masked_mse(pred, gt, zero)))


def test_ssim_matches_jax():
    """Batched (B, H, W, C), leading axes folded, and a single image."""
    pred, gt, mask = _images(2)
    flat = pred.reshape(-1, 40, 48, 3), gt.reshape(-1, 40, 48, 3)
    want = np.asarray(jm.ssim(*flat))
    np.testing.assert_allclose(tm.ssim(*_t(*flat)).numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(tm.ssim(*_t(pred * mask, gt * mask)).numpy(),
                               np.asarray(jm.ssim(
                                   (pred * mask).reshape(-1, 40, 48, 3),
                                   (gt * mask).reshape(-1, 40, 48, 3)))
                               .reshape(2, 3), rtol=1e-5)
    one = tm.ssim(*_t(pred[0, 0], gt[0, 0]))
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(jm.ssim(pred[0, 0],
                                                         gt[0, 0])),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def lpips_pair():
    model = jm.LPIPS()
    x = jnp.zeros((1, 16, 16, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    return jax.jit(model.apply), variables


def _lpips_inputs():
    pred, gt, _ = _images(3, (3, 32, 40, 3))
    return pred * 2 - 1, gt * 2 - 1


def test_lpips_matches_jax(lpips_pair):
    apply, variables = lpips_pair
    a, b = _lpips_inputs()
    want = np.asarray(apply(variables, a, b))
    port = tm.LPIPS()
    port.load_state_dict(twp.from_jax_lpips(
        jax.tree_util.tree_map(np.asarray, variables["params"])),
        strict=True)
    got = port(*_t(a, b)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # identical inputs are at distance 0
    assert np.all(port(*_t(a, a)).numpy() == 0)


def test_lpips_npz_loads_as_in_jax(lpips_pair, tmp_path):
    """An .npz in the export format (vgg/convN/kernel HWIO, linN) through
    make_lpips and through the JAX package's load_lpips_npz."""
    apply, variables = lpips_pair
    rng = np.random.RandomState(5)
    arrays = {}
    for i in range(13):
        k = np.asarray(variables["params"]["vgg"][f"conv{i}"]["kernel"])
        arrays[f"vgg/conv{i}/kernel"] = (
            rng.randn(*k.shape) / np.sqrt(np.prod(k.shape[:3]))).astype(
                np.float32)
        arrays[f"vgg/conv{i}/bias"] = 0.01 * rng.randn(k.shape[-1]).astype(
            np.float32)
    for i in range(5):
        shape = np.asarray(variables["params"][f"lin{i}"]).shape
        arrays[f"lin{i}"] = rng.rand(*shape).astype(np.float32)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **arrays)
    a, b = _lpips_inputs()
    want = np.asarray(apply(jwp.load_lpips_npz(str(path), variables), a, b))
    got = tm.make_lpips(str(path), device="cpu")(*_t(a, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_make_lpips_random_weights_are_seeded():
    a, b = _t(*_lpips_inputs())
    one = tm.make_lpips(seed=7, device="cpu")(a, b)
    two = tm.make_lpips(seed=7, device="cpu")(a, b)
    other = tm.make_lpips(seed=8, device="cpu")(a, b)
    assert torch.equal(one, two) and not torch.equal(one, other)


@pytest.mark.parametrize("n,nrow,padding", [(5, 3, 2), (4, 4, 0), (1, 2, 3)])
def test_make_grid_np_equals_jax(n, nrow, padding):
    imgs = np.random.RandomState(n).rand(n, 6, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tvis.make_grid_np(imgs, nrow, padding=padding, pad_value=0.5),
        jvis.make_grid_np(imgs, nrow, padding=padding, pad_value=0.5))


def test_image_grid_and_downsample_equal_jax():
    """The contact sheet's grid and 0.2 downsample on arrays against the
    JAX package's on PIL images (bilinear, Pillow's arithmetic)."""
    rng = np.random.RandomState(9)
    imgs = [rng.randint(0, 256, (30 + 5 * (i % 2), 40, 3), np.uint8)
            for i in range(5)]
    want = jvis.get_image_grid([Image.fromarray(im) for im in imgs])
    got = tvis.get_image_grid(imgs)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tvis.downsample_image(got, 0.2),
                                  np.asarray(jvis.downsample_image(want,
                                                                   0.2)))
