"""K4's output-channel tile (ops/fused_conv.py conv_n_tile, plain Python)
and its wrapper on CPU tensors at the Couts that take each tile, against
the JAX package's Pallas kernel in interpret mode.

The tile only decides how the card's blocks share the output channels; the
kernel itself runs on the card (test_torch_port_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu.ops import fused_conv as jfc

from view_neti_tpu_torch.ops import fused_conv as tfc


# the VAE's Couts: the decoder's conv_out (3) and the encoder's last conv
# (8) take the 16-channel tile, every ResNet conv (128, 256, 512) the
# 128-channel one; 16 and 17 are the edge between them
@pytest.mark.parametrize("cout,want", [
    (3, 16), (8, 16), (16, 16), (17, 128), (128, 128), (256, 128),
    (512, 128)])
def test_conv_n_tile(cout, want):
    assert tfc.conv_n_tile(cout) == want


def test_conv_n_tile_is_a_kernel_instantiation():
    """Every Cout maps to one of the library's two tiles (16, 128)."""
    assert {tfc.conv_n_tile(c) for c in range(1, 1025)} == {16, 128}


# a Cout of each tile, with every epilogue term
@pytest.mark.parametrize("Co", [3, 8, 24])
def test_fused_conv_wrapper_on_the_cpu_is_the_plain_version(Co):
    """K4's wrapper on CPU tensors gives fused_affine_silu_conv3x3_ref
    exactly, and that agrees with the Pallas kernel in interpret mode
    (fp32 on both sides: the same arithmetic up to summation order,
    1e-5)."""
    rng = np.random.RandomState(Co)
    B, H, W, Ci = 2, 5, 7, 16
    inp = dict(x=rng.randn(B, H, W, Ci), a=rng.randn(B, Ci) * 0.5,
               b=rng.randn(B, Ci) * 0.1, kernel=rng.randn(3, 3, Ci, Co) * 0.2,
               bias=rng.randn(Co), add_bc=rng.randn(B, Co),
               residual=rng.randn(B, H, W, Co))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = tfc.fused_affine_silu_conv3x3(**t)
    torch.testing.assert_close(got, tfc.fused_affine_silu_conv3x3_ref(**t),
                               rtol=0, atol=0)
    want = jfc.fused_affine_silu_conv3x3(
        *(jnp.asarray(inp[k]) for k in ("x", "a", "b", "kernel", "bias",
                                        "add_bc", "residual")),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
