"""The hand-written Hopper kernels of view_neti_tpu_torch against their plain
PyTorch versions, on the card.

Every test here needs a CUDA device: the module carries the `cuda` marker
and each test skips without a card. The file imports torch, numpy and the
port only. tests/conftest.py imports JAX, so on a machine without JAX run
it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels.py -q
"""
import numpy as np
import pytest
import torch

from view_neti_tpu_torch.ops import flash_attention as tfa
from view_neti_tpu_torch.ops import fused_conv as tfc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    # the plain versions in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _check_attention(q, k, v):
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    B, Lq, H, _ = q.shape
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Lq)
    ro, rlse = tfa.flash_attention_ref(q.float(), k.float(), v.float())
    # the bf16 output rounds by 2^-8 |o|; the bf16 p in the p.v product adds
    # independent roundings whose sum scales with the spread of o: 2^-4 of
    # its RMS. lse is fp32 from exact bf16 products: 1e-3
    tol = 2 ** -8 * ro.abs() + 2 ** -4 * ro.square().mean().sqrt()
    assert bool(((o.float() - ro).abs() <= tol).all())
    assert (lse - rlse).abs().max().item() <= 1e-3


# ragged q and kv tiles (64 rows each), cross-attention (Lk = 77), the head
# dims of SD-1.5 (40/80/160) and SD-2.1 (64), and the kernel's limits
# (d = 8 and 256, a single key)
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 200, 200, 3, 40), (2, 200, 77, 3, 80), (1, 108, 108, 2, 160),
    (2, 130, 77, 5, 64), (1, 65, 1, 2, 8), (1, 70, 129, 1, 256)])
def test_flash_attention_matches_plain(dev, B, Lq, Lk, H, d):
    _check_attention(_randn((B, Lq, H, d), 0, dev).bfloat16(),
                     _randn((B, Lk, H, d), 1, dev).bfloat16(),
                     _randn((B, Lk, H, d), 2, dev).bfloat16())


def test_flash_attention_reads_strided_views(dev):
    """q, k, v as views into one packed (B, L, 3, H, d) projection: the
    kernel reads the strides, no copies are made."""
    q, k, v = _randn((2, 96, 3, 4, 40), 3, dev).bfloat16().unbind(2)
    assert not q.is_contiguous()
    _check_attention(q, k, v)


def test_flash_attention_refuses_what_the_kernel_does_not_take(dev):
    ok = torch.zeros(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    d12 = torch.zeros(1, 8, 2, 12, device=dev, dtype=torch.bfloat16)
    d264 = torch.zeros(1, 8, 2, 264, device=dev, dtype=torch.bfloat16)
    for q, k, v in ((ok.float(), ok.float(), ok.float()), (d12, d12, d12),
                    (d264, d264, d264), (ok, ok.cpu(), ok),
                    (ok, ok[:, :4], ok)):
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, v)


# (Cin, Cout, bias, add_bc, residual dtype, output dtype): ragged Cout (the
# decoder's conv_out has 3), a ragged output-channel tile, every epilogue
# term, Cin below one 32-channel k-step and not a multiple of it, fp32
# residual and output
@pytest.mark.parametrize("Ci,Co,use_bias,use_add,res,out", [
    (16, 3, True, False, None, "bfloat16"),
    (64, 72, True, True, "bfloat16", "bfloat16"),
    (128, 128, True, False, "bfloat16", "bfloat16"),
    (8, 16, False, True, "float32", "float32"),
    (40, 64, True, True, None, "float32")])
def test_fused_conv_matches_plain(dev, Ci, Co, use_bias, use_add, res, out):
    B, H, W = 2, 9, 13
    x = _randn((B, H, W, Ci), 0, dev).bfloat16()
    a = 1 + _randn((B, Ci), 1, dev, 0.1)
    b = _randn((B, Ci), 2, dev, 0.1)
    w = _randn((3, 3, Ci, Co), 3, dev, (9 * Ci) ** -0.5).bfloat16()
    bias = _randn((Co,), 4, dev, 0.1).bfloat16() if use_bias else None
    add_bc = _randn((B, Co), 5, dev) if use_add else None
    residual = (_randn((B, H, W, Co), 6, dev).to(getattr(torch, res))
                if res else None)
    out_dtype = getattr(torch, out)
    before = tfc.fused_affine_silu_conv3x3.launches
    got = tfc.fused_affine_silu_conv3x3(x, a, b, w, bias, add_bc, residual,
                                        out_dtype)
    torch.cuda.synchronize()
    assert tfc.fused_affine_silu_conv3x3.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (B, H, W, Co)
    want = tfc.fused_affine_silu_conv3x3_ref(x, a, b, w, bias, add_bc,
                                             residual, torch.float32)
    # the same bf16 operands summed in fp32 in another order: 1e-3; a bf16
    # output adds its own rounding: 2e-2 + 2^-8 |out|
    if out_dtype == torch.float32:
        tol = 1e-3
    else:
        tol = 2e-2 + 2 ** -8 * want.abs()
    assert bool(((got.float() - want).abs() <= tol).all())


def test_fused_conv_refuses_what_the_kernel_does_not_take(dev):
    def args(Ci=16, dtype=torch.bfloat16):
        x = torch.zeros(1, 4, 4, Ci, device=dev, dtype=dtype)
        ab = torch.zeros(1, Ci, device=dev)
        w = torch.zeros(3, 3, Ci, 8, device=dev, dtype=dtype)
        return x, ab, ab, w

    x, a, b, w = args()
    for bad in (args(Ci=4), args(dtype=torch.float32),
                (x.transpose(1, 2), a, b, w), (x, a, b, w[:, :, :8])):
        with pytest.raises(ValueError):
            tfc.fused_affine_silu_conv3x3(*bad)
