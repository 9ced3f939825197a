"""The hand-written Hopper kernels of view_neti_tpu_torch (K1 flash-attention
forward, K2/K3 its backward, K4 the fused conv) against their plain PyTorch
versions, on the card.

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


# ragged q and kv tiles, cross-attention (Lk = 77), the head
# dims of SD-1.5 (40/80/160) and SD-2.1 (64), and the kernel's limits
# (d = 8 and 256, a single key)
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 200, 200, 3, 40), (2, 200, 77, 3, 80), (1, 108, 108, 2, 160),
    (2, 130, 77, 5, 64), (1, 65, 1, 2, 8), (1, 70, 129, 1, 256)])
def test_flash_attention_matches_plain(dev, B, Lq, Lk, H, d):
    _check_attention(_randn((B, Lq, H, d), 0, dev).bfloat16(),
                     _randn((B, Lk, H, d), 1, dev).bfloat16(),
                     _randn((B, Lk, H, d), 2, dev).bfloat16())


# K1's new code paths: Lq not a multiple of the 128-query block, Lk around
# the key-tile widths (one 80-key tile for Lk <= 80, 64-key tiles above)
@pytest.mark.parametrize("Lq,Lk", [(300, 300), (129, 77), (257, 80),
                                   (100, 81), (131, 129)])
def test_flash_attention_tile_edges(dev, Lq, Lk):
    _check_attention(_randn((2, Lq, 2, 40), 0, dev).bfloat16(),
                     _randn((2, Lk, 2, 40), 1, dev).bfloat16(),
                     _randn((2, Lk, 2, 40), 2, dev).bfloat16())


# one head dim in each of K1's padded buckets (16, 32, ..., 160, 192, 256),
# each with a single-tile key range and a streamed one
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 96, 120, 160, 192, 256])
@pytest.mark.parametrize("Lk", [77, 150])
def test_flash_attention_head_dim_buckets(dev, d, Lk):
    _check_attention(_randn((1, 140, 2, d), 0, dev).bfloat16(),
                     _randn((1, Lk, 2, d), 1, dev).bfloat16(),
                     _randn((1, Lk, 2, d), 2, dev).bfloat16())


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


def _bwd_tolerance(ref):
    """The limit on |got - ref| per element, as K1's: the bf16 rounding of
    the output (2^-8 |ref|) plus 2^-4 of the RMS for the bf16 rounding of p
    and ds before their products, a sum of independent roundings."""
    return 2 ** -8 * ref.abs() + 2 ** -4 * ref.square().mean().sqrt()


def _bwd_launches():
    return (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches)


def _check_backward(q, k, v, do):
    o, lse = tfa.flash_attention(q, k, v)
    before = _bwd_launches()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _bwd_launches() == (before[0] + 1, before[1] + 1)
    ref = tfa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float())
    for g, r, t in zip(got, ref, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert bool(((g.float() - r).abs() <= _bwd_tolerance(r)).all())


# ragged q and kv tiles, cross-attention (Lk = 77), the head dims of SD-1.5
# (40/80/160) and SD-2.1 (64), and the backward's limits (d = 8 and 192,
# three keys: with a single key p = 1, and dq and dk are 0 up to the
# rounding of the two summation orders, which no relative limit can hold)
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 200, 200, 3, 40), (2, 200, 77, 3, 80), (1, 108, 108, 2, 160),
    (2, 130, 77, 5, 64), (1, 65, 3, 2, 8), (1, 70, 129, 1, 192)])
def test_flash_attention_bwd_matches_plain(dev, B, Lq, Lk, H, d):
    _check_backward(_randn((B, Lq, H, d), 0, dev).bfloat16(),
                    _randn((B, Lk, H, d), 1, dev).bfloat16(),
                    _randn((B, Lk, H, d), 2, dev).bfloat16(),
                    _randn((B, Lq, H, d), 3, dev).bfloat16())


# one head dim in each of K3's buckets (16, 32, ..., 160, 192)
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 96, 120, 160, 192])
def test_flash_attention_bwd_head_dim_buckets(dev, d):
    _check_backward(_randn((1, 150, 2, d), 0, dev).bfloat16(),
                    _randn((1, 140, 2, d), 1, dev).bfloat16(),
                    _randn((1, 140, 2, d), 2, dev).bfloat16(),
                    _randn((1, 150, 2, d), 3, dev).bfloat16())


# K3 with Lq split across blocks (the last split short: 200 queries in
# four 64-query splits) and unsplit (the key tiles fill two waves)
@pytest.mark.parametrize("B,Lq,Lk,H,splits", [
    (1, 200, 77, 2, 4), (4, 70, 1100, 8, 1)])
def test_flash_attention_bwd_query_splits(dev, B, Lq, Lk, H, splits):
    assert tfa.dkv_splits(B, H, Lq, Lk, tfa.sm_count(dev)) == splits
    _check_backward(_randn((B, Lq, H, 40), 0, dev).bfloat16(),
                    _randn((B, Lk, H, 40), 1, dev).bfloat16(),
                    _randn((B, Lk, H, 40), 2, dev).bfloat16(),
                    _randn((B, Lq, H, 40), 3, dev).bfloat16())


def test_flash_attention_bwd_dkv_is_deterministic(dev):
    """The split reduction sums in a fixed order, with no atomics: two K3
    calls on the same inputs agree bit for bit."""
    q, do = (_randn((3, 3072, 2, 40), i, dev).bfloat16() for i in (0, 3))
    k, v = (_randn((3, 77, 2, 40), i, dev).bfloat16() for i in (1, 2))
    assert tfa.dkv_splits(3, 2, 3072, 77, tfa.sm_count(dev)) > 1
    o, lse = tfa.flash_attention(q, k, v)
    delta = tfa.attention_delta(o, do)
    first = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_bwd_reads_strided_views(dev):
    q, k, v = _randn((2, 96, 3, 4, 40), 4, dev).bfloat16().unbind(2)
    do = _randn((2, 96, 2, 4, 40), 5, dev).bfloat16()[:, :, 1]
    assert not do.is_contiguous()
    _check_backward(q, k, v, do)


def test_flash_attention_function_on_the_card(dev):
    """FlashAttention.apply runs K1 forward and K2/K3 backward; with q
    frozen K2 is skipped."""
    q, k, v, do = (_randn((2, 150, 2, 40), i, dev).bfloat16()
                   for i in range(4))
    o, lse = tfa.flash_attention(q, k, v)
    ref = tfa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float())
    for need in ("qkv", "kv"):
        leaves = [t.clone().requires_grad_(n in need)
                  for n, t in zip("qkv", (q, k, v))]
        dq0, dkv0 = _bwd_launches()
        (tfa.FlashAttention.apply(*leaves).float() * do.float()).sum() \
            .backward()
        torch.cuda.synchronize()
        assert _bwd_launches() == (dq0 + ("q" in need), dkv0 + 1)
        for n, leaf, r in zip("qkv", leaves, ref):
            if n not in need:
                assert leaf.grad is None
                continue
            assert bool(((leaf.grad.float() - r).abs()
                         <= _bwd_tolerance(r)).all())


def test_kernels_refuse_to_cut_a_gradient(dev):
    """K1 and K4 fill fresh tensors without a grad_fn: under grad mode they
    refuse inputs that require grad."""
    q = torch.zeros(1, 8, 2, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError):
        tfa.flash_attention(q, q, q)
    with torch.no_grad():
        tfa.flash_attention(q, q, q)
    x = torch.zeros(1, 4, 4, 16, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    ab = torch.zeros(1, 16, device=dev)
    w = torch.zeros(3, 3, 16, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        tfc.fused_affine_silu_conv3x3(x, ab, ab, w)
    with torch.no_grad():
        tfc.fused_affine_silu_conv3x3(x, ab, ab, w)


def test_flash_attention_bwd_refuses_what_the_kernels_do_not_take(dev):
    def args(d=16, L=8, dtype=torch.bfloat16):
        t = torch.zeros(1, L, 2, d, device=dev, dtype=dtype)
        rows = torch.zeros(1, 2, L, device=dev)
        return [t, t, t, t, rows, rows]             # q, k, v, do, lse, delta

    bad = [args(d=200), args(d=12), args(dtype=torch.float32)]
    a = args()
    bad.append(a[:4] + [a[4][..., :4], a[5]])            # lse shape
    bad.append(a[:4] + [a[4].double(), a[5]])            # lse dtype
    bad.append(a[:5] + [a[5].cpu()])                     # delta off the card
    bad.append(a[:3] + [a[3].cpu()] + a[4:])             # do off the card
    bad.append(a[:3] + [a[3][:, :4]] + a[4:])            # do not q's shape
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        for q, k, v, do, lse, delta in bad:
            with pytest.raises(ValueError):
                fn(q, k, v, do, lse, delta)


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
