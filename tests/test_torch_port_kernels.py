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


def _sm90_inputs(B, Lq, Lk, H, d, dev):
    return (_randn((B, Lq, H, d), 0, dev).bfloat16(),
            _randn((B, Lk, H, d), 1, dev).bfloat16(),
            _randn((B, Lk, H, d), 2, dev).bfloat16())


# K1's Hopper design (fwd_design "sm90": the head-dim buckets 48, 64, 80 and
# 160, one head dim of the paths in each): ragged query blocks, its
# short-key kernel's one 80-key tile (a single key, the mid blocks' 48 and
# 64, the cross-attention's 77, a full 80), its long-key kernel's first key
# past it and its ragged key tiles (128 keys, 64 at bucket 160), and the
# 6912-token self-attention of the serving path, each against the plain
# version, the mma.sync design and itself
SM90_DIMS = [40, 64, 80, 160]


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("Lq,Lk", [(63, 81), (65, 129), (200, 300),
                                   (6912, 6912), (129, 1), (130, 48),
                                   (131, 64), (257, 77), (100, 80),
                                   (300, 81), (190, 129)])
def test_flash_attention_sm90_matches_plain(dev, d, Lq, Lk):
    q, k, v = _sm90_inputs(1, Lq, Lk, 1, d, dev)
    assert tfa.fwd_design(d, Lk) == "sm90"
    before = tfa.flash_attention.designs["sm90"]
    _check_attention(q, k, v)
    assert tfa.flash_attention.designs["sm90"] == before + 1
    o, lse = tfa.flash_attention(q, k, v)
    o2, lse2 = tfa.flash_attention(q, k, v)
    mo, mlse = tfa._flash_attention_mma_sync(q, k, v)
    torch.cuda.synchronize()
    # no atomics, a fixed order of every sum: bit-equal from call to call
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, _ = tfa.flash_attention_ref(q.float(), k.float(), v.float())
    tol = 2 ** -8 * ro.abs() + 2 ** -4 * ro.square().mean().sqrt()
    assert bool(((o.float() - mo.float()).abs() <= tol).all())
    assert (lse - mlse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("d", SM90_DIMS)
def test_flash_attention_sm90_reads_strided_views(dev, d):
    """q, k, v as views into one packed (B, L, 3, H, d) projection, read
    through their strides by the tensor maps."""
    q, k, v = _randn((2, 300, 3, 4, d), 3, dev).bfloat16().unbind(2)
    assert not q.is_contiguous() and tfa.fwd_design(d, 300) == "sm90"
    _check_attention(q, k, v)


@pytest.mark.parametrize("d", SM90_DIMS)
def test_flash_attention_sm90_short_keys_read_strided_views(dev, d):
    """The cross-attention's layout: q a view into a packed (B, L, 3, H,
    d) projection, k and v views into a packed (B, 77, 2, H, d) one, read
    by the short-key kernel through their strides."""
    q = _randn((2, 300, 3, 4, d), 3, dev).bfloat16()[:, :, 1]
    k, v = _randn((2, 77, 2, 4, d), 4, dev).bfloat16().unbind(2)
    assert not q.is_contiguous() and not k.is_contiguous()
    assert tfa.fwd_design(d, 77) == "sm90"
    _check_attention(q, k, v)


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("Lk", [77, 200])
def test_flash_attention_sm90_lse_feeds_the_backward(dev, d, Lk):
    """FlashAttention.apply through the Hopper forward (its short-key and
    its long-key kernel): K2 and K3 read its lse, and the gradients match
    the plain backward from the plain forward's o and lse."""
    q, k, v = _sm90_inputs(2, 200, Lk, 3, d, dev)
    do = _randn((2, 200, 3, d), 3, dev).bfloat16()
    ro, rlse = tfa.flash_attention_ref(q.float(), k.float(), v.float())
    ref = tfa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), ro,
                                      rlse, do.float())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = tfa.flash_attention.designs["sm90"]
    (tfa.FlashAttention.apply(*leaves).float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    assert tfa.flash_attention.designs["sm90"] == before + 1
    for leaf, r in zip(leaves, ref):
        assert bool(((leaf.grad.float() - r).abs()
                     <= _bwd_tolerance(r)).all())


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("Lk", [77, 300])
def test_flash_attention_sm90_graph_replay_equals_eager(dev, d, Lk):
    """The Hopper forward captured in a CUDA graph (its tensor maps are
    kernel parameters) and replayed on new inputs: bit-equal to the eager
    call on them."""
    static = list(_sm90_inputs(1, 300, Lk, 2, d, dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attention(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = tfa.flash_attention(*static)
    for seed in (5, 6):
        new = [_randn(t.shape, seed + i, dev).bfloat16()
               for i, t in enumerate(static)]
        for s_, n in zip(static, new):
            s_.copy_(n)
        graph.replay()
        want, want_lse = tfa.flash_attention(*new)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(lse, want_lse)


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


# the folder path's 512x512 training (64x64 latents) at B = 9, 8 heads,
# head dim 40: self-attention at 4096 x 4096 (B.H = 72) and the
# cross-attention's 4096 x 77, forward and backward
@pytest.mark.parametrize("Lk", [4096, 77])
def test_flash_attention_at_the_folder_paths_shapes(dev, Lk):
    q, k, v, do = (_randn((9, L, 8, 40), i, dev).bfloat16()
                   for i, L in enumerate((4096, Lk, Lk, 4096)))
    _check_attention(q, k, v)
    _check_backward(q, k, v, do)


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


def _check_dq(q, k, v, do):
    """K2 alone against the plain backward's dq from the same lse and
    delta."""
    o, lse = tfa.flash_attention(q, k, v)
    delta = tfa.attention_delta(o, do)
    before = tfa.flash_attention_bwd_dq.launches
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches == before + 1
    ref = tfa._bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                         delta, need_dkv=False)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert bool(((dq.float() - ref).abs() <= _bwd_tolerance(ref)).all())


# K2's 128-query blocks (two 16-row blocks a warp at d 40, one at d 80)
# and 64-key tiles: Lq around the block, Lk around the tile
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("Lq,Lk", [(127, 63), (129, 64), (257, 65),
                                   (129, 130)])
def test_flash_attention_bwd_dq_tile_edges(dev, Lq, Lk, d):
    _check_dq(_randn((2, Lq, 2, d), 0, dev).bfloat16(),
              _randn((2, Lk, 2, d), 1, dev).bfloat16(),
              _randn((2, Lk, 2, d), 2, dev).bfloat16(),
              _randn((2, Lq, 2, d), 3, dev).bfloat16())


# one head dim in each of K2's buckets (16, 32, ..., 160, 192): Q and dO
# in registers up to 128, from shared memory above
@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 80, 96, 120, 160, 192])
def test_flash_attention_bwd_dq_head_dim_buckets(dev, d):
    _check_dq(_randn((1, 150, 3, d), 4, dev).bfloat16(),
              _randn((1, 140, 3, d), 5, dev).bfloat16(),
              _randn((1, 140, 3, d), 6, dev).bfloat16(),
              _randn((1, 150, 3, d), 7, dev).bfloat16())


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


# K2's and K3's Hopper design (bwd_design "sm90": the head-dim buckets 48,
# 64, 80 and 160 at any key count, one head dim of the paths in each): the
# first key past 80, ragged query and key tiles (128-query blocks and
# 64-key stages in K2; 128-key blocks, 64 at bucket 160, and 64-query
# stages in K3), the self-attentions of the train step (3072 tokens at
# d 40 and 64, 768 at d 80 and 160), and up to 80 keys (one key tile: the
# mid blocks' 48 and 64, the cross-attention's 77, a full 80) at every
# bucket, each against the plain version, the mma.sync design and itself
BWD_SM90_DIMS = [40, 64, 80, 160]
BWD_SM90_SHAPES = (
    [(d, Lq, Lk) for d in (40, 64) for Lq in (81, 129, 200, 3072)
     for Lk in (81, 129, 200, 3072)]
    + [(d, Lq, Lk) for d in (80, 160) for Lq in (81, 129, 200, 768)
       for Lk in (81, 129, 200, 768)]
    + [(d, Lq, Lk) for d in BWD_SM90_DIMS for Lq in (48, 200, 3072)
       for Lk in (48, 64, 77, 80)])


def _bwd_sm90_inputs(B, Lq, Lk, H, d, dev):
    q, k, v = _sm90_inputs(B, Lq, Lk, H, d, dev)
    do = _randn((B, Lq, H, d), 3, dev).bfloat16()
    o, lse = tfa.flash_attention(q, k, v)
    return q, k, v, do, lse, tfa.attention_delta(o, do)


def _bwd_designs():
    return (dict(tfa.flash_attention_bwd_dq.designs),
            dict(tfa.flash_attention_bwd_dkv.designs))


@pytest.mark.parametrize("d,Lq,Lk", BWD_SM90_SHAPES)
def test_flash_attention_bwd_sm90_matches_plain(dev, d, Lq, Lk):
    """The wrappers launch the design bwd_design names for each kernel
    (the Hopper one but at the shapes of BWD_MMA_SYNC_SHAPES); the Hopper
    design, forced at every shape, matches the plain version and itself,
    and so does the mma.sync design."""
    args = _bwd_sm90_inputs(1, Lq, Lk, 2, d, dev)
    assert tfa.bwd_design(d, Lk) == "sm90"
    want = {k: tfa.bwd_design(d, Lk, Lq, k) for k in ("dq", "dkv")}
    (dq0, dkv0) = _bwd_designs()
    wrapped = (tfa.flash_attention_bwd_dq(*args),
               *tfa.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    dq1, dkv1 = _bwd_designs()
    assert dq1 == dict(dq0, **{want["dq"]: dq0[want["dq"]] + 1})
    assert dkv1 == dict(dkv0, **{want["dkv"]: dkv0[want["dkv"]] + 1})

    def hopper():
        return (tfa._launch_bwd_dq(*args, "sm90")[0],
                *tfa._launch_bwd_dkv(*args, "sm90")[:2])

    got, again = hopper(), hopper()
    mma = (tfa._flash_attention_bwd_dq_mma_sync(*args),
           *tfa._flash_attention_bwd_dkv_mma_sync(*args))
    torch.cuda.synchronize()
    q, k, v, do, lse, delta = args
    ref = tfa._bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                         delta)
    for x, second, m, w, r in zip(got, again, mma, wrapped, ref):
        assert x.dtype == torch.bfloat16 and x.shape == m.shape
        tol = _bwd_tolerance(r)
        assert bool(((x.float() - r).abs() <= tol).all())
        assert bool(((m.float() - r).abs() <= tol).all())
        # no atomics, a fixed order of every sum: bit-equal from call to
        # call
        assert torch.equal(x, second)
    # the wrappers' results are their design's
    assert torch.equal(wrapped[0], got[0] if want["dq"] == "sm90" else mma[0])
    for i in (1, 2):
        assert torch.equal(wrapped[i], got[i] if want["dkv"] == "sm90"
                           else mma[i])


@pytest.mark.parametrize("d", BWD_SM90_DIMS)
def test_flash_attention_bwd_sm90_reads_strided_views(dev, d):
    """q, k, v views into one packed (B, L, 3, H, d) projection and do a
    view into another, read through their strides by the tensor maps."""
    q, k, v = _randn((2, 300, 3, 4, d), 4, dev).bfloat16().unbind(2)
    do = _randn((2, 300, 2, 4, d), 5, dev).bfloat16()[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    assert tfa.bwd_design(d, 300) == "sm90"
    _check_backward(q, k, v, do)


@pytest.mark.parametrize("d", BWD_SM90_DIMS)
@pytest.mark.parametrize("Lk", [77, 129, 3072])
def test_flash_attention_bwd_sm90_graph_replay_equals_eager(dev, d, Lk):
    """K2 and K3 captured in a CUDA graph (their tensor maps are kernel
    parameters) and replayed on new inputs: bit-equal to the eager calls
    on them."""
    static = list(_bwd_sm90_inputs(1, 300, Lk, 2, d, dev))

    def both(*a):
        return (tfa.flash_attention_bwd_dq(*a),
                *tfa.flash_attention_bwd_dkv(*a))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both(*static)
    for seed in (7, 8):
        new = _bwd_sm90_inputs(1, 300, Lk, 2, d, dev)
        new = [t * (seed / 6) if t.dtype == torch.bfloat16 else t
               for t in new]
        for s_, n in zip(static, new):
            s_.copy_(n)
        graph.replay()
        want = both(*new)
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("d", BWD_SM90_DIMS)
@pytest.mark.parametrize("Lk", [77, 300])
def test_flash_attention_bwd_sm90_through_the_function(dev, d, Lk):
    """FlashAttention.apply's backward launches the Hopper K2 and K3 at a
    self-attention shape and a 77-key cross-attention, and its gradients
    match the plain backward."""
    q, k, v = _sm90_inputs(2, 300, Lk, 3, d, dev)
    do = _randn((2, 300, 3, d), 3, dev).bfloat16()
    o, lse = tfa.flash_attention(q, k, v)
    ref = tfa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dq0, dkv0 = _bwd_designs()
    (tfa.FlashAttention.apply(*leaves).float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    dq1, dkv1 = _bwd_designs()
    assert dq1["sm90"] == dq0["sm90"] + 1 and dq1["mma_sync"] == dq0[
        "mma_sync"]
    assert dkv1["sm90"] == dkv0["sm90"] + 1
    for leaf, r in zip(leaves, ref):
        assert bool(((leaf.grad.float() - r).abs()
                     <= _bwd_tolerance(r)).all())


@pytest.mark.parametrize("d", BWD_SM90_DIMS)
@pytest.mark.parametrize("B,Lq,Lk,H", [(1, 200, 129, 2), (1, 3072, 200, 1),
                                       (9, 3072, 77, 8)])
def test_flash_attention_bwd_sm90_query_splits(dev, d, B, Lq, Lk, H):
    """The Hopper K3 with the queries split across blocks (a small grid):
    fp32 partials reduced in a fixed order, bit-equal from call to call."""
    assert tfa.dkv_splits(B, H, Lq, Lk, tfa.sm_count(dev),
                          tfa.dkv_key_tile("sm90", d)) > 1
    args = _bwd_sm90_inputs(B, Lq, Lk, H, d, dev)
    first = tfa.flash_attention_bwd_dkv(*args)
    second = tfa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    q, k, v, do, lse, delta = args
    ref = tfa._bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                         delta, need_dq=False)[1:]
    for a, b, r in zip(first, second, ref):
        assert torch.equal(a, b)
        assert bool(((a.float() - r).abs() <= _bwd_tolerance(r)).all())


def test_flash_attention_bwd_sm90_refuses_what_it_does_not_take(dev):
    """The Hopper design takes the head-dim buckets 48, 64, 80 and 160: its
    entry refuses 128, a bucket no path uses (forced past bwd_design,
    which never sends it), and the wrappers refuse views TMA cannot read;
    nothing falls back to the other design."""
    args = list(_bwd_sm90_inputs(1, 200, 200, 2, 128, dev))
    assert tfa.bwd_design(128, 200) == "mma_sync"
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfa._launch_bwd_dq(*args, "sm90")
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfa._launch_bwd_dkv(*args, "sm90")
    args = list(_bwd_sm90_inputs(1, 200, 200, 2, 40, dev))
    odd = torch.zeros(1, 200, 2, 41, device=dev,
                      dtype=torch.bfloat16)[..., :40]
    assert odd.stride(2) % 8
    before = _bwd_designs()
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError):
            fn(odd, *args[1:])
    assert _bwd_designs() == before


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


def _check_conv(dev, B, H, W, Ci, Co, use_bias=True, use_add=False,
                res=None, out="bfloat16", design=None):
    """K4 against its plain version: through the wrapper (its launch and
    conv_design's design counted), or with `design` forced (counting
    nothing)."""
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
    designs = dict(tfc.fused_affine_silu_conv3x3.designs)
    if design is None:
        got = tfc.fused_affine_silu_conv3x3(x, a, b, w, bias, add_bc,
                                            residual, out_dtype)
        designs[tfc.conv_design(Ci, Co)] += 1
    else:
        got = tfc._fused_affine_silu_conv3x3_design(
            design, x, a, b, w, bias, add_bc, residual, out_dtype)
    torch.cuda.synchronize()
    assert tfc.fused_affine_silu_conv3x3.launches == before + (
        design is None)
    assert tfc.fused_affine_silu_conv3x3.designs == designs
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


# (Cin, Cout, bias, add_bc, residual dtype, output dtype): ragged Cout (the
# decoder's conv_out has 3), a ragged output-channel tile, every epilogue
# term, Cin below one 64-channel chunk and not a multiple of it, fp32
# residual and output
@pytest.mark.parametrize("Ci,Co,use_bias,use_add,res,out", [
    (16, 3, True, False, None, "bfloat16"),
    (64, 72, True, True, "bfloat16", "bfloat16"),
    (128, 128, True, False, "bfloat16", "bfloat16"),
    (8, 16, False, True, "float32", "float32"),
    (40, 64, True, True, None, "float32")])
def test_fused_conv_matches_plain(dev, Ci, Co, use_bias, use_add, res, out):
    _check_conv(dev, 2, 9, 13, Ci, Co, use_bias, use_add, res, out)


# K4's pixel tiles (4 x 32 at 128 output channels, 8 x 32 at 16), 64-channel
# chunks and 128-channel output tiles: H and W across tile seams in both
# directions (neither a multiple of the tile), W below one tile, H = 1, Cin
# not a multiple of the chunk, Cout above one output tile and ragged, B > 1
# with add_bc and an fp32 residual
@pytest.mark.parametrize("B,H,W,Ci,Co,use_add,res,out", [
    (2, 9, 70, 64, 128, False, None, "bfloat16"),
    (1, 6, 5, 72, 40, True, "bfloat16", "bfloat16"),
    (1, 1, 40, 128, 16, False, "bfloat16", "bfloat16"),
    (3, 7, 33, 136, 200, True, "float32", "bfloat16"),
    (2, 5, 64, 96, 130, True, "float32", "float32"),
    (2, 4, 32, 512, 8, False, None, "bfloat16")])
def test_fused_conv_tile_edges(dev, B, H, W, Ci, Co, use_add, res, out):
    _check_conv(dev, B, H, W, Ci, Co, True, use_add, res, out)


# the folder path's VAE encoder at its widest: B = 9 at 512 x 512, 128
# channels, without and with the residual
@pytest.mark.parametrize("res", [None, "bfloat16"])
def test_fused_conv_at_the_folder_paths_encoder_shape(dev, res):
    _check_conv(dev, 9, 512, 512, 128, 128, True, False, res, "bfloat16")


# each output-channel tile of K4's mma.sync design (16 and 128) at the
# narrow Couts of the VAE (3, 8) and a wider one, whatever conv_n_tile
# would pick, on the mma.sync design whatever conv_design would pick
@pytest.mark.parametrize("n_tile", [16, 128])
@pytest.mark.parametrize("Co", [3, 8, 24])
def test_fused_conv_each_n_tile(dev, monkeypatch, n_tile, Co):
    monkeypatch.setattr(tfc, "conv_n_tile", lambda cout: n_tile)
    monkeypatch.setattr(tfc, "conv_design", lambda cin, cout: "mma_sync")
    _check_conv(dev, 2, 10, 37, 72, Co, True, True, "bfloat16")


# K4's Hopper design (csrc/fused_conv_sm90.cu) and its mma.sync design,
# each forced on, at the Hopper design's tile edges: H and W across its
# 8 x 32 pixel tiles (neither a multiple), Cin 72 (a ragged 64-channel
# chunk, an even chunk count: the residual's boxes by TMA) and 136 (an odd
# one), Cout 136 (a ragged 128-channel tile, two 64-channel boxes of which
# the second is ragged), 17 (not a multiple of 8: the wrapper pads the
# weights) and 24, every epilogue term, bf16 and fp32 residual and output
CONV_SM90_EDGES = [
    (2, 9, 35, 72, 136, True, "bfloat16", "bfloat16"),
    (2, 9, 35, 72, 136, True, "float32", "bfloat16"),
    (2, 9, 35, 72, 136, True, "bfloat16", "float32"),
    (1, 17, 70, 136, 136, False, "bfloat16", "bfloat16"),
    (3, 7, 33, 136, 200, True, "float32", "float32"),
    (2, 10, 37, 72, 17, True, "bfloat16", "bfloat16"),
    (1, 1, 40, 128, 24, False, None, "bfloat16"),
    (2, 8, 32, 64, 128, True, "bfloat16", "bfloat16")]


@pytest.mark.parametrize("design", ["sm90", "mma_sync"])
@pytest.mark.parametrize("B,H,W,Ci,Co,use_add,res,out", CONV_SM90_EDGES)
def test_fused_conv_each_design_at_the_sm90_tile_edges(dev, design, B, H, W,
                                                       Ci, Co, use_add, res,
                                                       out):
    _check_conv(dev, B, H, W, Ci, Co, True, use_add, res, out, design)


@pytest.mark.parametrize("Co,want", [(8, "mma_sync"), (16, "mma_sync"),
                                     (17, "sm90"), (128, "sm90")])
def test_fused_conv_counts_conv_designs_choice(dev, Co, want):
    """The wrapper launches the design conv_design names (every Cout > 16
    on the Hopper design) and counts it."""
    assert tfc.conv_design(64, Co) == want
    _check_conv(dev, 1, 9, 35, 64, Co, True, True, "bfloat16")


def test_fused_conv_sm90_is_deterministic_and_graphs_bit_equal(dev):
    """The Hopper design gives the same bits twice and in a CUDA graph
    replay; a, b and the weights at 16-byte misaligned offsets (the wrapper
    copies a and b and pads the weights) give the aligned call's bits."""
    B, H, W, Ci, Co = 2, 17, 40, 136, 136
    x = _randn((B, H, W, Ci), 0, dev).bfloat16()
    ab = 1 + _randn((2, B * Ci + 1), 1, dev, 0.1)
    a, b = ab[0, :B * Ci].view(B, Ci), ab[1, :B * Ci].view(B, Ci)
    w = _randn((3, 3, Ci, Co), 3, dev, (9 * Ci) ** -0.5).bfloat16()
    res = _randn((B, H, W, Co), 6, dev).bfloat16()
    first = tfc.fused_affine_silu_conv3x3(x, a, b, w, residual=res)
    assert torch.equal(first, tfc.fused_affine_silu_conv3x3(x, a, b, w,
                                                            residual=res))
    a_off = ab[0, 1:B * Ci + 1].view(B, Ci).contiguous()
    b_off = ab[1, 1:B * Ci + 1].view(B, Ci).contiguous()
    w_flat = torch.empty(w.numel() + 1, device=dev, dtype=torch.bfloat16)
    w_off = w_flat[1:].view_as(w)
    w_off.copy_(w)
    assert a_off.data_ptr() % 16 and w_off.data_ptr() % 16
    shifted = tfc.fused_affine_silu_conv3x3(x, a_off, b_off, w_off,
                                            residual=res)
    assert torch.equal(shifted, tfc.fused_affine_silu_conv3x3(
        x, a_off.clone(), b_off.clone(), w, residual=res))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfc.fused_affine_silu_conv3x3(x, a, b, w, residual=res)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        static = tfc.fused_affine_silu_conv3x3(x, a, b, w, residual=res)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, first)


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


# the fused UNet's ResNet convs (UNetConfig.fuse_conv) at full width where
# they meet the Hopper design's 8 x 32 pixel tiles raggedly: 9 x 12 (a
# second row tile of one row, 12 of 32 columns) and 18 x 24, Cin up to
# 2560 (40 chunks), Cout 1280 (10 output-channel blocks), with the time
# embedding (add_bc) or a bf16 residual
@pytest.mark.parametrize("B,H,W,Ci,Co,use_add,res", [
    (6, 9, 12, 2560, 1280, True, None),
    (6, 9, 12, 1280, 1280, False, "bfloat16"),
    (6, 18, 24, 1920, 1280, True, None)])
def test_fused_conv_at_the_unets_ragged_shapes(dev, B, H, W, Ci, Co,
                                               use_add, res):
    assert tfc.conv_design(Ci, Co) == "sm90"
    _check_conv(dev, B, H, W, Ci, Co, True, use_add, res, "bfloat16")


# a fused UNet forward against the unfused one on the same bf16 weights:
# K4 rounds once from fp32 sums where GroupNorm, SiLU, cuDNN and the
# time-embedding add each round to bf16, so the two differ by bf16
# roundings carried through 22 blocks; the limit on the relative RMS of
# the difference
FUSED_UNET_REL_LIMIT = 5e-2


def test_fused_unet_forward_matches_unfused(dev):
    """The tiny UNet with fuse_conv on the card: 44 K4 launches a forward,
    all on the Hopper design, nothing else changed, its output the
    unfused one's within FUSED_UNET_REL_LIMIT."""
    import copy
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 tiny_unet_config)
    from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
    from view_neti_tpu_torch.training import builder
    g = torch.Generator(dev).manual_seed(0)
    unet = builder._make(UNet2DCondition, tiny_unet_config(), dev, g,
                         torch.bfloat16)
    vae = builder._make(AutoencoderKL, tiny_vae_config(), dev, g,
                        torch.bfloat16)
    fused = copy.copy(unet)
    builder.fuse_for_inference(vae, unet=fused)
    assert fused.config.fuse_conv and not unet.config.fuse_conv
    lat = _randn((4, 16, 16, 4), 7, dev)
    t = torch.tensor([999.0, 999.0, 400.0, 400.0], device=dev)
    ctx = _randn((4, 16, 32), 8, dev)
    with torch.no_grad():
        want = unet(lat, t, ctx)
        before = _launches()
        got = fused(lat, t, ctx)
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in _launches().items()}
    assert {k: n[k] for k in ("K4", "K4 sm90", "K4 mma_sync")} == {
        "K4": 44, "K4 sm90": 44, "K4 mma_sync": 0}
    assert n["K1"] == 32
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    rel = ((got - want).square().mean().sqrt()
           / want.square().mean().sqrt()).item()
    assert rel <= FUSED_UNET_REL_LIMIT, rel


# --------------------------------------------------------- CUDA graphs ----
# The denoise loop and the train window as CUDA graph replays
# (utils/graphs.py) against the same work launched eagerly, on a tiny
# bf16 stack: bit for bit, the graphs' launch records equal to the eager
# launches, no host sync inside a capture, and a capture that fails
# raises instead of running eagerly.

def _tiny_serving(dev):
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 tiny_unet_config)
    from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
    from view_neti_tpu_torch.training import builder
    g = torch.Generator(dev).manual_seed(0)
    unet = builder._make(UNet2DCondition, tiny_unet_config(), dev, g,
                         torch.bfloat16)
    vae = builder.fuse_for_inference(builder._make(
        AutoencoderKL, tiny_vae_config(), dev, g, torch.bfloat16))
    ctx = _randn((3, 16, 1, 16, 32), 4, dev)
    return unet, vae, ctx, _randn((1, 16, 32), 5, dev)


def _launches():
    from view_neti_tpu_torch.utils.graphs import launch_counts
    return launch_counts()


def test_graphed_denoise_loop_equals_eager(dev):
    """Three 3-step CFG loops and decodes of new latents through one
    captured graph each, against the eager loop: bit for bit; the loop's
    graph launches K1 32 times a step, the decode's K4 as eagerly."""
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    unet, vae, ctx, uncond = _tiny_serving(dev)
    sched = DPMSolverSchedule()
    graphed = (pipeline.make_denoise_fn(unet, sched, 3, 7.5, torch.bfloat16),
               pipeline.make_decode_fn(vae))
    eager = (pipeline.make_denoise_fn(unet, sched, 3, 7.5, torch.bfloat16,
                                      graph=False),
             pipeline.make_decode_fn(vae, graph=False))
    for seed in range(3):
        lat0 = _randn((2, 16, 16, 4), 10 + seed, dev)
        outs = []
        for denoise, decode in (graphed, eager):
            before = _launches()
            lat = denoise(lat0, ctx, ctx, uncond)
            imgs = decode(lat.to(torch.bfloat16))
            torch.cuda.synchronize()
            outs.append((lat, imgs, {k: v - before[k]
                                     for k, v in _launches().items()}))
        (lat_g, img_g, n_g), (lat_e, img_e, n_e) = outs
        assert torch.equal(lat_g, lat_e) and torch.equal(img_g, img_e)
        assert n_g == n_e and n_e["K1"] == 32 * 3 and n_e["K4"] > 0
    (loop,), (dec,) = (list(f.captures.values()) for f in graphed)
    assert loop.replays == dec.replays == 2
    # the loop launches only K1 (both designs' shares), the decode only K4
    # (both designs' shares)
    assert loop.launches == {k: v for k, v in n_e.items()
                             if v and k.startswith("K1")}
    assert dec.launches == {k: v for k, v in n_e.items()
                            if v and k.startswith("K4")}


def _tiny_tree(root):
    """A DTU scan of the six dtu_subset-6 cameras (64x48 PNGs) and its
    calibration, as tests/test_torch_port_coach.py writes it."""
    from view_neti_tpu_torch.data import image_io
    from view_neti_tpu_torch.data.dtu import dtu_get_train_idxs
    rect = root / "dtu" / "Rectified" / "scan114"
    cal = root / "dtu" / "Calibration" / "cal18"
    rect.mkdir(parents=True)
    cal.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    for i in dtu_get_train_idxs(6):
        image_io.write_png(rect / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    return rect, cal


def _tiny_coach(tmp_path, name, spd, steps=3):
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach
    root = tmp_path / "tree"
    if not root.exists():
        _tiny_tree(root)
    rect = root / "dtu" / "Rectified" / "scan114"
    cal = root / "dtu" / "Calibration" / "cal18"
    data = {
        "learnable_mode": 2,
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 32,
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2},
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6,
                 "dtu_preprocess_key": -1, "repeats": 100,
                 "train_data_dir": str(rect), "augmentation_key": 7,
                 "resolution": 16},
        "log": {"exp_dir": str(tmp_path / name),
                "save_dataset_images": False, "report_to": "none",
                "save_steps": 10 ** 9},
        "eval": {"validation_prompts": None},
        "optim": {"mixed_precision": "bf16", "max_train_steps": steps,
                  "steps_per_dispatch": spd}}
    return Coach(decode(RunConfig, data), arch=builder.tiny_arch(),
                 calibration_dir=str(cal), device="cuda")


def _mappers(coach):
    text = coach.built.text
    return [p.detach().clone() for m in (text.obj_mappers[0],
                                         text.view_mapper)
            for p in m.parameters()]


def test_graphed_train_window_equals_eager_steps(dev, tmp_path):
    """A tiny bf16 Coach with the base cache and preset 7 on the card: one
    3-step window (the first step eager, the second captured, each a
    replay of K1-K4 with the augmentation and the optimizer) against
    three eager steps: the losses, the mappers and the counts bit for bit;
    the graph's launch record equals an eager step's launches."""
    runs = {}
    for name, spd in (("graphed", 3), ("eager", 1)):
        coach = _tiny_coach(tmp_path, name, spd)
        assert coach.window_step.enabled == (spd > 1)
        before = _launches()
        coach.train()
        runs[name] = (coach, {k: v - before[k]
                              for k, v in _launches().items()})
    (g, n_g), (e, n_e) = runs["graphed"], runs["eager"]
    assert g.losses == e.losses and len(e.losses) == 3
    assert all(torch.equal(a, b) for a, b in zip(_mappers(g), _mappers(e)))
    assert g.optimizer.counts == e.optimizer.counts
    (cap,) = g.window_step.captures.values()
    assert cap.replays == 2
    assert n_g == n_e and all(n_e[k] > 0 for k in ("K1", "K2", "K3", "K4"))
    assert {k: 3 * v for k, v in cap.launches.items()} == {
        k: v for k, v in n_e.items() if v}


def test_capture_syncs_nothing(dev, tmp_path, monkeypatch):
    """The denoise loop and the train step captured with
    torch.cuda.set_sync_debug_mode("error") on inside the capture (after
    torch.cuda.graph's own synchronize on entry): nothing inside them
    waits for the card."""
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule

    class strict_graph(torch.cuda.graph):
        def __enter__(self):
            super().__enter__()
            torch.cuda.set_sync_debug_mode("error")

        def __exit__(self, *exc):
            torch.cuda.set_sync_debug_mode("default")
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.cuda, "graph", strict_graph)
    unet, vae, ctx, uncond = _tiny_serving(dev)
    denoise = pipeline.make_denoise_fn(unet, DPMSolverSchedule(), 2, 7.5,
                                       torch.bfloat16)
    lat0 = _randn((2, 16, 16, 4), 3, dev)
    for _ in range(2):
        denoise(lat0, ctx, ctx, uncond)
    assert len(denoise.captures) == 1
    coach = _tiny_coach(tmp_path, "strict", 2, steps=2)
    coach.train()
    assert len(coach.window_step.captures) == 1


def test_failed_capture_raises(dev):
    """A function that reads the card to the host captures with an error:
    the call raises CaptureError naming the op and gives no eager result."""
    from view_neti_tpu_torch.utils.graphs import CaptureError, Graphed
    calls = []

    def reads_back(x):
        calls.append(1)
        return x * float(x.sum())

    fn = Graphed(reads_back, "reads back")
    x = torch.ones(4, device=dev)
    assert torch.equal(fn(x), x * 4)            # the eager warm-up
    with pytest.raises(CaptureError, match="reads back.*float"):
        fn(x)
    assert len(calls) == 2 and not fn.captures


def test_checkpoint_stash_captures(dev):
    """torch.utils.checkpoint's RNG-state stash (preserve_rng_state, the
    default that the UNet's and CLIP's gradient checkpointing keep) is
    allowed inside a capture: a checkpointed forward and backward captures
    and replays to the eager gradient."""
    lin = torch.nn.Linear(64, 64).to(dev)
    x = _randn((8, 64), 6, dev).requires_grad_(True)

    def step():
        y = torch.utils.checkpoint.checkpoint(lin, x, use_reentrant=False)
        y.square().sum().backward()

    step()
    want = x.grad.clone()
    x.grad = None
    lin.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x.grad, want)
