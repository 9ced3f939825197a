"""view_neti_tpu_torch/ops against the JAX package's ops.

The plain versions of the two ported kernels are held against the Pallas
kernels themselves, run in interpret mode on the CPU: flash attention (K1)
against flash_attention / _flash_fwd, the fused GroupNorm+SiLU+conv3x3 (K4)
against fused_affine_silu_conv3x3. Inputs come from numpy with a seed.
The kernels themselves need the card: their tests are in
test_torch_port_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from view_neti_tpu.ops import flash_attention as jfa
from view_neti_tpu.ops import fused_conv as jfc
from view_neti_tpu.ops.attention import single_head_attention as j_sha
from view_neti_tpu.ops.norm import FastGroupNorm
from view_neti_tpu.ops.resize import nearest_upsample_2x as j_up

from view_neti_tpu_torch.ops import attention as tatt
from view_neti_tpu_torch.ops import flash_attention as tfa
from view_neti_tpu_torch.ops import fused_conv as tfc
from view_neti_tpu_torch.ops.norm import GroupNorm, group_norm_fold
from view_neti_tpu_torch.ops.resize import nearest_upsample_2x as t_up


def _qkv(B, Lq, Lk, H, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, d).astype(np.float32),
            rng.randn(B, Lk, H, d).astype(np.float32),
            rng.randn(B, Lk, H, d).astype(np.float32))


# Lq=200 is not a 128-multiple (the TPU wrapper pads q), Lk=77 is the
# cross-attention length; d=40 is SD-1.5's first level, d=64 SD-2.1's.
@pytest.mark.parametrize("Lk,d", [(200, 40), (77, 40), (200, 64), (77, 64)])
def test_flash_attention_ref_matches_pallas_kernel(Lk, d):
    B, Lq, H = 1, 200, 2
    q, k, v = _qkv(B, Lq, Lk, H, d)
    o, lse = tfa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the logsumexp straight from the forward kernel, on its padded layout
    qf = jfa._pad_to(jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * H, Lq, d),
                     1, 128)
    kf = jfa._pad_to(jnp.asarray(k).transpose(0, 2, 1, 3).reshape(B * H, Lk, d),
                     1, 128)
    vf = jfa._pad_to(jnp.asarray(v).transpose(0, 2, 1, 3).reshape(B * H, Lk, d),
                     1, 128)
    bq, bk = jfa.select_blocks(qf.shape[1], kf.shape[1])
    _, jlse = jfa._flash_fwd(qf, kf, vf, d ** -0.5, Lk, bq, bk,
                             interpret=True)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse)[:, 0, :Lq].reshape(B, H, Lq),
        atol=1e-5, rtol=1e-5)


def test_multi_head_attention_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 16, 9, 2, 8, seed=1))
    torch.testing.assert_close(tatt.multi_head_attention(q, k, v),
                               tfa.flash_attention_ref(q, k, v)[0],
                               rtol=0, atol=0)


# ragged lengths (no 64- or 128-multiple) at both head dims of the path
@pytest.mark.parametrize("Lq,Lk,d,dtype", [
    (37, 77, 40, torch.float32), (200, 91, 40, torch.bfloat16),
    (53, 53, 64, torch.float32), (75, 77, 64, torch.bfloat16)])
def test_merged_cpu_backward_equals_dq_and_dkv_apart(Lq, Lk, d, dtype):
    """On CPU tensors flash_attention_bwd makes one pass of the plain
    arithmetic for dq, dk and dv: bit for bit the plain versions of K2
    and K3 called apart, and with one side not needed the other alone."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(2, Lq, Lk, 3, d, seed=d + Lq))
    do = torch.from_numpy(np.random.RandomState(Lk).randn(
        2, Lq, 3, d).astype(np.float32)).to(dtype)
    o, lse = tfa.flash_attention_ref(q, k, v)
    delta = tfa.attention_delta(o, do)
    apart = (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    merged = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    for got, want in zip(merged, apart):
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, need_dkv=False)
    assert dk is None and dv is None
    torch.testing.assert_close(dq, apart[0], rtol=0, atol=0)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, need_dq=False)
    assert dq is None
    torch.testing.assert_close((dk, dv), apart[1:], rtol=0, atol=0)


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, never computed by the plain version."""
    q = torch.empty(1, 8, 1, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    x = torch.empty(1, 4, 4, 8, device="meta", dtype=torch.bfloat16)
    ab = torch.empty(1, 8, device="meta")
    w = torch.empty(3, 3, 8, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfc.fused_affine_silu_conv3x3(x, ab, ab, w)


def _conv_inputs(B, H, W, Ci, Co, use_bias, use_add, use_res, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, H, W, Ci).astype(np.float32),
        a=(rng.randn(B, Ci) * 0.5).astype(np.float32),
        b=(rng.randn(B, Ci) * 0.1).astype(np.float32),
        kernel=(rng.randn(3, 3, Ci, Co) * 0.2).astype(np.float32),
        bias=rng.randn(Co).astype(np.float32) if use_bias else None,
        add_bc=rng.randn(B, Co).astype(np.float32) if use_add else None,
        residual=(rng.randn(B, H, W, Co).astype(np.float32)
                  if use_res else None))


# fp32: the same arithmetic up to summation order (1e-5). bf16: the plain
# version follows the kernel's rounding order, but bf16 products summed in
# a different order differ by a few bf16 ulps of O(1) outputs (2e-2).
@pytest.mark.parametrize("Co,use_bias,use_add,use_res,dtype,tol", [
    (16, True, False, False, "float32", 1e-5),
    (8, True, True, True, "float32", 1e-5),
    (3, True, False, False, "float32", 1e-5),
    (16, False, False, True, "float32", 1e-5),
    (16, True, True, True, "bfloat16", 2e-2),
    (3, True, False, True, "bfloat16", 2e-2),
])
def test_fused_conv_ref_matches_pallas_kernel(Co, use_bias, use_add, use_res,
                                              dtype, tol):
    inp = _conv_inputs(2, 8, 8, 16, Co, use_bias, use_add, use_res)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def jx(name, cast=True):
        a = inp[name]
        return None if a is None else jnp.asarray(a, jdt if cast
                                                  else jnp.float32)

    def tx(name, cast=True):
        a = inp[name]
        return None if a is None else torch.from_numpy(a).to(
            tdt if cast else torch.float32)

    want = jfc.fused_affine_silu_conv3x3(
        jx("x"), jx("a", False), jx("b", False), jx("kernel"), jx("bias"),
        jx("add_bc", False), jx("residual"), interpret=True)
    got = tfc.fused_affine_silu_conv3x3_ref(
        tx("x"), tx("a", False), tx("b", False), tx("kernel"), tx("bias"),
        tx("add_bc", False), tx("residual"))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_fused_conv_on_cpu_is_the_plain_version():
    inp = {k: (None if v is None else torch.from_numpy(v))
           for k, v in _conv_inputs(1, 6, 5, 8, 8, True, True, True).items()}
    torch.testing.assert_close(tfc.fused_affine_silu_conv3x3(**inp),
                               tfc.fused_affine_silu_conv3x3_ref(**inp),
                               rtol=0, atol=0)


def test_group_norm_fold_and_normalize_match_fast_group_norm():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 5, 16) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    gn = FastGroupNorm(num_groups=4, epsilon=1e-6)
    ja, jb = gn.apply(params, jnp.asarray(x), fold=True)
    jy = gn.apply(params, jnp.asarray(x))

    tgn = GroupNorm(4, 16, eps=1e-6).requires_grad_(False)
    tgn.load_state_dict({"weight": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)})
    ta, tb = group_norm_fold(torch.from_numpy(x), 4, tgn.weight, tgn.bias,
                             1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-5)
    ty = tgn(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)


def test_upsample_and_single_head_attention_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(t_up(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_up(jnp.asarray(x))))
    q, k, v = (rng.randn(2, 30, 16).astype(np.float32) for _ in range(3))
    want = j_sha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=8)
    got = tatt.single_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
