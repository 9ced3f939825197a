"""K3's split of the queries across blocks (ops/flash_attention.py
dkv_splits / dkv_split_rows, plain Python) and its wrapper on CPU tensors,
against the JAX package's Pallas backward in interpret mode.

The split only decides how the card's blocks share the work; the kernel
itself runs on the card (test_torch_port_kernels.py)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu.ops import flash_attention as jfa

from view_neti_tpu_torch.ops import flash_attention as tfa

# the streaming multiprocessors of an H100 SXM, the card the port targets
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's parallel regions spend most
    of their time waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the train step's self-attentions at levels 0 and 1 (B 9, 8 heads), whose
# key tiles already fill two waves of 132 SMs, and larger grids
@pytest.mark.parametrize("B,H,Lq,Lk", [
    (9, 8, 3072, 3072), (9, 8, 768, 768), (6, 8, 6912, 6912),
    (4, 8, 70, 1100), (33, 8, 77, 77)])
def test_dkv_splits_is_one_when_the_grid_fills_two_waves(B, H, Lq, Lk):
    assert -(-Lk // tfa.DKV_KEY_TILE) * B * H >= 2 * H100_SMS
    assert tfa.dkv_splits(B, H, Lq, Lk, H100_SMS) == 1
    assert tfa.dkv_split_rows(Lq, 1) >= Lq


# the train step's cross-attentions (77 keys) and its small self-attentions:
# 72 or 144 blocks, under two waves
@pytest.mark.parametrize("B,H,Lq,Lk,want", [
    (9, 8, 3072, 77, 4), (9, 8, 768, 77, 4), (9, 8, 192, 77, 3),
    (9, 8, 192, 192, 2)])
def test_dkv_splits_splits_the_small_grids(B, H, Lq, Lk, want):
    assert tfa.dkv_splits(B, H, Lq, Lk, H100_SMS) == want > 1


@pytest.mark.parametrize("Lk", [1, 77, 128, 300])
def test_every_split_holds_a_query_tile(Lk):
    """For every grid, on an H100 PCIe (114 SMs) and SXM (132): splits of
    whole 64-query granules that cover Lq, none of them empty, and never
    more splits than granules."""
    for sms, B, H in itertools.product((114, H100_SMS), (1, 2, 9),
                                       (1, 3, 8)):
        for Lq in range(1, 1600, 13):
            s = tfa.dkv_splits(B, H, Lq, Lk, sms)
            rows = tfa.dkv_split_rows(Lq, s)
            assert rows % tfa.DKV_QUERY_GRANULE == 0
            assert 1 <= s <= -(-Lq // tfa.DKV_QUERY_GRANULE)
            assert (s - 1) * rows < Lq <= s * rows, (sms, B, H, Lq, Lk, s)


# a split shape (the last split short) and an unsplit one
@pytest.mark.parametrize("B,Lq,Lk,H,d", [(1, 200, 77, 2, 40),
                                          (2, 70, 64, 1, 16)])
def test_dkv_wrapper_on_the_cpu_is_the_plain_backward(B, Lq, Lk, H, d):
    """K3's wrapper on CPU tensors gives flash_attention_bwd_ref's dk and dv
    exactly, whatever dkv_splits says, and that agrees with jax.grad of the
    Pallas flash attention in interpret mode (fp32 on both sides: 2e-5
    absolute on gradients of size <= 1)."""
    rng = np.random.RandomState(Lq + Lk)
    q, k, v, do = (rng.randn(*shape).astype(np.float32)
                   for shape in ((B, Lq, H, d), (B, Lk, H, d), (B, Lk, H, d),
                                 (B, Lq, H, d)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv)
    delta = tfa.attention_delta(o, tdo)
    dk, dv = tfa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta)
    _, rdk, rdv = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                              need_dq=False)
    torch.testing.assert_close(dk, rdk, rtol=0, atol=0)
    torch.testing.assert_close(dv, rdv, rtol=0, atol=0)

    def f(k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, interpret=True) * do)

    want = jax.grad(f, argnums=(0, 1))(k, v)
    for g, w in zip((dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)
