"""Flash-attention forward: the hand-written Hopper kernel (K1) and its plain
PyTorch version.

Replaces view_neti_tpu/ops/flash_attention.py::_fwd_kernel (launched by
_flash_fwd, the TPU's Pallas kernel). The CUDA source is
csrc/flash_attention_fwd.cu; see its header for the design and what bounds
it on an H100.

Layout at this module's functions is the JAX package's: q (B, Lq, H, d),
k/v (B, Lk, H, d); returns o (B, Lq, H, d) in q's dtype and the per-row
logsumexp lse (B, H, Lq) in fp32, which the backward of the training slice
reads. The TPU wrapper's padding of q and kv to 128-multiples and its
(B, L, H, d) -> (B*H, L, d) transposes become strides and bounds checks in
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from view_neti_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_I] * 5 + [_L] * 12 + [ctypes.c_float, _P])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version: fp32 logits and softmax (view_neti_tpu/ops/attention.py
    mha_jnp), plus the logsumexp. Returns (o in q.dtype, lse fp32)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return o.to(q.dtype), lse


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, L, H, d)")
    B, Lq, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d % 8 != 0 or d > 256:
        raise ValueError(f"flash_attention: head dim {d} unsupported "
                         f"(the kernel needs d % 8 == 0 and d <= 256)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             f"kernel takes bfloat16")
        # 16-byte vector loads along d: unit stride in d, 8-element
        # multiples elsewhere, a 16-byte aligned base
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} strides "
                             f"{t.stride()} / alignment not supported")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q kᵀ / sqrt(d)) v over (B, L, H, d) tensors -> (o, lse).

    A CPU tensor takes the plain version; a CUDA tensor launches K1 or
    raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    _check_inputs(q, k, v)
    B, Lq, H, d = q.shape
    Lk = k.shape[1]
    o = torch.empty((B, Lq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_attention_fwd", "flash_attention_fwd_bf16",
                     _ARGTYPES)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, Lq, Lk, d, *strides, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention_fwd", err, "flash_attention_fwd_bf16")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
