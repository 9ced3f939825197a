"""Attention entry points of the models (view_neti_tpu/ops/attention.py).

Every UNet attention call goes through `multi_head_attention`, which is
the flash-attention autograd Function: the hand-written kernels K1 forward
and K2/K3 backward on a CUDA tensor, their plain versions on a CPU tensor.
Unlike the TPU gate there is no shape rule that sends small levels
elsewhere. The VAE's single-head bottleneck
attention (d = 512, past the kernel's d <= 256) stays plain PyTorch, as it
stays jnp in the JAX package.

The XTI split-source contract (K from the regular context, V from the
bypass context) is resolved upstream in the projections; these functions
see standard (q, k, v).
"""
from __future__ import annotations

import torch

from view_neti_tpu_torch.ops.flash_attention import FlashAttention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q: (B, Lq, H, hd); k/v: (B, Lk, H, hd). Returns (B, Lq, H, hd)."""
    return FlashAttention.apply(q, k, v)


def single_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          chunk: int = 8192) -> torch.Tensor:
    """Exact single-head attention for the VAE's spatial AttnBlock, chunked
    over queries so the fp32 logits stay at (B, chunk, L). q/k/v: (B, L, C).
    """
    C = q.shape[-1]
    scale = C ** -0.5
    outs = []
    for s in range(0, q.shape[1], chunk):
        logits = torch.einsum("bqc,bkc->bqk", q[:, s:s + chunk].float(),
                              k.float())
        probs = torch.softmax(logits * scale, dim=-1)
        outs.append(torch.einsum("bqk,bkc->bqc", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1)
