"""Fused GroupNorm-affine + SiLU + conv3x3: the hand-written Hopper kernel
(K4) and its plain PyTorch version.

Replaces view_neti_tpu/ops/fused_conv.py::_kernel (launched by
fused_affine_silu_conv3x3, the TPU's Pallas kernel). The CUDA source is
csrc/fused_conv.cu; see its header for the design and what bounds it on an
H100. None of the TPU kernel's gates carries over: its VMEM plan, its
128-channel alignment rule (a Mosaic DMA constraint) and its profitability
thresholds (measured on the TPU) are gone, and every call on a CUDA tensor
runs the kernel, ragged channel counts included.

Contract, as in the JAX package: x (B, H, W, Cin) NHWC; a, b (B, Cin) the
per-sample affine from ops.norm.group_norm_fold; kernel (3, 3, Cin, Cout)
HWIO in the compute dtype; bias (Cout,); add_bc (B, Cout) broadcast over H
and W (the UNet time-embedding add); residual (B, H, W, Cout). Stride 1,
zero padding 1, applied to the post-SiLU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from view_neti_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I, _P] + [_I] * 6 + [_P]


def fused_affine_silu_conv3x3_ref(x, a, b, kernel, bias=None, add_bc=None,
                                  residual=None, out_dtype=None):
    """Plain version in the kernel's rounding order: the normalize is cast
    to the compute dtype before the SiLU, y * sigmoid(f32(y)) is cast back,
    the convolution accumulates in fp32 and the epilogue adds in fp32 with
    one cast at the end."""
    cd = kernel.dtype
    out_dtype = out_dtype or cd
    y = (x.float() * a.float()[:, None, None, :]
         + b.float()[:, None, None, :]).to(cd)
    y = y * torch.sigmoid(y.float()).to(cd)
    out = F.conv2d(y.permute(0, 3, 1, 2).float(),
                   kernel.permute(3, 2, 0, 1).float(), padding=1)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if add_bc is not None:
        out = out + add_bc.float()[:, None, None, :]
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype).contiguous()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_affine_silu_conv3x3: {msg}")


def fused_affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, kernel: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              add_bc: Optional[torch.Tensor] = None,
                              residual: Optional[torch.Tensor] = None,
                              out_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """conv3x3(silu(a*x + b)) + bias + add_bc + residual, NHWC.

    A CPU tensor takes the plain version; a CUDA tensor launches K4 or
    raises."""
    if x.device.type == "cpu":
        return fused_affine_silu_conv3x3_ref(x, a, b, kernel, bias, add_bc,
                                             residual, out_dtype)
    _require(x.device.type == "cuda", f"x is on {x.device}")
    _require(x.dim() == 4 and kernel.dim() == 4, "x must be (B, H, W, Cin) "
             "and kernel (3, 3, Cin, Cout)")
    B, H, W, Cin = x.shape
    Cout = kernel.shape[3]
    out_dtype = out_dtype or kernel.dtype
    _require(kernel.shape[:3] == (3, 3, Cin), f"kernel {tuple(kernel.shape)}"
             f" does not match Cin={Cin}")
    _require(x.dtype == torch.bfloat16 and kernel.dtype == torch.bfloat16,
             f"x {x.dtype} / kernel {kernel.dtype}: the kernel takes bf16")
    _require(Cin % 8 == 0, f"Cin={Cin} must be a multiple of 8")
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"out_dtype {out_dtype} unsupported")
    # the JAX wrapper's casts: the affine and the time embedding are fp32
    a = a.float().contiguous()
    b = b.float().contiguous()
    _require(a.shape == (B, Cin) and b.shape == (B, Cin), "a, b must be "
             "(B, Cin)")
    tensors = [x, a, b, kernel]
    if bias is not None:
        _require(bias.shape == (Cout,) and bias.dtype == torch.bfloat16,
                 "bias must be (Cout,) bf16")
        tensors.append(bias)
    if add_bc is not None:
        add_bc = add_bc.float().contiguous()
        _require(add_bc.shape == (B, Cout), "add_bc must be (B, Cout)")
        tensors.append(add_bc)
    if residual is not None:
        _require(residual.shape == (B, H, W, Cout)
                 and residual.dtype in (torch.bfloat16, torch.float32),
                 "residual must be (B, H, W, Cout) bf16 or fp32")
        tensors.append(residual)
    for t in tensors:
        _require(t.device == x.device, f"tensor on {t.device}, x on "
                 f"{x.device}")
        _require(t.is_contiguous(), f"tensor of shape {tuple(t.shape)} is "
                 f"not contiguous")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")

    out = torch.empty((B, H, W, Cout), dtype=out_dtype, device=x.device)
    fn = build.entry("fused_conv", "fused_affine_silu_conv3x3_bf16",
                     _ARGTYPES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), kernel.data_ptr(),
             ptr(bias), ptr(add_bc), ptr(residual),
             int(residual is not None and residual.dtype == torch.float32),
             out.data_ptr(), int(out_dtype == torch.float32),
             B, H, W, Cin, Cout,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("fused_conv", err, "fused_affine_silu_conv3x3_bf16")
    fused_affine_silu_conv3x3.launches += 1
    return out


fused_affine_silu_conv3x3.launches = 0
