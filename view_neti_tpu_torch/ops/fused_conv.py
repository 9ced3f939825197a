"""Fused GroupNorm-affine + SiLU + conv3x3: the hand-written Hopper kernel
(K4) in two designs, and its plain PyTorch version.

Replaces view_neti_tpu/ops/fused_conv.py::_kernel (launched by
fused_affine_silu_conv3x3, the TPU's Pallas kernel). conv_design picks the
design of a call: csrc/fused_conv_sm90.cu (wgmma and TMA) for every
Cout > 16, the VAE's and the UNet's ResNet convs; csrc/fused_conv.cu
(mma.sync) for the narrow convs (the decoder's conv_out, Cout 3, and the
encoder's last conv, Cout 8). See the sources' headers for the designs
and what bounds them on an H100. None of the TPU kernel's gates carries
over: its VMEM plan, its 128-channel alignment rule (a Mosaic DMA
constraint) and its profitability thresholds (measured on the TPU) are
gone, and every call on a CUDA tensor runs a kernel, ragged channel
counts included.

Contract, as in the JAX package: x (B, H, W, Cin) NHWC; a, b (B, Cin) the
per-sample affine from ops.norm.group_norm_fold; kernel (3, 3, Cin, Cout)
HWIO in the compute dtype; bias (Cout,); add_bc (B, Cout) broadcast over H
and W (the UNet time-embedding add); residual (B, H, W, Cout). Stride 1,
zero padding 1, applied to the post-SiLU tensor.

The wrapper launches on the current stream, so a CUDA graph's capture
(utils/graphs.py) records the launch; its first-launch work runs in the
eager warm-up before, and the graph adds its launches to `launches` and
`designs` on every replay. Where a count is open it adds its model FLOPs
(ops/flop_count.py).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from view_neti_tpu_torch.ops import build
from view_neti_tpu_torch.ops.flop_count import KernelFlops, conv3x3_flops

_P = ctypes.c_void_p
_I = ctypes.c_int
# both designs' C entries take the same arguments; the mma.sync design's
# last int is its output-channel tile, the Hopper design's the weights'
# column count
_ARGTYPES = [_P] * 7 + [_I, _P] + [_I] * 7 + [_P]
# K4's designs: (library, C entry point, the library's chunk query)
CONV_ENTRIES = {
    "sm90": ("fused_conv_sm90", "fused_affine_silu_conv3x3_sm90_bf16",
             "fused_conv_sm90_cin_chunk"),
    "mma_sync": ("fused_conv", "fused_affine_silu_conv3x3_bf16",
                 "fused_conv_cin_chunk")}
# the input channels of one staged chunk of either design's halo tile; each
# library reports its own, and its first launch checks they agree
CIN_CHUNK = 64


def conv_design(cin: int, cout: int) -> str:
    """Which K4 design a CUDA call with cin input and cout output channels
    launches: "sm90" (csrc/fused_conv_sm90.cu) for every cout > 16, the
    VAE's and the UNet's ResNet convs (Cout 128 to 512 and 320 to 1280),
    at any cin the kernel takes;
    "mma_sync" (csrc/fused_conv.cu) for the narrow convs, the decoder's
    conv_out (3) and the encoder's last conv (8), on its 16-channel tile."""
    del cin  # every cin that is a multiple of 8 takes either design
    return "sm90" if cout > 16 else "mma_sync"


def conv_n_tile(cout: int) -> int:
    """The output channels of one block of K4's mma.sync design: 16 for
    the narrow convs (the decoder's conv_out, Cout 3, and the encoder's
    last conv, Cout 8), whose 128-channel tile would be 94-98 % padding,
    else 128."""
    return 16 if cout <= 16 else 128


@functools.lru_cache(maxsize=None)
def _check_chunk(design: str) -> None:
    lib, _, symbol = CONV_ENTRIES[design]
    fn = getattr(build.load(lib), symbol)
    fn.argtypes, fn.restype = [], ctypes.c_int
    have = fn()
    if have != CIN_CHUNK:
        raise RuntimeError(f"{lib}: the library's input-channel chunk "
                           f"{have} is not the wrapper's {CIN_CHUNK}")


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


def _launch(x, a, b, kernel, bias, add_bc, residual, out_dtype,
            design=None):
    """K4's `design` (conv_design's by default) on CUDA tensors, checked:
    (out, design). Counts nothing."""
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

    design = design or conv_design(Cin, Cout)
    _check_chunk(design)
    if design == "sm90":
        # the weights' tensor map needs a row pitch of a multiple of 16
        # bytes and a 16-byte aligned base: pad the columns to a multiple
        # of 8 with zeros where they are not (no VAE conv needs it)
        if Cout % 8 or kernel.data_ptr() % 16:
            kernel = F.pad(kernel, (0, -Cout % 8)).contiguous()
        last = kernel.shape[3]
    else:
        last = conv_n_tile(Cout)
    out = torch.empty((B, H, W, Cout), dtype=out_dtype, device=x.device)
    lib, symbol, _ = CONV_ENTRIES[design]
    fn = build.entry(lib, symbol, _ARGTYPES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), kernel.data_ptr(),
             ptr(bias), ptr(add_bc), ptr(residual),
             int(residual is not None and residual.dtype == torch.float32),
             out.data_ptr(), int(out_dtype == torch.float32),
             B, H, W, Cin, Cout, last,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, symbol)
    return out, design


def fused_affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, kernel: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              add_bc: Optional[torch.Tensor] = None,
                              residual: Optional[torch.Tensor] = None,
                              out_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """conv3x3(silu(a*x + b)) + bias + add_bc + residual, NHWC.

    A CPU tensor takes the plain version; a CUDA tensor launches the K4
    design that conv_design names, or raises: nothing falls back to the
    other design. The function is forward-only, as in the JAX package: it
    refuses inputs that require grad while grad mode is on."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, b, kernel, bias, add_bc, residual)):
        raise RuntimeError("fused_affine_silu_conv3x3 is forward-only: its "
                           "inputs require grad with grad mode on")
    if x.device.type == "cpu":
        return fused_affine_silu_conv3x3_ref(x, a, b, kernel, bias, add_bc,
                                             residual, out_dtype)
    out, design = _launch(x, a, b, kernel, bias, add_bc, residual,
                          out_dtype)
    fused_affine_silu_conv3x3.launches += 1
    fused_affine_silu_conv3x3.designs[design] += 1
    if KernelFlops.active is not None:
        B, H, W, Cin = x.shape
        KernelFlops.active.add("K4", conv3x3_flops(B, H, W, Cin,
                                                   kernel.shape[3]))
    return out


fused_affine_silu_conv3x3.launches = 0
fused_affine_silu_conv3x3.designs = {"sm90": 0, "mma_sync": 0}


def _fused_affine_silu_conv3x3_design(design, x, a, b, kernel, bias=None,
                                      add_bc=None, residual=None,
                                      out_dtype=None):
    """K4's `design` ("sm90" or "mma_sync") at any shape, for timing and
    checking the two beside each other on the card; counts nothing. CUDA
    tensors only."""
    return _launch(x, a, b, kernel, bias, add_bc, residual, out_dtype,
                   design)[0]
