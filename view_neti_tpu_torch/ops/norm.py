"""GroupNorm and LayerNorm with fp32 statistics, on NHWC tensors; GroupNorm
as the hand-written kernels K5 on the card.

The port's counterpart of view_neti_tpu/ops/norm.py. Statistics are fp32
whatever the compute dtype, with the same one-pass variance
max(E[x^2] - E[x]^2, 0), and `fold=True` returns the per-(B, C) affine
(a, b) with normalize(x) == x*a + b that the fused conv kernel
(ops/fused_conv.py) consumes. Parameters stay fp32 (`weight`, `bias`, the
diffusers key names); the output takes the input's dtype.

GroupNorm on a CPU tensor is the plain chain (group_norm_ref,
group_norm_fold_ref), as on a meta tensor, which traces shapes. On a CUDA
tensor it is K5 (csrc/group_norm.cu; its
header gives the design and what bounds it): a statistics pass that reads
the activation once, the normalize with its optional SiLU in one pass, and
a backward of its own (GroupNormFunction), for bf16 and fp32 activations;
any other dtype raises, and nothing falls back to the plain chain. K5
replaces no Pallas kernel: it restores the fusion that XLA gives the JAX
package's FastGroupNorm. The wrappers launch on the current stream, so a
CUDA graph's capture records them, and count their calls in
`group_norm.launches` (utils/graphs.py's "K5": a forward, a fold or a
backward each one).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from view_neti_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P, _I, _I] + [_I] * 8 + [_P] * 3 + [_F] + [_P] * 4 + [
    _I, _P]
_BWD_ARGTYPES = [_P, _P, _I, _I] + [_I] * 8 + [_P] * 5 + [_F] + [_P] * 4 + [
    _I, _P]
# the thread slots of one block, and the blocks a launch aims for: eight
# blocks of 256 threads fill one of the H100's 132 SMs
THREADS = 256
TARGET_BLOCKS = 132 * 8
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# ------------------------------------------------------------- plain ----

def _stats_fold_ref(x, num_groups, weight, bias, eps):
    """The plain statistics and fold: per-(B, C) fp32 (a, b), and per
    (B, G) the mean and E[x^2] - mean^2 before the clamp, (B, G, 2)."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    x32 = x.reshape(B, -1, G, C // G).float()
    mean = x32.mean(dim=(1, 3), keepdim=True)
    mean2 = x32.square().mean(dim=(1, 3), keepdim=True)
    var_raw = mean2 - mean.square()
    var = torch.clamp(var_raw, min=0.0)
    a = torch.rsqrt(var + eps) * weight.float().reshape(1, 1, G, C // G)
    b = bias.float().reshape(1, 1, G, C // G) - mean * a
    stats = torch.stack([mean.reshape(B, G), var_raw.reshape(B, G)], -1)
    return a.reshape(B, C), b.reshape(B, C), stats


def group_norm_fold_ref(x: torch.Tensor, num_groups: int,
                        weight: torch.Tensor, bias: torch.Tensor,
                        eps: float):
    """(B, ..., C) -> per-(B, C) fp32 (a, b) with normalize(x) = x*a + b."""
    a, b, _ = _stats_fold_ref(x, num_groups, weight, bias, eps)
    return a, b


def _apply_ref(x, a, b, silu):
    """cast(x*a + b), then F.silu where `silu`."""
    B, C = x.shape[0], x.shape[-1]
    y = x.reshape(B, -1, C).float() * a[:, None, :] + b[:, None, :]
    y = y.reshape(x.shape).to(x.dtype)
    return F.silu(y) if silu else y


def group_norm_ref(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   silu: bool = False) -> torch.Tensor:
    """The plain chain, differentiable by autograd: the fold, the normalize
    cast to x's dtype, then F.silu where `silu`."""
    return _apply_ref(x, *group_norm_fold_ref(x, num_groups, weight, bias,
                                              eps), silu)


def group_norm_backward_ref(grad, x, weight, a, b, stats, num_groups, eps,
                            silu):
    """K5's backward in plain PyTorch, in its arithmetic: (dx, dgamma,
    dbeta) from the upstream gradient, x and the forward's a, b and stats
    (dgamma and dbeta fp32). The sums over pixels are fp32, those over
    chunks, channels and groups double, as in the kernels."""
    B, C = x.shape[0], x.shape[-1]
    G, cg = num_groups, C // num_groups
    x32 = x.reshape(B, -1, C).float()
    gy = grad.reshape(B, -1, C)
    if silu:
        y = (x32 * a[:, None, :] + b[:, None, :]).to(x.dtype).float()
        s = torch.sigmoid(y)
        gy = (gy.float() * s * (1 + y * (1 - s))).to(x.dtype)
    gy = gy.float()
    s0 = gy.sum(1).double().reshape(B, G, cg)
    s1 = (gy * x32).sum(1).double().reshape(B, G, cg)
    mean, var = stats[..., 0].double(), stats[..., 1]
    r = torch.rsqrt(var.clamp(min=0.0) + eps).double()
    da = s1 - mean[..., None] * s0
    dr = (weight.double().reshape(1, G, cg) * da).sum(-1)
    dvar = torch.where(var >= 0, dr * (-0.5 * r ** 3), 0.0)
    dmean = -(a.double().reshape(B, G, cg) * s0).sum(-1) - 2 * mean * dvar
    n = x32.shape[1] * cg
    c1 = (2 * dvar / n).float().repeat_interleave(cg, 1)
    c2 = (dmean / n).float().repeat_interleave(cg, 1)
    dx = a[:, None, :] * gy + c1[:, None, :] * x32 + c2[:, None, :]
    dgamma = (r[..., None] * da).reshape(B, C).float().sum(0)
    dbeta = s0.reshape(B, C).float().sum(0)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


# ------------------------------------------------------------ kernels ----

def norm_plan(B: int, P: int, C: int, vec: int) -> Tuple[int, int, int, int]:
    """K5's launch shape for (B, P pixels, C channels) loaded `vec`
    channels a thread: (tx, ty, rows, nchunks). A block is tx vector
    columns (at most 32, the columns split evenly over ceil(C/vec/32)
    channel tiles) by ty row lanes, and takes `rows` pixels of one batch
    item, a multiple of ty; the pixels are cut into nchunks chunks, so
    that the grid holds about TARGET_BLOCKS blocks and every block at
    least one row a lane: about 8 blocks an SM from the UNet's 6x8 level
    at batch 9 to the decoder's 576x768 level at batch 3."""
    ncols = C // vec
    ctiles = -(-ncols // 32)
    tx = -(-ncols // ctiles)
    ty = THREADS // tx
    chunks = max(1, TARGET_BLOCKS // (B * ctiles))
    rows = max(-(-P // chunks), ty)
    rows = -(-rows // ty) * ty
    return tx, ty, rows, -(-P // rows)


def _vec(C: int, itemsize: int, *tensors) -> int:
    """16-byte loads where C and every pointer allow them, else one
    element."""
    vec = 16 // itemsize
    if C % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"group_norm: {msg}")


def _check(x, num_groups, *params):
    """(B, P, C) of a CUDA x that K5 takes with these (C,) parameters, or
    raises."""
    _require(x.device.type == "cuda", f"x is on {x.device}")
    _require(x.dtype in _DTYPES, f"x is {x.dtype}: K5 takes bf16 and fp32")
    _require(x.dim() >= 2, "x must be (B, ..., C)")
    B, C = x.shape[0], x.shape[-1]
    _require(C % num_groups == 0 and C // num_groups <= THREADS,
             f"{C} channels in {num_groups} groups: a group must be a whole "
             f"number of channels, at most {THREADS}")
    for t in params:
        _require(t.shape == (C,) and t.device == x.device,
                 f"parameter {tuple(t.shape)} on {t.device} for {C} "
                 f"channels on {x.device}")
    return B, x.numel() // (B * C), C


def _forward_kernels(x, num_groups, weight, bias, eps, silu, apply):
    """K5's forward on a CUDA x: (out or None, a, b, stats)."""
    B, P, C = _check(x, num_groups, weight, bias)
    x = x.contiguous()
    gamma = weight.detach().float().contiguous()
    beta = bias.detach().float().contiguous()
    out = torch.empty_like(x) if apply else None
    vec = _vec(C, x.element_size(), x, *([out] if apply else []))
    tx, ty, rows, nchunks = norm_plan(B, P, C, vec)
    part = torch.empty((2, B, nchunks, C), dtype=torch.float32,
                       device=x.device)
    ab = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    stats = torch.empty((B, num_groups, 2), dtype=torch.float32,
                        device=x.device)
    fn = build.entry("group_norm", "group_norm_fwd", _FWD_ARGTYPES)
    err = fn(x.data_ptr(), _DTYPES[x.dtype], vec, B, P, C, num_groups, tx,
             ty, rows, nchunks, part.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), eps, ab[0].data_ptr(), ab[1].data_ptr(),
             stats.data_ptr(), None if out is None else out.data_ptr(),
             int(silu), torch.cuda.current_stream(x.device).cuda_stream)
    build.check("group_norm", err, "group_norm_fwd")
    group_norm.launches += 1
    return out, ab[0], ab[1], stats


def _backward_kernels(grad, x, weight, a, b, stats, num_groups, eps, silu,
                      need_dx, need_params):
    """K5's backward on CUDA tensors: (dx, dgamma, dbeta); dx None unless
    need_dx, dgamma and dbeta None unless need_params."""
    B, P, C = _check(x, num_groups, weight)
    _require(grad.shape == x.shape and grad.dtype == x.dtype,
             f"gradient {tuple(grad.shape)} {grad.dtype} for x "
             f"{tuple(x.shape)} {x.dtype}")
    grad, x = grad.contiguous(), x.contiguous()
    dx = torch.empty_like(x) if need_dx else None
    vec = _vec(C, x.element_size(), grad, x, *([dx] if need_dx else []))
    tx, ty, rows, nchunks = norm_plan(B, P, C, vec)
    dev = x.device
    part = torch.empty((2, B, nchunks, C), dtype=torch.float32, device=dev)
    c12 = torch.empty((B, num_groups, 2), dtype=torch.float32, device=dev)
    dparams = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    gamma = weight.detach().float().contiguous()
    fn = build.entry("group_norm", "group_norm_bwd", _BWD_ARGTYPES)
    err = fn(grad.data_ptr(), x.data_ptr(), _DTYPES[x.dtype], vec, B, P, C,
             num_groups, tx, ty, rows, nchunks, part.data_ptr(),
             gamma.data_ptr(), a.data_ptr(), b.data_ptr(), stats.data_ptr(),
             eps, c12.data_ptr(),
             dparams[0].data_ptr() if need_params else None,
             dparams[1].data_ptr() if need_params else None,
             None if dx is None else dx.data_ptr(), int(silu),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("group_norm", err, "group_norm_bwd")
    group_norm.launches += 1
    if not need_params:
        return dx, None, None
    dgamma, dbeta = dparams.sum(1)
    return dx, dgamma, dbeta


# ----------------------------------------------------------- wrappers ----

class GroupNormFunction(torch.autograd.Function):
    """GroupNorm (+ SiLU) of an NHWC CUDA x as K5, differentiable: the
    forward saves x, the per-(B, C) affine and the per-(B, G) statistics,
    never an fp32 copy of x; the backward recomputes the normalize from
    them (group_norm_backward_ref is its arithmetic in plain PyTorch)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        out, a, b, stats = _forward_kernels(x, num_groups, weight, bias, eps,
                                            silu, apply=True)
        ctx.save_for_backward(x, weight, a, b, stats)
        ctx.num_groups, ctx.eps, ctx.silu = num_groups, eps, silu
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, a, b, stats = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dgamma, dbeta = _backward_kernels(
            grad, x, weight, a, b, stats, ctx.num_groups, ctx.eps, ctx.silu,
            need_dx=need_x, need_params=need_w or need_b)
        return (dx if need_x else None,
                dgamma if need_w else None,
                dbeta if need_b else None, None, None, None)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last axis of x (B, ..., C), then SiLU where
    `silu`, in x's dtype. A CPU (or meta) tensor takes the plain chain
    (group_norm_ref); a CUDA tensor K5, forward and backward, or raises."""
    if x.device.type != "cuda":
        return group_norm_ref(x, num_groups, weight, bias, eps, silu)
    return GroupNormFunction.apply(x, weight, bias, num_groups, eps, silu)


group_norm.launches = 0


def group_norm_fold(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float):
    """(B, ..., C) -> per-(B, C) fp32 (a, b) with normalize(x) = x*a + b.
    A CPU (or meta) tensor takes the plain fold; a CUDA tensor K5's
    statistics, which are forward-only as K4 is: it refuses inputs that
    require grad while grad mode is on."""
    if x.device.type != "cuda":
        return group_norm_fold_ref(x, num_groups, weight, bias, eps)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("group_norm_fold is forward-only on the card: "
                           "its inputs require grad with grad mode on")
    _, a, b, _ = _forward_kernels(x, num_groups, weight, bias, eps, silu=False,
                                  apply=False)
    return a, b


class GroupNorm(nn.Module):
    """GroupNorm over the last (channel) axis of an NHWC tensor."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, fold: bool = False,
                silu: bool = False):
        """normalize(x), then SiLU where `silu`; with `fold`, the per-(B, C)
        affine (a, b) instead (silu does not apply)."""
        if fold:
            return group_norm_fold(x, self.num_groups, self.weight,
                                   self.bias, self.eps)
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps, silu)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and statistics, output in the input's
    dtype (flax nn.LayerNorm(dtype=compute) semantics)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)
