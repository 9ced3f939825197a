"""Flash attention: the hand-written Hopper kernels K1 (forward), K2 (dq) and
K3 (dk, dv), their plain PyTorch versions, and the autograd Function that
joins them.

Replaces view_neti_tpu/ops/flash_attention.py: K1 its _fwd_kernel (launched
by _flash_fwd), K2 and K3 its _bwd_dq_kernel and _bwd_dkv_kernel (launched
by _flash_bwd_rule, the custom_vjp backward). The CUDA sources are
csrc/flash_attention_fwd_sm90.cu and csrc/flash_attention_fwd.cu (K1's two
designs, chosen per shape by fwd_design), csrc/flash_attention_bwd_dq_sm90.cu
and csrc/flash_attention_bwd_dq.cu (K2's two designs) and
csrc/flash_attention_bwd_dkv_sm90.cu and csrc/flash_attention_bwd_dkv.cu
(K3's, with their split reduction, csrc/dkv_reduce.cuh), K2's and K3's
chosen per shape by bwd_design; see their headers for the design and what
bounds each kernel on an H100.

Layout at this module's functions is the JAX package's: q (B, Lq, H, d),
k/v (B, Lk, H, d); the forward returns o (B, Lq, H, d) in q's dtype and the
per-row logsumexp lse (B, H, Lq) in fp32, which the backward reads back to
recompute the probabilities. The TPU wrapper's padding of q and kv to
128-multiples and its (B, L, H, d) -> (B*H, L, d) transposes become strides
and bounds checks in the kernels.

Each wrapper launches on the current stream and counts its launch in
`<wrapper>.launches`, and its model FLOPs where a count is open
(ops/flop_count.py); each also counts its design's launches in
`<wrapper>.designs`. Under a CUDA graph's capture (utils/graphs.py) the
launch goes into the graph: the first-launch work (the library's load and
K3's tile check here, the kernels' shared-memory attribute in
csrc/mma_tiles.cuh) has run in the eager warm-up before, K3's split
scratch comes from the graph's memory pool, and the graph keeps the
counts and adds them on every replay.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from view_neti_tpu_torch.ops import build
from view_neti_tpu_torch.ops.flop_count import KernelFlops, attention_flops

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_FWD_ARGTYPES = [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P]
_DQ_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 15 + [_F, _P]
_DKV_ARGTYPES = [_P] * 9 + [_I] * 7 + [_L] * 18 + [_F, _P]
# K1's designs: (library, C entry point)
FWD_ENTRIES = {
    "sm90": ("flash_attention_fwd_sm90", "flash_attention_fwd_sm90_bf16"),
    "mma_sync": ("flash_attention_fwd", "flash_attention_fwd_bf16")}
# K2's ("dq") and K3's ("dkv") designs: the library of each, whose C entry
# point is flash_attention_bwd_<kernel>[_sm90]_bf16
BWD_ENTRIES = {
    "dq": {"sm90": "flash_attention_bwd_dq_sm90",
           "mma_sync": "flash_attention_bwd_dq"},
    "dkv": {"sm90": "flash_attention_bwd_dkv_sm90",
            "mma_sync": "flash_attention_bwd_dkv"}}
# K3 keeps a warp's dK and dV accumulators (2 x 16 x d fp32) in registers
# beside its score fragments, which caps the head dim of the backward
MAX_BWD_HEAD_DIM = 192
# K3's key rows per block and the query granule of its split across blocks;
# the library reports its own, and the first launch checks they agree
DKV_KEY_TILE = 128
DKV_QUERY_GRANULE = 64


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _check_dkv_tiles(lib_name: str) -> None:
    """Both K3 designs split the queries by dkv_splits: each library's key
    tile and query granule must be the wrapper's."""
    lib = build.load(lib_name)
    have = (getattr(lib, f"{lib_name}_key_tile")(),
            getattr(lib, f"{lib_name}_query_granule")())
    if have != (DKV_KEY_TILE, DKV_QUERY_GRANULE):
        raise RuntimeError(f"{lib_name}: the library's key tile and query "
                           f"granule {have} are not the wrapper's "
                           f"{(DKV_KEY_TILE, DKV_QUERY_GRANULE)}")


def dkv_splits(B: int, H: int, Lq: int, Lk: int, sms: int) -> int:
    """How many query splits K3 runs on a card with `sms` multiprocessors:
    1 when its (key tile, batch*head) blocks already fill two waves, else
    enough splits of whole 64-query granules to reach about two waves. Each
    split holds at least one granule:
    (splits - 1) * dkv_split_rows(Lq, splits) < Lq."""
    blocks = math.ceil(Lk / DKV_KEY_TILE) * B * H
    if blocks >= 2 * sms:
        return 1
    granules = math.ceil(Lq / DKV_QUERY_GRANULE)
    want = min(granules, math.ceil(2 * sms / blocks))
    # splits = ceil(granules / per_split) leaves no split empty
    return math.ceil(granules / math.ceil(granules / want))


def dkv_split_rows(Lq: int, splits: int) -> int:
    """The queries of each of K3's splits (the last may hold fewer): whole
    64-query granules."""
    granules = math.ceil(Lq / DKV_QUERY_GRANULE)
    return math.ceil(granules / splits) * DKV_QUERY_GRANULE


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version: fp32 logits and softmax (view_neti_tpu/ops/attention.py
    mha_jnp), plus the logsumexp. Returns (o in q.dtype, lse fp32)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return o.to(q.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in fp32, (B, Lq, H, d) -> (B, H, Lq): the term
    the JAX backward computes outside its kernels (_flash_bwd_rule)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, need_dq=True, need_dkv=True):
    """The backward's arithmetic in fp32 from delta: (dq or None,
    dk or None, dv or None) in q's, k's and v's dtypes."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    dq = dk = dv = None
    if need_dq:
        dq = (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)
    if need_dkv:
        dk = (torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale).to(k.dtype)
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_ref(q, k, v, o, lse, do, need_dq: bool = True,
                            need_dkv: bool = True):
    """Plain backward in fp32 by the recomputation formulas of the JAX
    backward: p = exp(scale q kᵀ - lse), ds = p (do vᵀ - delta),
    dq = scale ds k, dk = scale dsᵀ q, dv = pᵀ do, with
    delta = rowsum(do o). Returns (dq, dk, dv) in q's, k's and v's dtypes;
    a gradient that is not needed comes back as None."""
    return _bwd_plain(q, k, v, do, lse, attention_delta(o, do), need_dq,
                      need_dkv)


def _check_operands(what: str, named, max_d: int):
    """Raise unless every (name, tensor) is a bf16 (B, L, H, d) CUDA tensor on
    the first one's device that the kernels' 16-byte loads can read."""
    first = named[0][1]
    for name, t in named:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"{named[0][0]} on {first.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} is {t.dtype}; the kernel "
                             f"takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, L, H, d)")
        d = t.shape[3]
        if d % 8 != 0 or d > max_d:
            raise ValueError(f"{what}: head dim {d} unsupported (the kernel "
                             f"needs d % 8 == 0 and d <= {max_d})")
        # 16-byte vector loads along d: unit stride in d, 8-element
        # multiples elsewhere, a 16-byte aligned base
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} strides {t.stride()} / "
                             f"alignment not supported")


def _check_shapes(what: str, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be (B, L, H, d)")
    B, _, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, d):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def fwd_design(d: int, Lk: int) -> str:
    """Which K1 design a CUDA call with head dim d and Lk keys launches:
    "sm90" (csrc/flash_attention_fwd_sm90.cu) for the head-dim buckets 48,
    64, 80 and 160 (SD-1.5's d = 40, 80 and 160, SD-2.1's 64) at any Lk,
    else "mma_sync" (csrc/flash_attention_fwd.cu). Lk is the kernel's own
    choice inside the Hopper design (up to 80 keys its short-key kernel)."""
    return "sm90" if 32 < d <= 80 or 144 < d <= 160 else "mma_sync"


def _launch_fwd(q, k, v, design=None):
    """K1's `design` (fwd_design's by default) on CUDA tensors, checked:
    (o, lse, design). Counts nothing."""
    _check_shapes("flash_attention", q, k, v)
    _check_operands("flash_attention", (("q", q), ("k", k), ("v", v)), 256)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: inputs require grad with grad mode on, and the "
            "kernel's output has no grad_fn; use FlashAttention.apply")
    B, Lq, H, d = q.shape
    Lk = k.shape[1]
    design = design or fwd_design(d, Lk)
    o = torch.empty((B, Lq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib, symbol = FWD_ENTRIES[design]
    fn = build.entry(lib, symbol, _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, Lq, Lk, d, *_strides(q, k, v, o),
             d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, symbol)
    return o, lse, design


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q kᵀ / sqrt(d)) v over (B, L, H, d) tensors -> (o, lse).

    A CPU tensor takes the plain version; a CUDA tensor launches the K1
    design that fwd_design names, or raises: nothing falls back to the
    other design. K1's output carries no gradient, so on the card it
    refuses inputs that require one while grad mode is on: differentiate
    through FlashAttention.apply instead."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    o, lse, design = _launch_fwd(q, k, v)
    flash_attention.launches += 1
    flash_attention.designs[design] += 1
    if KernelFlops.active is not None:
        B, Lq, H, d = q.shape
        KernelFlops.active.add("K1", attention_flops(B, H, Lq, k.shape[1],
                                                     d))
    return o, lse


flash_attention.launches = 0
flash_attention.designs = {"sm90": 0, "mma_sync": 0}


def _flash_attention_mma_sync(q, k, v):
    """K1's mma.sync design (csrc/flash_attention_fwd.cu) at any shape, for
    timing and checking it beside the sm90 design on the card; counts
    nothing. CUDA tensors only."""
    return _launch_fwd(q, k, v, "mma_sync")[:2]


def _check_bwd(what, q, k, v, do, lse, delta):
    _check_shapes(what, q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} must be q's shape")
    _check_operands(what, (("q", q), ("k", k), ("v", v), ("do", do)),
                    MAX_BWD_HEAD_DIM)
    B, Lq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Lq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{what}: {name} must be a contiguous fp32 "
                             f"(B, H, Lq) tensor on q's device")


def bwd_design(d: int, Lk: int) -> str:
    """Which design of K2 and K3 a CUDA call with head dim d and Lk keys
    launches: "sm90" (csrc/flash_attention_bwd_dq_sm90.cu,
    csrc/flash_attention_bwd_dkv_sm90.cu) for the head-dim buckets 48 and
    64 above 80 keys (the self-attentions of SD-1.5's d = 40 and SD-2.1's
    d = 64), else "mma_sync" (csrc/flash_attention_bwd_dq.cu,
    csrc/flash_attention_bwd_dkv.cu): the 77-key cross-attentions, the
    buckets 80 and 160 and SD-2.1's 48-key mid block."""
    return "sm90" if 32 < d <= 64 and Lk > 80 else "mma_sync"


def _bwd_entry(kernel: str, design: str):
    lib = BWD_ENTRIES[kernel][design]
    symbol = f"{lib}_bf16"
    argtypes = _DQ_ARGTYPES if kernel == "dq" else _DKV_ARGTYPES
    return lib, symbol, build.entry(lib, symbol, argtypes)


def _launch_bwd_dq(q, k, v, do, lse, delta, design=None):
    """K2's `design` (bwd_design's by default) on CUDA tensors, checked:
    (dq, design). Counts nothing."""
    _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    B, Lq, H, d = q.shape
    Lk = k.shape[1]
    design = design or bwd_design(d, Lk)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib, symbol, fn = _bwd_entry("dq", design)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Lq, Lk,
             d, *_strides(q, k, v, do, dq), d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, symbol)
    return dq, design


def _launch_bwd_dkv(q, k, v, do, lse, delta, design=None):
    """K3's `design` (bwd_design's by default) on CUDA tensors, checked:
    (dk, dv, design). Counts nothing."""
    _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    B, Lq, H, d = q.shape
    Lk = k.shape[1]
    design = design or bwd_design(d, Lk)
    lib, symbol, fn = _bwd_entry("dkv", design)
    _check_dkv_tiles(lib)
    splits = dkv_splits(B, H, Lq, Lk, sm_count(q.device))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    part = (torch.empty((2, splits, B * H, Lk, d), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             part.data_ptr() if part is not None else None, B, H, Lq, Lk, d,
             splits, dkv_split_rows(Lq, splits),
             *_strides(q, k, v, do, dk, dv), d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, symbol)
    return dk, dv, design


def flash_attention_bwd_dq(q, k, v, do, lse, delta):
    """dq of flash attention from the forward's lse, the output gradient do
    and delta = attention_delta(o, do).

    A CPU tensor takes the plain version; a CUDA tensor launches the K2
    design that bwd_design names, or raises: nothing falls back to the
    other design."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, need_dkv=False)[0]
    dq, design = _launch_bwd_dq(q, k, v, do, lse, delta)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.designs[design] += 1
    if KernelFlops.active is not None:
        B, Lq, H, d = q.shape
        KernelFlops.active.add("K2", attention_flops(B, H, Lq, k.shape[1],
                                                     d))
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.designs = {"sm90": 0, "mma_sync": 0}


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """(dk, dv) of flash attention from the same inputs as
    flash_attention_bwd_dq.

    A CPU tensor takes the plain version; a CUDA tensor launches the K3
    design that bwd_design names, or raises. Where dkv_splits > 1, K3
    splits Lq across blocks into an fp32 scratch allocated here, and its
    reduction kernel sums the splits in a fixed order (no atomics: the
    result is the same from run to run)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, need_dq=False)[1:]
    dk, dv, design = _launch_bwd_dkv(q, k, v, do, lse, delta)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.designs[design] += 1
    if KernelFlops.active is not None:
        B, Lq, H, d = q.shape
        KernelFlops.active.add("K3", attention_flops(B, H, Lq, k.shape[1],
                                                     d))
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.designs = {"sm90": 0, "mma_sync": 0}


def _flash_attention_bwd_dq_mma_sync(q, k, v, do, lse, delta):
    """K2's mma.sync design (csrc/flash_attention_bwd_dq.cu) at any shape,
    for timing and checking it beside the sm90 design on the card; counts
    nothing. CUDA tensors only."""
    return _launch_bwd_dq(q, k, v, do, lse, delta, "mma_sync")[0]


def _flash_attention_bwd_dkv_mma_sync(q, k, v, do, lse, delta):
    """K3's mma.sync design (csrc/flash_attention_bwd_dkv.cu) at any shape,
    as _flash_attention_bwd_dq_mma_sync: (dk, dv)."""
    return _launch_bwd_dkv(q, k, v, do, lse, delta, "mma_sync")[:2]


def flash_attention_bwd(q, k, v, o, lse, do, need_dq: bool = True,
                        need_dkv: bool = True):
    """(dq, dk, dv) of flash attention from the forward's o and lse and the
    output gradient do; a gradient that is not needed comes back as None.
    delta = rowsum(do·o) is a PyTorch reduction, as in the JAX backward;
    K2 computes dq and K3 dk and dv. On CPU tensors one pass of the plain
    arithmetic builds S, P and dP once for all three gradients, bit-equal
    to the plain versions of K2 and K3 called apart."""
    if o.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} must be "
                         f"q's shape {tuple(q.shape)}")
    delta = attention_delta(o, do)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, need_dq, need_dkv)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta) if need_dq else None
    dk, dv = (flash_attention_bwd_dkv(q, k, v, do, lse, delta) if need_dkv
              else (None, None))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = flash attention of (q, k, v), differentiable: the forward is K1
    and saves q, k, v, o and lse; the backward is K2 (skipped when q needs no
    gradient) and K3 (skipped when neither k nor v needs one), the
    counterpart of the JAX package's custom_vjp. On CPU tensors both passes
    are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         need_dq=need_q,
                                         need_dkv=need_k or need_v)
        return dq, (dk if need_k else None), (dv if need_v else None)
