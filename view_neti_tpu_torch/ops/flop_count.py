"""Model FLOPs from shapes: the operations a call's algorithm needs, 2 for
each multiply-add of its matrix products, convolutions and attention
products. Recomputation is not counted: gradient checkpointing's second
forward, and the S and dP that K2 and K3 recompute from the forward's
log-sum-exp.

PyTorch's own ops are counted by torch.utils.flop_counter.FlopCounterMode.
The four kernels are ctypes launches that it cannot see, so while a
`KernelFlops` context is open each kernel wrapper adds its launch's count
(the formulas below, the counterparts of the TPU kernels' pl.CostEstimate
in view_neti_tpu/ops/flash_attention.py:148 and fused_conv.py:366). With no
context open the wrappers pay one attribute test. A wrapper given CPU
tensors runs its plain version, whose ops FlopCounterMode counts: there
the attention backward's one pass recomputes S from the log-sum-exp, so a
CPU count holds that product (a fifth of the backward's) where the card's
does not.

`count_flops(fn, *args)` runs fn once, eagerly, under both.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch


def attention_flops(B: int, H: int, Lq: int, Lk: int, d: int) -> int:
    """K1, the forward: S = Q Kᵀ and O = P V. It is also K2's (dP = dO Vᵀ
    and dQ = dS K) and K3's (dV = Pᵀ dO and dK = dSᵀ Q). Lk unpadded."""
    return 4 * B * H * Lq * Lk * d


def conv3x3_flops(B: int, H: int, W: int, Cin: int, Cout: int) -> int:
    """K4: the 3x3 convolution at stride 1 with zero padding 1; the affine,
    the SiLU, the bias and the residual are elementwise."""
    return 2 * 9 * B * H * W * Cin * Cout


class KernelFlops:
    """While open, the kernel wrappers add each launch's FLOPs to
    `by_kernel` ({"K1": n, ...}). One context at a time, never around a
    CUDA graph's capture: a capture launches nothing."""

    active: Optional["KernelFlops"] = None

    def __init__(self):
        self.by_kernel: Dict[str, int] = {}

    def add(self, key: str, flops: int) -> None:
        self.by_kernel[key] = self.by_kernel.get(key, 0) + flops

    def __enter__(self) -> "KernelFlops":
        if KernelFlops.active is not None:
            raise RuntimeError("a KernelFlops count is already open")
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("KernelFlops opened inside a CUDA graph "
                               "capture, which launches nothing")
        KernelFlops.active = self
        return self

    def __exit__(self, *exc) -> None:
        KernelFlops.active = None


@contextlib.contextmanager
def _no_recompute(modules):
    """The modules' gradient checkpointing off (their configs'
    gradient_checkpointing flag, read at each forward), so that a count
    holds no second forward."""
    saved = [(m, m.config) for m in modules
             if getattr(m.config, "gradient_checkpointing", False)]
    try:
        for m, cfg in saved:
            m.config = dataclasses.replace(cfg, gradient_checkpointing=False)
        yield
    finally:
        for m, cfg in saved:
            m.config = cfg


def count_flops(fn: Callable, *args, recompute_modules=()) -> Dict[str, int]:
    """The model FLOPs of one eager call fn(*args) by source: {"aten":
    PyTorch's ops', "K1": ..., ...} for the kernels launched.
    recompute_modules: the modules whose gradient checkpointing is
    switched off for the call."""
    from torch.utils.flop_counter import FlopCounterMode
    with _no_recompute(recompute_modules), \
            FlopCounterMode(display=False) as aten, KernelFlops() as kernels:
        fn(*args)
    return {"aten": int(aten.get_total_flops()), **kernels.by_kernel}
