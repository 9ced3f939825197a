"""The precision every product of the reference runs in, and the record of
the calls the flop and roofline arithmetic reads.

`mode` is "fp32" (the reference: float32 with TF32 off), "fp8" (the
control: each operand of a matrix product or convolution is rounded to
float8 e4m3 with one scale a tensor, then multiplied in float32, the
product of an fp8 GEMM; the gradient passes the rounding unchanged) or
"bf16" (the operands rounded to bfloat16, the precision the
configurations state: a witness of what rounding alone does).
`use(mode)` switches it for a block of code.

`Recorder` collects, while open, each attention call (B, H, Lq, Lk, d and
which gradients it needs) and each norm + SiLU + 3x3 convolution section
(B, H, W, Cin, Cout, residual) that the reference runs: the calls that the
port's hand-written kernels stand in for. It works on the `meta` device,
so the shapes of a cell cost no memory.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

mode = "fp32"
E4M3_MAX = 448.0


@contextlib.contextmanager
def use(new_mode: str):
    global mode
    if new_mode not in ("fp32", "fp8", "bf16"):
        raise ValueError(new_mode)
    old, mode = mode, new_mode
    try:
        yield
    finally:
        mode = old


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q(x: torch.Tensor) -> torch.Tensor:
    """x as the current mode stores an operand of a product."""
    if mode == "fp32" or x.device.type == "meta":
        return x
    if mode == "bf16":
        return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (xq - x).detach()


def linear(x, w, b=None):
    return F.linear(q(x), q(w), b)


def conv2d(x, w, b=None, stride=1, padding=0):
    """NHWC in and out; weights OIHW."""
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(w), b, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def matmul(a, b):
    return torch.matmul(q(a), q(b))


class Recorder:
    active: Optional["Recorder"] = None

    def __init__(self):
        self.attention: List[dict] = []
        self.conv: List[dict] = []
        self.where = "unet"

    @contextlib.contextmanager
    def at(self, where: str):
        """Tag the calls recorded inside with the model they belong to."""
        old, self.where = self.where, where
        try:
            yield
        finally:
            self.where = old

    def __enter__(self):
        if Recorder.active is not None:
            raise RuntimeError("a Recorder is already open")
        Recorder.active = self
        return self

    def __exit__(self, *exc):
        Recorder.active = None


def attention(qh, kh, vh, chunk: int = 8):
    """softmax(q kᵀ / sqrt(d)) v over (B, L, H, d), float32 logits, computed
    over blocks of `chunk` (batch, head) pairs so that the logits fit."""
    B, Lq, H, d = qh.shape
    Lk = kh.shape[1]
    if Recorder.active is not None:
        need_q = qh.requires_grad and torch.is_grad_enabled()
        need_kv = ((kh.requires_grad or vh.requires_grad)
                   and torch.is_grad_enabled())
        Recorder.active.attention.append(dict(
            B=B, H=H, Lq=Lq, Lk=Lk, d=d, dq=need_q, dkv=need_kv,
            where=Recorder.active.where))
    qt = qh.permute(0, 2, 1, 3).reshape(B * H, Lq, d)
    kt = kh.permute(0, 2, 1, 3).reshape(B * H, Lk, d)
    vt = vh.permute(0, 2, 1, 3).reshape(B * H, Lk, d)
    outs = []
    step = B * H if qh.device.type == "meta" else chunk
    for s in range(0, B * H, step):
        logits = matmul(qt[s:s + step], kt[s:s + step].transpose(1, 2))
        probs = torch.softmax(logits.float() * d ** -0.5, dim=-1)
        outs.append(matmul(probs, vt[s:s + step]))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(B, H, Lq, d).permute(0, 2, 1, 3)


def record_conv(x, cout: int, residual: bool) -> None:
    if Recorder.active is not None:
        B, H, W, C = x.shape
        Recorder.active.conv.append(dict(B=B, H=H, W=W, Cin=C, Cout=cout,
                                         residual=residual,
                                         where=Recorder.active.where))
