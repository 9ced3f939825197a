"""The weights of a run, drawn on the device from the run's seed.

One torch.Generator on the device, seeded from (seed, group), draws every
weight of a model group in one call of normal numbers, which are then
split and scaled by the tensor's role: a matrix or kernel N(0, 1/fan_in),
a bias N(0, 0.02^2), a norm's scale 1 + N(0, 0.05^2) and shift
N(0, 0.05^2), a token table N(0, 0.02^2), positions N(0, 0.01^2). The
numbers are drawn and scaled in bfloat16, the type the frozen models are
served in, so the program and the reference hold the same values. The
same seed gives the same weights, so the reference draws them again after
the window instead of keeping a copy, and a group is drawn, loaded and
freed before the next, so that the draw adds little to the peak.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch


def group_seed(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _scale_(name: str, shape: Tuple[int, ...], x: torch.Tensor) -> None:
    if name.endswith("position_embedding.weight"):
        x.mul_(0.01)
    elif name.endswith("token_embedding.weight"):
        x.mul_(0.02)
    elif len(shape) >= 2:
        x.mul_(_numel(shape[1:]) ** -0.5)
    elif name.endswith(".bias"):
        parent = name.rsplit(".", 1)[0]
        norm = "norm" in parent or "ln" in parent.rsplit(".", 1)[-1]
        x.mul_(0.05 if norm else 0.02)
    else:                               # a norm's scale
        x.mul_(0.05).add_(1.0)


def draw_group(shapes: Dict[str, Tuple[int, ...]], seed: int, group: str,
               device) -> Dict[str, torch.Tensor]:
    """{name: bfloat16 tensor} of one group: views of one flat draw."""
    g = torch.Generator(device).manual_seed(group_seed(seed, group))
    flat = torch.randn(sum(_numel(s) for s in shapes.values()),
                       generator=g, device=device, dtype=torch.bfloat16)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape)
        _scale_(name, shape, out[name])
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def load_into(module: torch.nn.Module, named: Dict[str, torch.Tensor],
              what: str) -> None:
    """Copy into a module's parameters in their own dtypes; the names and
    shapes have to be the module's, all of them."""
    params = dict(module.named_parameters())
    if set(params) != set(named):
        missing = sorted(set(params) - set(named))[:5]
        extra = sorted(set(named) - set(params))[:5]
        raise KeyError(f"{what}: parameters {missing} not drawn, {extra} "
                       f"not in the program")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(named[n].shape):
                raise ValueError(f"{what}.{n}: {tuple(p.shape)} in the "
                                 f"program, {tuple(named[n].shape)} drawn")
            p.copy_(named[n])
