"""AdamW over the mappers with per-mapper activity masking
(view_neti_tpu/training/optim.py).

The JAX package's `sliced_adamw` replicates what torch.optim.AdamW does
over the reference's mapper parameters, so the port uses torch's AdamW
itself, with one parameter group per mapper (per bank slice for the mode-3
object bank):
  * a mapper whose gradients are all zero (or absent) gets `.grad = None`
    before `step()`: torch then skips it entirely (no moment decay, no
    weight decay, no step count), which is what the JAX activity mask
    does per slice;
  * the learning rate of a key's groups is schedule(count), with count the
    key's number of active steps so far (the largest over the bank's slices
    for the stacked "object" key), as `sliced_adamw` evaluates it; torch's
    per-parameter step count gives each slice its own bias correction;
  * frozen keys (the mode-5 view mapper, the mode-1 object mapper) stay out
    of the optimizer;
  * under data parallelism the ranks average the gradients before `step()`
    (parallel/dist.py, over `gradients()`), so every rank decides each
    slice's activity from the same reduced gradients and keeps the same
    counts.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from view_neti_tpu_torch.config import OptimConfig

ParamGroups = Dict[str, List[List[torch.nn.Parameter]]]


class SlicedAdamW:
    """torch.optim.AdamW over {key: [slice params, ...]} with activity
    masking and a step-count learning-rate schedule."""

    def __init__(self, groups: ParamGroups,
                 learning_rate: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, frozen_keys: Sequence[str] = ()):
        self.learning_rate = learning_rate
        self.counts: Dict[str, List[int]] = {}
        param_groups = []
        for key, slices in groups.items():
            if key in frozen_keys or not slices:
                continue
            self.counts[key] = [0] * len(slices)
            for i, params in enumerate(slices):
                param_groups.append({"params": list(params), "key": key,
                                     "slice": i})
        self.optimizer = torch.optim.AdamW(
            param_groups, lr=learning_rate(1), betas=(b1, b2), eps=eps,
            weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def gradients(self) -> List[torch.Tensor]:
        """Every trainable parameter's gradient in the optimizer's order,
        a zero tensor set where one has none: the buffer the ranks average.
        The zeros change nothing: a slice whose gradients are all zero
        stays inactive in step(), and an active slice's unused leaf takes
        a zero gradient there anyway."""
        out = []
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                out.append(p.grad)
        return out

    @torch.no_grad()
    def step(self) -> None:
        groups = self.optimizer.param_groups
        sums = []
        for g in groups:
            gs = [p.grad.abs().sum() for p in g["params"]
                  if p.grad is not None]
            sums.append(torch.stack(gs).sum() if gs else None)
        # one device-to-host read for the activity of every slice
        present = [s for s in sums if s is not None]
        values = iter(torch.stack(present).tolist() if present else [])
        active = [s is not None and next(values) > 0 for s in sums]
        for g, on in zip(groups, active):
            if on:
                self.counts[g["key"]][g["slice"]] += 1
                # an unused leaf of an active slice takes a zero gradient,
                # as the JAX update treats every leaf of the subtree
                for p in g["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            else:
                for p in g["params"]:
                    p.grad = None
        for g in groups:
            g["lr"] = self.learning_rate(max(self.counts[g["key"]]))
        self.optimizer.step()


def make_lr_schedule(kind: str, base_lr: float, warmup_steps: int,
                     total_steps: int) -> Callable[[int], float]:
    """The learning rate at an optimizer step count (diffusers'
    get_scheduler names, view_neti_tpu/training/optim.py make_lr_schedule)."""
    warm = max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)
    if kind == "constant":
        return lambda step: base_lr
    if kind == "constant_with_warmup":
        return lambda step: base_lr * min(step / warm, 1.0)
    if kind == "linear":
        return lambda step: base_lr * min(
            min(step / warm, 1.0), max(0.0, (total_steps - step) / span))
    if kind == "cosine":
        def sched(step):
            prog = min(max((step - warmup_steps) / span, 0.0), 1.0)
            return (base_lr * min(step / warm, 1.0) * 0.5
                    * (1 + math.cos(math.pi * prog)))
        return sched
    raise NotImplementedError(f"lr_scheduler {kind!r}")


def scaled_learning_rate(base_lr: float, scale_lr: bool, batch_size: int,
                         grad_accum: int, num_processes: int) -> float:
    """lr *= accum * batch * processes when scale_lr (the reference's
    coach.py:728-733)."""
    if scale_lr:
        return base_lr * grad_accum * batch_size * num_processes
    return base_lr


def trainable_mask_keys(mode: int) -> Tuple[tuple, tuple]:
    """(stacked_keys, frozen_keys) per learnable mode: the object key is a
    bank of slices; view trains in modes 1-4 and is frozen in 5, object is
    frozen in 1 (view_neti_tpu/training/builder.py)."""
    frozen = ()
    if mode == 5:
        frozen = ("view",)
    if mode == 1:
        frozen = ("object",)
    return ("object",), frozen


def make_optimizer(groups: ParamGroups, cfg: OptimConfig, mode: int,
                   num_processes: int = 1) -> SlicedAdamW:
    """The optimizer of a run: the scaled learning rate under cfg's
    schedule, AdamW hyper-parameters from cfg, frozen keys by mode."""
    lr = scaled_learning_rate(cfg.learning_rate, cfg.scale_lr,
                              cfg.train_batch_size,
                              cfg.gradient_accumulation_steps, num_processes)
    sched = make_lr_schedule(cfg.lr_scheduler, lr, cfg.lr_warmup_steps,
                             cfg.max_train_steps)
    return SlicedAdamW(groups, sched, cfg.adam_beta1, cfg.adam_beta2,
                       cfg.adam_epsilon, cfg.adam_weight_decay,
                       frozen_keys=trainable_mask_keys(mode)[1])
