"""AdamW over the mappers with per-mapper activity masking
(view_neti_tpu/training/optim.py).

The JAX package's `sliced_adamw` replicates torch.optim.AdamW over the
reference's mapper parameters, one parameter group per mapper (per bank
slice for the mode-3 object bank). The port computes the same update with
its own tensor ops, and keeps everything that decides it on the
parameters' device, so that a step reads nothing back to the host and can
be captured in a CUDA graph (utils/graphs.py):
  * a slice is active when any of its gradients is non-zero; an inactive
    slice keeps its parameters, moments and step count (torch.where on the
    activity), which is what the JAX activity mask does per slice and what
    torch's AdamW does for a slice whose gradients are None;
  * each slice's count of active steps is a device tensor, and each
    parameter's AdamW step is its slice's count, so every slice has its
    own bias correction;
  * the learning rate of a key's slices is schedule(count), with count
    the key's largest slice count, as `sliced_adamw` evaluates it: the
    schedule is tabulated on the device for counts 0 .. schedule_steps + 1
    and indexed there (past the table, its last entry: make_lr_schedule's
    schedules are constant after their total steps);
  * each element follows torch.optim.AdamW's single-tensor arithmetic:
    p (1 - lr wd), lerp of the first moment, the second moment's
    addcmul, sqrt(v) / sqrt(1 - b2^t) + eps, and p + (-lr / (1 - b1^t)) m
    / denom;
  * frozen keys (the mode-5 view mapper, the mode-1 object mapper) stay out
    of the optimizer;
  * under data parallelism the ranks average the gradients before `step()`
    (parallel/dist.py, over `gradients()`), so every rank decides each
    slice's activity from the same reduced gradients and keeps the same
    counts.
The update runs once per key over flat buffers that hold every
parameter, gradient and moment, a key's slices as the rows of a matrix
and each slice's factors as a column, so a step's launches do not grow
with the number of slices (mode 3 has one
object mapper per scan). The per-parameter state keeps torch.optim's
layout (`state[p]` holds "step", and "exp_avg" and "exp_avg_sq" as views
of the flat moments), which train_state.py writes.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from view_neti_tpu_torch.config import OptimConfig

ParamGroups = Dict[str, List[List[torch.nn.Parameter]]]


class AdamWState:
    """AdamW's parameter groups (one per slice: {"params", "key", "slice"})
    and per-parameter state, in torch.optim's layout."""

    def __init__(self, param_groups: List[Dict]):
        self.param_groups = param_groups
        self.state: Dict[torch.nn.Parameter, Dict[str, torch.Tensor]] = {}


class SlicedAdamW:
    """AdamW over {key: [slice params, ...]} with activity masking and a
    step-count learning-rate schedule, decided on the device."""

    def __init__(self, groups: ParamGroups,
                 learning_rate: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, frozen_keys: Sequence[str] = (),
                 schedule_steps: int = 10_000):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        param_groups = []
        for key, slices in groups.items():
            if key in frozen_keys or not slices:
                continue
            for i, params in enumerate(slices):
                param_groups.append({"params": list(params), "key": key,
                                     "slice": i})
        self.optimizer = AdamWState(param_groups)
        # the slices (indices into param_groups) of each key, in order
        self._slices: Dict[str, List[int]] = {}
        for gi, g in enumerate(param_groups):
            self._slices.setdefault(g["key"], []).append(gi)
        params = [p for g in param_groups for p in g["params"]]
        if len({p.dtype for p in params}) > 1:
            raise ValueError("SlicedAdamW takes parameters of one dtype")
        self._params = params
        device = params[0].device if params else torch.device("cpu")
        dtype = params[0].dtype if params else torch.float32
        self._count = torch.zeros(len(param_groups), dtype=torch.int64,
                                  device=device)
        # each slice's key, as an index into the keys in order
        self._slice_key = torch.tensor(
            [list(self._slices).index(g["key"]) for g in param_groups],
            dtype=torch.int64, device=device)
        self._lr_table = torch.tensor(
            [learning_rate(s) for s in range(schedule_steps + 2)],
            dtype=torch.float64, device=device)
        # each parameter's AdamW step (its slice's count), as fp32 views
        self._steps = torch.zeros(len(params), dtype=torch.float32,
                                  device=device)
        self._param_slice = torch.tensor(
            [gi for gi, g in enumerate(param_groups) for _ in g["params"]],
            dtype=torch.int64, device=device)
        # the update runs on flat buffers of every parameter, gradient and
        # moment, so that its launches do not grow with the slices; the
        # moments live there, the parameters and gradients are copied in
        # (and the parameters back) with multi-tensor copies. A key's
        # slices have one layout, so its part of a buffer is a (slices,
        # elements) matrix, and a slice's factors are a column
        sizes = [p.numel() for p in params]
        self._flat, self._views = {}, {}
        for name in ("param", "grad", "exp_avg", "exp_avg_sq"):
            flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
            self._flat[name] = flat
            self._views[name] = [v.view_as(p) for v, p in
                                 zip(flat.split(sizes), params)]
        # each key's slices (first, last + 1) and its matrices, by buffer
        self._key_rows = []
        offset = 0
        for key, idx in self._slices.items():
            layouts = {tuple(tuple(p.shape) for p in param_groups[gi][
                "params"]) for gi in idx}
            if len(layouts) != 1:
                raise ValueError(f"the slices of {key!r} differ in layout")
            n = sum(param_groups[idx[0]]["params"][j].numel()
                    for j in range(len(param_groups[idx[0]]["params"])))
            self._key_rows.append((idx[0], idx[-1] + 1, {
                name: flat[offset:offset + n * len(idx)].view(len(idx), n)
                for name, flat in self._flat.items()}))
            offset += n * len(idx)
        for j, p in enumerate(params):
            self.optimizer.state[p] = {
                "step": self._steps[j],
                "exp_avg": self._views["exp_avg"][j],
                "exp_avg_sq": self._views["exp_avg_sq"][j]}

    @property
    def counts(self) -> Dict[str, List[int]]:
        """{key: [active steps of each slice]}, read from the device."""
        values = self._count.tolist()
        return {k: [values[gi] for gi in idx]
                for k, idx in self._slices.items()}

    @counts.setter
    def counts(self, counts: Dict[str, List[int]]) -> None:
        values = [0] * len(self.optimizer.param_groups)
        for k, idx in self._slices.items():
            for gi, c in zip(idx, counts[k]):
                values[gi] = int(c)
        self._count.copy_(torch.tensor(values, dtype=torch.int64))
        self._steps.copy_(self._count[self._param_slice].float())

    def learning_rates(self) -> Dict[str, float]:
        """{key: the learning rate of its last step}, the schedule at the
        key's largest count, read from the device."""
        last = len(self._lr_table) - 1
        return {k: float(self._lr_table[min(max(c), last)])
                for k, c in self.counts.items()}

    def zero_grad(self) -> None:
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                p.grad = None

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
        params = self._params
        if not params:
            return
        count, flat = self._count, self._flat
        grads = self._views["grad"]
        torch._foreach_copy_(self._views["param"], params)
        have = [i for i, p in enumerate(params) if p.grad is not None]
        if have:
            torch._foreach_copy_([grads[i] for i in have],
                                 [params[i].grad for i in have])
        if len(have) < len(params):
            # an absent gradient is zero: it leaves an inactive slice
            # inactive, and an active slice's unused leaf takes a zero
            # gradient, as the JAX update treats every leaf of the subtree
            torch._foreach_zero_([g for i, g in enumerate(grads)
                                  if params[i].grad is None])
        active = torch.cat([mat["grad"].abs().sum(1)
                            for _, _, mat in self._key_rows]) > 0
        count += active
        self._steps.copy_(count[self._param_slice].float())
        # each key's learning rate at its largest slice count
        top = count.new_zeros(len(self._slices)).scatter_reduce_(
            0, self._slice_key, count, "amax")
        rate = self._lr_table[top.clamp(max=len(self._lr_table) - 1)][
            self._slice_key]
        t = count.double()
        bias1 = 1 - torch.pow(self.b1, t)
        bias2_sqrt = torch.pow(1 - torch.pow(self.b2, t), 0.5)
        # each slice's factors, cast to the parameters' dtype as a 0-d
        # factor is, one column per slice
        decay, neg_step, b2_sqrt = torch.stack(
            [1 - rate * self.weight_decay, -(rate / bias1), bias2_sqrt]
        ).to(flat["param"].dtype).unsqueeze(2)
        on_all = active.unsqueeze(1)
        for a, b, mat in self._key_rows:
            p, g = mat["param"], mat["grad"]
            m, v = mat["exp_avg"], mat["exp_avg_sq"]
            on = on_all[a:b]
            m_new = torch.lerp(m, g, 1 - self.b1)
            v_new = v.mul(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v_new.sqrt() / b2_sqrt[a:b]).add_(self.eps)
            p_new = p.mul(decay[a:b]).addcdiv_(m_new * neg_step[a:b], denom)
            p.copy_(torch.where(on, p_new, p))
            m.copy_(torch.where(on, m_new, m))
            v.copy_(torch.where(on, v_new, v))
        torch._foreach_copy_(params, self._views["param"])

    def load_state(self, entries: List[List[Dict]],
                   counts: Dict[str, List[int]]) -> None:
        """Restore the moments (one list per parameter group of
        {"exp_avg", "exp_avg_sq", "step"}, {} for a slice that never ran)
        and the per-slice counts."""
        groups = self.optimizer.param_groups
        if [len(g) for g in entries] != [len(g["params"]) for g in groups]:
            raise ValueError("train state's optimizer groups do not match "
                             "the run's")
        for g, saved in zip(groups, entries):
            for p, e in zip(g["params"], saved):
                st = self.optimizer.state[p]
                for name in ("exp_avg", "exp_avg_sq"):
                    st[name].copy_(torch.as_tensor(e[name]) if e
                                   else torch.zeros_like(st[name]))
        self.counts = counts


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
                       frozen_keys=trainable_mask_keys(mode)[1],
                       schedule_steps=cfg.max_train_steps)
