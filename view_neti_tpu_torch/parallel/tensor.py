"""Tensor parallelism over torch.distributed: the port's counterpart of the
tp axis of view_neti_tpu/parallel/mesh.py (_TP_PATTERNS,
frozen_param_shardings) and of the JAX Coach's _place_frozen_on_mesh.

Under parallel.tensor_parallel the frozen UNet's attention and
feed-forward projections and CLIP's MLP are split over the ranks of a tp
group (parallel/dist.py: tp consecutive ranks, which hold the same rows),
in the port's diffusers/transformers key names:

  key (a Linear)                    split     JAX pattern (mesh.py:121-128)
  attn1/attn2 .to_q .to_k .to_v     column    (to_q|to_k|to_v)$ P(None, tp)
  attn1/attn2 .to_out.0             row       to_out$           P(tp, None)
  ff.net.0.proj (GEGLU)             geglu     ff_geglu/proj$    P(None, tp)
  ff.net.2                          row       ff_out$           P(tp, None)
  mlp.fc1 (CLIP)                    column    fc1$              P(None, tp)
  mlp.fc2 (CLIP)                    row       fc2$              P(tp, None)
  time_embedding.linear_1/_2        replicated  (JAX's fc1$/fc2$ match
                                    time_fc1/time_fc2 and split them)
  CLIP self_attn.*                  replicated  (matches no pattern)

  * column: rank r holds the r-th of tp equal pieces of the output
    features (weight rows and bias); an attention's pieces are whole heads,
    so rank r runs heads [r H/tp, (r + 1) H/tp) through K1-K3;
  * geglu: the projection's output is [value | gate]; rank r holds
    value[r] and gate[r], so its GELU gate meets its own values. (JAX's
    column split of the whole kernel is only a placement; here it would
    hand one rank all the values and the other all the gates);
  * row: rank r holds the r-th piece of the input features; the ranks'
    partial outputs are added (reduce_from_tp) and the bias once after;
  * an attention is split only where its head count divides by tp, and a
    feed-forward or MLP where its hidden width does: SD-2.1's 320-channel
    level has 5 heads of 64, so at tp 2 its attentions stay replicated
    (JAX's dims_ok tests the feature count, and XLA may regroup heads; a
    rank cannot split a head). This moves placement only, never a result,
    and shard_frozen_ logs each layer it keeps whole;
  * the VAE stays replicated, as in JAX (coach.py:743-744), and so does
    time_embedding: two small GEMMs a step that would each add a
    collective.

Two autograd Functions carry the collectives. copy_to_tp is the identity
forward and adds the input's gradient over the tp group backward (each
rank's projections see part of the heads or hidden units, so each holds
a part of the gradient); reduce_from_tp adds the partial outputs forward
and is the identity backward. Both add through one all_gather in rank
order, in fp32, as dist.all_reduce_mean_ does: every rank of a group must
hold the same bits, or the replicated layers and the mappers drift apart.

Nothing falls back: a collective that fails raises CollectiveError on its
rank; a rank that fails between two collectives leaves its partners
waiting in the next one until the process group's timeout ends them.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from view_neti_tpu_torch.parallel.dist import DataParallel, _collective

TP_TABLE = (
    (re.compile(r"attn[12]\.to_[qkv]$"), "column"),
    (re.compile(r"attn[12]\.to_out\.0$"), "row"),
    (re.compile(r"ff\.net\.0\.proj$"), "geglu"),
    (re.compile(r"ff\.net\.2$"), "row"),
    (re.compile(r"mlp\.fc1$"), "column"),
    (re.compile(r"mlp\.fc2$"), "row"),
)


def _sum_over_tp(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Every tp rank's x added in rank order in fp32 on x's device. gloo
    on a tensor on the card moves it through a host copy, and the parts
    come back to the card for the sum."""
    send = x.detach().contiguous()
    if dp.backend == "gloo" and send.is_cuda:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(dp.tp_world)]
    _collective(tdist.all_gather, parts, send, group=dp.tp_group)
    total = parts[0].to(x.device).float()
    for part in parts[1:]:
        total = total + part.to(x.device).float()
    return total


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over_tp(grad, ctx.dp).to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, dp):
        ctx.dtype = partial.dtype
        return _sum_over_tp(partial, dp)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_tp(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """x as it is; backward, its gradient added over the tp group. dp None
    (a layer kept whole) is the identity both ways."""
    return x if dp is None else _CopyToTP.apply(x, dp)


def reduce_from_tp(partial: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The tp ranks' partials added in rank order, in fp32; backward, the
    gradient as it is, in the partial's dtype."""
    return _ReduceFromTP.apply(partial, dp)


class ColumnParallelLinear(nn.Module):
    """The rank's piece of a Linear's output features (weight rows and
    bias), applied to the whole input."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """The rank's piece of a Linear's input features. Each rank's partial
    is its GEMM's output in the input's dtype (bf16 on the card: the GEMM
    accumulates in fp32 and rounds once), so a partial carries the compute
    dtype's precision; the partials are added in fp32 in rank order, the
    bias once after in fp32, and the sum rounded once to the compute
    dtype."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 dp: DataParallel):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))
        self.tp = dp

    def forward(self, x):
        out = reduce_from_tp(F.linear(x, self.weight), self.tp)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


# ------------------------------------------------------------ the plan ----

def _units(module: nn.Module):
    """(path, unit, width, heads) of every splittable unit of a UNet or a
    CLIP text encoder: the attentions (their head count), the
    feed-forwards and the CLIP MLPs (their hidden width)."""
    from view_neti_tpu_torch.models.clip_text import CLIPMLP
    from view_neti_tpu_torch.models.unet import CrossAttention, FeedForward
    for path, m in module.named_modules():
        if isinstance(m, CrossAttention):
            yield path, m, m.to_q.out_features, m.heads
        elif isinstance(m, FeedForward):
            yield path, m, m.net[2].in_features, None
        elif isinstance(m, CLIPMLP):
            yield path, m, m.fc1.out_features, None


def _splits(width: int, heads: Optional[int], tp: int) -> bool:
    """A unit is split where tp divides its hidden width and, for an
    attention, its head count."""
    return width % tp == 0 and (heads is None or heads % tp == 0)


def _layers(path: str, unit: nn.Module):
    """(full key, key inside the unit, Linear, TP_TABLE rule) of a unit's
    TP_TABLE layers."""
    for name, layer in unit.named_modules():
        key = f"{path}.{name}"
        rule = next((r for pat, r in TP_TABLE if pat.search(key)), None)
        if rule is not None and isinstance(layer, nn.Linear):
            yield key, name, layer, rule


def tp_plan(module: nn.Module, tp: int) -> Dict[str, str]:
    """{state-dict key: "column" | "geglu" | "row" | "replicated"} for the
    weights and biases of TP_TABLE's layers in a UNet or a CLIP text
    encoder at tp ranks. A row layer's bias is replicated (it is added
    once after the sum); a unit whose heads (attention) or hidden width
    (feed-forward, MLP) tp does not divide stays replicated whole. Read
    from the whole module, before shard_frozen_."""
    plan = {}
    for path, unit, width, heads in _units(module):
        split = _splits(width, heads, tp)
        for key, _, layer, rule in _layers(path, unit):
            plan[f"{key}.weight"] = rule if split else "replicated"
            if layer.bias is not None:
                plan[f"{key}.bias"] = (rule if split and rule != "row"
                                       else "replicated")
    return plan


def tp_cut(t: torch.Tensor, rule: str, tp_index: int, tp: int
           ) -> torch.Tensor:
    """tp_index's piece of a full weight or bias under rule (a copy)."""
    if rule == "replicated":
        return t.clone()
    if rule == "row":
        n = t.shape[1] // tp
        return t[:, tp_index * n:(tp_index + 1) * n].clone()
    if rule == "geglu":
        value, gate = t.chunk(2, dim=0)
        n = value.shape[0] // tp
        return torch.cat([value[tp_index * n:(tp_index + 1) * n],
                          gate[tp_index * n:(tp_index + 1) * n]])
    n = t.shape[0] // tp
    return t[tp_index * n:(tp_index + 1) * n].clone()


def tp_shard_state_dict(sd: Dict[str, torch.Tensor], tp_index: int, tp: int,
                        plan: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Rank tp_index's state dict of a full diffusers / transformers state
    dict sd, cut as shard_frozen_ cuts the modules (plan: tp_plan of the
    module it belongs to; keys outside it stay whole)."""
    return {k: tp_cut(v, plan.get(k, "replicated"), tp_index, tp)
            for k, v in sd.items()}


def shard_frozen_(unet: nn.Module, clip: nn.Module, dp: DataParallel,
                  log: Callable[[str], None] = print) -> Dict[str, str]:
    """Split the frozen UNet and CLIP over the rank's tp group in place,
    after their weights are loaded: each splittable unit's TP_TABLE layers
    become ColumnParallelLinear / RowParallelLinear modules holding the
    rank's pieces (the full weights are released), attentions run their
    local heads, and each unit adds its input's gradient over the group
    (copy_to_tp). Logs each unit kept whole and returns the plan ({} when
    the record splits nothing)."""
    if not dp.sharded:
        return {}
    tp, r = dp.tp_world, dp.tp_index
    plans = {}
    for name, module in (("unet", unet), ("clip", clip)):
        plan = tp_plan(module, tp)
        plans.update({f"{name}.{k}": v for k, v in plan.items()})
        for path, unit, width, heads in list(_units(module)):
            layers = list(_layers(path, unit))
            if plan[f"{layers[0][0]}.weight"] == "replicated":
                what = (f"{heads} heads" if heads is not None
                        else f"hidden width {width}")
                log(f"tensor parallel: {name}.{path} kept whole ({what} "
                    f"not divisible by tp={tp})")
                continue
            for key, inner, layer, rule in layers:
                w = tp_cut(layer.weight.data, rule, r, tp)
                b = (None if layer.bias is None else tp_cut(
                    layer.bias.data, plan[f"{key}.bias"], r, tp))
                _set_submodule(unit, inner, RowParallelLinear(w, b, dp)
                               if rule == "row"
                               else ColumnParallelLinear(w, b))
            if heads is not None:
                unit.heads = heads // tp
            unit.tp = dp
    return plans


def _set_submodule(root: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    owner = root.get_submodule(parent) if parent else root
    if isinstance(owner, nn.ModuleList):
        owner[int(name)] = new
    else:
        setattr(owner, name, new)
