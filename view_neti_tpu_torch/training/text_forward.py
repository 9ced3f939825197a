"""NeTI text conditioning: one batched CLIP forward over the 16 UNet layers
(view_neti_tpu/training/text_forward.py).

Only the scalar layer index differs between the reference's 16 per-layer
text-encoder passes, so they fold into one forward with the layer axis in
the batch: (B, 77) -> (16*B, 77) -> CLIP -> (16, B, 77, D). The mappers run
outside the CLIP module and hand it their word-embedding and bypass
vectors. Serving runs it under no_grad; the train step runs it with
train=True, so that the gradient reaches the mappers, and hands it the
nested-dropout draws.

Mode 3's fused batch is G contiguous groups of B / G prompts, each with
its own scene's object mapper: the object mappers run G small passes,
each over its group's rows of every layer, and the CLIP pass stays one.
Under data parallelism a rank's rows may hold part of a group or straddle
two; parallel/dist.py (shard_object_idx, shard_draws) hands the rank equal
groups again (its runs inside each group, or one group per row), so every
row is still conditioned on its own group's object mapper.

Its spans (utils/profiling.span), "prompt.mappers" around the mappers and
"prompt.text_encoder" around the CLIP pass, split a conditioning call's
host time; inside the train step's CUDA graph they run at the warm-up and
the capture only.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
from view_neti_tpu_torch.models.clip_text import NeTICLIPTextEncoder
from view_neti_tpu_torch.models.neti_mapper import (NestedDropoutDraws,
                                                    NeTIMapper,
                                                    lookup_view_rows)
from view_neti_tpu_torch.utils.profiling import span


@dataclass
class TextModels:
    """The CLIP encoder, the mappers and their lookup tables.

    obj_mappers: one mapper per object token (the mode-3 bank; else one).
    view_table_ids / view_table_params: (V,) token ids and (V, C) camera
      parameters scaled to (-1, 1), for the view-token lookup.
    obj_norm_scales: (N,) per-object target norms or None.
    """
    clip: NeTICLIPTextEncoder
    obj_mappers: Optional[List[NeTIMapper]] = None
    view_mapper: Optional[NeTIMapper] = None
    view_table_ids: Optional[torch.Tensor] = None
    view_table_params: Optional[torch.Tensor] = None
    obj_norm_scales: Optional[torch.Tensor] = None
    view_norm_scale: Optional[torch.Tensor] = None
    original_ti: bool = False


def _tile(x: torch.Tensor, K: int) -> torch.Tensor:
    return x.repeat((K,) + (1,) * (x.dim() - 1))


ObjectIdx = Union[int, torch.Tensor]


def object_groups(object_idx: ObjectIdx) -> Optional[List[int]]:
    """The per-group object indices of a grouped batch (a (G,) tensor on
    the host), or None for one index for the whole batch."""
    if isinstance(object_idx, torch.Tensor) and object_idx.dim() > 0:
        return object_idx.tolist()
    return None


def neti_text_conditioning(models: TextModels, input_ids: torch.Tensor,
                           ph_obj_ids: torch.Tensor,
                           ph_view_ids: torch.Tensor,
                           timesteps: torch.Tensor,
                           object_idx: ObjectIdx = 0,
                           truncation_idx: Optional[int] = None,
                           num_layers: int = NUM_UNET_LAYERS,
                           train: bool = False,
                           draws: Optional[Dict[str, NestedDropoutDraws]]
                           = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context, context_bypass), each (num_layers, B, L, D).

    input_ids: (B, L); ph_obj_ids / ph_view_ids: (B,) placeholder ids (-1
    where absent); timesteps: (B,). object_idx picks the object mapper: an
    int (or a 0-d tensor) for the whole batch, or a (G,) int64 tensor on
    the host for G contiguous groups of B / G prompts, group g conditioned
    on object mapper object_idx[g]. Original
    TI runs one layer-0 pass broadcast over the layers, without bypass
    (reference coach.py:307-309).

    train=False runs under no_grad (serving). train=True records the graph
    back to the mappers; draws then holds each mapper's nested-dropout
    draws for its num_layers * B rows, keyed "object" and "view" (None or
    a missing key: no dropout). The rows are layer-major, (K, B); with
    groups, the object draws are group-major: group g takes rows
    [g K B/G, (g + 1) K B/G), layer-major within the group, the order of
    its own mapper pass.
    """
    with contextlib.nullcontext() if train else torch.no_grad():
        return _conditioning(models, input_ids, ph_obj_ids, ph_view_ids,
                             timesteps, object_idx, truncation_idx,
                             num_layers, (draws or {}) if train else {})


def _conditioning(models, input_ids, ph_obj_ids, ph_view_ids, timesteps,
                  object_idx, truncation_idx, num_layers, draws):
    B, L = input_ids.shape
    K = 1 if models.original_ti else num_layers
    ids_k = _tile(input_ids, K)
    t_k = _tile(timesteps.float(), K)
    l_k = torch.arange(K, dtype=torch.float32,
                       device=input_ids.device).repeat_interleave(B)
    ph_obj_k = _tile(ph_obj_ids, K)
    ph_view_k = _tile(ph_view_ids, K)

    kwargs = dict(ph_obj_ids=ph_obj_k, ph_view_ids=ph_view_k)
    with span("prompt.mappers"):
        if models.obj_mappers:
            out, word, bypass = _object_pass(models, object_idx, t_k, l_k,
                                             K, B, truncation_idx,
                                             draws.get("object"))
            kwargs.update(word_obj=word, bypass_obj=bypass,
                          alpha_obj=out.output_bypass_alpha,
                          unconstrained_obj=out.bypass_unconstrained)
        if models.view_mapper is not None:
            rows = lookup_view_rows(ph_view_k, models.view_table_ids)
            out = models.view_mapper(
                t_k, l_k, view_params=models.view_table_params[rows],
                view_rows=rows, truncation_idx=truncation_idx,
                norm_scale=models.view_norm_scale, dropout=draws.get("view"))
            kwargs.update(word_view=out.word_embedding,
                          bypass_view=out.bypass_output,
                          alpha_view=out.output_bypass_alpha,
                          unconstrained_view=out.bypass_unconstrained)

    with span("prompt.text_encoder"):
        hidden, hidden_bypass, _, _ = models.clip(ids_k, **kwargs)
    D = hidden.shape[-1]
    ctx = hidden.reshape(K, B, L, D)
    ctx_b = (hidden_bypass.reshape(K, B, L, D)
             if hidden_bypass is not None else ctx)
    if K == 1:
        ctx = ctx.expand(num_layers, B, L, D)
        ctx_b = ctx_b.expand(num_layers, B, L, D)
    return ctx, ctx_b


def _object_pass(models, object_idx, t_k, l_k, K, B, truncation_idx, drop):
    """The object mappers' (last output, word rows, bypass rows) over the
    K * B layer-major rows: one pass for one index; with G groups, one
    pass per group over its rows [k B + g B/G, k B + (g + 1) B/G) of every
    layer k, the outputs scattered back to the layer-major order."""
    def run(idx, t, layer, dropout):
        scales = models.obj_norm_scales
        return models.obj_mappers[idx](
            t, layer, truncation_idx=truncation_idx,
            norm_scale=scales[idx] if scales is not None else None,
            dropout=dropout)

    groups = object_groups(object_idx)
    if groups is None:
        out = run(int(object_idx), t_k, l_k, drop)
        return out, out.word_embedding, out.bypass_output
    G = len(groups)
    if B % G:
        raise ValueError(f"batch {B} is not {G} equal groups")
    bs, n = B // G, K * (B // G)
    words, bypasses = [], []
    for g, idx in enumerate(groups):
        def rows(x):
            return x.reshape(K, G, bs)[:, g].reshape(-1)
        d = (tuple(t[g * n:(g + 1) * n] for t in drop)
             if drop is not None else None)
        out = run(idx, rows(t_k), rows(l_k), d)
        words.append(out.word_embedding.reshape(K, bs, -1))
        if out.bypass_output is not None:
            bypasses.append(out.bypass_output.reshape(K, bs, -1))
    word = torch.stack(words, dim=1).reshape(K * B, -1)
    bypass = (torch.stack(bypasses, dim=1).reshape(K * B, -1)
              if bypasses else None)
    return out, word, bypass
