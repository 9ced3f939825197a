"""NeTI text conditioning: one batched CLIP forward over the 16 UNet layers
(view_neti_tpu/training/text_forward.py).

Only the scalar layer index differs between the reference's 16 per-layer
text-encoder passes, so they fold into one forward with the layer axis in
the batch: (B, 77) -> (16*B, 77) -> CLIP -> (16, B, 77, D). The mappers run
outside the CLIP module and hand it their word-embedding and bypass
vectors. Serving runs it under no_grad; the train step runs it with
train=True, so that the gradient reaches the mappers, and hands it the
nested-dropout draws.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
from view_neti_tpu_torch.models.clip_text import NeTICLIPTextEncoder
from view_neti_tpu_torch.models.neti_mapper import (NestedDropoutDraws,
                                                    NeTIMapper,
                                                    lookup_view_rows)


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


def neti_text_conditioning(models: TextModels, input_ids: torch.Tensor,
                           ph_obj_ids: torch.Tensor,
                           ph_view_ids: torch.Tensor,
                           timesteps: torch.Tensor, object_idx: int = 0,
                           truncation_idx: Optional[int] = None,
                           num_layers: int = NUM_UNET_LAYERS,
                           train: bool = False,
                           draws: Optional[Dict[str, NestedDropoutDraws]]
                           = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context, context_bypass), each (num_layers, B, L, D).

    input_ids: (B, L); ph_obj_ids / ph_view_ids: (B,) placeholder ids (-1
    where absent); timesteps: (B,). object_idx picks the object mapper.
    Original TI runs one layer-0 pass broadcast over the layers, without
    bypass (reference coach.py:307-309).

    train=False runs under no_grad (serving). train=True records the graph
    back to the mappers; draws then holds each mapper's nested-dropout
    draws for its num_layers * B rows, keyed "object" and "view" (None or
    a missing key: no dropout).
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
    if models.obj_mappers:
        norm_scale = (models.obj_norm_scales[object_idx]
                      if models.obj_norm_scales is not None else None)
        out = models.obj_mappers[object_idx](
            t_k, l_k, truncation_idx=truncation_idx, norm_scale=norm_scale,
            dropout=draws.get("object"))
        kwargs.update(word_obj=out.word_embedding,
                      bypass_obj=out.bypass_output,
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

    hidden, hidden_bypass, _, _ = models.clip(ids_k, **kwargs)
    D = hidden.shape[-1]
    ctx = hidden.reshape(K, B, L, D)
    ctx_b = (hidden_bypass.reshape(K, B, L, D)
             if hidden_bypass is not None else ctx)
    if K == 1:
        ctx = ctx.expand(num_layers, B, L, D)
        ctx_b = ctx_b.expand(num_layers, B, L, D)
    return ctx, ctx_b
