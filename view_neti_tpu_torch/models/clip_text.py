"""CLIP text transformer with the NeTI injection points, in PyTorch
(view_neti_tpu/models/clip_text.py).

Written here rather than taken from `transformers`, with its state_dict
keys (text_model.embeddings..., text_model.encoder.layers.N...,
text_model.final_layer_norm), so a transformers CLIPTextModel checkpoint
loads strictly. As in the JAX module:
  * the mappers run outside; their word-embedding and bypass vectors come
    in as arguments, and this module overwrites the placeholder row and
    merges the bypass after the encoder;
  * under tensor parallelism (parallel/tensor.py shard_frozen_) each MLP
    runs its rank's piece of the hidden units and adds its input's
    gradient over the tp group (copy_to_tp); attention stays whole, as
    in the JAX mesh;
  * the token table carries `vocab_headroom` spare rows for placeholder
    tokens;
  * attention logits are fp32 with a finfo(f32).min causal bias;
  * gradients reach the mappers' vectors through the placeholder overwrite
    and the bypass merge, which write nothing in place; with
    `gradient_checkpointing` the encoder layers are recomputed in the
    backward (torch.utils.checkpoint), as nn.remat does there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from view_neti_tpu_torch.ops.norm import LayerNorm
from view_neti_tpu_torch.parallel.tensor import copy_to_tp


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    vocab_headroom: int = 128          # spare rows for placeholder tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"     # "quick_gelu" (SD1.x) | "gelu" (SD2.x)
    # recompute the encoder layers in the backward (the reference's
    # text_encoder.gradient_checkpointing_enable())
    gradient_checkpointing: bool = False

    @property
    def total_vocab(self) -> int:
        return self.vocab_size + self.vocab_headroom


def sd15_text_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def sd21_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                          intermediate_size=4096, hidden_act="gelu")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x, causal_bias):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.q_proj(x).reshape(B, L, H, hd)
        k = self.k_proj(x).reshape(B, L, H, hd)
        v = self.v_proj(x).reshape(B, L, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * hd ** -0.5 + causal_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(out.reshape(B, L, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        if self.act not in ("quick_gelu", "gelu"):
            raise ValueError(self.act)
        self.tp = None
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(copy_to_tp(x, self.tp))
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, causal_bias):
        x = x + self.self_attn(self.layer_norm1(x), causal_bias)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.total_vocab, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


def _overwrite_placeholder_rows(embeds: torch.Tensor, input_ids: torch.Tensor,
                                placeholder_ids: torch.Tensor,
                                word_embedding: torch.Tensor) -> torch.Tensor:
    """Replace the placeholder-token row of each prompt; rows whose
    placeholder id is -1 are untouched."""
    mask = (input_ids == placeholder_ids[:, None])[..., None]
    return torch.where(mask, word_embedding[:, None, :].to(embeds.dtype),
                       embeds)


def _safe_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    # clamp inside the sqrt: a zero vector gives 0, not NaN
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=keepdim),
                                  min=1e-24))


def _merge_bypass(hidden: torch.Tensor, input_ids: torch.Tensor,
                  placeholder_ids: torch.Tensor, bypass: torch.Tensor,
                  alpha: float, unconstrained: bool) -> torch.Tensor:
    """Post-encoder bypass merge at the placeholder position.

    constrained: new = existing + alpha * normalize(bypass) * ||existing||
    unconstrained: new = normalize(bypass) * mean_seq_norm(hidden), the
    norm term detached (stop_gradient in the JAX module)
    """
    mask = input_ids == placeholder_ids[:, None]            # (B, L)
    has = mask.any(dim=1)                                   # (B,)
    existing = torch.einsum("bl,bld->bd", mask.to(hidden.dtype), hidden)
    bypass = bypass.to(hidden.dtype)
    b_normed = bypass / _safe_norm(bypass)
    if unconstrained:
        norm_term = _safe_norm(hidden, keepdim=False).mean(dim=-1).detach()
        new_state = b_normed * norm_term[:, None]
    else:
        new_state = existing + alpha * b_normed * _safe_norm(existing)
    write = mask[..., None] & has[:, None, None]
    return torch.where(write, new_state[:, None, :], hidden)


class NeTICLIPTextEncoder(nn.Module):
    """forward returns (last_hidden, last_hidden_with_bypass or None, pooled,
    pooled_with_bypass); both hidden states are post final-layer-norm."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextModel(config)

    def forward(self, input_ids: torch.Tensor,
                word_obj: Optional[torch.Tensor] = None,
                bypass_obj: Optional[torch.Tensor] = None,
                ph_obj_ids: Optional[torch.Tensor] = None,
                word_view: Optional[torch.Tensor] = None,
                bypass_view: Optional[torch.Tensor] = None,
                ph_view_ids: Optional[torch.Tensor] = None,
                alpha_obj: float = 0.2, alpha_view: float = 0.2,
                unconstrained_obj: bool = False,
                unconstrained_view: bool = False):
        tm = self.text_model
        dtype = tm.encoder.layers[0].self_attn.q_proj.weight.dtype
        L = input_ids.shape[1]
        embeds = tm.embeddings.token_embedding(input_ids).to(dtype)
        if word_obj is not None:
            embeds = _overwrite_placeholder_rows(embeds, input_ids,
                                                 ph_obj_ids, word_obj)
        if word_view is not None:
            embeds = _overwrite_placeholder_rows(embeds, input_ids,
                                                 ph_view_ids, word_view)
        x = embeds + tm.embeddings.position_embedding.weight[None, :L].to(
            dtype)
        causal = torch.triu(torch.full((L, L), torch.finfo(torch.float32).min,
                                       device=input_ids.device), diagonal=1)
        remat = self.config.gradient_checkpointing and torch.is_grad_enabled()
        for layer in tm.encoder.layers:
            if remat:
                x = checkpoint(layer, x, causal[None, None],
                               use_reentrant=False)
            else:
                x = layer(x, causal[None, None])

        hidden = x
        hidden_bypass = hidden
        any_bypass = bypass_obj is not None or bypass_view is not None
        if bypass_obj is not None:
            hidden_bypass = _merge_bypass(hidden_bypass, input_ids,
                                          ph_obj_ids, bypass_obj, alpha_obj,
                                          unconstrained_obj)
        if bypass_view is not None:
            hidden_bypass = _merge_bypass(hidden_bypass, input_ids,
                                          ph_view_ids, bypass_view,
                                          alpha_view, unconstrained_view)
        hidden = tm.final_layer_norm(hidden)
        hidden_bypass = (tm.final_layer_norm(hidden_bypass) if any_bypass
                         else hidden)
        # pooled output: the EOT row (the highest id in CLIP's vocab order)
        eot = torch.argmax(input_ids, dim=-1)
        rows = torch.arange(input_ids.shape[0], device=input_ids.device)
        return (hidden, hidden_bypass if any_bypass else None,
                hidden[rows, eot], hidden_bypass[rows, eot])
