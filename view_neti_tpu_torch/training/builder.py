"""Assemble the serving stack from a RunConfig
(view_neti_tpu/training/builder.py, serving part).

Grows the tokenizer with the placeholder tokens, initialises their rows
from the super-category rows, computes the target norms, builds the
mappers for the learnable mode, and builds the frozen SD stack (CLIP, UNet,
VAE) with seeded random weights on the given device. Real weights are
loaded afterwards with load_state_dict (weight_port.py carries JAX trees
across).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from view_neti_tpu_torch.config import RunConfig
from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
from view_neti_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                  NeTICLIPTextEncoder,
                                                  sd15_text_config,
                                                  sd21_text_config)
from view_neti_tpu_torch.models.neti_mapper import NeTIMapper
from view_neti_tpu_torch.models.unet import (UNetConfig, UNet2DCondition,
                                             sd15_unet_config,
                                             sd21_unet_config,
                                             tiny_unet_config)
from view_neti_tpu_torch.models.vae import (AutoencoderKL, VAEConfig,
                                            tiny_vae_config)
from view_neti_tpu_torch.models.view_tokens import (ViewTokenTable,
                                                    build_view_token_table)
from view_neti_tpu_torch.ops.norm import GroupNorm, LayerNorm
from view_neti_tpu_torch.training.text_forward import TextModels
from view_neti_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SDArch:
    """Architecture bundle for one SD family."""
    text: CLIPTextConfig
    unet: UNetConfig
    vae: VAEConfig
    prediction_type: str = "epsilon"


def resolve_arch(name: str, word_embedding_dim: int) -> SDArch:
    """Map a model name to its architecture configs."""
    name = name.lower()
    if "stable-diffusion-2" in name:
        pred = "v_prediction" if not name.endswith("base") else "epsilon"
        arch = SDArch(text=sd21_text_config(), unet=sd21_unet_config(),
                      vae=VAEConfig(), prediction_type=pred)
    else:  # SD 1.x family (v1-4, v1-5)
        arch = SDArch(text=sd15_text_config(), unet=sd15_unet_config(),
                      vae=VAEConfig(), prediction_type="epsilon")
    if arch.text.hidden_size != word_embedding_dim:
        raise ValueError(f"word_embedding_dim {word_embedding_dim} != text "
                         f"encoder width {arch.text.hidden_size} for {name}")
    return arch


def tiny_arch(ctx_dim: int = 32) -> SDArch:
    """Miniature stack for tests (builder.tiny_arch of the JAX package)."""
    text = CLIPTextConfig(vocab_size=512, vocab_headroom=128,
                          hidden_size=ctx_dim, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position_embeddings=16)
    return SDArch(text=text,
                  unet=tiny_unet_config(cross_attention_dim=ctx_dim),
                  vae=tiny_vae_config())


@dataclass
class BuiltModels:
    """The serving stack and the placeholder bookkeeping."""
    text: TextModels
    unet: UNet2DCondition
    vae: AutoencoderKL
    arch: SDArch
    tokenizer: Any
    placeholder_token_ids: List[int]
    placeholder_object_token_ids: List[int]
    placeholder_view_token_ids: List[int]
    view_table: Optional[ViewTokenTable]
    target_norm_object: Optional[List[float]]
    target_norm_view: Optional[float]


@torch.no_grad()
def add_concept_tokens(cfg: RunConfig, tokenizer,
                       placeholder_view_tokens: List[str],
                       placeholder_object_tokens: List[str],
                       token_table: torch.Tensor
                       ) -> Tuple[List[int], List[int], List[int],
                                  List[float], Optional[float]]:
    """Grow the vocabulary and copy each placeholder's super-category row
    into its row of `token_table` (in place). Returns the id lists, the
    per-object target norms and the view target norm."""
    placeholder_tokens = placeholder_view_tokens + placeholder_object_tokens
    n_added = tokenizer.add_tokens(placeholder_tokens)
    if n_added == 0 and placeholder_tokens:
        raise ValueError("No new tokens were added to the tokenizer")
    view_ids = tokenizer.convert_tokens_to_ids(placeholder_view_tokens)
    object_ids = tokenizer.convert_tokens_to_ids(placeholder_object_tokens)
    all_ids = tokenizer.convert_tokens_to_ids(placeholder_tokens)
    if max(all_ids, default=0) >= token_table.shape[0]:
        raise ValueError(
            f"vocab overflow: token id {max(all_ids)} >= table "
            f"{token_table.shape[0]}; raise CLIPTextConfig.vocab_headroom")

    # one super-category per object for mode 3, else a single one
    if cfg.learnable_mode == 3:
        supers_obj = cfg.data.super_category_object_tokens
    else:
        supers_obj = [cfg.data.super_category_object_token] * len(
            placeholder_object_tokens)

    def super_id(token: str) -> int:
        ids = tokenizer.encode(token, add_special_tokens=False)
        if len(ids) != 1:
            raise ValueError(
                f"super-category {token!r} is not a single token")
        return ids[0]

    target_norm_object: List[float] = []
    for tok_id, sup in zip(object_ids, supers_obj):
        sid = super_id(sup)
        token_table[tok_id] = token_table[sid]
        target_norm_object.append(float(torch.linalg.norm(token_table[sid])))
    target_norm_view = None
    if placeholder_view_tokens:
        sid = super_id(cfg.data.super_category_view_token)
        token_table[view_ids] = token_table[sid].clone()
        target_norm_view = float(torch.linalg.norm(token_table[sid]))
    return (all_ids, view_ids, object_ids, target_norm_object,
            target_norm_view)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in flax's manner: dense and conv kernels N(0, 1/fan_in),
    zero biases, unit norms, token/position tables N(0, 0.02 / 0.01)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else 0.02
            m.weight.normal_(0.0, std, generator=generator)
        elif isinstance(m, (GroupNorm, LayerNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def cast_compute_dtype_(module: nn.Module, dtype: torch.dtype) -> None:
    """Cast the dense and conv layers to the compute dtype. Norms,
    embedding tables and layers marked keep_fp32 (the UNet's conv_out) stay
    fp32, as the JAX modules keep them."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) \
                and not getattr(m, "keep_fp32", False):
            m.to(dtype)


def _make(cls, config, device, generator, dtype):
    with torch.device("meta"):
        module = cls(config)
    module.to_empty(device=device)
    init_params_(module, generator)
    cast_compute_dtype_(module, dtype)
    return module.eval().requires_grad_(False)


def _init_mapper(cfg: RunConfig, embedding_type: str, num_view_cond_dims: int,
                 normalize: bool, output_bypass: bool,
                 bypass_unconstrained: bool, alpha: float,
                 generator: torch.Generator, device,
                 num_view_tokens: int = 0,
                 ti_init_embed: Optional[torch.Tensor] = None) -> NeTIMapper:
    m = cfg.model
    mapper = NeTIMapper(
        embedding_type=embedding_type,
        output_dim=m.word_embedding_dim,
        arch_mlp_hidden_dims=m.arch_mlp_hidden_dims,
        use_nested_dropout=m.use_nested_dropout,
        normalize_output=normalize,
        use_positional_encoding=(
            m.use_positional_encoding_object if embedding_type == "object"
            else m.use_positional_encoding_view),
        num_pe_time_anchors=m.num_pe_time_anchors,
        pe_sigmas=m.pe_sigmas,
        output_bypass=output_bypass,
        arch_view_net=m.arch_view_net,
        arch_view_disable_tl=(m.arch_view_disable_tl
                              if embedding_type == "view" else True),
        original_ti=m.original_ti,
        bypass_unconstrained=bypass_unconstrained,
        output_bypass_alpha=alpha,
        num_unet_layers=NUM_UNET_LAYERS,
        num_view_cond_dims=num_view_cond_dims,
        num_view_tokens=num_view_tokens,
        device=device)
    mapper.reset_parameters_(generator, ti_init_embed)
    return mapper.eval()


def build_models(cfg: RunConfig, tokenizer,
                 placeholder_view_tokens: List[str],
                 placeholder_object_tokens: List[str],
                 arch: Optional[SDArch] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 calibration_dir: Optional[str] = None,
                 device=None) -> BuiltModels:
    """Build the serving stack for a learnable mode (0/1/2/3/4/5) on
    `device` (None: the card, raising if there is none), with weights drawn
    from a torch.Generator seeded with cfg.seed."""
    device = resolve_device(device)
    mode = cfg.learnable_mode
    arch = arch or resolve_arch(cfg.model.pretrained_model_name_or_path,
                                cfg.model.word_embedding_dim)
    g = torch.Generator(device).manual_seed(cfg.seed)

    clip = _make(NeTICLIPTextEncoder, arch.text, device, g, compute_dtype)
    table = clip.text_model.embeddings.token_embedding.weight
    (all_ids, view_ids, object_ids, norms_obj,
     norm_view) = add_concept_tokens(cfg, tokenizer, placeholder_view_tokens,
                                     placeholder_object_tokens, table)

    view_table = None
    num_cond = 0
    if placeholder_view_tokens:
        view_table = build_view_token_table(
            placeholder_view_tokens, view_ids,
            calibration_dir=calibration_dir)
        num_cond = view_table.num_cond_dims

    m = cfg.model
    obj_mappers = None
    obj_norm_scales = None
    if mode in (0, 2, 3, 4, 5) and placeholder_object_tokens:
        obj_mappers = [
            _init_mapper(cfg, "object", 0,
                         normalize=m.normalize_object_mapper_output,
                         output_bypass=m.output_bypass_object,
                         bypass_unconstrained=m.bypass_unconstrained_object,
                         alpha=m.output_bypass_alpha_object, generator=g,
                         device=device,
                         ti_init_embed=(table[oid] if m.original_ti
                                        else None))
            for oid in object_ids]
        if m.normalize_object_mapper_output:
            obj_norm_scales = torch.tensor(norms_obj, device=device)

    view_mapper = None
    view_norm_scale = None
    if mode in (1, 2, 3, 4, 5) and placeholder_view_tokens:
        view_mapper = _init_mapper(
            cfg, "view", num_cond,
            normalize=m.normalize_view_mapper_output,
            output_bypass=m.output_bypass_view,
            bypass_unconstrained=m.bypass_unconstrained_view,
            alpha=m.output_bypass_alpha_view, generator=g, device=device,
            num_view_tokens=len(placeholder_view_tokens),
            ti_init_embed=table[view_ids[0]] if m.original_ti else None)
        if m.normalize_view_mapper_output and norm_view:
            view_norm_scale = torch.tensor(norm_view, device=device)

    unet = _make(UNet2DCondition, arch.unet, device, g, compute_dtype)
    vae = _make(AutoencoderKL, arch.vae, device, g, compute_dtype)

    text = TextModels(
        clip=clip, obj_mappers=obj_mappers, view_mapper=view_mapper,
        view_table_ids=(torch.as_tensor(view_table.token_ids.astype(np.int64),
                                        device=device)
                        if view_table else None),
        view_table_params=(torch.as_tensor(view_table.params_scaled(),
                                           device=device)
                           if view_table else None),
        obj_norm_scales=obj_norm_scales, view_norm_scale=view_norm_scale,
        original_ti=m.original_ti)
    return BuiltModels(
        text=text, unet=unet, vae=vae, arch=arch, tokenizer=tokenizer,
        placeholder_token_ids=all_ids,
        placeholder_object_token_ids=object_ids,
        placeholder_view_token_ids=view_ids, view_table=view_table,
        target_norm_object=norms_obj or None, target_norm_view=norm_view)


def fuse_for_inference(vae: AutoencoderKL) -> AutoencoderKL:
    """Route the VAE decoder's norm+SiLU+conv3x3 sections through the fused
    conv (ops/fused_conv.py). Parameters are unchanged; the UNet stays
    unfused, as in the JAX package's default."""
    vae.config = dataclasses.replace(vae.config, fuse_conv=True)
    return vae
