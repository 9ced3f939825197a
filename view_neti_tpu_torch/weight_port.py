"""Carry JAX parameter trees across to the port's state_dicts.

The inverse of view_neti_tpu/weight_port.py:98-362, with the port's own
copy of its key tables: each diffusers/transformers key maps to a path in
the flax tree and a transform (flax HWIO conv kernels -> torch OIHW, flax
(in, out) dense kernels -> torch (out, in), norm scale -> weight). The
result loads with load_state_dict(strict=True) into the port's modules.
Every leaf of the tree must be consumed and every expected key found, or
the port raises: a partial carry must never pass silently.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]
KeyTable = Dict[str, Tuple[Path, Callable]]


def _linear_w(k):   # flax (in, out) -> torch (out, in)
    return np.ascontiguousarray(np.asarray(k).T)


def _conv_w(k):     # flax HWIO -> torch OIHW
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _ident(x):
    return np.asarray(x)


def _norm(prefix_t: str, path: Path, group: bool = False) -> KeyTable:
    """GroupNorm/LayerNorm scale/bias -> weight/bias. The JAX GroupNorm
    wrappers nest a FastGroupNorm named GroupNorm_0."""
    inner = path + (("GroupNorm_0",) if group else ())
    return {f"{prefix_t}.weight": (inner + ("scale",), _ident),
            f"{prefix_t}.bias": (inner + ("bias",), _ident)}


def _convm(prefix_t: str, path: Path) -> KeyTable:
    return {f"{prefix_t}.weight": (path + ("kernel",), _conv_w),
            f"{prefix_t}.bias": (path + ("bias",), _ident)}


def _densem(prefix_t: str, path: Path, bias: bool = True) -> KeyTable:
    m = {f"{prefix_t}.weight": (path + ("kernel",), _linear_w)}
    if bias:
        m[f"{prefix_t}.bias"] = (path + ("bias",), _ident)
    return m


def unet_mapping(num_blocks: int = 4, layers_per_block: int = 2,
                 use_linear_projection: bool = False) -> KeyTable:
    m: KeyTable = {}
    m.update(_convm("conv_in", ("conv_in",)))
    m.update(_densem("time_embedding.linear_1", ("time_fc1",)))
    m.update(_densem("time_embedding.linear_2", ("time_fc2",)))

    def resnet(tp: str, fp: str) -> KeyTable:
        out: KeyTable = {}
        out.update(_norm(f"{tp}.norm1", (fp, "norm1"), group=True))
        out.update(_convm(f"{tp}.conv1", (fp, "conv1")))
        out.update(_densem(f"{tp}.time_emb_proj", (fp, "time_emb_proj")))
        out.update(_norm(f"{tp}.norm2", (fp, "norm2"), group=True))
        out.update(_convm(f"{tp}.conv2", (fp, "conv2")))
        # only where the block changes channel count
        out.update(_convm(f"{tp}.conv_shortcut", (fp, "conv_shortcut")))
        return out

    def attn(tp: str, fp: str) -> KeyTable:
        out: KeyTable = {}
        out.update(_norm(f"{tp}.norm", (fp, "norm"), group=True))
        proj = _densem if use_linear_projection else _convm
        out.update(proj(f"{tp}.proj_in", (fp, "proj_in")))
        out.update(proj(f"{tp}.proj_out", (fp, "proj_out")))
        b = f"{tp}.transformer_blocks.0"
        fb = (fp, "block")
        for a in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                out.update(_densem(f"{b}.{a}.{p}", fb + (a, p), bias=False))
            out.update(_densem(f"{b}.{a}.to_out.0", fb + (a, "to_out")))
        for i in (1, 2, 3):
            out.update(_norm(f"{b}.norm{i}", fb + (f"norm{i}",)))
        out.update(_densem(f"{b}.ff.net.0.proj", fb + ("ff_geglu", "proj")))
        out.update(_densem(f"{b}.ff.net.2", fb + ("ff_out",)))
        return out

    for i in range(num_blocks):
        for j in range(layers_per_block):
            m.update(resnet(f"down_blocks.{i}.resnets.{j}",
                            f"down_{i}_res_{j}"))
            if i < num_blocks - 1:
                m.update(attn(f"down_blocks.{i}.attentions.{j}",
                              f"down_{i}_attn_{j}"))
        if i < num_blocks - 1:
            m.update(_convm(f"down_blocks.{i}.downsamplers.0.conv",
                            (f"down_{i}_downsample",)))
    m.update(resnet("mid_block.resnets.0", "mid_res_0"))
    m.update(attn("mid_block.attentions.0", "mid_attn"))
    m.update(resnet("mid_block.resnets.1", "mid_res_1"))
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            m.update(resnet(f"up_blocks.{i}.resnets.{j}", f"up_{i}_res_{j}"))
            if i > 0:
                m.update(attn(f"up_blocks.{i}.attentions.{j}",
                              f"up_{i}_attn_{j}"))
        if i < num_blocks - 1:
            m.update(_convm(f"up_blocks.{i}.upsamplers.0.conv",
                            (f"up_{i}_upsample",)))
    m.update(_norm("conv_norm_out", ("norm_out",), group=True))
    m.update(_convm("conv_out", ("conv_out",)))
    return m


def vae_mapping(num_blocks: int = 4, layers_per_block: int = 2) -> KeyTable:
    m: KeyTable = {}

    def resnet(tp: str, fp: Path) -> KeyTable:
        out: KeyTable = {}
        out.update(_norm(f"{tp}.norm1", fp + ("norm1",), group=True))
        out.update(_convm(f"{tp}.conv1", fp + ("conv1",)))
        out.update(_norm(f"{tp}.norm2", fp + ("norm2",), group=True))
        out.update(_convm(f"{tp}.conv2", fp + ("conv2",)))
        out.update(_convm(f"{tp}.conv_shortcut", fp + ("shortcut",)))
        return out

    def attn(tp: str, fp: Path) -> KeyTable:
        out: KeyTable = {}
        out.update(_norm(f"{tp}.group_norm", fp + ("norm",), group=True))
        for t, f in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                     ("to_out.0", "proj_out")):
            out.update(_densem(f"{tp}.{t}", fp + (f,)))
        return out

    e = ("encoder",)
    m.update(_convm("encoder.conv_in", e + ("conv_in",)))
    for i in range(num_blocks):
        for j in range(layers_per_block):
            m.update(resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                            e + (f"down_{i}_block_{j}",)))
        if i < num_blocks - 1:
            m.update(_convm(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                            e + (f"down_{i}_downsample",)))
    m.update(resnet("encoder.mid_block.resnets.0", e + ("mid_block_1",)))
    m.update(attn("encoder.mid_block.attentions.0", e + ("mid_attn",)))
    m.update(resnet("encoder.mid_block.resnets.1", e + ("mid_block_2",)))
    m.update(_norm("encoder.conv_norm_out", e + ("norm_out",), group=True))
    m.update(_convm("encoder.conv_out", e + ("conv_out",)))
    m.update(_convm("quant_conv", e + ("quant_conv",)))

    d = ("decoder",)
    m.update(_convm("post_quant_conv", d + ("post_quant_conv",)))
    m.update(_convm("decoder.conv_in", d + ("conv_in",)))
    m.update(resnet("decoder.mid_block.resnets.0", d + ("mid_block_1",)))
    m.update(attn("decoder.mid_block.attentions.0", d + ("mid_attn",)))
    m.update(resnet("decoder.mid_block.resnets.1", d + ("mid_block_2",)))
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            m.update(resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                            d + (f"up_{i}_block_{j}",)))
        if i < num_blocks - 1:
            m.update(_convm(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                            d + (f"up_{i}_upsample",)))
    m.update(_norm("decoder.conv_norm_out", d + ("norm_out",), group=True))
    m.update(_convm("decoder.conv_out", d + ("conv_out",)))
    return m


def clip_text_mapping(num_layers: int = 12) -> KeyTable:
    m: KeyTable = {
        "text_model.embeddings.token_embedding.weight":
            (("token_embedding",), _ident),
        "text_model.embeddings.position_embedding.weight":
            (("position_embedding",), _ident),
    }
    for i in range(num_layers):
        tp = f"text_model.encoder.layers.{i}"
        fp = (f"layers_{i}",)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m.update(_densem(f"{tp}.self_attn.{proj}",
                             fp + ("self_attn", proj)))
        m.update(_norm(f"{tp}.layer_norm1", fp + ("layer_norm1",)))
        m.update(_norm(f"{tp}.layer_norm2", fp + ("layer_norm2",)))
        m.update(_densem(f"{tp}.mlp.fc1", fp + ("fc1",)))
        m.update(_densem(f"{tp}.mlp.fc2", fp + ("fc2",)))
    m.update(_norm("text_model.final_layer_norm", ("final_layer_norm",)))
    return m


def mapper_mapping() -> KeyTable:
    """NeTIMapper: the same names on both sides; dense and LayerNorm leaves
    transform as above, the frequency matrices and TI rows as they are."""
    m: KeyTable = {}
    for name in ("net_dense0", "net_dense1", "output_layer", "input_layer"):
        m.update(_densem(name, ("params", name)))
    for name in ("net_ln0", "net_ln1"):
        m.update(_norm(name, ("params", name)))
    m["ti_embeddings"] = (("params", "ti_embeddings"), _ident)
    m["fourier_w"] = (("constants", "fourier_w"), _ident)
    m["neti_w"] = (("constants", "neti_w"), _ident)
    return m


def _leaves(tree: Mapping, prefix: Path = ()) -> Dict[Path, object]:
    out: Dict[Path, object] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _carry(tree: Mapping, mapping: KeyTable, what: str,
           optional: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    leaves = _leaves(tree)
    sd: Dict[str, torch.Tensor] = {}
    missing = []
    for key, (path, tf) in mapping.items():
        if path in leaves:
            sd[key] = torch.from_numpy(tf(leaves.pop(path)).copy())
        elif not any(s in key for s in optional):
            missing.append(key)
    if missing or leaves:
        raise KeyError(
            f"{what}: {len(missing)} expected leaves missing (e.g. "
            f"{missing[:3]}), {len(leaves)} leaves unconsumed (e.g. "
            f"{['/'.join(p) for p in list(leaves)[:3]]})")
    return sd


def from_jax_unet(params: Mapping, **cfg) -> Dict[str, torch.Tensor]:
    """JAX UNet params (variables['params']) -> diffusers state_dict.
    cfg: num_blocks, layers_per_block, use_linear_projection."""
    return _carry(params, unet_mapping(**cfg), "unet",
                  optional=("conv_shortcut",))


def from_jax_vae(params: Mapping, **cfg) -> Dict[str, torch.Tensor]:
    """JAX VAE params -> diffusers state_dict. cfg: num_blocks,
    layers_per_block."""
    return _carry(params, vae_mapping(**cfg), "vae",
                  optional=("conv_shortcut",))


def from_jax_clip_text(params: Mapping, num_layers: int = 12
                       ) -> Dict[str, torch.Tensor]:
    """JAX CLIP params -> transformers-keyed state_dict. The token table
    keeps its headroom rows (placeholder rows included), as the port's
    NeTICLIPTextEncoder allocates them."""
    return _carry(params, clip_text_mapping(num_layers), "clip_text")


def from_jax_mapper(params: Mapping, constants: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """One JAX NeTIMapper's params (and its 'constants' collection: the
    frequency matrix) -> the port's NeTIMapper state_dict."""
    tree = {"params": params, "constants": constants or {}}
    mapping = mapper_mapping()
    leaves = _leaves(tree)
    present = {k: v for k, v in mapping.items() if v[0] in leaves}
    return _carry(tree, present, "mapper")
