"""The Stable Diffusion UNet with XTI per-layer contexts, in PyTorch
(view_neti_tpu/models/unet.py).

Parameter names are diffusers' UNet2DConditionModel keys, so a diffusers
checkpoint loads strictly. As in the JAX module:
  * every cross-attention block carries a static `xti_index` into a stacked
    (16, B, 77, D) context; K comes from the context and V from the bypass
    stack (reference models/xti_attention_processor.py:38-42);
  * activations are NHWC; GroupNorm statistics are fp32, eps 1e-5 in the
    ResNets and 1e-6 in the Transformer2D norm; GEGLU uses exact GELU;
    conv_out runs in fp32;
  * every attention call goes through ops.attention.multi_head_attention,
    the flash-attention kernel on the card;
  * under tensor parallelism (parallel/tensor.py shard_frozen_) an
    attention runs its rank's heads and a feed-forward its rank's piece of
    the hidden units; `tp` is then the rank's record, and each adds its
    inputs' gradients over the tp group (copy_to_tp);
  * with `fuse_conv` (inference only; training.builder.fuse_for_inference
    with `unet`) each ResNet block runs its two norm -> SiLU -> conv3x3
    sections through ops.fused_conv.fused_affine_silu_conv3x3, the
    hand-written kernel K4 on the card: conv1 with the time embedding as
    its broadcast add, conv2 with the block's input (or its 1x1 shortcut)
    as its residual. conv_in, the samplers, the Transformer2D norms and
    conv_norm_out + conv_out stay unfused. The parameters are the same
    either way, so a shallow copy of the module with another config is a
    second view of the same weights;
  * with `gradient_checkpointing` the ResNet blocks are recomputed in the
    backward (torch.utils.checkpoint), as nn.remat does there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from view_neti_tpu_torch.ops.attention import multi_head_attention
from view_neti_tpu_torch.ops.conv import conv3x3_hwio, conv_nhwc
from view_neti_tpu_torch.ops.fused_conv import fused_affine_silu_conv3x3
from view_neti_tpu_torch.ops.norm import GroupNorm, LayerNorm
from view_neti_tpu_torch.ops.resize import nearest_upsample_2x
from view_neti_tpu_torch.parallel.tensor import copy_to_tp


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD1.x fixes the head COUNT (8); SD2.x fixes the head DIM (64).
    num_attention_heads: Optional[int] = 8
    attention_head_dim: Optional[int] = None
    norm_groups: int = 32
    use_linear_projection: bool = False    # True for SD2.x
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    gradient_checkpointing: bool = False
    # run the ResNet blocks' norm+silu+conv3x3 sections through the fused
    # conv (K4). Forward-only: the kernel refuses inputs that require grad,
    # so only inference UNets turn it on (the JAX package's default is off)
    fuse_conv: bool = False

    def heads_for(self, channels: int) -> int:
        if self.attention_head_dim is not None:
            return channels // self.attention_head_dim
        return self.num_attention_heads


def sd15_unet_config(**overrides) -> UNetConfig:
    return UNetConfig(**overrides)


def sd21_unet_config(**overrides) -> UNetConfig:
    base = dict(cross_attention_dim=1024, num_attention_heads=None,
                attention_head_dim=64, use_linear_projection=True)
    base.update(overrides)
    return UNetConfig(**base)


def tiny_unet_config(**overrides) -> UNetConfig:
    """16 cross-attn layers preserved, tiny channels — for tests."""
    base = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32,
                num_attention_heads=2, norm_groups=8)
    base.update(overrides)
    return UNetConfig(**base)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=1e-5)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, temb, fuse: bool = False):
        t = self.time_emb_proj(F.silu(temb))
        if fuse:
            a1, b1 = self.norm1(x, fold=True)
            h = fused_affine_silu_conv3x3(
                x, a1, b1, conv3x3_hwio(self.conv1), self.conv1.bias,
                add_bc=t, out_dtype=x.dtype)
            a2, b2 = self.norm2(h, fold=True)
            if self.conv_shortcut is not None:
                x = conv_nhwc(self.conv_shortcut, x)
            return fused_affine_silu_conv3x3(
                h, a2, b2, conv3x3_hwio(self.conv2), self.conv2.bias,
                residual=x, out_dtype=x.dtype)
        h = conv_nhwc(self.conv1, F.silu(self.norm1(x)))
        h = h + t[:, None, None, :]
        h = conv_nhwc(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x)
        return x + h


class CrossAttention(nn.Module):
    """QKV attention with separate K-source and V-source tensors: None for
    both is self-attention; for XTI cross-attention ctx_k is the regular
    context and ctx_v the bypass context. heads: the heads this process
    runs (under tensor parallelism, its rank's)."""

    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.tp = None
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx_k=None, ctx_v=None):
        B, L, _ = x.shape
        H = self.heads
        x = copy_to_tp(x, self.tp)
        src_k = x if ctx_k is None else copy_to_tp(ctx_k.to(x.dtype),
                                                   self.tp)
        src_v = src_k if ctx_v is None else copy_to_tp(ctx_v.to(x.dtype),
                                                       self.tp)
        q = self.to_q(x)
        hd = q.shape[-1] // H
        q = q.reshape(B, L, H, hd)
        k = self.to_k(src_k).reshape(B, src_k.shape[1], H, hd)
        v = self.to_v(src_v).reshape(B, src_v.shape[1], H, hd)
        out = multi_head_attention(q, k, v).reshape(B, L, H * hd)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.tp = None
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx_k, ctx_v):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx_k, ctx_v)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer around one BasicTransformerBlock; xti_index is the
    static index into the stacked (16, B, 77, D) contexts."""

    def __init__(self, channels: int, ctx_dim: int, heads: int,
                 xti_index: int, groups: int, use_linear_projection: bool):
        super().__init__()
        self.xti_index = xti_index
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, ctx_dim, heads)])

    def forward(self, x, context, context_bypass):
        B, H, W, C = x.shape
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.reshape(B, H * W, C))
        else:
            h = conv_nhwc(self.proj_in, h).reshape(B, H * W, C)
        h = self.transformer_blocks[0](h, context[self.xti_index],
                                       context_bypass[self.xti_index])
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(B, H, W, C)
        else:
            h = conv_nhwc(self.proj_out, h.reshape(B, H, W, C))
        return h + x


class _Sampler(nn.Module):
    """Holds the `conv` of a diffusers Downsample2D / Upsample2D."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=1)


class _Block(nn.Module):
    """One down/up block: resnets, optional attentions, optional sampler."""

    def __init__(self, resnets: List[nn.Module], attentions: List[nn.Module],
                 sampler: Optional[nn.Module], sampler_name: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        setattr(self, sampler_name,
                nn.ModuleList([sampler]) if sampler is not None else None)


class _TimeEmbedding(nn.Module):
    def __init__(self, ch0: int, temb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(ch0, temb_dim)
        self.linear_2 = nn.Linear(temb_dim, temb_dim)


class UNet2DCondition(nn.Module):
    """forward(latents, timesteps, context, context_bypass=None).

    latents: (B, H, W, 4) NHWC; timesteps: (B,); context / context_bypass:
    (16, B, 77, ctx_dim) stacked per-layer conditioning, or (B, 77, ctx_dim)
    broadcast over the 16 layers. Returns (B, H, W, 4) in fp32.
    """

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        G = cfg.norm_groups
        ctx = cfg.cross_attention_dim
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, temb_dim)

        def attn(ch, xti):
            return Transformer2D(ch, ctx, cfg.heads_for(ch), xti, G,
                                 cfg.use_linear_projection)

        xti = 0
        skip_chs = [ch0]
        ch = ch0
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(cfg.block_out_channels):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(ch, out_ch, temb_dim, G))
                ch = out_ch
                if i < n - 1:
                    attns.append(attn(out_ch, xti))
                    xti += 1
                skip_chs.append(ch)
            down = _Sampler(ch, 2) if i < n - 1 else None
            if down is not None:
                skip_chs.append(ch)
            self.down_blocks.append(_Block(resnets, attns, down,
                                           "downsamplers"))
        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid_ch, mid_ch, temb_dim, G),
             ResnetBlock(mid_ch, mid_ch, temb_dim, G)],
            [attn(mid_ch, xti)], None, "samplers")
        xti += 1
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(reversed(cfg.block_out_channels)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(ch + skip_chs.pop(), out_ch,
                                           temb_dim, G))
                ch = out_ch
                if i > 0:
                    attns.append(attn(out_ch, xti))
                    xti += 1
            up = _Sampler(ch, 1) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, up, "upsamplers"))
        assert xti == 16, f"XTI layer count {xti} != 16"
        self.conv_norm_out = GroupNorm(G, ch, eps=1e-5)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)
        self.conv_out.keep_fp32 = True   # the JAX module's fp32 conv_out

    def forward(self, latents, timesteps, context, context_bypass=None):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if context.dim() == 3:   # (B, L, D) -> the same for all 16 layers
            context = context[None].expand((16,) + tuple(context.shape))
        if context_bypass is None:
            context_bypass = context
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(temb.to(dtype))))

        remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
        fuse = cfg.fuse_conv

        def resnet(block, x):
            if remat:
                return checkpoint(block, x, temb, fuse, use_reentrant=False)
            return block(x, temb, fuse)

        x = conv_nhwc(self.conv_in, latents.to(dtype))
        skips = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = resnet(res, x)
                if block.attentions is not None:
                    x = block.attentions[j](x, context, context_bypass)
                skips.append(x)
            if block.downsamplers is not None:
                x = conv_nhwc(block.downsamplers[0].conv, x)
                skips.append(x)

        mid = self.mid_block
        x = resnet(mid.resnets[0], x)
        x = mid.attentions[0](x, context, context_bypass)
        x = resnet(mid.resnets[1], x)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = resnet(res, torch.cat([x, skips.pop()], dim=-1))
                if block.attentions is not None:
                    x = block.attentions[j](x, context, context_bypass)
            if block.upsamplers is not None:
                x = conv_nhwc(block.upsamplers[0].conv,
                              nearest_upsample_2x(x))

        x = F.silu(self.conv_norm_out(x))
        return conv_nhwc(self.conv_out, x.float())
