"""The Stable Diffusion AutoencoderKL in PyTorch (view_neti_tpu/models/vae.py).

The whole autoencoder is built, with diffusers' state_dict keys, so a
diffusers checkpoint loads strictly. Serving runs `decode`; training runs
`encode_sample` (or `moments`) under no_grad. Activations are NHWC;
GroupNorm eps 1e-6 with fp32 statistics.

With `fuse_conv=True` every norm -> SiLU -> conv3x3 section of the encoder
and the decoder (both convs of each ResNet block and conv_out) runs through
ops.fused_conv.fused_affine_silu_conv3x3: the hand-written kernel K4 on the
card, which is forward-only. Parameters are identical either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from view_neti_tpu_torch.ops.attention import single_head_attention
from view_neti_tpu_torch.ops.conv import conv3x3_hwio, conv_nhwc
from view_neti_tpu_torch.ops.fused_conv import fused_affine_silu_conv3x3
from view_neti_tpu_torch.ops.norm import GroupNorm
from view_neti_tpu_torch.ops.resize import nearest_upsample_2x

SD_VAE_SCALING = 0.18215


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = SD_VAE_SCALING
    # run the decoder's norm+silu+conv3x3 sections through the fused conv
    fuse_conv: bool = False


def tiny_vae_config(**overrides) -> VAEConfig:
    """Small config for tests."""
    base = dict(base_channels=16, channel_mults=(1, 2), norm_groups=4)
    base.update(overrides)
    return VAEConfig(**base)


def _norm_silu_conv(norm: GroupNorm, conv: nn.Conv2d, x: torch.Tensor,
                    fuse: bool, residual=None) -> torch.Tensor:
    """conv3x3(silu(norm(x))) [+ residual], fused or unfused."""
    if fuse:
        a, b = norm(x, fold=True)
        return fused_affine_silu_conv3x3(x, a, b, conv3x3_hwio(conv),
                                         conv.bias, residual=residual,
                                         out_dtype=x.dtype)
    h = conv_nhwc(conv, F.silu(norm(x)))
    return h if residual is None else residual + h


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, fuse: bool = False):
        h = _norm_silu_conv(self.norm1, self.conv1, x, fuse)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x)
        return _norm_silu_conv(self.norm2, self.conv2, h, fuse, residual=x)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        h = single_head_attention(self.to_q(h), self.to_k(h), self.to_v(h))
        return x + self.to_out[0](h).reshape(B, H, W, C)


class _Sampler(nn.Module):
    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride,
                              padding=0 if stride == 2 else 1)


class _Block(nn.Module):
    def __init__(self, resnets, sampler, sampler_name: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        setattr(self, sampler_name,
                nn.ModuleList([sampler]) if sampler is not None else None)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups),
                                      ResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([AttnBlock(ch, groups)])

    def forward(self, x, fuse: bool):
        x = self.resnets[0](x, fuse)
        x = self.attentions[0](x)
        return self.resnets[1](x, fuse)


class Encoder(nn.Module):
    """Images (N, H, W, 3) -> the last conv's (N, h, w, 2 * latent) output
    (view_neti_tpu/models/vae.py Encoder, without quant_conv)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        G = cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = ch
        for i, mult in enumerate(cfg.channel_mults):
            out_ch = ch * mult
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(cur, out_ch, G))
                cur = out_ch
            down = (_Sampler(out_ch, 2)
                    if i != len(cfg.channel_mults) - 1 else None)
            self.down_blocks.append(_Block(resnets, down, "downsamplers"))
        self.mid_block = _MidBlock(cur, G)
        self.conv_norm_out = GroupNorm(G, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x, fuse: bool = False):
        h = conv_nhwc(self.conv_in, x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h, fuse)
            if block.downsamplers is not None:
                # asymmetric (0, 1) pad of H and W, then the stride-2 conv
                h = conv_nhwc(block.downsamplers[0].conv,
                              F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_block(h, fuse)
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, h, fuse)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        G = cfg.norm_groups
        cur = ch * cfg.channel_mults[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, cur, 3, padding=1)
        self.mid_block = _MidBlock(cur, G)
        self.up_blocks = nn.ModuleList()
        for i, mult in enumerate(reversed(cfg.channel_mults)):
            out_ch = ch * mult
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(cur, out_ch, G))
                cur = out_ch
            up = (_Sampler(out_ch, 1)
                  if i != len(cfg.channel_mults) - 1 else None)
            self.up_blocks.append(_Block(resnets, up, "upsamplers"))
        self.conv_norm_out = GroupNorm(G, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, cfg.in_channels, 3, padding=1)

    def forward(self, z, fuse: bool = False):
        h = conv_nhwc(self.conv_in, z)
        h = self.mid_block(h, fuse)
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h, fuse)
            if block.upsamplers is not None:
                h = conv_nhwc(block.upsamplers[0].conv,
                              nearest_upsample_2x(h))
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, h, fuse)


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def moments(self, x: torch.Tensor) -> torch.Tensor:
        """Images (N, H, W, 3) in [-1, 1] -> posterior moments
        (N, H/f, W/f, 2 * latent): mean | logvar."""
        return conv_nhwc(self.quant_conv,
                         self.encoder(x, self.config.fuse_conv))

    def encode_sample(self, x: torch.Tensor, eps: torch.Tensor
                      ) -> torch.Tensor:
        """z = (mean + std * eps) * scaling factor, with logvar clamped to
        [-30, 20] (diffusers' DiagonalGaussianDistribution). eps is the
        standard-normal draw of the latent's shape, passed in as data; it is
        cast to the moments' dtype, in which the JAX package draws it."""
        mean, logvar = self.moments(x).chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        return (mean + std * eps.to(mean.dtype)) * self.config.scaling_factor

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior mode (the mean), scaled."""
        return self.moments(x).chunk(2, dim=-1)[0] * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (N, h, w, 4) -> images (N, H, W, 3) in [-1, 1]."""
        z = z / self.config.scaling_factor
        return self.decoder(conv_nhwc(self.post_quant_conv, z),
                            self.config.fuse_conv)
