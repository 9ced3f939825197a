"""Stable Diffusion's UNet, VAE and CLIP text encoder in plain PyTorch,
float32, NHWC activations.

Written from the published diffusers and transformers modules
(UNet2DConditionModel, AutoencoderKL, CLIPTextModel) with their state_dict
keys, so that one dictionary of seeded weights loads into these modules
and into the program alike. Two departures from the published models,
both of ViewNeTI: each of the UNet's 16 cross-attentions reads its own
layer of a (16, B, L, D) context, K from the context and V from the
bypass context; the text encoder overwrites a placeholder token's input
row with the mapper's word embedding and merges its bypass vector after
the last layer (neti.py).

Every matrix product and convolution goes through prec.py, which runs it
in float32 or, for the control, on float8 operands.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import prec


# ------------------------------------------------------------ layers ----

class Linear(nn.Linear):
    def forward(self, x):
        return prec.linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    """A convolution on NHWC tensors."""

    def forward(self, x):
        return prec.conv2d(x, self.weight, self.bias, self.stride,
                           self.padding)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    pass


def norm_silu_conv(norm, conv, x, residual=None):
    """conv3x3(silu(norm(x))) [+ residual]: the section the port fuses."""
    prec.record_conv(x, conv.out_channels, residual is not None)
    h = conv(F.silu(norm(x)))
    return h if residual is None else residual + h


def upsample2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# -------------------------------------------------------------- UNet ----

@dataclass(frozen=True)
class UNetSizes:
    block_out_channels: Tuple[int, ...]
    cross_attention_dim: int
    num_attention_heads: Optional[int]
    attention_head_dim: Optional[int]
    use_linear_projection: bool
    layers_per_block: int = 2
    norm_groups: int = 32
    in_channels: int = 4
    out_channels: int = 4

    def heads(self, channels: int) -> int:
        if self.attention_head_dim:
            return channels // self.attention_head_dim
        return self.num_attention_heads


def timestep_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, eps):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = Linear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = norm_silu_conv(self.norm1, self.conv1, x)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return norm_silu_conv(self.norm2, self.conv2, h, residual=x)


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx_k=None, ctx_v=None):
        B, L, C = x.shape
        H = self.heads
        src_k = x if ctx_k is None else ctx_k
        src_v = src_k if ctx_v is None else ctx_v
        qh = self.to_q(x).reshape(B, L, H, C // H)
        kh = self.to_k(src_k).reshape(B, src_k.shape[1], H, C // H)
        vh = self.to_v(src_v).reshape(B, src_v.shape[1], H, C // H)
        out = prec.attention(qh, kh, vh).reshape(B, L, C)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
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
    def __init__(self, ch, ctx_dim, heads, layer, groups, linear_proj):
        super().__init__()
        self.layer, self.linear_proj = layer, linear_proj
        self.norm = GroupNorm(groups, ch, 1e-6)
        proj = (lambda: Linear(ch, ch)) if linear_proj else \
            (lambda: Conv(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, ctx_dim, heads)])
        self.proj_out = proj()

    def forward(self, x, ctx, ctx_b):
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        h = self.transformer_blocks[0](h, ctx[self.layer], ctx_b[self.layer])
        return self.proj_out(h.reshape(B, H, W, C)) + x


class _Holder(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    def __init__(self, resnets, attentions, sampler, sampler_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        setattr(self, sampler_name,
                nn.ModuleList([sampler]) if sampler is not None else None)


class _TimeEmbedding(nn.Module):
    def __init__(self, ch, dim):
        super().__init__()
        self.linear_1 = Linear(ch, dim)
        self.linear_2 = Linear(dim, dim)


class UNet(nn.Module):
    """forward(latents (B, h, w, 4), timesteps (B,), ctx, ctx_b (16, B, L,
    D)) -> (B, h, w, 4)."""

    def __init__(self, s: UNetSizes):
        super().__init__()
        self.s = s
        ch0 = s.block_out_channels[0]
        temb = 4 * ch0
        G, n = s.norm_groups, len(s.block_out_channels)
        self.conv_in = Conv(s.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, temb)
        layer = 0
        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, out in enumerate(s.block_out_channels):
            res, att = [], []
            for _ in range(s.layers_per_block):
                res.append(ResnetBlock(ch, out, temb, G, 1e-5))
                ch = out
                if i < n - 1:
                    att.append(Transformer2D(out, s.cross_attention_dim,
                                             s.heads(out), layer, G,
                                             s.use_linear_projection))
                    layer += 1
                skips.append(ch)
            down = None
            if i < n - 1:
                down = _Holder(Conv(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
            self.down_blocks.append(_Block(res, att, down, "downsamplers"))
        mid = s.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid, mid, temb, G, 1e-5),
             ResnetBlock(mid, mid, temb, G, 1e-5)],
            [Transformer2D(mid, s.cross_attention_dim, s.heads(mid), layer,
                           G, s.use_linear_projection)], None, "samplers")
        layer += 1
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(reversed(s.block_out_channels)):
            res, att = [], []
            for _ in range(s.layers_per_block + 1):
                res.append(ResnetBlock(ch + skips.pop(), out, temb, G, 1e-5))
                ch = out
                if i > 0:
                    att.append(Transformer2D(out, s.cross_attention_dim,
                                             s.heads(out), layer, G,
                                             s.use_linear_projection))
                    layer += 1
            up = _Holder(Conv(ch, ch, 3, padding=1)) if i < n - 1 else None
            self.up_blocks.append(_Block(res, att, up, "upsamplers"))
        if layer != 16:
            raise ValueError(f"{layer} cross-attention layers, not 16")
        self.conv_norm_out = GroupNorm(G, ch, 1e-5)
        self.conv_out = Conv(ch, s.out_channels, 3, padding=1)

    def forward(self, x, t, ctx, ctx_b):
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(timestep_embedding(
            t, self.s.block_out_channels[0]))))
        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = res(x, temb)
                if block.attentions is not None:
                    x = block.attentions[j](x, ctx, ctx_b)
                skips.append(x)
            if block.downsamplers is not None:
                x = block.downsamplers[0].conv(x)
                skips.append(x)
        m = self.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x, temb), ctx, ctx_b),
                         temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = res(torch.cat([x, skips.pop()], dim=-1), temb)
                if block.attentions is not None:
                    x = block.attentions[j](x, ctx, ctx_b)
            if block.upsamplers is not None:
                x = block.upsamplers[0].conv(upsample2x(x))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


# --------------------------------------------------------------- VAE ----

@dataclass(frozen=True)
class VAESizes:
    base_channels: int
    channel_mults: Tuple[int, ...]
    latent_channels: int
    norm_groups: int = 32
    layers_per_block: int = 2
    in_channels: int = 3
    scaling_factor: float = 0.18215


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        o = prec.attention(self.to_q(h)[:, :, None], self.to_k(h)[:, :, None],
                           self.to_v(h)[:, :, None], chunk=1)
        return x + self.to_out[0](o.reshape(B, H * W, C)).reshape(B, H, W, C)


class _Mid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, 0, groups, 1e-6),
                                      ResnetBlock(ch, ch, 0, groups, 1e-6)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        G, ch = s.norm_groups, s.base_channels
        self.conv_in = Conv(s.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = ch
        for i, mult in enumerate(s.channel_mults):
            res = []
            for _ in range(s.layers_per_block):
                res.append(ResnetBlock(cur, ch * mult, 0, G, 1e-6))
                cur = ch * mult
            down = (_Holder(Conv(cur, cur, 3, stride=2))
                    if i < len(s.channel_mults) - 1 else None)
            self.down_blocks.append(_Block(res, None, down, "downsamplers"))
        self.mid_block = _Mid(cur, G)
        self.conv_norm_out = GroupNorm(G, cur, 1e-6)
        self.conv_out = Conv(cur, 2 * s.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return norm_silu_conv(self.conv_norm_out, self.conv_out,
                              self.mid_block(h))


class Decoder(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        G, ch = s.norm_groups, s.base_channels
        cur = ch * s.channel_mults[-1]
        self.conv_in = Conv(s.latent_channels, cur, 3, padding=1)
        self.mid_block = _Mid(cur, G)
        self.up_blocks = nn.ModuleList()
        for i, mult in enumerate(reversed(s.channel_mults)):
            res = []
            for _ in range(s.layers_per_block + 1):
                res.append(ResnetBlock(cur, ch * mult, 0, G, 1e-6))
                cur = ch * mult
            up = (_Holder(Conv(cur, cur, 3, padding=1))
                  if i < len(s.channel_mults) - 1 else None)
            self.up_blocks.append(_Block(res, None, up, "upsamplers"))
        self.conv_norm_out = GroupNorm(G, cur, 1e-6)
        self.conv_out = Conv(cur, s.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if block.upsamplers is not None:
                h = block.upsamplers[0].conv(upsample2x(h))
        return norm_silu_conv(self.conv_norm_out, self.conv_out, h)


class VAE(nn.Module):
    def __init__(self, s: VAESizes):
        super().__init__()
        self.s = s
        self.encoder = Encoder(s)
        self.decoder = Decoder(s)
        self.quant_conv = Conv(2 * s.latent_channels, 2 * s.latent_channels,
                               1)
        self.post_quant_conv = Conv(s.latent_channels, s.latent_channels, 1)

    def encode_sample(self, x, eps):
        """Images in [-1, 1] -> a latent sample of the posterior, scaled."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        return (mean + std * eps) * self.s.scaling_factor

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.s.scaling_factor))

    def decode_uint8(self, z):
        img = torch.clamp(self.decode(z) / 2 + 0.5, 0, 1)
        return torch.round(img * 255).to(torch.uint8)


# -------------------------------------------------------------- CLIP ----

@dataclass(frozen=True)
class TextSizes:
    vocab_size: int
    vocab_headroom: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int
    hidden_act: str
    layer_norm_eps: float = 1e-5


class _Attn(nn.Module):
    def __init__(self, D, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(D, D), Linear(D, D)
        self.v_proj, self.out_proj = Linear(D, D), Linear(D, D)

    def forward(self, x, bias):
        B, L, D = x.shape
        H = self.heads
        qh = self.q_proj(x).reshape(B, L, H, D // H).transpose(1, 2)
        kh = self.k_proj(x).reshape(B, L, H, D // H).transpose(1, 2)
        vh = self.v_proj(x).reshape(B, L, H, D // H).transpose(1, 2)
        logits = prec.matmul(qh, kh.transpose(-1, -2)) * (D // H) ** -0.5
        probs = torch.softmax(logits + bias, dim=-1)
        out = prec.matmul(probs, vh).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, D, inner, act):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = Linear(D, inner), Linear(inner, D)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return self.fc2(h)


class _Layer(nn.Module):
    def __init__(self, s: TextSizes):
        super().__init__()
        D = s.hidden_size
        self.self_attn = _Attn(D, s.num_heads)
        self.layer_norm1 = LayerNorm(D, eps=s.layer_norm_eps)
        self.mlp = _MLP(D, s.intermediate_size, s.hidden_act)
        self.layer_norm2 = LayerNorm(D, eps=s.layer_norm_eps)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _Emb(nn.Module):
    def __init__(self, s: TextSizes):
        super().__init__()
        self.token_embedding = nn.Embedding(s.vocab_size + s.vocab_headroom,
                                            s.hidden_size)
        self.position_embedding = nn.Embedding(s.max_position_embeddings,
                                               s.hidden_size)


class _Enc(nn.Module):
    def __init__(self, s: TextSizes):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(s) for _ in range(s.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, s: TextSizes):
        super().__init__()
        self.embeddings = _Emb(s)
        self.encoder = _Enc(s)
        self.final_layer_norm = LayerNorm(s.hidden_size, eps=s.layer_norm_eps)


class TextEncoder(nn.Module):
    """encode(embeds (B, L, D)) -> the last layer's hidden states, before
    the final LayerNorm (neti.py merges the bypass there, then applies
    it)."""

    def __init__(self, s: TextSizes):
        super().__init__()
        self.s = s
        self.text_model = _TextModel(s)

    def embed(self, ids):
        return self.text_model.embeddings.token_embedding.weight[ids]

    def encode(self, embeds):
        tm = self.text_model
        L = embeds.shape[1]
        x = embeds + tm.embeddings.position_embedding.weight[:L]
        bias = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, bias)
        return x

    def final_norm(self, x):
        return self.text_model.final_layer_norm(x)
