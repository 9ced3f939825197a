"""NeTIMapper: (timestep, UNet layer[, camera]) -> CLIP word embedding and
bypass vector (view_neti_tpu/models/neti_mapper.py).

The paths the reference ships: arch_view_net 15 (Fourier features over
[t, l (+ camera)] -> 2-block MLP -> output head), the legacy object paths
(arch <= 14, use_positional_encoding 0 or 1) and original TI. Nested
dropout zeroes the tail of the hidden vector: at inference from a fixed
`truncation_idx`, in training from random draws that the caller passes in
(`sample_nested_dropout`), since torch's generator never gives JAX's bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
from view_neti_tpu_torch.models import positional_encoding as pe
from view_neti_tpu_torch.utils.types import MapperOutput, PESigmas

_PE_DIM = 64  # arch-15 encode dim (reference neti_mapper.py:506-511)


def lookup_view_rows(batch_view_ids: torch.Tensor,
                     table_token_ids: torch.Tensor) -> torch.Tensor:
    """Vectorized token-id -> table-row lookup. (B,) ids -> (B,) rows."""
    eq = batch_view_ids[:, None] == table_token_ids[None, :]
    return torch.argmax(eq.int(), dim=1)


NestedDropoutDraws = Tuple[torch.Tensor, torch.Tensor]


def sample_nested_dropout(generator: torch.Generator, rows: int, dim: int,
                          prob: float, device=None) -> NestedDropoutDraws:
    """The training-time nested-dropout draws for `rows` hidden vectors of
    width `dim`: whether each row drops (Bernoulli(prob)) and where its tail
    starts (uniform on [0, dim)), as jax.random.bernoulli / randint draw
    them in the JAX mapper."""
    apply = torch.rand(rows, generator=generator, device=device) < prob
    idx = torch.randint(0, dim, (rows,), generator=generator, device=device)
    return apply, idx


def nested_dropout(h: torch.Tensor, draws: NestedDropoutDraws
                   ) -> torch.Tensor:
    """Zero h[i, idx[i]:] in every row i with apply[i]
    (view_neti_tpu/models/neti_mapper.py _nested_dropout, train=True)."""
    apply, idx = draws
    pos = torch.arange(h.shape[-1], device=h.device)
    keep = (pos[None, :] < idx[:, None]) | ~apply[:, None]
    return h * keep


class NeTIMapper(nn.Module):
    """Constructor arguments are the JAX module's fields; parameter names
    follow its tree (net_dense0, net_ln0, ..., output_layer), and the
    frequency matrix is the persistent buffer `fourier_w` (arch 15) or
    `neti_w` (legacy PE 1)."""

    def __init__(self, embedding_type: str, output_dim: int = 768,
                 arch_mlp_hidden_dims: int = 128,
                 use_nested_dropout: bool = True,
                 nested_dropout_prob: float = 0.5,
                 norm_scale: Optional[float] = None,
                 normalize_output: bool = False,
                 use_positional_encoding: int = 1,
                 num_pe_time_anchors: int = 10,
                 pe_sigmas: Optional[PESigmas] = None,
                 output_bypass: bool = True, arch_view_net: int = 0,
                 arch_view_disable_tl: bool = True,
                 original_ti: bool = False,
                 bypass_unconstrained: bool = True,
                 output_bypass_alpha: float = 0.2,
                 num_unet_layers: int = NUM_UNET_LAYERS,
                 num_view_cond_dims: int = 0, num_view_tokens: int = 0,
                 pe_seed: int = 0, device=None):
        super().__init__()
        if original_ti and output_bypass:
            raise ValueError("original_ti is incompatible with output_bypass "
                             "(reference neti_mapper.py:73-76)")
        self.embedding_type = embedding_type
        self.output_dim = output_dim
        self.use_nested_dropout = use_nested_dropout
        self.nested_dropout_prob = nested_dropout_prob
        self.norm_scale = norm_scale
        self.normalize_output = normalize_output
        self.use_positional_encoding = use_positional_encoding
        self.output_bypass = output_bypass
        self.arch_view_net = arch_view_net
        self.original_ti = original_ti
        self.bypass_unconstrained = bypass_unconstrained
        self.output_bypass_alpha = output_bypass_alpha
        self.num_unet_layers = num_unet_layers
        self.num_view_cond_dims = num_view_cond_dims
        self.is_ti = original_ti or (embedding_type == "view"
                                     and arch_view_net == 1)
        sigmas = self._sigmas(pe_sigmas or PESigmas())

        if self.is_ti:
            n_rows = max(num_view_tokens, 1) if embedding_type == "view" \
                else 1
            self.ti_embeddings = nn.Parameter(
                torch.zeros(n_rows, output_dim, device=device))
            return

        if arch_view_net <= 14:
            if embedding_type != "object":
                raise NotImplementedError(
                    "legacy arch<=14 view paths are not rebuilt")
            if use_positional_encoding == 1:
                freqs = pe.make_neti_freqs(pe_seed, sigmas[0], sigmas[1],
                                           device=device)
                self.register_buffer("neti_w", freqs)
                input_dim = num_pe_time_anchors * num_unet_layers
                self.input_layer = nn.Linear(2 * freqs.shape[0], input_dim,
                                             device=device)
                self.num_pe_time_anchors = num_pe_time_anchors
            elif use_positional_encoding == 0:
                input_dim = 2
            else:
                raise ValueError(f"use_positional_encoding="
                                 f"{use_positional_encoding} unsupported")
            h = arch_mlp_hidden_dims
        elif arch_view_net == 15:
            if embedding_type == "view" and arch_view_disable_tl:
                raise NotImplementedError(
                    "arch 15 assumes (t,l) conditioning "
                    "(reference neti_mapper.py:481-483)")
            self.register_buffer(
                "fourier_w", pe.make_fourier_freqs(pe_seed, _PE_DIM, sigmas,
                                                   device=device))
            input_dim = _PE_DIM
            # view arch 15 uses a fixed 64-wide net; object the configured
            h = 64 if embedding_type == "view" else arch_mlp_hidden_dims
        else:
            raise NotImplementedError(
                f"arch_view_net={arch_view_net} not rebuilt")
        out_dim = output_dim * (2 if output_bypass else 1)
        self.net_dense0 = nn.Linear(input_dim, h, device=device)
        self.net_ln0 = nn.LayerNorm(h, eps=1e-5, device=device)
        self.net_dense1 = nn.Linear(h, h, device=device)
        self.net_ln1 = nn.LayerNorm(h, eps=1e-5, device=device)
        self.output_layer = nn.Linear(h, out_dim, device=device)

    @property
    def hidden_dim(self) -> int:
        """Width of the hidden vector that nested dropout cuts."""
        return self.net_dense1.out_features

    def _sigmas(self, s: PESigmas):
        sigmas = [s.sigma_t, s.sigma_l]
        if self.embedding_type == "view":
            if self.num_view_cond_dims == 1:
                sigmas += [s.sigma_phi]
            elif self.num_view_cond_dims == 2:
                sigmas += [s.sigma_theta, s.sigma_phi]
            elif self.num_view_cond_dims == 12:
                sigmas += [s.sigma_dtu12] * 12
            elif self.num_view_cond_dims != 0:
                raise NotImplementedError(self.num_view_cond_dims)
        return sigmas

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator,
                          ti_init_embed: Optional[torch.Tensor] = None):
        """Seeded init as in flax: dense kernels N(0, 1/fan_in), zero biases,
        unit LayerNorms; the legacy input projection starts from the encoded
        (t, l) anchors; original TI starts from `ti_init_embed` if given."""
        if self.is_ti:
            if ti_init_embed is not None:
                self.ti_embeddings.copy_(ti_init_embed.expand_as(
                    self.ti_embeddings))
            else:
                self.ti_embeddings.normal_(0.0, 0.02, generator=generator)
            return
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if hasattr(self, "neti_w"):
            self.input_layer.weight.copy_(pe.neti_init_layer(
                self.neti_w, self.num_pe_time_anchors, self.num_unet_layers))

    def forward(self, timestep: torch.Tensor, unet_layer: torch.Tensor,
                view_params: Optional[torch.Tensor] = None,
                view_rows: Optional[torch.Tensor] = None,
                truncation_idx: Optional[int] = None,
                norm_scale: Optional[torch.Tensor] = None,
                dropout: Optional[NestedDropoutDraws] = None
                ) -> MapperOutput:
        """timestep, unet_layer: (B,) raw values in [0, 1000) and [0, 16);
        view_params: (B, C) scaled to (-1, 1) or None; view_rows: (B,) table
        rows (original-TI view path). dropout: the training-time nested
        dropout draws (sample_nested_dropout); given, they take the place
        of truncation_idx, as train=True does in the JAX mapper. Returns
        (B, output_dim) embeddings."""
        if self.is_ti:
            if self.embedding_type == "view":
                emb = self.ti_embeddings[view_rows]
            else:
                emb = self.ti_embeddings[0][None, :].expand(
                    timestep.shape[0], self.output_dim)
            return MapperOutput(word_embedding=emb, bypass_output=None,
                                bypass_unconstrained=False,
                                output_bypass_alpha=self.output_bypass_alpha)

        h = self._encode(timestep, unet_layer, view_params)
        h = F.leaky_relu(self.net_ln0(self.net_dense0(h)), 0.01)
        h = F.leaky_relu(self.net_ln1(self.net_dense1(h)), 0.01)
        if self.use_nested_dropout and dropout is not None:
            h = nested_dropout(h, dropout)
        elif self.use_nested_dropout and truncation_idx is not None:
            # zero the tail h[idx:] (reference neti_mapper.py:411-413)
            pos = torch.arange(h.shape[-1], device=h.device)
            h = h * (pos < truncation_idx)
        out = self.output_layer(h)
        if self.output_bypass:
            word, bypass = out.chunk(2, dim=-1)
        else:
            word, bypass = out, None
        scale = norm_scale if norm_scale is not None else self.norm_scale
        if (self.normalize_output or self.norm_scale is not None) \
                and scale is not None:
            # safe norm: clamp inside the sqrt (a zero word embedding is
            # reachable under full truncation with a zero output bias)
            sq = torch.sum(word * word, dim=-1, keepdim=True)
            word = word / torch.sqrt(torch.clamp(sq, min=1e-24)) * scale
        return MapperOutput(
            word_embedding=word, bypass_output=bypass,
            bypass_unconstrained=self.bypass_unconstrained
            and self.output_bypass,
            output_bypass_alpha=self.output_bypass_alpha)

    def _encode(self, timestep, unet_layer, view_params):
        if self.arch_view_net <= 14:
            if self.use_positional_encoding == 1:
                return self.input_layer(
                    pe.neti_encode(self.neti_w, timestep, unet_layer))
            return pe.basic_encode(timestep, unet_layer,
                                   num_unet_layers=self.num_unet_layers)
        # arch 15: scale (t, l) to [-1, 1] (reference neti_mapper.py:546-547
        # divides by 1000 / num_unet_layers, not by N-1)
        t_s = timestep.float() / 1000.0 * 2 - 1
        l_s = unet_layer.float() / self.num_unet_layers * 2 - 1
        data = torch.stack([t_s, l_s], dim=-1)
        if self.embedding_type == "view":
            data = torch.cat([data, view_params.float()], dim=-1)
        return pe.fourier_encode(self.fourier_w, data)
