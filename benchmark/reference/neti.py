"""The NeTI text conditioning in plain PyTorch: the view and object mappers
(arch 15: Fourier features of (t, l [, camera]) -> two LayerNorm +
LeakyReLU blocks -> a word embedding and a bypass vector), the placeholder
overwrite, the text encoder and the bypass merge, for every one of the
UNet's 16 layers.

Written from ViewNeTI's published mapper (neti_mapper.py, arch_view_net
15) and its XTI text encoder. The Fourier frequencies are fixed data that
the recipe draws from seed 0 with torch's CPU generator; this file draws
them the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sd import Linear, TextEncoder

NUM_LAYERS = 16
PE_DIM = 64


def fourier_freqs(sigmas: Sequence[float]) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    w = torch.randn((PE_DIM // 2, len(sigmas)), generator=g, device="cpu")
    return w * torch.tensor(list(sigmas), dtype=torch.float32,
                            device="cpu")[None]


class Mapper(nn.Module):
    def __init__(self, in_sigmas: Sequence[float], hidden: int, out: int):
        super().__init__()
        self.register_buffer("fourier_w", fourier_freqs(in_sigmas),
                             persistent=False)
        self.net_dense0 = Linear(PE_DIM, hidden)
        self.net_ln0 = nn.LayerNorm(hidden, eps=1e-5)
        self.net_dense1 = Linear(hidden, hidden)
        self.net_ln1 = nn.LayerNorm(hidden, eps=1e-5)
        self.output_layer = Linear(hidden, 2 * out)

    def forward(self, t, layer, norm, view_params=None):
        """(word embedding scaled to `norm`, bypass vector), each (N, D)."""
        data = torch.stack([t.float() / 1000.0 * 2 - 1,
                            layer.float() / NUM_LAYERS * 2 - 1], dim=-1)
        if view_params is not None:
            data = torch.cat([data, view_params], dim=-1)
        proj = data @ self.fourier_w.to(data.device).T
        h = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        h = F.leaky_relu(self.net_ln0(self.net_dense0(h)), 0.01)
        h = F.leaky_relu(self.net_ln1(self.net_dense1(h)), 0.01)
        word, bypass = self.output_layer(h).chunk(2, dim=-1)
        sq = torch.sum(word * word, dim=-1, keepdim=True)
        return word / torch.sqrt(torch.clamp(sq, min=1e-24)) * norm, bypass


def scaled_view_params(cams: np.ndarray) -> np.ndarray:
    """(N, 12) camera matrices -> scaled to (-1, 1) by each column's range
    over all N cameras (a constant column passes through)."""
    lo, hi = cams.min(0), cams.max(0)
    rng = hi - lo
    out = (cams - lo) / np.where(rng == 0, 1.0, rng) * 2 - 1
    return np.where(rng == 0, cams, out).astype(np.float32)


@dataclass
class Conditioner:
    """Everything the conditioning reads: the text encoder (with the
    placeholders' rows set), both mappers, the target norms, the token ids
    of the placeholders and each view token's scaled camera."""
    text: TextEncoder
    obj_mapper: Mapper
    view_mapper: Mapper
    obj_norm: float
    view_norm: float
    obj_id: int
    view_ids: torch.Tensor          # (V,)
    view_params: torch.Tensor       # (V, 12)
    alpha_obj: float
    alpha_view: float


def _merge(hidden, ids, ph, bypass, alpha):
    mask = ids == ph[:, None]
    existing = torch.einsum("bl,bld->bd", mask.float(), hidden)
    norm_b = torch.sqrt(torch.clamp((bypass * bypass).sum(-1, keepdim=True),
                                    min=1e-24))
    norm_e = torch.sqrt(torch.clamp((existing * existing).sum(
        -1, keepdim=True), min=1e-24))
    new = existing + alpha * bypass / norm_b * norm_e
    write = (mask & mask.any(1, keepdim=True))[..., None]
    return torch.where(write, new[:, None], hidden)


def conditioning(c: Conditioner, ids: torch.Tensor, t: torch.Tensor,
                 block: int = 64):
    """ids (B, L) with one view and one object placeholder each, t (B,)
    -> (ctx, ctx_bypass), each (16, B, L, D): the 16 layers' rows through
    the text encoder in blocks of `block` rows."""
    B, L = ids.shape
    ids_k = ids.repeat(NUM_LAYERS, 1)
    t_k = t.float().repeat(NUM_LAYERS)
    l_k = torch.arange(NUM_LAYERS, device=ids.device).repeat_interleave(B)
    ph_obj = torch.full((B * NUM_LAYERS,), c.obj_id, device=ids.device)
    vmask = ids_k[:, :, None] == c.view_ids[None, None, :]
    ph_view = torch.where(vmask.any(1), c.view_ids[None, :],
                          torch.zeros_like(c.view_ids)[None]).amax(1)
    rows = torch.argmax(vmask.any(1).int(), dim=1)
    w_obj, b_obj = c.obj_mapper(t_k, l_k, c.obj_norm)
    w_view, b_view = c.view_mapper(t_k, l_k, c.view_norm,
                                   c.view_params[rows])
    outs, outs_b = [], []
    for s in range(0, B * NUM_LAYERS, block):
        sl = slice(s, s + block)
        idb = ids_k[sl]
        emb = c.text.embed(idb)
        emb = torch.where((idb == ph_obj[sl, None])[..., None],
                          w_obj[sl, None], emb)
        emb = torch.where((idb == ph_view[sl, None])[..., None],
                          w_view[sl, None], emb)
        hidden = c.text.encode(emb)
        hb = _merge(hidden, idb, ph_obj[sl], b_obj[sl], c.alpha_obj)
        hb = _merge(hb, idb, ph_view[sl], b_view[sl], c.alpha_view)
        outs.append(c.text.final_norm(hidden))
        outs_b.append(c.text.final_norm(hb))
    D = outs[0].shape[-1]
    return (torch.cat(outs).reshape(NUM_LAYERS, B, L, D),
            torch.cat(outs_b).reshape(NUM_LAYERS, B, L, D))


def uncond_context(text: TextEncoder, ids: torch.Tensor) -> torch.Tensor:
    """The negative prompt's hidden states (1, L, D), no placeholder."""
    return text.final_norm(text.encode(text.embed(ids)))


def mapper_sigmas(cfg: Dict) -> Dict[str, List[float]]:
    """The Fourier scales of the object and view mappers from the
    configuration's `mapper` group."""
    m = cfg["mapper"]
    tl = [m["sigma_t"], m["sigma_l"]]
    return {"object": tl, "view": tl + [m["sigma_dtu12"]] * 12}


def set_placeholder_rows(table: torch.Tensor, obj_id: int, obj_super: int,
                         view_ids: Sequence[int], view_super: int):
    """Each placeholder's row is its super-category's; returns the object
    and view target norms (the super-category rows' norms)."""
    table[obj_id] = table[obj_super].clone()
    table[list(view_ids)] = table[view_super].clone()
    return (float(torch.linalg.norm(table[obj_super])),
            float(torch.linalg.norm(table[view_super])))


