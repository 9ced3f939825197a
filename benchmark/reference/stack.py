"""The reference stack of one configuration file: sizes, modules, weights.

`build(cfg, device)` makes the modules on `device` (the `meta` device for
shapes and FLOPs); `param_shapes(cfg)` lists every weight the benchmark
draws, by the published state_dict names, grouped as the models are
("unet", "vae", "text", "object_mapper", "view_mapper").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from benchmark.reference import neti
from benchmark.reference.sd import (TextEncoder, TextSizes, UNet, UNetSizes,
                                    VAE, VAESizes)


@dataclass
class Stack:
    text: TextEncoder
    unet: UNet
    vae: VAE
    object_mapper: neti.Mapper
    view_mapper: neti.Mapper
    prediction: str

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "text": self.text,
                "object_mapper": self.object_mapper,
                "view_mapper": self.view_mapper}


def sizes(cfg: Dict):
    t, u, v = cfg["text"], cfg["unet"], cfg["vae"]
    return (TextSizes(**t),
            UNetSizes(**{**u, "block_out_channels":
                         tuple(u["block_out_channels"])}),
            VAESizes(**{**v, "channel_mults": tuple(v["channel_mults"])}))


def build(cfg: Dict, device) -> Stack:
    ts, us, vs = sizes(cfg)
    m = cfg["mapper"]
    sig = neti.mapper_sigmas(cfg)
    D = ts.hidden_size
    with torch.device(device):
        stack = Stack(
            text=TextEncoder(ts), unet=UNet(us), vae=VAE(vs),
            object_mapper=neti.Mapper(sig["object"], m["object_hidden"], D),
            view_mapper=neti.Mapper(sig["view"], m["view_hidden"], D),
            prediction=cfg["prediction_type"])
    for mod in stack.modules().values():
        mod.requires_grad_(False)
    return stack


def param_shapes(cfg: Dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    stack = build(cfg, "meta")
    return {group: {n: tuple(p.shape) for n, p in mod.named_parameters()}
            for group, mod in stack.modules().items()}


def load(stack: Stack, weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy each group's weights in, strictly."""
    for group, mod in stack.modules().items():
        params = dict(mod.named_parameters())
        if set(params) != set(weights[group]):
            raise KeyError(f"{group}: the weights do not name its "
                           f"parameters")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(weights[group][n])
