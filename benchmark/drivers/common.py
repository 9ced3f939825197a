"""What the traffic drivers share: the synthetic DTU files, the program's
architecture and weights from a configuration file, the reference stack
after the window, and the spans the traced run reads.

The program is imported inside the functions that use it, so that the
harness's own modules import nothing of it.
"""
from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark import weights as weights_lib
from benchmark.reference import neti, prec
from benchmark.reference import stack as ref_stack


# ------------------------------------------------------------- files ----

def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG, filter 0 on every
    row."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def write_calibration(rng: np.random.Generator, caldir: str,
                      n: int) -> np.ndarray:
    """n DTU calibration files pos_001.txt .. (3x4 matrices, four
    decimals); returns the (n, 12) float32 values as written."""
    os.makedirs(caldir, exist_ok=True)
    cams = np.round(rng.standard_normal((n, 3, 4)) * 100, 4)
    for i in range(n):
        with open(os.path.join(caldir, f"pos_{i + 1:03d}.txt"), "w") as f:
            f.write("\n".join(" ".join(f"{x:.4f}" for x in row)
                              for row in cams[i]))
    return np.asarray([[float(f"{x:.4f}") for x in c.reshape(-1)]
                       for c in cams], np.float32)


# ----------------------------------------------------------- program ----

def program_arch(cfg: Dict):
    from view_neti_tpu_torch.models.clip_text import CLIPTextConfig
    from view_neti_tpu_torch.models.unet import UNetConfig
    from view_neti_tpu_torch.models.vae import VAEConfig
    from view_neti_tpu_torch.training import builder
    u, v = dict(cfg["unet"]), dict(cfg["vae"])
    u["block_out_channels"] = tuple(u["block_out_channels"])
    v["channel_mults"] = tuple(v["channel_mults"])
    return builder.SDArch(text=CLIPTextConfig(**cfg["text"]),
                          unet=UNetConfig(**u), vae=VAEConfig(**v),
                          prediction_type=cfg["prediction_type"])


def program_modules(built) -> Dict[str, torch.nn.Module]:
    text = built.text
    return {"unet": built.unet, "vae": built.vae, "text": text.clip,
            "object_mapper": text.obj_mappers[0],
            "view_mapper": text.view_mapper}


def load_program_weights(built, cfg: Dict, seed: int, device, run_cfg,
                         tokenizer) -> None:
    """The run's weights into the program's models, then the placeholder
    rows and target norms worked out from them, as the program does after
    loading a checkpoint."""
    from view_neti_tpu_torch.training import builder
    shapes = ref_stack.param_shapes(cfg)
    for group, module in program_modules(built).items():
        drawn = weights_lib.draw_group(shapes[group], seed, group, device)
        weights_lib.load_into(module, drawn, group)
        del drawn
    table = built.text.clip.text_model.embeddings.token_embedding.weight
    norms_obj, norm_view = builder.init_concept_rows_(
        run_cfg, tokenizer, built.placeholder_view_token_ids,
        built.placeholder_object_token_ids, table)
    built.target_norm_object, built.target_norm_view = norms_obj, norm_view
    built.text.obj_norm_scales = torch.tensor(norms_obj, device=device)
    built.text.view_norm_scale = torch.tensor(norm_view, device=device)


def mapper_leaves(built) -> Dict[str, torch.nn.Parameter]:
    text = built.text
    return {**{f"object_mapper.{n}": p
               for n, p in text.obj_mappers[0].named_parameters()},
            **{f"view_mapper.{n}": p
               for n, p in text.view_mapper.named_parameters()}}


# --------------------------------------------------------- reference ----

def reference_conditioner(cfg: Dict, seed: int, device, ids: Dict,
                          cams: np.ndarray, view_cams: Sequence[int]):
    """(stack, conditioner) on `device`: the run's weights drawn again,
    in float32, and the placeholders' rows and norms worked out from
    them. ids: obj, obj_super, view (one per view_cams entry),
    view_super. cams: every calibration camera (n, 12)."""
    prec.tf32_off()
    stack = ref_stack.build(cfg, device)
    shapes = ref_stack.param_shapes(cfg)
    for group, module in stack.modules().items():
        drawn = weights_lib.draw_group(shapes[group], seed, group, device)
        weights_lib.load_into(module, drawn, group)
        del drawn
    table = stack.text.text_model.embeddings.token_embedding.weight
    with torch.no_grad():
        obj_norm, view_norm = neti.set_placeholder_rows(
            table, ids["obj"], ids["obj_super"], ids["view"],
            ids["view_super"])
    params = neti.scaled_view_params(cams)[list(view_cams)]
    m = cfg["mapper"]
    cond = neti.Conditioner(
        text=stack.text, obj_mapper=stack.object_mapper,
        view_mapper=stack.view_mapper, obj_norm=obj_norm,
        view_norm=view_norm, obj_id=ids["obj"],
        view_ids=torch.tensor(ids["view"], device=device),
        view_params=torch.from_numpy(params).to(device),
        alpha_obj=m["alpha_object"], alpha_view=m["alpha_view"])
    return stack, cond


# ------------------------------------------------------------- spans ----

class Spans:
    """The benchmark's own spans around the calls it makes into the
    program: a record_function range of the name, which the traced run's
    readers find on the profile's host timeline; with `sync`, the span
    ends at a synchronize."""

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        with torch.profiler.record_function(name):
            yield
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()


def note_phases(marks) -> None:
    """The seconds of each set-up phase, on standard error."""
    import sys
    print("setup phases " + " ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
        file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
