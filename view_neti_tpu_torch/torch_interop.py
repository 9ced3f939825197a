"""Import the reference's torch checkpoints
(view_neti_tpu/torch_interop.py:1-333, 530-542; the import side).

The published ViewNeTI artifacts are torch pickles:

  mapper-steps-N_{view,object}.pt : {"cfg": the pyrallis-encoded RunConfig,
        "mappers": {token_id | "dummy_key": {"state_dict": OrderedDict,
        "encoder": <pickled nn.Module>, "placeholder_object_token": str}}}
  learned_embeds-steps-N.bin      : {token: torch.Tensor row}

They convert to the msgpack checkpoints of checkpoint.py, so that modes 4
and 5 start from the reference's pretrained view mapper without rerunning
its pretraining. A reference mapper state_dict becomes the port's
NeTIMapper state_dict directly (its Sequential indices renamed; torch
Linear and LayerNorm weights keep their layout), and then the JAX tree
layout of the checkpoint files (weight_port.to_jax_mapper). The torch-seeded
frequency matrix comes from the state_dict's encoder.w, or from the
pickled encoder module where a CUDA-saved checkpoint dropped it.

Unpickling the encoder needs the reference's module path
(models.positional_encoding); _install_unpickle_shims registers bare
stand-in classes (pickle restores instance state without calling
__init__), so no reference code is imported or run. Exporting the port's
checkpoints to the reference's formats is not ported yet.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from view_neti_tpu_torch import config as config_lib
from view_neti_tpu_torch import weight_port
from view_neti_tpu_torch.checkpoint import clean_config_dict
from view_neti_tpu_torch.utils import msgpack_codec

# the reference's Sequential index -> the port's submodule (Linear,
# LayerNorm, LeakyReLU, Linear, LayerNorm, LeakyReLU; the activations hold
# no parameters)
_NET_RENAME = (("net.0", "net_dense0"), ("net.1", "net_ln0"),
               ("net.3", "net_dense1"), ("net.4", "net_ln1"))


def _install_unpickle_shims() -> None:
    """Make the reference's pickled encoder modules loadable: bare
    nn.Module subclasses at models.positional_encoding.<Name>."""
    mod_name = "models.positional_encoding"
    if mod_name in sys.modules:
        return
    pkg = sys.modules.get("models")
    if pkg is None:
        pkg = types.ModuleType("models")
        pkg.__path__ = []          # a package, for pickle's imports
        sys.modules["models"] = pkg
    mod = types.ModuleType(mod_name)
    for cls_name in ("NeTIPositionalEncoding", "BasicEncoder",
                     "PositionalEncoding", "FourierPositionalEncoding",
                     "FourierPositionalEncodingNDims"):
        setattr(mod, cls_name,
                type(cls_name, (torch.nn.Module,), {"__module__": mod_name}))
    sys.modules[mod_name] = mod
    setattr(pkg, "positional_encoding", mod)


def load_torch_checkpoint(path: Path) -> Dict[str, Any]:
    """torch.load with the unpickle shims installed. The pickled encoder
    modules need weights_only=False: the file is trusted user input, as in
    the reference's own torch.load."""
    _install_unpickle_shims()
    return torch.load(str(path), map_location="cpu", weights_only=False)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def _encoder_w(sd: Dict[str, Any], encoder) -> Optional[torch.Tensor]:
    """The positional encoder's frequency matrix of a reference checkpoint
    entry: encoder.w of the state_dict (CPU-saved checkpoints), else the
    pickled encoder's w (CUDA-saved ones, where Parameter.cuda() demoted
    it to a plain attribute), else the reference's construction replayed
    from its sigmas (torch.manual_seed(0), randn(dim // 2, nfeats) scaled
    per column)."""
    if "encoder.w" in sd:
        return _f32(sd["encoder.w"])
    if encoder is None:
        return None
    w = getattr(encoder, "w", None)
    if w is not None:
        return _f32(w)
    sigmas = getattr(encoder, "sigmas", None)
    dim = getattr(encoder, "dim", None)
    if sigmas is None or dim is None:
        return None
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((int(dim) // 2, len(sigmas)), generator=gen)
    for i, s in enumerate(sigmas):
        w[:, i] *= s
    return w


def mapper_state_from_torch(sd: Dict[str, Any], encoder=None
                            ) -> Dict[str, torch.Tensor]:
    """The port's NeTIMapper state_dict of a reference mapper state_dict:
    arch-15 Fourier mappers (view and object), the legacy PE-1 object
    mapper, and original TI. encoder: the entry's pickled encoder module,
    read for the frequency matrix when the state_dict lacks it."""
    if "ti_embeddings" in sd:
        return {"ti_embeddings": _f32(sd["ti_embeddings"])}
    out: Dict[str, torch.Tensor] = {}
    w = _encoder_w(sd, encoder)
    if "input_layer.weight" in sd:
        out["input_layer.weight"] = _f32(sd["input_layer.weight"])
        out["input_layer.bias"] = _f32(sd["input_layer.bias"])
        if w is not None:
            out["neti_w"] = w
    elif w is not None:
        out["fourier_w"] = w
    # BasicEncoder's normalized_timesteps / unet_layers buffers are
    # recomputed in closed form by the port; they are dropped
    for ref, name in _NET_RENAME:
        out[f"{name}.weight"] = _f32(sd[f"{ref}.weight"])
        out[f"{name}.bias"] = _f32(sd[f"{ref}.bias"])
    out["output_layer.weight"] = _f32(sd["output_layer.0.weight"])
    out["output_layer.bias"] = _f32(sd["output_layer.0.bias"])
    return out


def _convert_cfg(raw_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's encoded config -> the port's canonical encoding,
    through its decoder, so that a converted checkpoint loads as a native
    one."""
    cfg = config_lib.decode(config_lib.RunConfig,
                            clean_config_dict(dict(raw_cfg)))
    return config_lib.encode(cfg)


def convert_mapper_checkpoint(path: Path, embedding_type: str
                              ) -> Dict[str, Any]:
    """A reference mapper-steps-N_{view,object}.pt -> the payload of a
    checkpoint.py mapper file. A view checkpoint's {"dummy_key": ...} level
    becomes the "view" entry; object mappers are keyed by token string
    (token ids depend on the tokenizer)."""
    if embedding_type not in ("view", "object"):
        raise ValueError(f"embedding_type {embedding_type!r}")
    ckpt = load_torch_checkpoint(path)
    payload: Dict[str, Any] = {"cfg": _convert_cfg(ckpt["cfg"]),
                               "mappers": {},
                               "source": f"torch-import:{Path(path).name}"}
    arch = int(ckpt["cfg"].get("model", {}).get("arch_view_net", 15))
    for key, entry in ckpt["mappers"].items():
        state = mapper_state_from_torch(entry["state_dict"],
                                        encoder=entry.get("encoder"))
        if (arch >= 15 and "ti_embeddings" not in state
                and "fourier_w" not in state):
            raise ValueError(
                f"cannot recover the Fourier frequency matrix for mapper "
                f"{key!r} in {path}: encoder.w is absent from the "
                f"state_dict and from the pickled encoder (arch_view_net="
                f"{arch})")
        params, constants = weight_port.to_jax_mapper(state)
        tok = "" if embedding_type == "view" else str(
            entry.get("placeholder_object_token", ""))
        payload["mappers"]["view" if embedding_type == "view" else tok] = {
            "params": params, "constants": constants,
            "placeholder_object_token": tok}
    if embedding_type == "view":
        # regenerated from the calibration when the mapper is loaded
        payload["view_tokens"] = []
        payload["view_token_ids"] = []
    return payload


def convert_learned_embeds(path: Path) -> Dict[str, Any]:
    """learned_embeds-steps-N.bin ({token: tensor}) -> {token: float32
    row}."""
    ckpt = load_torch_checkpoint(path)
    return {str(tok): _f32(row).numpy() for tok, row in ckpt.items()}


def import_torch_artifacts(out_dir: Path,
                           view_path: Optional[Path] = None,
                           object_path: Optional[Path] = None,
                           embeds_path: Optional[Path] = None,
                           iteration: Optional[int] = None) -> List[Path]:
    """Write checkpoint.py's msgpack files side by side in out_dir, named
    so that training (model.pretrained_view_mapper) and offline inference
    (mapper-steps-N_*.msgpack) find them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: List[Path] = []

    def iter_of(p: Path) -> str:
        if iteration is not None:
            return str(iteration)
        for part in Path(p).stem.replace("_", "-").split("-"):
            if part.isdigit():
                return part
        return "0"

    jobs = []
    if view_path is not None:
        jobs.append((f"mapper-steps-{iter_of(view_path)}_view.msgpack",
                     lambda: convert_mapper_checkpoint(Path(view_path),
                                                       "view")))
    if object_path is not None:
        jobs.append((f"mapper-steps-{iter_of(object_path)}_object.msgpack",
                     lambda: convert_mapper_checkpoint(Path(object_path),
                                                       "object")))
    if embeds_path is not None:
        jobs.append((f"learned_embeds-steps-{iter_of(embeds_path)}.msgpack",
                     lambda: convert_learned_embeds(Path(embeds_path))))
    for name, convert in jobs:
        out = out_dir / name
        out.write_bytes(msgpack_codec.packb(convert()))
        written.append(out)
    return written


def maybe_import_view_mapper(path: Path) -> Path:
    """model.pretrained_view_mapper as a msgpack path: a torch view mapper
    (.pt, .bin, .pth) is converted once into a .msgpack beside it (again
    when the source is newer); a msgpack path passes through."""
    path = Path(path)
    if path.suffix not in (".pt", ".bin", ".pth"):
        return path
    cache = path.with_suffix(".msgpack")
    if not cache.exists() or cache.stat().st_mtime < path.stat().st_mtime:
        cache.write_bytes(msgpack_codec.packb(
            convert_mapper_checkpoint(path, "view")))
    return cache
