"""Carry JAX parameter trees across to the port's state_dicts, and load
the SD stack from a diffusers-layout directory on disk.

The inverse of view_neti_tpu/weight_port.py:98-362, with the port's own
copy of its key tables: each diffusers/transformers key maps to a path in
the flax tree and a transform (flax HWIO conv kernels -> torch OIHW, flax
(in, out) dense kernels -> torch (out, in), norm scale -> weight). The
result loads with load_state_dict(strict=True) into the port's modules.
Every leaf of the tree must be consumed and every expected key found, or
the port raises: a partial carry must never pass silently. For the
mappers, to_jax_mapper and to_jax_trainable go the other way, so that
checkpoints carry them in the JAX tree layout (checkpoint.py).

load_sd_weights (view_neti_tpu/weight_port.py:364) reads the UNet, VAE and
CLIP text encoder of a local diffusers-layout directory (.safetensors
through the port's own reader, .bin through torch.load(weights_only=True)).
The port's modules use diffusers'/transformers' own keys, so the files'
state_dicts load as they are; the same key tables account for every key
(PortReport), and the CLIP token table gains its vocab headroom.

write_manifest and check_manifest pin a weights directory by sha256, in
the JAX package's manifest format; python -m
view_neti_tpu_torch.weights_manifest is their command line.
"""
from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path as FilePath
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from view_neti_tpu_torch.utils import safetensors_io

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


def from_jax_trainable(trainable: Mapping,
                       obj_constants: Optional[Mapping] = None,
                       view_constants: Optional[Mapping] = None
                       ) -> Dict[str, object]:
    """The JAX trainable tree {"object": bank stacked on a leading axis N,
    "view": one mapper's params} -> {"object": [N state_dicts, one per
    object mapper], "view": state_dict}; absent keys stay absent."""
    out: Dict[str, object] = {}
    bank = trainable.get("object")
    if bank is not None:
        leaves = _leaves(bank)
        n = np.asarray(next(iter(leaves.values()))).shape[0]

        def slice_tree(tree, i):
            return {k: slice_tree(v, i) if isinstance(v, Mapping)
                    else np.asarray(v)[i] for k, v in tree.items()}

        out["object"] = [from_jax_mapper(slice_tree(bank, i), obj_constants)
                         for i in range(n)]
    if trainable.get("view") is not None:
        out["view"] = from_jax_mapper(trainable["view"], view_constants)
    return out


def _set_path(tree: Dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_jax_mapper(state_dict: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict, Dict]:
    """The inverse of from_jax_mapper: a port NeTIMapper state_dict ->
    (params, constants) in the JAX module's tree layout, float32 numpy
    leaves (dense kernels back to (in, out), LayerNorm weight to scale)."""
    mapping = mapper_mapping()
    tree: Dict = {"params": {}, "constants": {}}
    for key, value in state_dict.items():
        if key not in mapping:
            raise KeyError(f"mapper: unexpected state_dict key {key!r}")
        path, tf = mapping[key]
        arr = value.detach().cpu().numpy().astype(np.float32)
        # the dense transform is a transpose, its own inverse
        _set_path(tree, path, np.ascontiguousarray(arr.T) if tf is _linear_w
                  else arr)
    return tree["params"], tree["constants"]


def to_jax_trainable(object_state_dicts: Optional[list] = None,
                     view_state_dict: Optional[Mapping] = None
                     ) -> Tuple[Dict, Optional[Dict], Optional[Dict]]:
    """The inverse of from_jax_trainable: the port's object mappers'
    state_dicts (stacked on a leading axis, the JAX bank) and its view
    mapper's -> (trainable {"object": bank, "view": params}, the object
    mappers' constants, the view mapper's constants)."""
    trainable: Dict = {}
    obj_constants = view_constants = None
    if object_state_dicts:
        trees = [to_jax_mapper(sd) for sd in object_state_dicts]

        def stack(*leaves):
            if isinstance(leaves[0], Mapping):
                return {k: stack(*(t[k] for t in leaves)) for k in leaves[0]}
            return np.stack(leaves)

        trainable["object"] = stack(*(p for p, _ in trees))
        obj_constants = trees[0][1]
    if view_state_dict is not None:
        trainable["view"], view_constants = to_jax_mapper(view_state_dict)
    return trainable, obj_constants, view_constants


# --------------------------------------------------------------------------
# SD weights from disk (view_neti_tpu/weight_port.py:23-95, 364-405)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PortReport:
    """The accounting of one component's load: a silent partial load must
    be impossible, so every key the table expects and every key the file
    holds is counted.

    missing_optional: expected keys absent from the file that may be
      (conv_shortcut: diffusers builds it only where a ResNet block changes
      its channel count).
    missing: expected keys absent from the file that should be there.
    unconsumed: file keys that no table entry reads (a forgotten submodule,
      or a buffer that is not a parameter, other than position_ids)."""
    name: str
    ported: int = 0
    missing: List[str] = dataclasses.field(default_factory=list)
    missing_optional: List[str] = dataclasses.field(default_factory=list)
    unconsumed: List[str] = dataclasses.field(default_factory=list)

    OPTIONAL_SUBSTRINGS = ("conv_shortcut",)
    IGNORABLE_SUBSTRINGS = ("position_ids",)

    def summary(self) -> str:
        s = (f"{self.name}: ported {self.ported} tensors"
             f" ({len(self.missing_optional)} optional absent)")
        if self.missing:
            s += (f"; MISSING {len(self.missing)} expected keys, "
                  f"e.g. {self.missing[:3]}")
        if self.unconsumed:
            s += (f"; {len(self.unconsumed)} checkpoint keys unconsumed, "
                  f"e.g. {self.unconsumed[:3]}")
        return s

    @property
    def clean(self) -> bool:
        return not self.missing and not self.unconsumed


def load_state_dict(path: Union[str, FilePath]) -> Dict[str, torch.Tensor]:
    """A .safetensors file (the port's reader) or a torch .bin pickle of
    tensors, as CPU tensors."""
    path = FilePath(path)
    if path.suffix == ".safetensors":
        return safetensors_io.load_file(path)
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _find_weights_file(subdir: FilePath) -> FilePath:
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        p = subdir / name
        if p.exists():
            return p
    raise FileNotFoundError(f"no weights file in {subdir}")


def _account(sd: Dict[str, torch.Tensor], table: KeyTable,
             report: PortReport) -> Dict[str, torch.Tensor]:
    """Fill the report of a file's state_dict against a key table; returns
    the entries the table reads."""
    for key in table:
        if key in sd:
            report.ported += 1
        elif any(s in key for s in report.OPTIONAL_SUBSTRINGS):
            report.missing_optional.append(key)
        else:
            report.missing.append(key)
    report.unconsumed = [
        k for k in sd if k not in table
        and not any(s in k for s in report.IGNORABLE_SUBSTRINGS)]
    return {k: v for k, v in sd.items() if k in table}


def load_sd_weights(model_dir: Union[str, FilePath], text_layers: int = 12,
                    use_linear_projection: bool = False,
                    vocab_headroom: int = 128, strict: bool = True,
                    log=None, unet_blocks: int = 4, vae_blocks: int = 4
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "clip"}: the state_dicts of a local diffusers-layout
    SD directory (unet/, vae/, text_encoder/), in the files' dtypes, ready
    for load_state_dict into the port's modules. The CLIP token table gains
    vocab_headroom zero rows (the placeholder rows are filled from their
    super-categories by builder.init_concept_rows_).

    strict (the default) raises unless every component is clean: an
    expected key absent or a file key unread. strict=False (the CLI's
    VIEW_NETI_LAX_WEIGHTS=1) logs each skip and goes on."""
    log = log or (lambda m: print(f"[weight_port] {m}"))
    model_dir = FilePath(model_dir)
    parts = (("unet", "unet", unet_mapping(
                  num_blocks=unet_blocks,
                  use_linear_projection=use_linear_projection)),
             ("vae", "vae", vae_mapping(num_blocks=vae_blocks)),
             ("clip", "text_encoder", clip_text_mapping(text_layers)))
    out, reports = {}, []
    for name, sub, table in parts:
        report = PortReport(name)
        out[name] = _account(
            load_state_dict(_find_weights_file(model_dir / sub)), table,
            report)
        reports.append(report)
        log(report.summary())
    bad = [r for r in reports if not r.clean]
    if strict and bad:
        raise KeyError(
            "weight port is not clean: "
            + "; ".join(r.summary() for r in bad)
            + " - fix the checkpoint or pass strict=False "
              "(VIEW_NETI_LAX_WEIGHTS=1 from the CLI)")
    key = "text_model.embeddings.token_embedding.weight"
    if key in out["clip"]:
        tab = out["clip"][key]
        out["clip"][key] = torch.cat(
            [tab, tab.new_zeros((vocab_headroom, tab.shape[1]))])
    return out


# --------------------------------------------------------------------------
# LPIPS weights (view_neti_tpu/weight_port.py:458)
# --------------------------------------------------------------------------

def from_jax_lpips(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LPIPS params ({"vgg": {"convN": {kernel HWIO, bias}}, "linN":
    (1, 1, 1, C)}) -> the port's LPIPS state_dict (vgg.convN OIHW, linN
    (C,))."""
    tree = _leaves(params)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in tree.items():
        arr = np.asarray(value, np.float32)
        if path[0] == "vgg":
            kernel = path[2] == "kernel"
            name = f"vgg.{path[1]}.{'weight' if kernel else 'bias'}"
            arr = _conv_w(arr) if kernel else arr
        else:
            name = path[0]
            arr = arr.reshape(-1)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_lpips_npz(path: Union[str, FilePath]) -> Dict[str, torch.Tensor]:
    """The port's LPIPS state_dict of an .npz with keys vgg/convN/kernel
    (HWIO), vgg/convN/bias and linN, the JAX package's export format."""
    tree: Dict = {}
    with np.load(str(path)) as data:
        for key in data.files:
            _set_path(tree, tuple(key.split("/")), data[key])
    return from_jax_lpips(tree)


# --------------------------------------------------------------------------
# weight manifests (view_neti_tpu/weight_port.py:479-542): pin the weight
# files by sha256, so that an acceptance run scores the files it names.
# A manifest written by either package checks in the other.
# --------------------------------------------------------------------------

MANIFEST_PATTERNS = ("*.safetensors", "*.bin", "*.npz", "vocab.json",
                     "merges.txt")


def _manifest_files(root: Union[str, FilePath],
                    extra: Sequence[str] = ()) -> List[FilePath]:
    """The weight files under a diffusers-layout directory (those
    load_sd_weights reads, the tokenizer's vocabulary files), each pattern
    sorted, then the extras that exist."""
    root = FilePath(root)
    files: List[FilePath] = []
    for pattern in MANIFEST_PATTERNS:
        files += sorted(root.rglob(pattern))
    return files + [FilePath(e) for e in extra if FilePath(e).exists()]


def _sha256_file(path: Union[str, FilePath]) -> str:
    """sha256 of a file read in 4 MiB chunks: weight files are GBs."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(root: Union[str, FilePath],
                   out_path: Union[str, FilePath],
                   extra: Sequence[str] = ()) -> int:
    """Write one line "sha256  bytes  relpath" per weight file (an extra
    outside root keeps its own path); returns the number of files."""
    root = FilePath(root)
    lines = []
    for f in _manifest_files(root, extra):
        try:
            rel = f.relative_to(root)
        except ValueError:
            rel = f
        lines.append(f"{_sha256_file(f)}  {f.stat().st_size}  {rel}")
    FilePath(out_path).write_text("\n".join(lines) + "\n")
    return len(lines)


def check_manifest(root: Union[str, FilePath],
                   manifest_path: Union[str, FilePath]) -> List[str]:
    """The files that differ from a manifest, one "missing: ", "size
    mismatch: " or "sha256 mismatch: " line each; [] when all match."""
    root = FilePath(root)
    problems = []
    for line in FilePath(manifest_path).read_text().splitlines():
        if not line.strip():
            continue
        want_hash, want_size, rel = line.split(maxsplit=2)
        f = FilePath(rel) if FilePath(rel).is_absolute() else root / rel
        if not f.exists():
            problems.append(f"missing: {rel}")
        elif f.stat().st_size != int(want_size):
            problems.append(f"size mismatch: {rel}")
        elif _sha256_file(f) != want_hash:
            problems.append(f"sha256 mismatch: {rel}")
    return problems
