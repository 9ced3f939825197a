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
__init__), so no reference code is imported or run.

The export side (view_neti_tpu/torch_interop.py:339-527) writes the
port's msgpack checkpoints back in those formats, so that mappers trained
by the port run in the published ViewNeTI tooling: the config cut to the
reference's fields, the reference's state_dict keys (no encoder.w, which
the reference does not register), and the pickled encoder as an instance
of the shim class, so that the pickle names the reference's class path.
`python -m view_neti_tpu_torch.export_torch` is its command line.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from view_neti_tpu_torch import config as config_lib
from view_neti_tpu_torch import weight_port
from view_neti_tpu_torch.checkpoint import CheckpointHandler, clean_config_dict
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


def _iteration_of(p: Path, iteration: Optional[int]) -> str:
    """The step for an output name: `iteration`, else the first number in
    the file's name, else 0."""
    if iteration is not None:
        return str(iteration)
    for part in Path(p).stem.replace("_", "-").split("-"):
        if part.isdigit():
            return part
    return "0"


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
    jobs = []
    if view_path is not None:
        jobs.append((view_path, "mapper-steps-{}_view.msgpack",
                     lambda: convert_mapper_checkpoint(Path(view_path),
                                                       "view")))
    if object_path is not None:
        jobs.append((object_path, "mapper-steps-{}_object.msgpack",
                     lambda: convert_mapper_checkpoint(Path(object_path),
                                                       "object")))
    if embeds_path is not None:
        jobs.append((embeds_path, "learned_embeds-steps-{}.msgpack",
                     lambda: convert_learned_embeds(Path(embeds_path))))
    written: List[Path] = []
    for src, name, convert in jobs:
        out = out_dir / name.format(_iteration_of(src, iteration))
        out.write_bytes(msgpack_codec.packb(convert()))
        written.append(out)
    return written


# ---- export ---------------------------------------------------------------

# The reference RunConfig's fields (reference training/config.py:11-293).
# The reference decodes a checkpoint's config strictly
# (checkpoint_handler.py:142), so the port's own fields (parallel,
# log.{checkpoint_backend,resume_from}, data.{tokenizer_path,device_augment,
# placeholder_view_tokens}, eval.{validation_view_tokens,
# do_t2i_generalization,max_validation_failures},
# optim.{fuse_accumulation,fuse_conv,steps_per_dispatch}) are left out.
_REF_CFG_FIELDS: Dict[str, frozenset] = {
    "log": frozenset({
        "exp_name", "overwrite_ok", "exp_dir", "save_steps", "logging_dir",
        "report_to", "checkpoints_total_limit", "save_dataset_images"}),
    "data": frozenset({
        "train_data_dir", "train_data_subsets", "placeholder_object_token",
        "super_category_object_token", "super_category_view_token",
        "placeholder_object_tokens", "super_category_object_tokens",
        "fixed_object_token_or_path", "dataloader_num_workers", "repeats",
        "resolution", "dtu_preprocess_key", "center_crop", "flip_p",
        "caption_strategy", "camera_representation", "dtu_lighting",
        "dtu_subset", "augmentation_key"}),
    "model": frozenset({
        "pretrained_model_name_or_path", "pretrained_view_mapper",
        "pretrained_view_mapper_key", "word_embedding_dim",
        "arch_mlp_hidden_dims", "use_nested_dropout", "nested_dropout_prob",
        "normalize_object_mapper_output", "normalize_view_mapper_output",
        "target_norm_object", "target_norm_view",
        "use_positional_encoding_object", "use_positional_encoding_view",
        "pe_sigmas", "pe_sigma_exp_key", "pe_t_exp_key", "pe_l_exp_key",
        "pe_sigmas_view", "num_pe_time_anchors", "output_bypass_object",
        "output_bypass_view", "revision", "mapper_checkpoint_path",
        "arch_view_net", "arch_view_mix_streams", "arch_view_disable_tl",
        "original_ti", "bypass_unconstrained_object",
        "bypass_unconstrained_view", "output_bypass_alpha_view",
        "output_bypass_alpha_object"}),
    "eval": frozenset({
        "validation_prompts", "num_validation_images", "validation_seeds",
        "validation_steps", "num_denoising_steps", "dtu_upsample_key",
        "eval_placeholder_object_tokens"}),
    "optim": frozenset({
        "max_train_steps", "learning_rate", "scale_lr", "train_batch_size",
        "gradient_checkpointing", "gradient_accumulation_steps", "seed",
        "lr_scheduler", "lr_warmup_steps", "adam_beta1", "adam_beta2",
        "adam_weight_decay", "adam_epsilon", "mixed_precision",
        "allow_tf32"}),
}
_REF_CFG_TOP = frozenset({"learnable_mode", "debug", "seed",
                          "log", "data", "model", "eval", "optim"})




def reference_cfg_dict(cfg_enc: Dict[str, Any]) -> Dict[str, Any]:
    """The port's encoded RunConfig cut to the reference's fields."""
    out: Dict[str, Any] = {}
    for k, v in cfg_enc.items():
        if k not in _REF_CFG_TOP:
            continue
        if isinstance(v, dict) and k in _REF_CFG_FIELDS:
            out[k] = {fk: fv for fk, fv in v.items()
                      if fk in _REF_CFG_FIELDS[k]}
        else:
            out[k] = v
    return out


def _t(a) -> torch.Tensor:
    # a copy: msgpack arrays are read-only views
    return torch.from_numpy(np.array(a, copy=True))


def torch_state_from_flax(params: Dict[str, Any]) -> Dict[str, Any]:
    """A mapper's parameter tree of a checkpoint file (the JAX layout:
    Dense kernels (in, out), LayerNorm scales) -> the state_dict keys of
    the reference's NeTIMapper. encoder.w is not among them: the
    reference's nn.Parameter(...).cuda() leaves it unregistered, and its
    strict load_state_dict would refuse the key; the frequencies travel in
    the pickled encoder."""
    sd: Dict[str, Any] = {}
    if "ti_embeddings" in params:
        sd["ti_embeddings"] = _t(params["ti_embeddings"])
        return sd
    if "input_layer" in params:        # the legacy PE-1 object mapper
        sd["input_layer.weight"] = _t(params["input_layer"]["kernel"]).T
        sd["input_layer.bias"] = _t(params["input_layer"]["bias"])
    for ref, name in _NET_RENAME:
        leaf = params[name]
        if "kernel" in leaf:
            sd[f"{ref}.weight"] = _t(leaf["kernel"]).T.contiguous()
        else:
            sd[f"{ref}.weight"] = _t(leaf["scale"])
        sd[f"{ref}.bias"] = _t(leaf["bias"])
    sd["output_layer.0.weight"] = _t(
        params["output_layer"]["kernel"]).T.contiguous()
    sd["output_layer.0.bias"] = _t(params["output_layer"]["bias"])
    return sd


def _sigmas_for(cfg, n_feats: int) -> List[float]:
    """The reference's sigmas in construction order (neti_mapper.py:
    486-503): [sigma_t, sigma_l] and the pose's, by the frequency matrix's
    width."""
    ps = cfg.model.pe_sigmas
    base = [float(ps.sigma_t), float(ps.sigma_l)]
    if n_feats == 2:                 # an object mapper: (t, l)
        return base
    if n_feats == 3:                 # a view mapper, deg_freedom "phi"
        return base + [float(ps.sigma_phi)]
    if n_feats == 4:                 # "theta-phi"
        return base + [float(ps.sigma_theta), float(ps.sigma_phi)]
    return base + [float(ps.sigma_dtu12)] * (n_feats - 2)   # "dtu-12d"


def make_torch_encoder(constants: Dict[str, Any], cfg) -> Any:
    """The pickled encoder the reference's save_mapper embeds
    (checkpoint_handler.py:70-71, 85): an instance of the shim class at
    models.positional_encoding, with the attributes of the reference's
    constructor (positional_encoding.py:10-41, 153-171) and w a plain
    tensor, as a CUDA-saved reference checkpoint carries it."""
    _install_unpickle_shims()
    pe_mod = sys.modules["models.positional_encoding"]
    if "fourier_w" in constants:
        w = np.array(constants["fourier_w"], np.float32)
        enc = pe_mod.FourierPositionalEncodingNDims()
        enc.sigmas = _sigmas_for(cfg, w.shape[1])
        enc.dim = int(w.shape[0]) * 2
        enc.normalize = False
        enc.w = torch.from_numpy(w)
        return enc
    if "neti_w" in constants:
        w = np.array(constants["neti_w"], np.float32)
        enc = pe_mod.NeTIPositionalEncoding()
        enc.sigma_t = float(cfg.model.pe_sigmas.sigma_t)
        enc.sigma_l = float(cfg.model.pe_sigmas.sigma_l)
        enc.num_w = int(w.shape[0])
        enc.w = torch.from_numpy(w)
        return enc
    # PE 0: closed-form anchors (positional_encoding.py:57-68)
    enc = pe_mod.BasicEncoder()
    enc.normalized_timesteps = (torch.arange(1000) / 999.0) * 2 - 1
    enc.normalized_unet_layers = (torch.arange(16) / 15.0) * 2 - 1
    return enc


def export_mapper_checkpoint(path: Path, embedding_type: str
                             ) -> Dict[str, Any]:
    """A mapper-steps-N_{view,object}.msgpack -> the payload of the
    reference's save_mapper (checkpoint_handler.py:57-97). Object entries
    are keyed by ids after CLIP's vocabulary in the order of their tokens
    (the reference's load_mapper maps tokens to ids with its own tokenizer,
    checkpoint_handler.py:183-186, and never reads the keys); the view
    entry keeps the reference's "dummy_key"."""
    if embedding_type not in ("view", "object"):
        raise ValueError(f"embedding_type {embedding_type!r}")
    cfg, payload = CheckpointHandler.load_mapper(Path(path))
    out: Dict[str, Any] = {"cfg": reference_cfg_dict(payload["cfg"]),
                           "mappers": {}}
    first_added_id = 49408           # CLIP's vocabulary; added tokens follow
    for i, (key, entry) in enumerate(sorted(payload["mappers"].items())):
        sd = torch_state_from_flax(entry["params"])
        enc = make_torch_encoder(entry.get("constants") or {}, cfg)
        if embedding_type == "view":
            out_key: Any = "dummy_key"
            tok = "dummy"
        else:
            out_key = first_added_id + i
            tok = str(entry.get("placeholder_object_token") or key)
        out["mappers"][out_key] = {"state_dict": sd, "encoder": enc,
                                   "placeholder_object_token": tok}
    return out


def export_learned_embeds(path: Path) -> Dict[str, Any]:
    """learned_embeds msgpack -> the reference's .bin payload ({token:
    float32 row}, checkpoint_handler.py:40-55)."""
    embeds = CheckpointHandler.load_learned_embeds(Path(path))
    return {str(t): torch.from_numpy(np.asarray(r, np.float32))
            for t, r in embeds.items()}


def export_torch_artifacts(out_dir: Path,
                           view_path: Optional[Path] = None,
                           object_path: Optional[Path] = None,
                           embeds_path: Optional[Path] = None,
                           iteration: Optional[int] = None) -> List[Path]:
    """Write the reference's mapper-steps-N_{view,object}.pt and
    learned_embeds-steps-N.bin from the port's msgpack files (the mirror
    of import_torch_artifacts)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    if view_path is not None:
        jobs.append((view_path, "mapper-steps-{}_view.pt",
                     lambda: export_mapper_checkpoint(view_path, "view")))
    if object_path is not None:
        jobs.append((object_path, "mapper-steps-{}_object.pt",
                     lambda: export_mapper_checkpoint(object_path,
                                                      "object")))
    if embeds_path is not None:
        jobs.append((embeds_path, "learned_embeds-steps-{}.bin",
                     lambda: export_learned_embeds(embeds_path)))
    written: List[Path] = []
    for src, name, payload in jobs:
        out = out_dir / name.format(_iteration_of(src, iteration))
        torch.save(payload(), str(out))
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
