"""Run configuration: dataclass tree, YAML files and CLI dot-overrides.

The port's counterpart of view_neti_tpu/config.py. Field names, defaults and
the decode/encode rules are those of the JAX package (and of the
reference's pyrallis surface), so a config written for one reads the same
in the other. YAML goes through utils/yaml_subset.py, the port's own reader
and writer, since the machine with the card has no PyYAML.

`parallel.*` steers the dp x tp rank layout over torch.distributed
(parallel/dist.py resolve and with_layout; parallel/tensor.py for
tensor_parallel): the port's counterpart of the JAX mesh's dp and tp
axes.
`optim.steps_per_dispatch` is the dispatch window of the JAX package
(0: 4 optimizer steps with a cache on the card, else 1): on the card the
Coach replays each of a window's steps as a CUDA graph and reads the
window's losses once (training/coach.py); 1 runs every step eagerly.
`log.checkpoint_backend:
orbax` asks for a resumable train state, which the port writes in its own
format (train_state.py). `optim.fuse_conv: null` means: fuse the frozen VAE
encode when the run is on the card.
"""
from __future__ import annotations

import dataclasses
import sys
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from view_neti_tpu_torch.constants import VALIDATION_PROMPTS
from view_neti_tpu_torch.utils import yaml_subset
from view_neti_tpu_torch.utils.types import PESigmas

# Reusable pretrained view-mapper registry: keys map to checkpoint paths.
lookup_pretrained_models: Dict[str, str] = {}

# experiment-key shorthands (reference training/config.py:142-178)
_SIGMA_DTU12_BY_KEY = {0: None, 1: 1.0, 2: 0.5, 3: 0.25, 4: 0.75, 5: 0.1}
_SIGMA_T_BY_KEY = {0: 0.03, 1: 0.06, 2: 0.2, 3: 0.5}
_SIGMA_L_BY_KEY = {0: 2.0, 1: 4.0}


@dataclass
class LogConfig:
    """Logging and saving (view_neti_tpu/config.py LogConfig)."""
    exp_name: str = ""
    overwrite_ok: bool = False
    exp_dir: Path = Path("./outputs")
    save_steps: int = 1000
    logging_dir: Path = Path("logs")
    report_to: str = "tensorboard"
    checkpoints_total_limit: Optional[int] = None
    save_dataset_images: bool = True
    checkpoint_backend: str = "msgpack"
    resume_from: Optional[str] = None


@dataclass
class DataConfig:
    """The data pipeline (view_neti_tpu/config.py DataConfig)."""
    train_data_dir: Path = None
    train_data_subsets: Optional[List[Path]] = None
    placeholder_object_token: str = "<>"
    super_category_object_token: Optional[str] = "object"
    super_category_view_token: Optional[str] = "view"
    placeholder_object_tokens: Optional[List[str]] = None
    super_category_object_tokens: Optional[List[str]] = None
    fixed_object_token_or_path: Optional[str] = None
    dataloader_num_workers: int = 8
    repeats: int = 100
    resolution: int = 512
    # DTU preprocessing: 0 = pad to square, resize 512; 1 = 512x384;
    # 2 = 768x576
    dtu_preprocess_key: int = 1
    center_crop: bool = False
    flip_p: float = 0.5
    caption_strategy: int = 0
    camera_representation: str = "spherical"
    dtu_lighting: str = "3"
    dtu_subset: int = -2
    augmentation_key: int = 0
    placeholder_view_tokens: Optional[List[str]] = None
    tokenizer_path: Optional[Path] = None
    # run the stochastic augmentation on the card inside the train step
    # (ops/device_augment.py)
    device_augment: bool = True


@dataclass
class ModelConfig:
    """Mapper and model fields (view_neti_tpu/config.py ModelConfig)."""
    pretrained_model_name_or_path: str = "CompVis/stable-diffusion-v1-4"
    pretrained_view_mapper: Optional[Path] = None
    pretrained_view_mapper_key: Optional[int] = None
    word_embedding_dim: int = 768
    arch_mlp_hidden_dims: int = 128
    use_nested_dropout: bool = True
    nested_dropout_prob: float = 0.5
    normalize_object_mapper_output: bool = True
    normalize_view_mapper_output: bool = False
    target_norm_object: Optional[float] = None
    target_norm_view: Optional[float] = None
    use_positional_encoding_object: int = 1
    use_positional_encoding_view: int = 1
    pe_sigmas: Dict[str, float] = field(
        default_factory=lambda: {
            'sigma_t': 0.03,
            'sigma_l': 2.0,
            'sigma_theta': 1.0,
            'sigma_phi': 1.0,
            'sigma_r': 1.0,
            'sigma_dtu12': 2.0,
        })
    pe_sigma_exp_key: int = 0
    pe_t_exp_key: int = 0
    pe_l_exp_key: int = 0
    pe_sigmas_view: Dict[str, float] = field(
        default_factory=lambda: {'sigma_phi': 1.0})
    num_pe_time_anchors: int = 10
    output_bypass_object: bool = True
    output_bypass_view: bool = True
    revision: Optional[str] = None
    mapper_checkpoint_path: Optional[Path] = None
    arch_view_net: int = 0
    arch_view_mix_streams: int = 0
    arch_view_disable_tl: bool = True
    original_ti: bool = False
    bypass_unconstrained_object: bool = False
    bypass_unconstrained_view: bool = False
    output_bypass_alpha_view: float = 0.2
    output_bypass_alpha_object: float = 0.2

    def __post_init__(self):
        # Resolve the experiment-key shorthands into concrete sigmas
        # (view_neti_tpu/config.py:133-167).
        if isinstance(self.pe_sigmas, dict):
            s = self.pe_sigmas
            # the reference keys theta and r off sigma_phi on purpose
            self.pe_sigmas = PESigmas(
                sigma_t=s['sigma_t'], sigma_l=s['sigma_l'],
                sigma_theta=s.get('sigma_phi', 1.0),
                sigma_phi=s.get('sigma_phi', 1.0),
                sigma_r=s.get('sigma_phi', 1.0),
                sigma_dtu12=s.get('sigma_dtu12', 2.0))
        if not isinstance(self.pe_sigmas, PESigmas):
            return
        if self.pe_sigma_exp_key not in _SIGMA_DTU12_BY_KEY:
            raise ValueError(
                f"unknown pe_sigma_exp_key {self.pe_sigma_exp_key}")
        if self.pe_t_exp_key not in _SIGMA_T_BY_KEY:
            raise ValueError(f"unknown pe_t_exp_key {self.pe_t_exp_key}")
        if self.pe_l_exp_key not in _SIGMA_L_BY_KEY:
            raise ValueError(f"unknown pe_l_exp_key {self.pe_l_exp_key}")
        updates = {"sigma_t": _SIGMA_T_BY_KEY[self.pe_t_exp_key],
                   "sigma_l": _SIGMA_L_BY_KEY[self.pe_l_exp_key]}
        dtu12 = _SIGMA_DTU12_BY_KEY[self.pe_sigma_exp_key]
        if dtu12 is not None:
            updates["sigma_dtu12"] = dtu12
        self.pe_sigmas = dataclasses.replace(self.pe_sigmas, **updates)


@dataclass
class EvalConfig:
    """Validation (view_neti_tpu/config.py EvalConfig): the Coach's rounds
    every validation_steps (training/validate.py) and offline inference
    (inference/offline.py) read it."""
    validation_prompts: List[str] = field(
        default_factory=lambda: list(VALIDATION_PROMPTS))
    validation_view_tokens: Optional[List[str]] = None
    num_validation_images: int = 3
    validation_seeds: Optional[List[int]] = field(
        default_factory=lambda: [0, 1, 2])
    validation_steps: int = 250
    num_denoising_steps: int = 30
    dtu_upsample_key: int = 1
    eval_placeholder_object_tokens: Optional[List[str]] = None
    do_t2i_generalization: bool = False
    max_validation_failures: int = 3

    def __post_init__(self):
        if self.validation_seeds is None:
            self.validation_seeds = list(range(self.num_validation_images))
        assert len(self.validation_seeds) == self.num_validation_images, \
            "Length of validation_seeds should equal num_validation_images"


@dataclass
class OptimConfig:
    """Optimization (view_neti_tpu/config.py OptimConfig).

    fuse_accumulation runs the accumulation window as one fused batch of
    train_batch_size x gradient_accumulation_steps; False accumulates the
    gradients of k micro-batches and steps once (optax.MultiSteps in the
    JAX package). mixed_precision "fp16" runs bf16, as in the JAX package
    (the kernels are bf16)."""
    max_train_steps: Optional[int] = 1_000
    learning_rate: float = 1e-3
    scale_lr: bool = True
    train_batch_size: int = 3
    gradient_checkpointing: bool = False
    gradient_accumulation_steps: int = 3
    seed: Optional[int] = None
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-08
    mixed_precision: str = "no"
    allow_tf32: bool = False
    fuse_accumulation: bool = True
    steps_per_dispatch: int = 0
    fuse_conv: Optional[bool] = None


@dataclass
class ParallelConfig:
    """The rank layout, the JAX package's device mesh (its fields and
    defaults), read by parallel/dist.py resolve under a multi-rank launch:
    use_mesh false refuses several ranks (None and true accept them); tp
    must divide the world size; dp 0 is world / tp, else it must equal it;
    tensor_parallel splits the frozen UNet's and CLIP's projections over
    each group of tp ranks (parallel/tensor.py), and without it the tp
    ranks are replicas. One process ignores them, as a single device does
    in the JAX Coach."""
    use_mesh: Optional[bool] = None
    dp: int = 0
    tp: int = 1
    tensor_parallel: bool = False


@dataclass
class RunConfig:
    """Top-level trainer configuration. learnable_mode:
      0: object only               "A photo of a <object>"
      1: view only                 "<view_x>. A photo of a {object}"
      2: view + object jointly     "<view_x>. A photo of a <object>"
      3: shared view + per-scene objects (multi-scene pretraining)
      4: pretrained view (learnable) + new object
      5: pretrained view (frozen)  + new object
    """
    learnable_mode: int = 0
    debug: bool = False
    seed: int = 0
    log: LogConfig = field(default_factory=LogConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        if self.optim.train_batch_size > 3:
            raise ValueError(
                "batch size should be 3 and so should grad accumulation")
        if self.learnable_mode == 3:
            assert self.data.super_category_object_tokens is not None
            if self.eval.eval_placeholder_object_tokens is not None:
                assert all(
                    d in self.data.placeholder_object_tokens
                    for d in self.eval.eval_placeholder_object_tokens
                ), ("eval.eval_placeholder_tokens not in "
                    "data.placeholder_object_tokens")
        if self.data.placeholder_object_tokens is not None:
            assert len(self.data.placeholder_object_tokens) == len(
                set(self.data.placeholder_object_tokens)), \
                "cfg.data.placeholder_object_tokens must be unique strings"
        if self.learnable_mode in (4, 5):
            assert (self.model.pretrained_view_mapper
                    or self.model.pretrained_view_mapper_key)
            if self.model.pretrained_view_mapper_key:
                self.model.pretrained_view_mapper = Path(
                    lookup_pretrained_models[str(
                        self.model.pretrained_view_mapper_key)])


@dataclass
class InferenceConfig:
    """Offline inference (view_neti_tpu/config.py InferenceConfig); read
    from input_configs/inference.yaml by the inference CLI
    (inference/offline.py)."""
    iteration: Optional[int] = None
    input_dir: Optional[Path] = None
    inference_dir: Optional[Path] = None
    seeds: List[int] = field(default_factory=lambda: [42])
    eval_placeholder_object_tokens: List[str] = field(default_factory=list)
    torch_dtype: str = "fp16"
    num_denoising_steps: int = 30
    debug: int = 0
    calibration_dir: Optional[str] = None
    masks_root: Optional[str] = None
    lpips_weights: Optional[str] = None

    def __post_init__(self):
        if self.inference_dir is None and self.input_dir is not None:
            self.inference_dir = Path(self.input_dir) / "inference"


# ---------------------------------------------------------------------------
# decoding and encoding (the pyrallis subset the reference uses)
# ---------------------------------------------------------------------------

def _unwrap_optional(tp):
    if typing.get_origin(tp) is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return (args[0] if len(args) == 1 else tp), True
    return tp, False


def _decode_value(tp, value):
    if value is None:
        return None
    tp, _ = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if is_dataclass(tp):
        return decode(tp, value)
    if origin in (list, List):
        (elem_tp,) = typing.get_args(tp) or (Any,)
        return [_decode_value(elem_tp, v) for v in value]
    if origin in (dict, Dict):
        args = typing.get_args(tp)
        if args:
            return {k: _decode_value(args[1], v) for k, v in value.items()}
        return dict(value)
    if tp is Path:
        return Path(value)
    if tp is bool:
        if isinstance(value, str):
            return value.lower() in ('1', 'true', 'yes', 'on')
        return bool(value)
    if tp is int:
        return int(value)
    if tp is float:
        return float(value)
    if tp is str:
        return str(value)
    return value


def decode(cls, data: Optional[Dict[str, Any]]):
    """Build dataclass `cls` from a (possibly nested) plain dict; unknown
    keys raise."""
    data = data or {}
    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {unknown}")
    return cls(**{name: _decode_value(hints[name], data[name])
                  for name in names if name in data})


def encode(obj) -> Any:
    """Dataclass tree -> plain dict of YAML scalars (pyrallis.encode)."""
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: encode(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    return obj


def _parse_scalar(s: str):
    # YAML 1.1 reads yes/no/on/off as booleans, but "no" is a value of
    # optim.mixed_precision: keep those as strings (bool fields still
    # coerce them in _decode_value)
    if s.lower() in ("yes", "no", "on", "off"):
        return s
    try:
        return yaml_subset.loads(s)
    except yaml_subset.YAMLSubsetError:
        return s


def _set_dotted(d: Dict[str, Any], dotted: str, value: Any):
    keys = dotted.split('.')
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value


def _deep_update(base: Dict[str, Any], extra: Dict[str, Any]):
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def read_yaml(path: Union[str, Path]) -> Any:
    return yaml_subset.loads(Path(path).read_text())


def parse_cli(argv: Optional[List[str]] = None, cls=RunConfig):
    """pyrallis-style CLI: --config_path file.yaml --section.key value
    (or --section.key=value)."""
    if argv is None:
        argv = sys.argv[1:]
    data: Dict[str, Any] = {}
    config_path = None
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith('--'):
            raise ValueError(f"unexpected argument {arg!r}")
        key = arg[2:]
        if '=' in key:
            key, raw = key.split('=', 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            raw = argv[i + 1]
            i += 2
        if key == 'config_path':
            config_path = Path(raw)
        else:
            _set_dotted(data, key, _parse_scalar(raw))
    base: Dict[str, Any] = {}
    if config_path is not None:
        base = read_yaml(config_path) or {}
    _deep_update(base, data)
    return decode(cls, base)


def load_config(path: Union[str, Path]) -> RunConfig:
    return decode(RunConfig, read_yaml(path) or {})


def dump_config(cfg, path: Union[str, Path]) -> None:
    Path(path).write_text(yaml_subset.dumps(encode(cfg)))
