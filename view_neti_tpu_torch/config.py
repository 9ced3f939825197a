"""Run configuration for the serving stack, without YAML.

The port's counterpart of view_neti_tpu/config.py, cut to the fields that
conditioning, the mappers and the model builder read. Field names and
defaults are those of the JAX package (and of the reference's pyrallis
surface), so a config written for one reads the same in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from view_neti_tpu_torch.utils.types import PESigmas

# experiment-key shorthands (reference training/config.py:142-178)
_SIGMA_DTU12_BY_KEY = {0: None, 1: 1.0, 2: 0.5, 3: 0.25, 4: 0.75, 5: 0.1}
_SIGMA_T_BY_KEY = {0: 0.03, 1: 0.06, 2: 0.2, 3: 0.5}
_SIGMA_L_BY_KEY = {0: 2.0, 1: 4.0}


@dataclass
class DataConfig:
    """The data fields the builder reads (placeholder super-categories)."""
    super_category_object_token: Optional[str] = "object"
    super_category_view_token: Optional[str] = "view"
    super_category_object_tokens: Optional[List[str]] = None


@dataclass
class ModelConfig:
    """Mapper and model fields (view_neti_tpu/config.py ModelConfig)."""
    pretrained_model_name_or_path: str = "CompVis/stable-diffusion-v1-4"
    word_embedding_dim: int = 768
    arch_mlp_hidden_dims: int = 128
    use_nested_dropout: bool = True
    normalize_object_mapper_output: bool = True
    normalize_view_mapper_output: bool = False
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
    num_pe_time_anchors: int = 10
    output_bypass_object: bool = True
    output_bypass_view: bool = True
    arch_view_net: int = 0
    arch_view_disable_tl: bool = True
    original_ti: bool = False
    bypass_unconstrained_object: bool = False
    bypass_unconstrained_view: bool = False
    output_bypass_alpha_view: float = 0.2
    output_bypass_alpha_object: float = 0.2

    def __post_init__(self):
        # Resolve the experiment-key shorthands into concrete sigmas
        # (view_neti_tpu/config.py:134-167).
        if isinstance(self.pe_sigmas, dict):
            s = self.pe_sigmas
            # the reference keys theta and r off sigma_phi on purpose
            self.pe_sigmas = PESigmas(
                sigma_t=s['sigma_t'], sigma_l=s['sigma_l'],
                sigma_theta=s.get('sigma_phi', 1.0),
                sigma_phi=s.get('sigma_phi', 1.0),
                sigma_r=s.get('sigma_phi', 1.0),
                sigma_dtu12=s.get('sigma_dtu12', 2.0))
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
class RunConfig:
    """The top-level fields the serving stack reads. learnable_mode as in
    view_neti_tpu/config.py RunConfig (2 = view + object jointly)."""
    learnable_mode: int = 0
    seed: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
