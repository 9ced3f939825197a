"""Core value types of the port (counterpart of view_neti_tpu/utils/types.py).

Plain dataclasses: PyTorch runs eagerly, so nothing here has to be a pytree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PESigmas:
    """Fourier-feature frequency scales (reference utils/types.py:17-24,
    with the reference's `float`-type defaults replaced by real values)."""
    sigma_t: float = 0.03
    sigma_l: float = 2.0
    sigma_theta: float = 1.0
    sigma_phi: float = 1.0
    sigma_r: float = 1.0
    sigma_dtu12: float = 2.0


@dataclass
class MapperOutput:
    """Mapper forward result.

    word_embedding: (B, D) vector written into the placeholder row of the
      CLIP input embeddings.
    bypass_output: (B, D) or None; merged into the post-encoder hidden state.
    """
    word_embedding: torch.Tensor
    bypass_output: Optional[torch.Tensor]
    bypass_unconstrained: bool = False
    output_bypass_alpha: float = 0.2
