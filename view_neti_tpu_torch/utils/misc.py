"""Small host-side helpers (view_neti_tpu/utils/misc.py:15-27)."""
from __future__ import annotations

import random
from pathlib import Path
from typing import Iterable, List

import numpy as np
import torch


def fixseed(seed: int) -> None:
    """Seed the host's random number generators: Python's, numpy's and
    torch's (on every device). The train step's own draws come from
    generators seeded per step, not from these."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def filter_paths_imgs(paths: Iterable[Path]) -> List[Path]:
    """Keep only .png / .jpg files."""
    return [p for p in paths if Path(p).suffix in ('.png', '.jpg')]
