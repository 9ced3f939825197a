"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on. None means the card: it raises when
    no CUDA device is present rather than carrying on on the CPU. Callers
    that want the CPU (the tests) pass device="cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "view_neti_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
