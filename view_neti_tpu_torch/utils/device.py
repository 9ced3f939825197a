"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   local_rank: Optional[int] = None,
                   shared_card: bool = False) -> torch.device:
    """The device an entry point runs on. None means the card: it raises when
    no CUDA device is present rather than carrying on on the CPU. Callers
    that want the CPU (the tests) pass device="cpu".

    Under data parallelism (parallel/dist.py passes the rank's local_rank)
    None means the rank's own card, cuda:<local_rank>, or cuda:0 when the
    host's ranks share one card (shared_card); it is made the current CUDA
    device, so that the rank's kernels and collectives go to it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "view_neti_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        if local_rank is None:
            return torch.device("cuda")
        card = torch.device("cuda", 0 if shared_card else local_rank)
        torch.cuda.set_device(card)
        return card
    return torch.device(device)
