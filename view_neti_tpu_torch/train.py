"""The training entry point (scripts/train.py of the JAX package):

    python -m view_neti_tpu_torch.train --config_path input_configs/train.yaml \
        [--section.key value ...]

It reads the config (YAML and dot-overrides), seeds the host, prepares the
experiment directory (a non-empty one only with log.overwrite_ok or
log.resume_from) and runs the Coach on the card, validating every
eval.validation_steps. input_configs/train_m3.yaml runs mode 3; add
--log.checkpoint_backend orbax for resumable train states and
--log.resume_from latest to go on from the newest. The environment names
the files the repository does not hold: DTU_CALIBRATION_DIR the DTU
calibration directory, SD_WEIGHTS_DIR a diffusers-layout SD directory (else
the frozen stack is seeded random weights), DTU_MASKS_DIR the IDR object
masks, LPIPS_WEIGHTS an .npz of LPIPS weights (else validation reports
LPIPS as 0). VIEW_NETI_TINY=1 swaps in the miniature stack
(builder.tiny_arch(), 16-pixel resolution, the 64x48 DTU preprocess) for
smoke runs; it does not choose the CPU: `main(argv, device="cpu")` does.

Data parallel, one process per rank (parallel/dist.py):

    torchrun --standalone --nproc_per_node N -m view_neti_tpu_torch.train \
        --config_path input_configs/train.yaml

(or the JAX package's VIEW_NETI_COORDINATOR / VIEW_NETI_NUM_PROCESSES /
VIEW_NETI_PROCESS_ID) computes what one process computes, up to the order
of the gradient sum; N must divide the fused batch (9 in the shipped
recipes: 1, 3 or 9 ranks). Ranks with a card each talk over NCCL, ranks
sharing one card over gloo. The mesh's tp axis:

    torchrun --standalone --nproc_per_node 2 -m view_neti_tpu_torch.train \
        --config_path input_configs/train.yaml \
        --parallel.tp 2 --parallel.tensor_parallel true

runs dp = N / tp groups of tp ranks; the ranks of a group hold the same
rows and split the frozen UNet's attention and feed-forward projections
and CLIP's MLP between them (parallel/tensor.py). dp must divide the fused
batch.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

from view_neti_tpu_torch.config import parse_cli
from view_neti_tpu_torch.parallel import dist
from view_neti_tpu_torch.utils.misc import fixseed


def prepare_directories(cfg) -> None:
    """Create the experiment directory; refuse to overwrite a non-empty one
    without log.overwrite_ok."""
    exp_dir = Path(cfg.log.exp_dir)
    if cfg.log.exp_name:
        exp_dir = exp_dir / cfg.log.exp_name
        cfg.log.exp_dir = exp_dir
    if exp_dir.exists() and any(exp_dir.iterdir()) \
            and not cfg.log.overwrite_ok and not cfg.log.resume_from:
        raise FileExistsError(
            f"{exp_dir} exists; pass --log.overwrite_ok true to overwrite")
    exp_dir.mkdir(parents=True, exist_ok=True)


def main(argv: Optional[List[str]] = None, device=None) -> Dict[str, float]:
    cfg = parse_cli(argv)
    fixseed(cfg.seed)
    dp = dist.init_distributed(device)
    failure = None
    if dp.is_main:
        try:
            prepare_directories(cfg)
        except Exception as e:   # raised below, on every rank
            failure = e
    # rank 0's directory, or its error, which ends every rank
    exp_dir, message = dist.broadcast_from_main(
        dp, (cfg.log.exp_dir, None if failure is None else repr(failure)))
    if message is not None:
        dist.destroy(dp)
        if failure is not None:
            raise failure
        raise RuntimeError(f"rank 0 could not prepare {exp_dir}: {message}")
    cfg.log.exp_dir = exp_dir
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.validate import ValidationHandler
    calibration_dir = os.environ.get("DTU_CALIBRATION_DIR")
    arch = None
    if os.environ.get("VIEW_NETI_TINY"):
        arch = builder.tiny_arch()
        cfg.model.word_embedding_dim = arch.text.hidden_size
        cfg.data.resolution = 16
        cfg.data.dtu_preprocess_key = -1
    coach = Coach(cfg, arch=arch, calibration_dir=calibration_dir,
                  weights_dir=os.environ.get("SD_WEIGHTS_DIR"), dist=dp)
    lpips_fn = None
    if os.environ.get("LPIPS_WEIGHTS"):
        from view_neti_tpu_torch.ops.metrics import make_lpips
        lpips_fn = make_lpips(os.environ["LPIPS_WEIGHTS"],
                              device=coach.device)
    coach.validator = ValidationHandler(
        cfg, masks_root=os.environ.get("DTU_MASKS_DIR"),
        calibration_dir=calibration_dir, lpips_fn=lpips_fn)
    result = coach.train()
    dist.destroy(dp)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
