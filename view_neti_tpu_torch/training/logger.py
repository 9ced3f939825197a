"""CoachLogger: stdout and file logging, the config dump and the metric
trackers (view_neti_tpu/training/logger.py:17-114).

Messages go to stdout and to <exp_dir>/logs/log.txt; the run's config is
written to <exp_dir>/config.yaml. Metrics go to tensorboard through
torch.utils.tensorboard where it imports, and to wandb where that package
exists, as log.report_to asks. Under data parallelism only rank 0 logs: the
other ranks' loggers (enabled=False) print nothing and open no file.
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from view_neti_tpu_torch import config as config_lib


class CoachLogger:
    def __init__(self, cfg, name: str = "view_neti_tpu_torch",
                 enabled: bool = True):
        self.cfg = cfg
        self.exp_dir = Path(cfg.log.exp_dir)
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
        self.step = 0
        self._writer = None
        self._wandb = None
        if not enabled:
            self.logger.addHandler(logging.NullHandler())
            return
        log_dir = self.exp_dir / "logs"
        log_dir.mkdir(parents=True, exist_ok=True)
        fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
        for h in (logging.StreamHandler(sys.stdout),
                  logging.FileHandler(log_dir / "log.txt")):
            h.setFormatter(fmt)
            self.logger.addHandler(h)
        config_lib.dump_config(cfg, self.exp_dir / "config.yaml")
        if cfg.log.report_to in ("tensorboard", "all"):
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(
                    log_dir=str(self.exp_dir / cfg.log.logging_dir))
            except Exception as e:  # tensorboard is optional
                self.log_message(f"tensorboard unavailable: {e}")
        if cfg.log.report_to in ("wandb", "all"):
            try:
                import wandb
                self._wandb = wandb.init(
                    project="view_neti_tpu", name=cfg.log.exp_name or None,
                    dir=str(self.exp_dir), config=config_lib.encode(cfg))
            except ImportError:
                self.log_message(
                    "wandb requested (log.report_to="
                    f"{cfg.log.report_to!r}) but not installed; skipping")
            except Exception as e:
                self.log_message(f"wandb init failed: {e}")

    def log_message(self, msg: str) -> None:
        self.logger.info(msg)

    def update_step(self, step: int) -> None:
        self.step = step

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[int] = None) -> None:
        step = step if step is not None else self.step
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()},
                            step=step)

    def log_images(self, tag: str, images, step: Optional[int] = None
                   ) -> None:
        """Validation sheets, (H, W, C) float in [0, 1] or uint8, to the
        trackers."""
        step = step if step is not None else self.step
        if self._writer is not None:
            for i, img in enumerate(images):
                self._writer.add_image(f"{tag}/{i}", np.asarray(img), step,
                                       dataformats="HWC")
        if self._wandb is not None:
            import wandb
            self._wandb.log(
                {tag: [wandb.Image(np.asarray(im)) for im in images]},
                step=step)

    def log_start_of_training(self, total_batch_size: int,
                              num_samples: int) -> None:
        optim = self.cfg.optim
        self.log_message("***** Running training *****")
        self.log_message(f"  Num examples = {num_samples}")
        self.log_message(f"  Instantaneous batch size per device = "
                         f"{optim.train_batch_size}")
        self.log_message(f"  Total batch size (w. accumulation) = "
                         f"{total_batch_size}")
        self.log_message(f"  Gradient accumulation steps = "
                         f"{optim.gradient_accumulation_steps}")
        self.log_message(f"  Total optimization steps = "
                         f"{optim.max_train_steps}")

    def close(self):
        if self._writer is not None:
            self._writer.close()
        if self._wandb is not None:
            self._wandb.finish()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
