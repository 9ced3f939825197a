"""Step timing for the train loop (view_neti_tpu/utils/profiling.py:34-74).

`StepTimer` is a cheap steady-state step-time estimate: an EMA of the
intervals between ticks that skips the first ticks and rejects stalls (a
save, a cache fill) of more than 5x the EMA, counting them.
"""
from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Blocking-free steady-state throughput estimate (EMA of step time)."""

    def __init__(self, alpha: float = 0.1, skip: int = 2):
        self.alpha = alpha
        self.skip = skip
        self._n = 0
        self._rejects = 0
        # every outlier tick left out of the EMA, so that a run whose
        # steady rate hides stalls can be told from a clean one
        self.rejected_total = 0
        self._last = None
        self.ema_s: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._n += 1
            if self._n > self.skip:
                if (self.ema_s is not None and dt > 5 * self.ema_s
                        and self._rejects < 3):
                    # a stall must not enter the steady estimate; after 3
                    # slow ticks in a row the regime has changed, and the
                    # EMA follows
                    self._rejects += 1
                    self.rejected_total += 1
                    self._last = now
                    return self.ema_s
                self._rejects = 0
                self.ema_s = (dt if self.ema_s is None
                              else (1 - self.alpha) * self.ema_s
                              + self.alpha * dt)
        self._last = now
        return self.ema_s

    def imgs_per_sec(self, batch_size: int) -> Optional[float]:
        return batch_size / self.ema_s if self.ema_s else None
