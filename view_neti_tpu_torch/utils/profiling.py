"""Tracing and step timing for the train loop
(view_neti_tpu/utils/profiling.py).

`trace(logdir)` profiles the code it encloses with torch.profiler: the
host's ops, and the card's kernels and copies when the process uses a card.
The Coach opens it around its train loop when VIEW_NETI_TRACE_DIR is set.
On exit it writes one Chrome trace per process,

    <logdir>/<host>_<pid>[_rank<r>].<ns>.pt.trace.json

with the process group's rank in the name under torch.distributed, so that
ranks never write the same file. Open it in Perfetto or chrome://tracing,
or with TensorBoard's PyTorch profiler plugin (`tensorboard --logdir
<logdir>`). The JAX package writes XProf's plugins/profile/*/*.xplane.pb
there instead. torch.profiler does not nest: `trace` raises where a
profiler is already open. `annotate(name)` marks a host-side region, which
shows on the trace's timeline under that name.

`StepTimer` is a cheap steady-state step-time estimate: an EMA of the
intervals between ticks that skips the first ticks and rejects stalls (a
save, a cache fill) of more than 5x the EMA, counting them.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


def _worker_name() -> str:
    name = f"{socket.gethostname()}_{os.getpid()}"
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        name += f"_rank{torch.distributed.get_rank()}"
    return name


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed code into a trace file under `logdir` (nothing
    when logdir is falsy). The trace is written when the block ends, also
    when it raises."""
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if torch.autograd.profiler._is_profiler_enabled:
        raise RuntimeError(
            f"cannot trace into {logdir}: a torch.profiler is already open "
            f"in this process, and profilers do not nest (unset "
            f"VIEW_NETI_TRACE_DIR inside a profiled region)")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     str(logdir), worker_name=_worker_name())):
        yield


def annotate(name: str):
    """A named host-side region on the trace's timeline."""
    return torch.profiler.record_function(name)


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
