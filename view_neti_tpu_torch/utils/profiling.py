"""Tracing, spans and step timing (view_neti_tpu/utils/profiling.py).

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
profiler is already open.

`span(name, label=None)` marks a region of the program at one of its layer
boundaries (the Coach's loop, the conditioning, the CUDA graphs, set-up):
it records (name, label, start_ns, end_ns, depth, thread) on
time.perf_counter_ns() into a buffer in the process that keeps the newest
MAX_SPANS, always, at 1-2 us a span on the host; `spans()` reads the
buffer and `clear()` empties it. While `trace(logdir)` is open, a span also
opens a record_function range of its name, so that it shows on the trace's
timeline; under any other profiler it does not, since a range that
launches kernels shows on the device's timeline as an annotation over
their whole extent. A span inside a function that a CUDA graph captures
runs at the warm-up and the capture, never at a replay.

`StepTimer` is a cheap steady-state step-time estimate: an EMA of the
intervals between ticks that skips the first ticks and rejects stalls (a
save, a cache fill) of more than 5x the EMA, counting them.
"""
from __future__ import annotations

import collections
import contextlib
import os
import socket
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 16


class SpanRecord(NamedTuple):
    """One finished span: times on time.perf_counter_ns(); depth counts
    the spans open around it on its thread."""
    name: str
    label: Optional[str]
    start_ns: int
    end_ns: int
    depth: int
    thread: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


# the finished spans as plain tuples (SpanRecord's fields), newest last
_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_DEPTH = threading.local()
# True while trace() is open: spans then open record_function ranges
_TRACING = False
_now = time.perf_counter_ns
_thread = threading.get_ident


class span:
    """Record the enclosed region as a span (module docstring); after the
    block, `record` is its SpanRecord."""

    __slots__ = ("name", "label", "_t0", "_depth", "_range", "_done")

    def __init__(self, name: str, label: Optional[str] = None):
        self.name = name
        self.label = label
        self._done = None

    def __enter__(self) -> "span":
        depth = getattr(_DEPTH, "n", 0)
        _DEPTH.n = depth + 1
        self._depth = depth
        self._range = None
        if _TRACING:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now()
        if self._range is not None:
            self._range.__exit__(*exc)
        _DEPTH.n = self._depth
        self._done = (self.name, self.label, self._t0, t1, self._depth,
                      _thread())
        _SPANS.append(self._done)
        return False

    @property
    def record(self) -> Optional[SpanRecord]:
        return SpanRecord(*self._done) if self._done is not None else None


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (the newest MAX_SPANS)."""
    return [SpanRecord(*t) for t in list(_SPANS)]


def within(outer: SpanRecord, name: str) -> List[SpanRecord]:
    """The recorded spans of that name inside `outer`, on its thread."""
    return [s for s in spans()
            if s.name == name and s.thread == outer.thread
            and outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns]


def clear() -> None:
    _SPANS.clear()


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
    global _TRACING
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     str(logdir), worker_name=_worker_name())):
        _TRACING = True
        try:
            yield
        finally:
            _TRACING = False


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
