"""The traced run: torch.profiler over the window, reduced to what the
per-layer metrics read.

`Trace.start()` opens a profiler (CPU and CUDA activity) and a
record_function range "bench.window"; `Trace.stop()` closes both. `reduce`
turns the profile into a `TraceData`: every device operation (kernels,
copies, sets) as (name, start, end) in microseconds, the benchmark's host
spans (record_function ranges named "bench.*") on the same clock, and the
window's span. The metric readers (metrics/*.py) take it from there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


class Trace:
    def __init__(self):
        self.prof = None
        self._range = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = torch.profiler.record_function("bench.window")
        self._range.__enter__()

    def stop(self):
        self._range.__exit__(None, None, None)
        self.prof.stop()


@dataclass
class TraceData:
    ops: List[Tuple[str, float, float]]          # device operations, us
    spans: List[Tuple[str, float, float]]        # host "bench.*" ranges, us
    window: Tuple[float, float]                  # the window's span, us
    units: int = 0                               # steps or views traced
    extra: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self):
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.ops
                if e > a and s < b]

    def busy_s(self, ops=None) -> float:
        """The union of the operations' intervals, in seconds."""
        ops = sorted((s, e) for _, s, e in (ops if ops is not None
                                            else self.in_window()))
        total, cur_s, cur_e = 0.0, None, None
        for s, e in ops:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def ops_in_spans(self, name: str):
        """The device operations that start inside a host span of that
        name (its spans end at a synchronize in the traced run)."""
        spans = [(s, e) for n, s, e in self.spans if n == name]
        return [o for o in self.ops
                if any(s <= o[1] < e for s, e in spans)]

    def matching(self, patterns) -> List[Tuple[str, float, float]]:
        low = [p.lower() for p in patterns]
        return [o for o in self.in_window()
                if any(p in o[0].lower() for p in low)]


def reduce(prof) -> Optional[TraceData]:
    """The profile's device operations and benchmark spans, or None when
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    ops, spans, window = [], [], None
    for e in prof.events():
        name = e.name
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if name.startswith("bench."):
                continue          # a range's mark on the device timeline
            ops.append((name, s, t))
        elif name == "bench.window":
            window = (s, t)
        elif name.startswith("bench."):
            spans.append((name, s, t))
    if not ops or window is None:
        return None
    return TraceData(ops=ops, spans=spans, window=window)


# the kernel groups of the breakdown (chip_smoke.py's, by name)
GROUPS = (("K1 flash_attention_fwd", ("flash_fwd_kernel",)),
          ("K2 flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("K3 flash_attention_bwd_dkv", ("flash_bwd_dkv",)),
          ("K4 fused_conv", ("fused_conv_kernel",)),
          ("cudnn conv", ("fprop", "dgrad", "conv", "nhwc", "nchw",
                          "cudnn")),
          ("cublas matmul", ("gemm", "nvjet", "cutlass", "xmma")),
          ("memcpy/memset", ("memcpy", "memset")),
          ("reduction/norm", ("reduce", "norm")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def breakdown(data: TraceData) -> Dict:
    """The ten device groups that took most time, and the ten longest idle
    gaps of the window, each named by the benchmark span open on the host
    when it began ("program" when none of the benchmark's was)."""
    by_group: Dict[str, float] = {}
    for n, s, e in data.in_window():
        g = group_of(n)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e6
    ops = sorted((s, e) for _, s, e in data.in_window())
    gaps, cur = [], data.window[0]
    for s, e in ops:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if data.window[1] > cur:
        gaps.append((cur, data.window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])

    def host(at):
        open_ = [(s, n) for n, s, e in data.spans if s <= at < e]
        return max(open_)[1] if open_ else "program"

    return {"device_ops": sorted(([g, v] for g, v in by_group.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[host(a), (b - a) / 1e6] for a, b in gaps[:10]]}
