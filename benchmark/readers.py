"""What the metric readers (metrics/<name>.py) share.

Each reader is a module with `UNIT` and `read(run)`, where `run` holds the
driver's record of the run (`run.record`), the reduced trace of a traced
run (`run.trace`, a trace.TraceData, or None) and the cell's work per unit
(`run.work`, flops.unit_work's record). `read` returns a number, or None
when it finds nothing to read; the harness then leaves the metric out.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from benchmark import flops


def window_s(run) -> float:
    return run.record.t1 - run.record.t0


def roofline(run, kernels: Dict[str, List[str]], bound: Dict
             ) -> Optional[float]:
    """Σ bound / Σ device time of the kernels named, in percent: None
    when the trace holds fewer launches of a kernel than the calls of the
    traced units need (a kernel renamed or taken off the path)."""
    data = run.trace
    if data is None or not data.units:
        return None
    time_s = 0.0
    for k, patterns in kernels.items():
        ops = data.matching(patterns)
        need = bound["launches"].get(k, 0) * data.units
        if len(ops) < need or (need and not ops):
            return None
        time_s += sum(e - s for _, s, e in ops) / 1e6
    if time_s <= 0:
        return None
    return 100.0 * bound["bound_s"] * data.units / time_s


def attention_roofline(run) -> Optional[float]:
    return roofline(run, {"K1": ["flash_fwd_kernel"],
                          "K2": ["flash_bwd_dq_kernel"],
                          "K3": ["flash_bwd_dkv"]},
                    flops.attention_bound(run.work))


def conv_roofline(run) -> Optional[float]:
    return roofline(run, {"K4": ["fused_conv_kernel"]},
                    flops.conv_bound(run.work))


def mfu(run) -> Optional[float]:
    data = run.trace
    if data is None or not data.units or data.window_s <= 0:
        return None
    return (100.0 * run.work["flops"] * data.units / data.window_s
            / flops.PEAK_FLOPS)


def idle_share(run) -> Optional[float]:
    data = run.trace
    if data is None or data.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s() / data.window_s)


def span_ms(run, name: str) -> Optional[float]:
    data = run.trace
    if data is None:
        return None
    a, b = data.window
    d = [e - s for n, s, e in data.spans if n == name and a <= s < b]
    return sum(d) / len(d) / 1e3 if d else None


def busy_in_span_ms(run, name: str, per: int) -> Optional[float]:
    data = run.trace
    if data is None or not data.units:
        return None
    ops = data.ops_in_spans(name)
    if not ops:
        return None
    return 1e3 * data.busy_s(ops) / (data.units * per)
