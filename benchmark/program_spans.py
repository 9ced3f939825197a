"""The program's own spans on the traced run's clock, for the metric
readers that read them.

The program records spans at its layer boundaries
(view_neti_tpu_torch/utils/profiling.py: `span`, `spans()`) on
time.perf_counter_ns(); the profile's events are in microseconds on the
profiler's clock. Both drivers take `record.t0` on perf_counter right after
Trace.start() opened the "bench.window" range, and `record.t1` right before
Trace.stop() closed it: the offset between the clocks is at least the
window's start less t0 and at most its end less t1. The start's bound is
low by the most where the window's range is the process's first
record_function (about a millisecond on a loaded host). The drivers' own
ranges tighten both: a program span of INSIDE starts a little after the
benchmark range the driver opens around the call, one of AROUND a little
before the range the driver opens inside it. The offset is the middle of
the two bounds; where they lie more than BRIDGE_TOL_US apart, nothing is
mapped. A program without the recorder gives no spans, and the readers
then return None.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple

BRIDGE_TOL_US = 1000.0
# (benchmark range, program span): the program's span runs inside it
INSIDE = (("bench.train_step", "graph.replay"),
          ("bench.prompt", "prompt.embed"),
          ("bench.denoise", "graph.replay"),
          ("bench.decode", "graph.replay"))
# (benchmark range, program span): the program's span runs around it
AROUND = (("bench.train_step", "coach.step"),
          ("bench.denoise", "render.denoise"),
          ("bench.decode", "render.decode"))


class Span(NamedTuple):
    """A program span on the trace's clock (us)."""
    name: str
    label: Optional[str]
    start: float
    end: float
    depth: int


def recorded() -> list:
    """The program's recorded spans (profiling.SpanRecord), or [] when the
    program has no recorder."""
    try:
        from view_neti_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def offset_us(run) -> Optional[float]:
    """trace clock (us) - perf_counter (us), or None without a trace or
    when its bounds lie too far apart (module docstring)."""
    data, rec = run.trace, run.record
    t0, t1 = getattr(rec, "t0", None), getattr(rec, "t1", None)
    if data is None or t0 is None or t1 is None:
        return None
    first = low = data.window[0] - t0 * 1e6
    high = data.window[1] - t1 * 1e6
    records = recorded()
    for pairs, inside in ((INSIDE, True), (AROUND, False)):
        for outer, name in pairs:
            starts = [r.start_ns / 1e3 for r in records if r.name == name]
            for _, b, _ in (x for x in data.spans if x[0] == outer):
                # its own span: the one that starts nearest b at the
                # start's offset (the next starts a step or a view away)
                p = min(starts, key=lambda p: abs(p + first - b),
                        default=None)
                if p is None or abs(p + first - b) > 2 * BRIDGE_TOL_US:
                    continue
                if inside:
                    low = max(low, b - p)
                else:
                    high = min(high, b - p)
    if abs(high - low) > BRIDGE_TOL_US:
        return None
    return (low + high) / 2


def mapped(run, names: Iterable[str]) -> List[Span]:
    """The program's spans of these names on the trace's clock; [] when
    there are none or the bridge fails."""
    off = offset_us(run)
    names = set(names)
    if off is None:
        return []
    return [Span(r.name, r.label, r.start_ns / 1e3 + off,
                 r.end_ns / 1e3 + off, r.depth)
            for r in recorded() if r.name in names]


def in_window(run, name: str) -> List[Span]:
    """The spans of that name that start inside the traced window."""
    a, b = run.trace.window if run.trace is not None else (0.0, 0.0)
    return [s for s in mapped(run, (name,)) if a <= s.start < b]


def open_at(spans: List[Span], at: float) -> Optional[Span]:
    """The innermost of `spans` open at the instant `at`."""
    inside = [s for s in spans if s.start <= at < s.end]
    return max(inside, key=lambda s: (s.depth, s.start)) if inside else None


def gaps(data) -> List[Tuple[float, float]]:
    """The device's idle intervals in the traced window, as
    trace.breakdown finds them: between the union of the operations'
    intervals, and before the first and after the last."""
    ops = sorted((s, e) for _, s, e in data.in_window())
    out, cur = [], data.window[0]
    for s, e in ops:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if data.window[1] > cur:
        out.append((cur, data.window[1]))
    return out


def idle_ms_per_unit(run, inside: List[Span],
                     outside: List[Span] = ()) -> Optional[float]:
    """Device-idle ms a traced unit in the gaps that begin while one of
    `inside` is open and none of `outside` is; None without `inside`."""
    data = run.trace
    if data is None or not data.units or not inside:
        return None

    def open_(spans, at):
        return any(s.start <= at < s.end for s in spans)

    idle = sum(b - a for a, b in gaps(data)
               if open_(inside, a) and not open_(outside, a))
    return idle / 1e3 / data.units


def setup_s(run, names: Iterable[str]) -> Optional[float]:
    """Σ seconds of the spans of these names that end before the window
    opens; None when there are none."""
    if run.trace is None:
        return None
    done = [s.end - s.start for s in mapped(run, names)
            if s.end <= run.trace.window[0]]
    return sum(done) / 1e6 if done else None
