"""utils/profiling.py's span recorder: nesting, the bounded buffer, the
record_function ranges it opens only under trace(), the bridge that maps
its spans onto a torch.profiler trace's clock (benchmark/program_spans.py),
and, on the card, spans inside a function that a CUDA graph captures.
Beside them, utils/graphs.flatten frees a call's tensors without the
cyclic collector: the spans' objects move the collector's passes, and
tensors held in a cycle until one made the peak memory follow them.

The file imports no JAX: its card test runs where JAX is absent
(`python -m pytest --noconftest tests/test_torch_port_spans.py`).
"""
import gc
import threading
import time
import weakref
from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans
from benchmark.trace import Trace, TraceData
from view_neti_tpu_torch.utils import profiling
from view_neti_tpu_torch.utils.graphs import Graphed


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def test_spans_nest_with_their_depth():
    with profiling.span("outer", "a") as outer:
        with profiling.span("inner") as inner:
            time.sleep(0.001)
        with pytest.raises(ValueError):
            with profiling.span("raises"):
                raise ValueError("planted")
        with profiling.span("after"):
            pass
    got = profiling.spans()
    assert [s.name for s in got] == ["inner", "raises", "after", "outer"]
    assert [s.depth for s in got] == [1, 1, 1, 0]
    assert got[-1] == outer.record and got[0] == inner.record
    assert outer.record.label == "a" and inner.record.label is None
    o, i = outer.record, inner.record
    assert o.start_ns <= i.start_ns < i.end_ns <= o.end_ns
    assert i.seconds >= 1e-3
    assert {s.thread for s in got} == {threading.get_ident()}
    assert profiling.within(o, "inner") == [i]
    with profiling.span("next"):
        pass
    assert profiling.spans()[-1].depth == 0


def test_each_thread_counts_its_own_depth():
    done = []

    def worker():
        with profiling.span("worker"):
            pass
        done.append(threading.get_ident())

    with profiling.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and len(done) == 1
    by_name = {s.name: s for s in profiling.spans()}
    assert by_name["worker"].depth == 0 and by_name["main"].depth == 0
    assert by_name["worker"].thread == done[0] != by_name["main"].thread
    # within() keeps to the outer span's thread
    assert profiling.within(by_name["main"], "worker") == []


def test_the_buffer_keeps_the_newest_spans():
    n = profiling.MAX_SPANS + 10
    for i in range(n):
        with profiling.span("s", str(i)):
            pass
    got = profiling.spans()
    assert len(got) == profiling.MAX_SPANS
    assert got[0].label == "10" and got[-1].label == str(n - 1)
    profiling.clear()
    assert profiling.spans() == []


def test_a_span_opens_no_range_under_another_profiler():
    """The benchmark's profiler is not trace(): a range of a span's name
    would show on its device timeline as busy time."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("prompt.embed"):
            with profiling.span("prompt.chunk"):
                (x @ x).sum()
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names
    assert not names & {"prompt.embed", "prompt.chunk"}
    assert [s.name for s in profiling.spans()] == ["prompt.chunk",
                                                   "prompt.embed"]


def test_the_bridge_puts_a_span_around_its_op():
    """With the benchmark's window range and perf_counter stamps right
    inside it, as the drivers take them, and the render driver's range
    between the program's spans around each decode, a span around an aten
    op maps onto the profile's clock so that the op's CPU event lies inside
    it."""
    x = torch.randn(64, 64)
    trace = Trace()
    trace.start()
    t0 = time.perf_counter()
    for _ in range(5):
        time.sleep(0.003)
        with profiling.span("render.decode"):
            with torch.profiler.record_function("bench.decode"):
                with profiling.span("graph.replay", "decode"):
                    torch.mm(x, x)
    time.sleep(0.001)
    t1 = time.perf_counter()
    trace.stop()
    events = trace.prof.events()
    (window,) = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "bench.window"]
    ranges = sorted(("bench.decode", e.time_range.start, e.time_range.end)
                    for e in events if e.name == "bench.decode")
    mms = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.name == "aten::mm")
    run = SimpleNamespace(record=SimpleNamespace(t0=t0, t1=t1),
                          trace=TraceData(ops=[], spans=ranges,
                                          window=window))
    inner = program_spans.mapped(run, ("graph.replay",))
    outer = program_spans.mapped(run, ("render.decode",))
    assert len(inner) == len(outer) == len(mms) == len(ranges) == 5
    for o, (_, a, b), i, (ms, me) in zip(outer, ranges, inner, mms):
        assert o.start <= a + 50 and b <= o.end + 50
        assert a - 50 <= i.start and i.end <= b + 50
        assert i.start - 50 <= ms and me <= i.end + 50
    # the window's end stamped 2 ms late: its bound lies below the start's
    late = SimpleNamespace(t0=t0, t1=t1 + 2e-3)
    assert program_spans.mapped(SimpleNamespace(record=late,
                                                trace=run.trace),
                                ("graph.replay",)) == []


def test_flatten_leaves_no_reference_cycle():
    from view_neti_tpu_torch.utils.graphs import flatten, unflatten
    x, y = torch.randn(4), torch.randn(3)
    refs = [weakref.ref(x), weakref.ref(y)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        tensors, tree = flatten(({"x": x}, [y, 2]))
        assert unflatten(tree, tensors) == ({"x": x}, [y, 2])
        g = Graphed(lambda a, b: a + b.sum(), "plain")
        assert torch.equal(g(x, y), x + y.sum())
        del tensors, tree, x, y
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()


@pytest.mark.cuda
def test_spans_inside_a_captured_function_on_the_card(tmp_path):
    """A span inside a function a CUDA graph captures runs at the warm-up
    and the capture, never at a replay, and breaks no capture, also while
    trace() opens a range for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    w = torch.randn(64, 64, device="cuda")

    def fn(x):
        with profiling.span("inner"):
            return torch.relu(x @ w)

    x = torch.randn(8, 64, device="cuda")
    want = fn(x)
    for logdir in (None, str(tmp_path)):
        profiling.clear()
        g = Graphed(fn, "spanned")
        with profiling.trace(logdir):
            outs = [g(x) for _ in range(4)]
        torch.cuda.synchronize()
        for out in outs:
            torch.testing.assert_close(out, want, rtol=0, atol=0)
        names = [s.name for s in profiling.spans()]
        assert names.count("inner") == 2, names
        assert names.count("graph.warmup") == names.count(
            "graph.capture") == 1
        assert names.count("graph.replay") == 3
        assert {s.label for s in profiling.spans()
                if s.name.startswith("graph.")} == {"spanned"}
