"""The benchmark's readers of the program's spans
(benchmark/program_spans.py, benchmark/metrics/{cond_host_ms.render,
idle_cond_ms.render, idle_coach_ms.train, setup_graphs_s,
setup_build_s}.py) on a synthetic trace and recorder: each reads the
number worked out by hand, None on an empty recorder (a program without
the spans), and None when the window's two ends disagree.

Times below are microseconds on the trace's clock; the recorder's spans
are the same instants on perf_counter (record.t0 = 100 s is the window's
start, 1000 us).
"""
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import program_spans, trace
from benchmark.run import load_metric
from view_neti_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
T0_S, WINDOW = 100.0, (1000.0, 11000.0)
OFF_US = WINDOW[0] - T0_S * 1e6


def _record(name, start, end, depth=0, label=None):
    return profiling.SpanRecord(name, label, round((start - OFF_US) * 1e3),
                                round((end - OFF_US) * 1e3), depth, 1)


SETUP = [_record("setup.build_models", -50000, -20000),
         _record("graph.warmup", -9000, -8000, 1, "denoise loop"),
         _record("graph.capture", -7000, -6500, 1, "denoise loop"),
         _record("graph.replay", -6000, -5500, 1, "denoise loop"),
         # ends after the window opened: not set-up
         _record("graph.warmup", 1200, 1300, 1, "decode")]

RENDER = dict(
    ops=[(1000, 2000), (3000, 6000), (6500, 11000)],   # gaps 1000, 500
    spans=SETUP + [_record("prompt.embed", -5000, -3000),
                   _record("prompt.chunk", 1600, 1900, 1),
                   _record("prompt.embed", 1500, 2600),
                   _record("prompt.embed", 5000, 6200)],
    bench=[("bench.prompt", 1490, 2700), ("bench.prompt", 4990, 6300)])

TRAIN = dict(
    ops=[(1000, 1500), (2000, 4000), (4200, 11000)],   # gaps 500, 200
    spans=SETUP + [_record("coach.loop", -60000, 12000),
                   _record("coach.step", 900, 1800, 1),
                   _record("graph.replay", 910, 1650, 2, "train step"),
                   _record("coach.step", 3000, 3900, 1),
                   _record("graph.replay", 3010, 3750, 2, "train step"),
                   _record("coach.feed", 3950, 4100, 1)],
    bench=[("bench.train_step", 905, 1700), ("bench.train_step", 3005, 3800)])

CASES = [("cond_host_ms.render", RENDER, (1100 + 1200) / 2 / 1e3),
         # the gaps at 2000 and 6000 begin inside prompt.embed: 2 views
         ("idle_cond_ms.render", RENDER, (1000 + 500) / 2 / 1e3),
         # the gap at 1500 begins inside a coach.step, the one at 4000 not
         ("idle_coach_ms.train", TRAIN, 200 / 2 / 1e3),
         ("setup_graphs_s", RENDER, (1000 + 500) / 1e6),
         ("setup_graphs_s", TRAIN, (1000 + 500) / 1e6),
         ("setup_build_s", TRAIN, 30000 / 1e6)]


def _run(case, t0_lag_s=0.0, t1_shift_s=0.0):
    data = trace.TraceData(ops=[("k", s, e) for s, e in case["ops"]],
                           spans=list(case["bench"]), window=WINDOW, units=2)
    t1 = T0_S + (WINDOW[1] - WINDOW[0]) / 1e6 + t1_shift_s
    return SimpleNamespace(record=SimpleNamespace(t0=T0_S + t0_lag_s, t1=t1),
                           trace=data, work=None, process_start=0.0)


@pytest.mark.parametrize("name,case,want", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_reader_reads_the_number_worked_out_by_hand(name, case, want,
                                                    monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: case["spans"])
    metric = load_metric(ROOT, name)
    assert metric.read(_run(case)) == pytest.approx(want, rel=1e-9)
    # the window's start stamped 0.8 ms late, as where its range is the
    # process's first: the benchmark's ranges around the program's spans
    # put them back
    assert metric.read(_run(case, t0_lag_s=8e-4)) == pytest.approx(
        want, rel=1e-9)
    # the window's end stamped 2 ms late, its bound 2 ms below the
    # start's: no bridge, no number
    assert metric.read(_run(case, t1_shift_s=2e-3)) is None


@pytest.mark.parametrize("name,case",
                         list({c[0]: c[1] for c in CASES}.items()))
def test_reader_reads_none_on_an_empty_recorder(name, case):
    profiling.clear()
    assert program_spans.recorded() == []
    assert load_metric(ROOT, name).read(_run(case)) is None


def test_the_gaps_are_the_breakdowns(monkeypatch):
    data = _run(RENDER).trace
    gaps = program_spans.gaps(data)
    assert gaps == [(2000, 3000), (6000, 6500)]
    assert sorted(g[1] for g in trace.breakdown(data)["idle_gaps"]) == \
        sorted((b - a) / 1e6 for a, b in gaps)
    monkeypatch.setattr(program_spans, "recorded", lambda: RENDER["spans"])
    spans = program_spans.mapped(_run(RENDER),
                                 ("prompt.embed", "prompt.chunk"))
    assert program_spans.open_at(spans, 1700).name == "prompt.chunk"
    assert program_spans.open_at(spans, 2000).name == "prompt.embed"
    assert program_spans.open_at(spans, 3000) is None
