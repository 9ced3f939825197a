"""utils/profiling.py's trace against the JAX package's, its spans, and
the Coach's VIEW_NETI_TRACE_DIR, on the CPU.

Both packages' trace(None) write nothing and trace(dir) write a file under
dir (the JAX package XProf's xplane.pb, the port a Chrome trace that
parses). A tiny Coach with the variable set writes a trace holding its
steps, and its losses and mappers are bit-equal to a run without it, which
writes nothing; when the loop raises, the profiler is closed. A span shows
on trace()'s timeline and never on another profiler's. The card's trace,
with K1-K4 in it, is held by chip_smoke.py's coach phase.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from view_neti_tpu.utils import profiling as jprofiling

from view_neti_tpu_torch.utils import profiling

import test_torch_port_coach as mode2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True) if os.path.isfile(p))


def _port_trace(root):
    """The events of the one trace file under root."""
    (name,) = glob.glob(os.path.join(root, "*.pt.trace.json"))
    with open(name) as f:
        return json.load(f)["traceEvents"]


def _matmuls():
    x = torch.randn(8, 8)
    with profiling.span("port_region"):
        return (x @ x).sum()


@pytest.mark.parametrize("logdir", [None, ""])
def test_trace_off_writes_nothing(logdir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with jprofiling.trace(logdir):
        jnp.ones(4).sum().block_until_ready()
    with profiling.trace(logdir):
        assert not torch.autograd.profiler._is_profiler_enabled
        _matmuls()
    assert _files(tmp_path) == []


def test_trace_writes_a_file_in_both_packages(tmp_path):
    with jprofiling.trace(str(tmp_path / "jax")):
        with jprofiling.annotate("jax_region"):
            jax.jit(lambda x: x @ x)(jnp.ones((8, 8))).block_until_ready()
    jax_files = _files(tmp_path / "jax")
    assert any(f.endswith(".xplane.pb") for f in jax_files), jax_files

    with profiling.trace(str(tmp_path / "port")):
        _matmuls()
    assert not torch.autograd.profiler._is_profiler_enabled
    (name,) = _files(tmp_path / "port")
    assert name.endswith(".pt.trace.json") and f"_{os.getpid()}." in name
    names = {e.get("name") for e in _port_trace(str(tmp_path / "port"))}
    assert {"port_region", "aten::mm"} <= names, sorted(names)[:40]


def test_trace_refuses_to_nest(tmp_path):
    """torch.profiler does not nest: inside an open profiler trace raises
    at once, writes nothing and leaves the outer profiler recording."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as outer:
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.trace(str(tmp_path)):
                pass
        _matmuls()
    assert _files(tmp_path) == []
    names = {e.name for e in outer.events()}
    # the outer profiler records; a span opens no range under it
    assert "aten::mm" in names and "port_region" not in names


def test_trace_names_the_rank(tmp_path):
    """Under torch.distributed each rank writes its own file."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with profiling.trace(str(tmp_path / "trace")):
            _matmuls()
    finally:
        dist.destroy_process_group()
    (name,) = _files(tmp_path / "trace")
    assert f"_{os.getpid()}_rank0." in name


def _mappers(coach):
    text = coach.built.text
    return {f"{name}.{k}": v.detach().clone()
            for name, m in ([(f"object{i}", m)
                             for i, m in enumerate(text.obj_mappers)]
                            + [("view", text.view_mapper)])
            for k, v in m.state_dict().items()}


def _run(tree, tmp_path, name, monkeypatch, trace_dir=None):
    if trace_dir is None:
        monkeypatch.delenv("VIEW_NETI_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("VIEW_NETI_TRACE_DIR", str(trace_dir))
    coach = mode2._coach(tree, tmp_path, name,
                         optim={"max_train_steps": 2})
    coach.train()
    return coach


def test_coach_trace_is_bit_equal_to_no_trace(tmp_path, monkeypatch):
    tree = mode2.make_tree(tmp_path / "dtu")
    plain = _run(tree, tmp_path, "plain", monkeypatch)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not glob.glob(str(tmp_path / "**" / "*.pt.trace.json"),
                         recursive=True)
    traced = _run(tree, tmp_path, "traced", monkeypatch,
                  trace_dir=tmp_path / "trace")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(plain.losses) == 2 and traced.losses == plain.losses
    want, got = _mappers(plain), _mappers(traced)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    names = {e.get("name") for e in _port_trace(str(tmp_path / "trace"))}
    # the steps' attention and its backward ran under the trace, inside
    # the Coach's spans
    assert {"FlashAttentionBackward", "aten::einsum", "coach.loop",
            "coach.step", "coach.feed"} <= names
    # the final checkpoint is written after the trace closes
    assert (tmp_path / "traced" / "mapper-final_view.msgpack").exists()


def test_coach_closes_the_trace_when_the_loop_raises(tmp_path, monkeypatch):
    tree = mode2.make_tree(tmp_path / "dtu")
    monkeypatch.setenv("VIEW_NETI_TRACE_DIR", str(tmp_path / "trace"))
    coach = mode2._coach(tree, tmp_path, "run",
                         optim={"max_train_steps": 2})

    def planted(*args):
        raise ValueError("planted failure in the train loop")

    monkeypatch.setattr(coach, "_run_window", planted)
    with pytest.raises(ValueError, match="planted"):
        coach.train()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not profiling._TRACING
    assert len(_files(tmp_path / "trace")) == 1
    # a new profiler opens and records, and spans open no range under it
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _matmuls()
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names and "port_region" not in names
