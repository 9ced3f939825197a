"""The harness on the CPU at a tiny size: the result line, files found by
name, the checks that refuse a run, and `correct` coming out false under
each fault the cells can have.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests -q
"""
from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 7


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cell(root, cell, trace=0, seed=SEED):
    buf = io.StringIO()
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        root=str(root), device="cpu", out_stream=buf)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.render"])
def test_result_line(tmp_path, cell):
    rc, line = run_cell(tiny.make_root(tmp_path), cell)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    kind = cell.split(".")[1]
    assert set(line["metrics"]) == {f"{kind}_imgs_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1
    for c in line["check"].values():
        assert c["value"] <= c["limit"]


def test_traced_line_reads_per_layer_metrics_only(tmp_path):
    rc, line = run_cell(tiny.make_root(tmp_path), "tiny.render", trace=1)
    assert rc == 0 and line["correct"] is True
    # the CPU trace holds no device operation: every reader finds nothing
    assert line["metrics"] == {}


def test_files_added_by_name_are_found(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries only."""
    root = tiny.make_root(tmp_path)
    d = root / "benchmark"
    cfg = json.loads((d / "configs" / "tiny.json").read_text())
    cfg["unet"]["attention_head_dim"] = 8
    (d / "configs" / "tiny8.json").write_text(json.dumps(cfg))
    t = json.loads((d / "traffic" / "tiny_render.json").read_text())
    t["seeds"] = [5]
    (d / "traffic" / "tiny_one_seed.json").write_text(json.dumps(t))
    (d / "metrics" / "views_done.py").write_text(
        'UNIT = "views"\n\n\ndef read(run):\n'
        '    return float(run.record.views)\n')
    (d / "limits" / "tiny8.one_seed.json").write_text(json.dumps(
        {"limits": tiny.LIMITS["tiny.render"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny8", "source": "tests",
                             "file": "benchmark/configs/tiny8.json",
                             "reduced": [], "why": "head dim 8"})
    bench["workloads"].append({"name": "tiny8.one_seed", "config": "tiny8",
                               "traffic": "tiny_one_seed", "chips": 1,
                               "why": "one seed a view"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_imgs_per_s":
            m["workloads"].append("tiny8.one_seed")
    bench["end_to_end"].append({"name": "views_done", "unit": "views",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny8.one_seed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = run_cell(root, "tiny8.one_seed")
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["views_done"]["value"] >= 2
    assert "render_imgs_per_s" in line["metrics"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "view_neti_tpu_torch_x", sys)
    assert "view_neti_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "view_neti_tpu.ops", sys)
    assert bench_run.forbidden_modules() == ["view_neti_tpu"]


def test_harness_and_reference_import_no_jax():
    code = ("import sys; import benchmark.run, benchmark.control, "
            "benchmark.flops, benchmark.trace, benchmark.readers, "
            "benchmark.drivers.coach, benchmark.drivers.render, "
            "benchmark.reference.stack, benchmark.reference.augment; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'view_neti_tpu', "
            "'view_neti_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_sources_import_nothing_of_the_program():
    for f in (REPO / "benchmark" / "reference").glob("*.py"):
        text = f.read_text()
        for name in ("view_neti_tpu", "jax", "flax"):
            assert f"import {name}" not in text and \
                f"from {name}" not in text, f"{f.name} imports {name}"


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    buf = io.StringIO()
    rc = bench_run.main(["--workload", "tiny.train", "--seed", "1",
                         "--seconds", "1", "--trace", "0"],
                        root=str(tiny.make_root(tmp_path)), out_stream=buf)
    assert rc != 0 and buf.getvalue() == ""


def test_benchmark_files_alone_exit_without_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "sd21.train_mode2", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------------------ faults ----

def _still_state(self):
    return None


def _half_batch_loss(models, batch, draws, latents, compute_dtype):
    from view_neti_tpu_torch.training import train_step as ts
    h = batch.input_ids.shape[0] // 2
    sub = ts.TrainBatch(pixel_values=batch.pixel_values[:h],
                        input_ids=batch.input_ids[:h],
                        input_ids_placeholder_object=(
                            batch.input_ids_placeholder_object[:h]),
                        input_ids_placeholder_view=(
                            batch.input_ids_placeholder_view[:h]),
                        object_idx=batch.object_idx)
    d = ts.StepDraws(draws.vae_eps[:h], draws.noise[:h],
                     draws.timesteps[:h], draws.dropout, draws.augment)
    return _ORIG["loss"](models, sub, d, latents[:h], compute_dtype)


def _token_altered(models, input_ids, *args, **kw):
    ids = input_ids.clone()
    ids[:, 1] = (ids[:, 1] + 1) % 512
    return _ORIG["cond"](models, ids, *args, **kw)


def _answer_altered(vae, latents):
    img = _ORIG["decode"](vae, latents).clone()
    img[:, :4, :4] = 255 - img[:, :4, :4]
    return img


_ORIG = {}


@pytest.mark.parametrize("fault,cell", [
    ("state_unchanged", "tiny.train"),
    ("half_batch", "tiny.train"),
    ("token_altered", "tiny.train"),
    ("token_altered", "tiny.render"),
    ("answer_altered", "tiny.render")])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell):
    """The timed path broken underneath a whole run: `correct` is false.
    (One card: no exchange between chips to leave out.)"""
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.training import optim
    from view_neti_tpu_torch.training import train_step as ts
    _ORIG.update(loss=ts.diffusion_loss, cond=ts.neti_text_conditioning,
                 decode=pipeline.decode_to_uint8)
    if fault == "state_unchanged":
        monkeypatch.setattr(optim.SlicedAdamW, "step", _still_state)
    elif fault == "half_batch":
        monkeypatch.setattr(ts, "diffusion_loss", _half_batch_loss)
    elif fault == "token_altered" and cell == "tiny.train":
        monkeypatch.setattr(ts, "neti_text_conditioning", _token_altered)
    elif fault == "token_altered":
        from view_neti_tpu_torch.inference import prompt_manager
        monkeypatch.setattr(prompt_manager, "neti_text_conditioning",
                            _token_altered)
    else:
        monkeypatch.setattr(pipeline, "decode_to_uint8", _answer_altered)
    rc, line = run_cell(tiny.make_root(tmp_path), cell)
    assert rc == 0
    assert line["correct"] is False, line["check"]
