"""Resume in the port (log.resume_from over the port's train state,
view_neti_tpu_torch/train_state.py), on the CPU at the tiny width, as the
JAX package's tests/test_resume_exact.py holds its orbax resume (which
skips here: its teapot data is not in the repository): on synthetic DTU
trees in modes 2 and 3, a run stopped after 2 steps and resumed for 2
more equals 4 uninterrupted steps bit for bit.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from view_neti_tpu_torch import train as ttrain
from view_neti_tpu_torch import train_state
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.utils import msgpack_codec

import test_torch_port_coach as mode2
import test_torch_port_mode3 as mode3

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: on one thread they do not wait for cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Mode 2's single scan and mode 3's four scans."""
    return {2: mode2.make_tree(tmp_path_factory.mktemp("m2")),
            3: mode3.make_tree(tmp_path_factory.mktemp("m3"))}


def _config(trees, mode, exp_dir, steps, **log):
    """The tiny recipe of each mode at 1 x 3 fused (mode 3: three groups
    of one, each with its own scene draw) with nested dropout on (its draws
    come from the step's position too), the resumable state requested
    (checkpoint_backend "orbax"), a checkpoint only at the end unless
    `log` says otherwise."""
    rect, _ = trees[mode]
    data = (mode2.tiny_cfg(rect, exp_dir) if mode == 2
            else mode3.config(rect, exp_dir))
    data["model"]["use_nested_dropout"] = True
    data["optim"].update(max_train_steps=steps, train_batch_size=1,
                         gradient_accumulation_steps=3)
    data["log"].update({"checkpoint_backend": "orbax",
                        "save_steps": 10 ** 9}, **log)
    return decode(RunConfig, data)


def _coach(trees, mode, exp_dir, steps, **log):
    return Coach(_config(trees, mode, exp_dir, steps, **log),
                 arch=tbuilder.tiny_arch(),
                 calibration_dir=str(trees[mode][1]), device="cpu")


def _optimizer_state(coach):
    """Every optimized parameter's AdamW step, moments and value, in the
    optimizer's order, and the per-slice counts."""
    opt = coach.optimizer
    out = []
    for group in opt.optimizer.param_groups:
        for p in group["params"]:
            st = opt.optimizer.state.get(p, {})
            out.append((p.detach().clone(),
                        {k: v.clone() for k, v in st.items()}))
    return out, {k: list(v) for k, v in opt.counts.items()}


@pytest.mark.parametrize("mode", [2, 3])
def test_resumed_run_equals_the_uninterrupted_one(trees, tmp_path, mode):
    """4 straight steps against 2 steps, then 2 more resumed from the
    stopped run's "latest" state: the losses of steps 3-4, every mapper
    parameter (frequency buffers too), every AdamW moment and step, and
    the per-slice counts, all bit for bit."""
    straight = _coach(trees, mode, tmp_path / "straight", 4)
    straight.train()
    _coach(trees, mode, tmp_path / "parts", 2).train()
    assert sorted(p.name for p in (tmp_path / "parts" / "train_state")
                  .iterdir()) == ["state-2.msgpack"]
    resumed = _coach(trees, mode, tmp_path / "parts", 4,
                     resume_from="latest")
    assert resumed.global_step == 2
    log = (tmp_path / "parts" / "logs" / "log.txt").read_text()
    assert "resumed from" in log and "state-2.msgpack" in log
    resumed.train()
    assert resumed.global_step == 4
    assert resumed.losses == straight.losses[2:]
    for a, b in ((straight.built.text.view_mapper,
                  resumed.built.text.view_mapper),
                 *zip(straight.built.text.obj_mappers,
                      resumed.built.text.obj_mappers)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    (params_a, counts_a), (params_b, counts_b) = (
        _optimizer_state(straight), _optimizer_state(resumed))
    assert counts_a == counts_b
    if mode == 3:
        assert straight.mode3_group_size == 1
        assert len(counts_a["object"]) == 4
    assert len(params_a) == len(params_b)
    for (pa, sa), (pb, sb) in zip(params_a, params_b):
        assert torch.equal(pa, pb)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_latest_is_the_newest_state(trees, tmp_path):
    """"latest" orders the states by their step, not by name; a run that
    wrote a state every step resumes from its last."""
    root = tmp_path / "fake" / "train_state"
    root.mkdir(parents=True)
    for step in (2, 10, 9):
        (root / f"state-{step}.msgpack").write_bytes(b"")
    assert train_state.latest_state(tmp_path / "fake").name == \
        "state-10.msgpack"
    with pytest.raises(FileNotFoundError, match="no train states"):
        train_state.latest_state(tmp_path / "none")
    _coach(trees, 2, tmp_path / "run", 3, save_steps=1).train()
    coach = _coach(trees, 2, tmp_path / "run", 5, resume_from="latest")
    assert coach.global_step == 3
    assert coach.optimizer.counts == {"object": [3], "view": [3]}


def test_states_are_pruned_with_the_checkpoints(trees, tmp_path):
    """checkpoints_total_limit 2: the step checkpoints and the train states
    of the two newest steps stay; the final files are never pruned."""
    _coach(trees, 2, tmp_path, 4, save_steps=1,
           checkpoints_total_limit=2).train()
    states = sorted(p.name for p in (tmp_path / "train_state").iterdir())
    assert states == ["state-3.msgpack", "state-4.msgpack"]
    steps = sorted(p.name for p in tmp_path.glob("mapper-steps-*"))
    assert steps == ["mapper-steps-3_object.msgpack",
                     "mapper-steps-3_view.msgpack",
                     "mapper-steps-4_object.msgpack",
                     "mapper-steps-4_view.msgpack"]


def test_a_state_without_a_step_is_rejected(trees, tmp_path):
    """The JAX Coach's error for a state that predates resume: it names
    the missing 'step' entry."""
    _coach(trees, 2, tmp_path / "run", 1).train()
    path = tmp_path / "run" / "train_state" / "state-1.msgpack"
    state = msgpack_codec.unpackb(path.read_bytes())
    assert state["step"] == 1
    assert set(state) == {"step", "trainable", "opt_state", "obj_constants",
                          "view_constants"}
    assert set(state["opt_state"]) == {"adamw", "counts"}
    del state["step"]
    bad = tmp_path / "old.msgpack"
    bad.write_bytes(msgpack_codec.packb(state))
    with pytest.raises(RuntimeError, match="has no 'step' entry"):
        _coach(trees, 2, tmp_path / "run2", 2, resume_from=str(bad))


def test_train_cli_resumes_into_its_directory(trees, tmp_path, monkeypatch):
    """The train CLI refuses a non-empty experiment directory unless asked
    to overwrite or to resume; resumed, it goes on from the saved step."""
    rect, cal = trees[2]
    scan = tmp_path / "scan114"
    shutil.copytree(rect, scan)
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    monkeypatch.setenv("DTU_CALIBRATION_DIR", str(cal))
    monkeypatch.delenv("SD_WEIGHTS_DIR", raising=False)
    args = ["--config_path", str(REPO / "input_configs" / "train.yaml"),
            "--log.exp_dir", str(tmp_path), "--log.report_to", "none",
            "--data.train_data_dir", str(scan), "--data.dtu_subset", "6",
            "--model.pretrained_model_name_or_path",
            "runwayml/stable-diffusion-v1-5", "--eval.validation_steps",
            "1000", "--log.checkpoint_backend", "orbax"]
    out = ttrain.main(args + ["--optim.max_train_steps", "1"], device="cpu")
    assert out["steps"] == 1
    with pytest.raises(FileExistsError):
        ttrain.main(args + ["--optim.max_train_steps", "2"], device="cpu")
    out = ttrain.main(args + ["--optim.max_train_steps", "2",
                              "--log.resume_from", "latest"], device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert (tmp_path / "train" / "train_state" / "state-2.msgpack").exists()
