"""The offline inference CLI's legacy flags (--exp_dir ... --save_dir)
against the JAX script's: view_neti_tpu_torch.inference.offline.parse_args
and scripts/inference.py::_parse_args (loaded with importlib, driven
through sys.argv) give the same InferenceConfig on the same argv, and both
exit with code 2 where argparse refuses it; offline.main then looks up the
step's checkpoint as on the YAML surface."""
import dataclasses
import importlib.util
import os
import sys

import pytest

from view_neti_tpu_torch.inference import offline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_inference_script", os.path.join(ROOT, "scripts", "inference.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_parse(jax_script, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["inference.py", *argv])
    return jax_script._parse_args()


ARGVS = {
    "exp_dir": ["--exp_dir", "runs/x", "--iteration", "5", "--seeds", "0",
                "1"],
    "save_dir": ["--exp_dir", "runs/x", "--iteration", "5", "--seeds", "0",
                 "1", "--save_dir", "out/y"],
    "every_flag": ["--exp_dir", "runs/x", "--iteration", "1500", "--seeds",
                   "3", "4", "5", "--num_denoising_steps", "12",
                   "--calibration_dir", "cal", "--masks_root", "masks",
                   "--save_dir", "out/y", "--lpips_weights", "lpips.npz"],
    "defaults": ["--exp_dir", "runs/x", "--iteration", "7"],
    "abbreviated": ["--exp_dir", "runs/x", "--iter", "5", "--num_den", "4",
                    "--seed", "9"],
    "abbreviated_exp_dir": ["--save_dir", "out/y", "--exp", "runs/x",
                            "--iteration", "5"],
    "equals": ["--exp_dir=runs/x", "--iteration=5", "--save_dir=out/y"],
    # no legacy flag: both take the YAML / dot-override surface
    "dot_overrides": ["--input_dir", "runs/x", "--iteration", "5",
                      "--num_denoising_steps", "3"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_equals_the_jax_scripts(name, jax_script, monkeypatch):
    argv = ARGVS[name]
    want = _jax_parse(jax_script, monkeypatch, argv)
    got = offline.parse_args(list(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__ == "InferenceConfig"
    if name == "save_dir":
        assert str(got.inference_dir) == "out/y"
    elif name == "exp_dir":
        # the run directory itself, not InferenceConfig's <input_dir>/inference
        assert str(got.inference_dir) == "runs/x" and got.seeds == [0, 1]
    elif name == "defaults":
        assert got.seeds == [0, 1, 2] and got.num_denoising_steps == 30


@pytest.mark.parametrize("argv", [
    ["--save_dir", "out/y", "--iteration", "5"],     # no --exp_dir
    ["--exp_dir", "runs/x"],                         # no --iteration
    ["--exp_dir", "runs/x", "--iteration", "5", "--seeds"],
    ["--exp_dir", "runs/x", "--iteration", "5", "--debug", "1"],
])
def test_refused_argv_exits_2_as_the_jax_scripts(argv, jax_script,
                                                 monkeypatch):
    with pytest.raises(SystemExit) as want:
        _jax_parse(jax_script, monkeypatch, argv)
    with pytest.raises(SystemExit) as got:
        offline.parse_args(list(argv))
    assert got.value.code == want.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--exp_dir", "{run}", "--iteration", "5", "--seeds", "0", "1"],
    ["--exp_dir", "{run}", "--parallel.dp", "1", "--iteration", "5",
     "--save_dir", "{run}/out"],
    ["--input_dir", "{run}", "--iteration", "5"],
])
def test_main_looks_up_the_steps_checkpoint(argv, tmp_path):
    """Both surfaces (the --parallel.* options split off first) reach the
    checkpoint lookup, which raises on the missing step-5 mapper files
    before anything is written."""
    argv = [a.format(run=tmp_path) for a in argv]
    with pytest.raises(FileNotFoundError, match="mapper-steps-5_object"):
        offline.main(argv, device="cpu")
    assert os.listdir(tmp_path) == []
