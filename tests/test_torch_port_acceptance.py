"""The acceptance run, the weights manifest and the import CLI of the port
against the JAX package's, and offline inference reading SD_WEIGHTS_DIR,
on the CPU at the tiny width.

  * weight_port.write_manifest / check_manifest of both packages: the same
    bytes for the same tree, each package's manifest checks clean in the
    other, and each catches a changed byte, a changed size and a missing
    file in the other's manifest (the cases of tests/test_acceptance.py);
  * python -m view_neti_tpu_torch.weights_manifest write / check;
  * acceptance.recipe against the config dict of tools/acceptance.py,
    read with ast and decoded by both packages;
  * python -m view_neti_tpu_torch.acceptance --smoke: the JAX tool's
    acceptance.json key set with finite metrics, exit 2 on a failed
    --reference_lpips, and a failed manifest stopping the run before
    training;
  * python -m view_neti_tpu_torch.import_torch against the JAX package's
    import_torch_artifacts on the same .pt / .bin files;
  * offline inference of a run trained on a weights directory: with
    SD_WEIGHTS_DIR set it equals the Coach's own sweep, unset it renders
    the seeded stack.
"""
import ast
import copy
import dataclasses
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from view_neti_tpu import config as jconfig
from view_neti_tpu import torch_interop as jinterop
from view_neti_tpu import weight_port as jwp

from view_neti_tpu_torch import acceptance, import_torch, weights_manifest
from view_neti_tpu_torch import torch_interop as tinterop
from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.inference import offline
from view_neti_tpu_torch.training import builder, inference_dtu
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.training.validate import ValidationHandler
from view_neti_tpu_torch.utils import msgpack_codec

from test_torch_port_export import _files, assert_trees_equal
from test_torch_port_validate import config as validate_config
from test_torch_port_weights import write_stack

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jwp, "port": twp}


def _jax_tool_literals():
    """The config dict expression of tools/acceptance.py (its
    decode(RunConfig, {...}) call), compiled, and the acceptance.json key
    set that tests/test_acceptance.py pins: read with ast, since the tool
    and that test run JAX."""
    tool = ast.parse((REPO / "tools" / "acceptance.py").read_text())
    recipe, = [node.args[1] for node in ast.walk(tool)
               if isinstance(node, ast.Call)
               and getattr(node.func, "id", None) == "decode"
               and getattr(node.args[0], "id", None) == "RunConfig"]
    test = ast.parse((REPO / "tests" / "test_acceptance.py").read_text())
    keys, = [node.comparators[0] for node in ast.walk(test)
             if isinstance(node, ast.Compare)
             and isinstance(node.comparators[0], ast.Set)
             and ast.unparse(node.left) == "set(payload)"]
    return (compile(ast.Expression(recipe), "tools/acceptance.py", "eval"),
            ast.literal_eval(keys))


JAX_RECIPE, PAYLOAD_KEYS = _jax_tool_literals()
ASSET_ENV = ("SD_WEIGHTS_DIR", "TOKENIZER_PATH", "LPIPS_WEIGHTS",
             "DTU_MASKS_DIR", "WEIGHTS_MANIFEST", "VIEW_NETI_TINY")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_assets(monkeypatch):
    for name in ASSET_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------- manifest ----

def weight_tree(tmp_path):
    """A weights directory (unet/*.bin, a .safetensors, vocab.json) and an
    extra file outside it."""
    rng = np.random.RandomState(0)
    root = tmp_path / "weights"
    (root / "unet").mkdir(parents=True)
    (root / "text_encoder").mkdir()
    (root / "unet" / "diffusion_pytorch_model.bin").write_bytes(
        rng.bytes(512))
    (root / "unet" / "extra.bin").write_bytes(rng.bytes(64))
    (root / "text_encoder" / "model.safetensors").write_bytes(rng.bytes(300))
    (root / "vocab.json").write_text('{"a": 0}')
    (root / "notes.txt").write_text("not a weight file")
    extra = tmp_path / "lpips.npz"
    extra.write_bytes(rng.bytes(128))
    return root, extra


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


TAMPER = {
    "sha256 mismatch: ": _flip_byte,
    "size mismatch: ": lambda p: p.write_bytes(p.read_bytes() + b"\0"),
    "missing: ": lambda p: p.unlink(),
}


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_manifest_is_the_same_in_both_packages(tmp_path, writer):
    """Either package's writer gives the same bytes, and the other
    package's check passes them."""
    root, extra = weight_tree(tmp_path)
    manifests = {}
    for name, pkg in PACKAGES.items():
        manifests[name] = tmp_path / f"{name}.sha256"
        n = pkg.write_manifest(root, manifests[name], (str(extra),))
        assert n == 5
    assert manifests["jax"].read_bytes() == manifests["port"].read_bytes()
    lines = manifests[writer].read_text().splitlines()
    assert [line.split(maxsplit=2)[2] for line in lines] == [
        "text_encoder/model.safetensors", "unet/diffusion_pytorch_model.bin",
        "unet/extra.bin", "vocab.json", str(extra)]
    other = PACKAGES["port" if writer == "jax" else "jax"]
    assert other.check_manifest(root, manifests[writer]) == []


@pytest.mark.parametrize("problem", sorted(TAMPER))
@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_manifest_catches_tampering_across_packages(tmp_path, writer,
                                                    problem):
    """A manifest of one package, a file changed after it: the other
    package's check names the file and the fault as the writer's own
    check does."""
    root, extra = weight_tree(tmp_path)
    manifest = root / "MANIFEST.sha256"
    PACKAGES[writer].write_manifest(root, manifest, (str(extra),))
    TAMPER[problem](root / "unet" / "diffusion_pytorch_model.bin")
    TAMPER[problem](extra)
    want = [f"{problem}unet/diffusion_pytorch_model.bin",
            f"{problem}{extra}"]
    for pkg in PACKAGES.values():
        assert pkg.check_manifest(root, manifest) == want


def test_manifest_cli_writes_and_checks(tmp_path, capsys):
    root, extra = weight_tree(tmp_path)
    out = weights_manifest.main(["write", "--root", str(root), "--extra",
                                 str(extra)])
    assert out == root / "MANIFEST.sha256"
    assert "(5 files)" in capsys.readouterr().out
    assert weights_manifest.main(["check", "--root", str(root)]) == out
    assert capsys.readouterr().out.strip() == "OK"
    jwp.write_manifest(root, tmp_path / "jax.sha256", (str(extra),))
    assert out.read_bytes() == (tmp_path / "jax.sha256").read_bytes()
    (root / "vocab.json").write_text('{"b": 1}')
    with pytest.raises(SystemExit) as e:
        weights_manifest.main(["check", "--root", str(root), "--manifest",
                               str(out)])
    assert e.value.code == 1
    assert "sha256 mismatch: vocab.json" in capsys.readouterr().out


# -------------------------------------------------------- acceptance ----

@pytest.fixture
def few_cameras(no_assets):
    """The sweep cut to two test and two train cameras of the 34: LPIPS's
    VGG at 300x400 takes about 1.6 s a view on one core (the card runs
    all 34). TensorFlow's import behind tensorboard (about 10 s) is
    refused, so that the Coach logs "tensorboard unavailable"."""
    get = inference_dtu.get_cam_idxs

    def cut(dtu_subset):
        cams, train, test = get(dtu_subset)
        keep = test[:2] + train[:2]
        return ([c for c in cams if c in keep], train,
                [c for c in test if c in keep])
    no_assets.setattr(inference_dtu, "get_cam_idxs", cut)
    no_assets.setitem(sys.modules, "torch.utils.tensorboard", None)
    return no_assets


@pytest.mark.parametrize("tokenizer", [False, True])
@pytest.mark.parametrize("tiny", [False, True])
def test_recipe_is_the_jax_tools(tmp_path, no_assets, tiny, tokenizer):
    """acceptance.recipe equals the JAX tool's config dict decoded by
    either package, field by field: the full recipe and the smoke's, with
    and without TOKENIZER_PATH."""
    if tokenizer:
        no_assets.setenv("TOKENIZER_PATH", str(tmp_path / "tokenizer"))
    args = acceptance.parse_args(["--out", str(tmp_path / "acc"),
                                  "--steps", "7", "--dtu_subset", "3",
                                  "--seeds", "4", "5"])
    scan_dir = tmp_path / "Rectified" / "scan114"
    data = eval(JAX_RECIPE, {"args": args, "scan_dir": scan_dir,
                             "tiny": tiny, "os": os})
    got = dataclasses.asdict(acceptance.recipe(args, scan_dir, tiny))
    assert got == dataclasses.asdict(decode(RunConfig, data))
    assert got == dataclasses.asdict(jconfig.decode(jconfig.RunConfig, data))
    assert (str(got["data"]["tokenizer_path"]) == str(tmp_path / "tokenizer")
            if tokenizer else "tokenizer_path" not in data["data"])


def test_smoke_writes_the_jax_payload_and_fails_a_far_reference(
        tmp_path, few_cameras):
    """--smoke on the CPU: the JAX tool's key set, finite metrics, the
    run labelled as not meaningful, and a reference 1000 far off exits 2
    after writing acceptance.json."""
    with pytest.raises(SystemExit) as e:
        acceptance.main(["--smoke", "--out", str(tmp_path),
                         "--reference_lpips", "1000"], device="cpu")
    assert e.value.code == 2
    payload = json.loads((tmp_path / "acceptance.json").read_text())
    assert set(payload) == PAYLOAD_KEYS
    for m in acceptance.METRICS:
        for split in ("train", "test"):
            v = payload["metrics"][f"{m}_{split}_mean"]
            assert math.isfinite(v), (m, split, v)
    assert set(payload["assets"]) == {"SD_WEIGHTS_DIR", "TOKENIZER_PATH",
                                      "LPIPS_WEIGHTS", "DTU_MASKS_DIR",
                                      "dtu_root"}
    assert all(set(v) == {"path", "present"}
               for v in payload["assets"].values())
    assert payload["assets"]["dtu_root"]["present"]
    assert payload["all_assets_real"] is False
    assert payload["meaningful_for_quality"] is False
    assert payload["manifest"] is None
    assert payload["train_wall_s"] > 0 and payload["eval_wall_s"] > 0
    assert (payload["steps"], payload["seeds"],
            payload["denoise_steps"]) == (2, [0], 2)
    verdict = payload["acceptance"]
    assert verdict["pass"] is False and verdict["reference"] == 1000
    assert verdict["lpips_test_mean"] == payload["metrics"]["lpips_test_mean"]
    assert (tmp_path / "run" / "mapper-steps-2_view.msgpack").exists()
    assert "tensorboard unavailable" in (
        tmp_path / "run" / "logs" / "log.txt").read_text()


@pytest.mark.parametrize("ratio,passes", [(1.0, True), (1.009, True),
                                          (0.991, True), (1.011, False),
                                          (0.98, False)])
def test_lpips_verdict_holds_one_percent(ratio, passes):
    got = 0.25
    v = acceptance.lpips_verdict(got, got * ratio)
    assert v["pass"] is passes
    assert v["rel_diff"] == pytest.approx(abs(1 - 1 / ratio))
    assert set(v) == {"lpips_test_mean", "reference", "rel_diff", "pass"}


def test_failed_manifest_stops_before_training(tmp_path, no_assets):
    """SD_WEIGHTS_DIR with a MANIFEST.sha256 that no longer matches: the
    run raises naming the file before a Coach is built."""
    root, _ = weight_tree(tmp_path)
    twp.write_manifest(root, root / "MANIFEST.sha256")
    _flip_byte(root / "unet" / "extra.bin")
    no_assets.setenv("SD_WEIGHTS_DIR", str(root))

    def no_coach(*args, **kwargs):
        raise AssertionError("a Coach was built")
    no_assets.setattr(Coach, "__init__", no_coach)
    out = tmp_path / "acc"
    with pytest.raises(SystemExit) as e:
        acceptance.main(["--smoke", "--out", str(out)], device="cpu")
    assert "sha256 mismatch: unet/extra.bin" in str(e.value.code)
    assert not (out / "run").exists() and not (out / "acceptance.json"
                                               ).exists()


def test_run_needs_a_dtu_root(tmp_path, no_assets):
    with pytest.raises(SystemExit, match="--dtu_root is required"):
        acceptance.main(["--out", str(tmp_path)], device="cpu")


# -------------------------------------------------------- import CLI ----

def test_import_cli_writes_what_the_jax_importer_writes(tmp_path, capsys):
    """The reference's .pt mappers and learned_embeds .bin (the port's
    export of test_torch_port_export's files): the same file names as the
    JAX package's import_torch_artifacts, and trees equal leaf for leaf."""
    exported = tinterop.export_torch_artifacts(tmp_path / "pt",
                                               **_files(tmp_path))
    view, obj, embeds = (str(p) for p in exported)
    written = import_torch.main(["--out", str(tmp_path / "port"), "--view",
                                 view, "--object", obj, "--embeds", embeds])
    assert "wrote" in capsys.readouterr().out
    want = jinterop.import_torch_artifacts(
        tmp_path / "jax", view_path=exported[0], object_path=exported[1],
        embeds_path=exported[2])
    assert [p.name for p in written] == [p.name for p in want] == [
        "mapper-steps-300_view.msgpack", "mapper-steps-900_object.msgpack",
        "learned_embeds-steps-300.msgpack"]
    for got, ref in zip(written, want):
        assert_trees_equal(msgpack_codec.unpackb(got.read_bytes()),
                           msgpack_codec.unpackb(ref.read_bytes()))
    renamed = import_torch.main(["--out", str(tmp_path / "it"), "--view",
                                 view, "--iteration", "7"])
    assert [p.name for p in renamed] == ["mapper-steps-7_view.msgpack"]
    with pytest.raises(SystemExit):
        import_torch.main(["--out", str(tmp_path / "none")])
    assert "nothing to import" in capsys.readouterr().err


# ------------------------------------------ offline with SD_WEIGHTS_DIR ----

STEP, SEEDS = 2, [0, 1]


def scan_tree(root):
    """scan114 at 64x48 (the six dtu_subset-6 cameras and the debug
    sweep's two eval cameras) and 64 calibration files; no masks, so the
    sweep's masks are white."""
    rect, cal = root / "Rectified" / "scan114", root / "Calibration" / "cal18"
    rect.mkdir(parents=True)
    cal.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    cams, train, _ = inference_dtu.get_cam_idxs(6)
    for i in sorted(set(cams[:2]) | set(train)):
        image_io.write_png(rect / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    return rect, cal, root / "idrmasks"


@pytest.fixture(scope="module")
def weighted_run(tmp_path_factory):
    """A tiny mode-2 Coach (seed 0) trained STEP steps on a stack written
    from seed 5 in the diffusers layout, with a debug validation round (2
    cameras, 2 denoising steps) at STEP after its checkpoint."""
    root = tmp_path_factory.mktemp("acc_offline")
    rect, cal, masks_root = scan_tree(root / "dtu")
    weights = root / "sd"
    write_stack(weights, seed=5)
    data = validate_config(rect, root / "run", debug=True,
                           log={"save_steps": STEP},
                           eval={"validation_steps": STEP},
                           optim={"max_train_steps": STEP})
    coach = Coach(decode(RunConfig, data), arch=builder.tiny_arch(),
                  calibration_dir=str(cal), weights_dir=str(weights),
                  device="cpu")
    coach.validator = ValidationHandler(
        coach.cfg, masks_root=str(masks_root), calibration_dir=str(cal))
    rounds = []
    infer_dtu = coach.validator.infer_dtu

    def record(*args, **kwargs):
        rounds.append(infer_dtu(*args, **kwargs))
        return rounds[-1]
    coach.validator.infer_dtu = record
    coach.train()
    assert len(rounds) == 1
    return dict(run=root / "run", weights=weights, cal=cal,
                masks_root=masks_root, cfg=coach.cfg, sweep=rounds[0])


def _offline(run, tmp_path, cal, masks_root):
    return offline.main([
        "--input_dir", str(run), "--iteration", str(STEP), "--seeds",
        json.dumps(SEEDS), "--num_denoising_steps", "2", "--debug", "1",
        "--torch_dtype", "fp32", "--calibration_dir", str(cal),
        "--masks_root", str(masks_root), "--inference_dir",
        str(tmp_path)], device="cpu")


def test_offline_inference_reads_sd_weights_dir(weighted_run, tmp_path,
                                                no_assets):
    """With SD_WEIGHTS_DIR set the offline sweep equals the Coach's own
    sweep of the step bit for bit; unset, it equals a sweep of the seeded
    stack (the JAX script's behaviour) and differs from the first."""
    r = weighted_run
    no_assets.setenv("VIEW_NETI_TINY", "1")
    no_assets.setenv("SD_WEIGHTS_DIR", str(r["weights"]))
    loaded = _offline(r["run"], tmp_path / "loaded", r["cal"],
                      r["masks_root"])
    assert loaded["cam_idxs"] == r["sweep"]["cam_idxs"]
    for got, want in zip(loaded["imgs_pred"], r["sweep"]["imgs_pred"]):
        np.testing.assert_array_equal(got, want)

    no_assets.delenv("SD_WEIGHTS_DIR")
    seeded = _offline(r["run"], tmp_path / "seeded", r["cal"],
                      r["masks_root"])
    cfg = copy.deepcopy(r["cfg"])
    cfg.eval.num_denoising_steps = 2
    coach = Coach(cfg, arch=builder.tiny_arch(), calibration_dir=str(
        r["cal"]), device="cpu")
    want = ValidationHandler(
        cfg, masks_root=str(r["masks_root"]), calibration_dir=str(r["cal"])
    ).infer_dtu(coach, step=STEP, num_steps=2, return_instead_of_save=True,
                on_missing_ckpt="raise")
    for got, ref, other in zip(seeded["imgs_pred"], want["imgs_pred"],
                               loaded["imgs_pred"]):
        np.testing.assert_array_equal(got, ref)
        assert not np.array_equal(got, other)
