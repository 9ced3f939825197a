"""Mode 3's validation round, offline inference and summary in the port,
on the CPU at the tiny width: a tiny mode-3 run trained 2 steps with
validation on, its per-token sweeps (one held against the JAX package's
sweep on the same weights), the object renders' mapper resolution, and
the inference and summarize CLIs on the run.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.training import inference_dtu as jinf

from view_neti_tpu_torch import summarize_dtu as tsummarize
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.constants import T2I_GENERALIZATION_PROMPTS
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.inference import offline as tinference
from view_neti_tpu_torch.inference import pipeline as tpipe
from view_neti_tpu_torch.inference.prompt_manager import PromptManager
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import inference_dtu as tinf
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.training.validate import ValidationHandler
from view_neti_tpu_torch.utils import msgpack_codec
from view_neti_tpu_torch.utils.vis import make_grid_np

from test_torch_port_mode3 import (EVAL_TOKENS, SCANS, SEEDS, TOKENS,
                                   config, make_tree)
from test_torch_port_validate import _jax_stack


def jax_noise(seeds, h, w, device):
    """The JAX sweep's initial latents, for the port's sweep."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(int(s)), (h, w, 4), jnp.float32))
        for s in seeds])).to(device)


def assert_close_uint8(got, want):
    """The sweep tolerance of tests/test_torch_port_validate.py: +-1 on at
    most 0.5 % of the values."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: on one thread they do not wait for cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("m3"))


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """A tiny mode-3 Coach trained 2 steps with validation every 2 steps
    (debug: cameras 0 and 1, 2 denoising steps) over the three eval
    tokens."""
    rect, cal = tree
    exp = tmp_path_factory.mktemp("trained")
    coach = Coach(decode(RunConfig, config(
        rect, exp, debug=True, log={"save_steps": 2},
        eval={"validation_prompts": ["A photo of a {}"],
              "validation_steps": 2})),
        arch=tbuilder.tiny_arch(), calibration_dir=str(cal), device="cpu")
    coach.validator = ValidationHandler(coach.cfg, calibration_dir=str(cal))
    rounds = []
    infer = coach.validator.infer

    def record(coach, step):
        rounds.append(infer(coach=coach, step=step))
        return rounds[-1]

    coach.validator.infer = record
    coach.train()
    return coach, exp, rounds


@pytest.fixture(scope="module")
def jax_stack(trained, tree):
    """The JAX stack holding the trained run's weights (bank of four)."""
    coach, exp, _ = trained
    return _jax_stack(coach, jdecode(JRunConfig, config(tree[0], exp)),
                      tree[1])


def test_infer_mode3_writes_a_bundle_per_token(trained):
    """One validation round: a sweep per eval token, each with its own
    bundle and sheets, its ground truth from its own scan (each scan has
    its own brightness band), and the renders of the tokens."""
    coach, exp, rounds = trained
    assert len(rounds) == 1 and sorted(rounds[0]) == sorted(EVAL_TOKENS)
    for tok, res in rounds[0].items():
        bundle = exp / ("validation-iter_2-denoisesteps_2_numseeds_2"
                        f"-{tok}.msgpack")
        assert res["bundle"] == bundle and bundle.exists()
        assert (exp / f"val-dtu-step2-{tok}-seed1.png").exists()
        loaded = msgpack_codec.unpackb(bundle.read_bytes())
        assert loaded["imgs_pred"].shape == (2, 2, 300, 400, 3)
        s = SCANS.index(dict(zip(TOKENS, SCANS))[tok])
        mean = loaded["imgs_gt"].mean() * 255
        assert 60 * s <= mean <= 60 * s + 60, (tok, mean)
        # cameras 0 and 1 are test views of dtu_subset 3
        assert np.isfinite(res["psnr_test_mean"])
    assert (exp / "val-disentangled-step2.png").exists()
    log = (exp / "logs" / "log.txt").read_text()
    assert "falling back to LIVE" not in log
    assert all(f"DTU val step 2-{t}" in log for t in EVAL_TOKENS)


def test_object_index_resolves_by_token_id(trained, monkeypatch):
    """A render names its mapper by the token id it holds, not by a
    substring: "<statue2>" is object 2 though "<statue>" is a prefix of
    it; the sweep picks the eval token's own mapper."""
    coach, _, _ = trained
    seen = []
    embeds = PromptManager.embed_prompts

    def spy(self, prompts, object_idx=0, **kw):
        seen.append((prompts[0], object_idx))
        return embeds(self, prompts, object_idx=object_idx, **kw)

    monkeypatch.setattr(PromptManager, "embed_prompts", spy)
    handler = ValidationHandler(coach.cfg)
    handler.infer_disentangled_objects_dtu(coach, 2, 1,
                                           ["<statue2>", "<statue>", "<toy>"])
    assert [i for _, i in seen] == [2, 1, 3]
    seen.clear()
    tinf.dtu_generate_camidxs_to_preds(
        coach, [0], 2, num_denoising_steps=1, seeds=[0],
        eval_placeholder_object_token="<statue2>",
        calibration_dir=str(coach.train_dataset.calibration_dir))
    assert seen and seen[0][0].endswith("A photo of a <statue2>")
    assert seen[0][1] == 2


def test_mode3_sweep_matches_jax(trained, tree, jax_stack, monkeypatch):
    """One eval token's DTU sweep (two cameras, two denoising steps, two
    seeds) on the JAX stack holding the trained run's weights (bank of
    four) and on the port's, both reloading the step's files: uint8 images
    within +-1 on at most 0.5 % of the values, as
    tests/test_torch_port_validate.py holds the mode-2 sweep."""
    coach, _, _ = trained
    _, cal = tree
    jc = jax_stack
    monkeypatch.setattr(tpipe, "initial_latents", jax_noise)
    cams = [0, 1]
    want = jinf.dtu_generate_camidxs_to_preds(
        jc, jc.trainable, cams, 2, num_denoising_steps=2, seeds=SEEDS,
        eval_placeholder_object_token="<toy>", calibration_dir=str(cal),
        on_missing_ckpt="raise")
    got = tinf.dtu_generate_camidxs_to_preds(
        coach, cams, 2, num_denoising_steps=2, seeds=SEEDS,
        eval_placeholder_object_token="<toy>", calibration_dir=str(cal),
        on_missing_ckpt="raise")
    for cam in cams:
        assert got[cam].shape == (2, 48, 64, 3)
        assert_close_uint8(got[cam], want[cam])


def test_t2i_generalization_sheet_matches_jax(trained, tree, jax_stack,
                                              tmp_path, monkeypatch):
    """eval.do_t2i_generalization on: the round renders the free-text
    sheet (debug: the first prompt over cameras 0 and 1, seed 0). Its
    prediction strip is JAX's sweep of the prompt as the object token at
    the sweep tolerance (assert_close_uint8), its ground-truth strip the
    first scan's images, both at half resolution; the prompt is in the
    log."""
    coach, _, _ = trained
    rect, cal = tree
    jc = jax_stack
    monkeypatch.setattr(tpipe, "initial_latents", jax_noise)
    cfg = copy.deepcopy(coach.cfg)
    cfg.eval.do_t2i_generalization = True
    cfg.log.exp_dir = str(tmp_path)
    handler = ValidationHandler(cfg, calibration_dir=str(cal))
    messages = []
    monkeypatch.setattr(coach.logger, "log_message", messages.append)
    # the per-token sweeps are held above; here they only name their token
    monkeypatch.setattr(handler, "infer_dtu", lambda coach, step, n, **kw:
                        kw["eval_placeholder_object_token"])
    res = handler.infer_mode3(coach, 2, 2)
    assert res == {t: t for t in EVAL_TOKENS}
    sheet = image_io.read_png(
        tmp_path / f"validation-iter_2-denoisesteps_"
                   f"{cfg.eval.num_denoising_steps}_upsample_"
                   f"{cfg.eval.dtu_upsample_key}_imgs_t2i_0.png")
    assert not list(tmp_path.glob("*_imgs_t2i_1.png"))
    prompt = T2I_GENERALIZATION_PROMPTS[0]
    cams = [0, 1]
    want = jinf.dtu_generate_camidxs_to_preds(
        jc, jc.trainable, cams, 2, num_denoising_steps=2, seeds=[0],
        eval_placeholder_object_token=prompt, calibration_dir=str(cal),
        on_missing_ckpt="raise")
    preds = np.concatenate([want[c] for c in cams])
    gts = tinf.dtu_get_gt_images(
        cams, rect / cfg.data.train_data_subsets[0], cfg.data.dtu_lighting,
        cfg.data.dtu_preprocess_key)
    top = make_grid_np(preds, 2)[::2, ::2]
    bottom = make_grid_np(np.stack([gts[c] for c in cams]), 2)[::2, ::2]
    assert sheet.shape == (top.shape[0] + bottom.shape[0], top.shape[1], 3)
    assert_close_uint8(sheet[:top.shape[0]], top)
    np.testing.assert_array_equal(sheet[top.shape[0]:], bottom)
    assert any(m.endswith(f"_imgs_t2i_0.png: {prompt}") for m in messages)


def test_offline_inference_and_summary_on_a_mode3_run(trained, tree,
                                                      tmp_path, monkeypatch):
    """python -m view_neti_tpu_torch.inference on the run at step 2 with
    --debug 1: one sweep per eval token, keyed by token, each bit-equal to
    the round's sweep, each with its own bundle; summarize_dtu on the run
    reads one bundle per token."""
    _, exp, rounds = trained
    _, cal = tree
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    res = tinference.main([
        "--input_dir", str(exp), "--iteration", "2", "--seeds", "[0, 1]",
        "--num_denoising_steps", "2", "--debug", "1", "--torch_dtype",
        "fp32", "--calibration_dir", str(cal), "--inference_dir",
        str(tmp_path)], device="cpu")
    assert sorted(res) == sorted(EVAL_TOKENS)
    for tok in EVAL_TOKENS:
        assert (tmp_path / f"results_all_iter_2-{tok}.msgpack").exists()
        assert (tmp_path / f"preds_iter_2-{tok}_seed0.png").exists()
        for got, want in zip(res[tok]["imgs_pred"],
                             rounds[0][tok]["imgs_pred"]):
            np.testing.assert_array_equal(got, want)
    rows = tsummarize.main(["--results_dirs", str(exp), "--iteration", "2",
                            "--out", str(tmp_path / "s.csv")], device="cpu")
    assert len(rows) == len(EVAL_TOKENS) * 2
    assert sorted({r["bundle"].rsplit("-", 1)[1] for r in rows}) == sorted(
        EVAL_TOKENS)
    rows = tsummarize.main(["--results_dirs", str(tmp_path), "--iteration",
                            "2", "--out", str(tmp_path / "o.csv")],
                           device="cpu")
    assert len(rows) == len(EVAL_TOKENS) * 2
