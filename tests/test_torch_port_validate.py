"""The port's DTU validation, offline inference and summary against the JAX
package, on the CPU at the tiny width (builder.tiny_arch, DTU preprocess
-1: 64x48 images).

A port Coach is built with no training step, and the JAX package's stack
is assembled around the same weights (through the JAX package's own
torch-checkpoint loader, so that nothing on the JAX side is initialised or
compiled but the sweep itself); the port writes the step's mapper files
once, and both sweeps reload them, with the initial noise passed in as
data (JAX's threefry and torch's generators never agree). One tiny port
Coach then trains with validation on, and its bundle feeds the offline
CLI and the summaries.
"""
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu import weight_port as jwp
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.models import view_tokens as jvt
from view_neti_tpu.models.clip_text import NeTICLIPTextEncoder as JCLIP
from view_neti_tpu.models.unet import UNet2DCondition as JUNet
from view_neti_tpu.models.vae import AutoencoderKL as JVAE
from view_neti_tpu.ops import metrics as jmetrics
from view_neti_tpu.schedulers.ddpm import DDPMSchedule as JDDPM
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training import inference_dtu as jinf
from view_neti_tpu.training.text_forward import TextModels as JTextModels
from view_neti_tpu.training.train_step import FrozenModels as JFrozen

from view_neti_tpu_torch import summarize_dtu as tsummarize
from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import dtu as tdtu
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.inference import offline as tinference
from view_neti_tpu_torch.inference import pipeline as tpipe
from view_neti_tpu_torch.ops import metrics as tmetrics
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import inference_dtu as tinf
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.training.validate import ValidationHandler
from view_neti_tpu_torch.utils import msgpack_codec

REPO = Path(__file__).resolve().parents[1]
STEP, SEEDS = 5, [0, 1]


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
    """scan114 with all 49 cameras at 64x48, 64 calibration files, and IDR
    masks for two of the eval cameras (the others fall back to white)."""
    root = tmp_path_factory.mktemp("dtu")
    rect = root / "Rectified" / "scan114"
    cal = root / "Calibration" / "cal18"
    masks = root / "idrmasks" / "scan114" / "mask"
    for d in (rect, cal, masks):
        d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    for i in range(49):
        image_io.write_png(rect / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    for cam in (0, 2):
        m = np.zeros((1200, 1600), np.uint8)
        m[200:1000, 250:1250] = 255
        image_io.write_png(masks / f"{cam:03d}.png", m, filters=0)
    return rect, cal, masks.parents[1]


def config(rect, exp_dir, **changes):
    data = {
        "learnable_mode": 2,
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 32,
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2},
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6,
                 "dtu_preprocess_key": -1, "repeats": 100,
                 "train_data_dir": str(rect), "augmentation_key": 7,
                 "resolution": 16},
        "log": {"exp_dir": str(exp_dir), "save_dataset_images": False,
                "report_to": "none", "save_steps": 10 ** 9},
        "eval": {"validation_seeds": SEEDS, "num_validation_images": 2},
        "optim": {"mixed_precision": "no", "max_train_steps": 0,
                  "gradient_accumulation_steps": 1},
    }
    for section, values in changes.items():
        if isinstance(values, dict):
            data[section].update(values)
        else:
            data[section] = values
    return data


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_stack(tc, jcfg, cal):
    """The JAX package's BuiltModels holding the port Coach's stack: its
    UNet, VAE and CLIP state_dicts through the JAX package's own loader
    (weight_port.port_*), its mappers through to_jax_trainable, the same
    tokenizer growth and view table. The JAX module definitions come from
    tracing their init (jax.eval_shape), so nothing is initialised or
    compiled."""
    tb = tc.built
    arch = jbuilder.tiny_arch()

    def sd(module):
        return {k: v.detach().numpy() for k, v in module.state_dict().items()}

    reports = [jwp.PortReport(n) for n in ("unet", "vae", "clip")]
    unet_p = jwp.port_unet(sd(tb.unet), report=reports[0])
    vae_p = jwp.port_vae(sd(tb.vae), num_blocks=2, report=reports[1])
    clip_p = jwp.port_clip_text(sd(tb.text.clip), num_layers=2,
                                vocab_headroom=0, report=reports[2])
    assert all(not r.missing and not r.unconsumed for r in reports), [
        r.summary() for r in reports]
    trainable, obj_c, view_c = tc.jax_trainable()
    views, objs = tc.placeholder_view_tokens, tc.placeholder_object_tokens
    jtok = JTok(base_vocab_size=512)
    jtok.model_max_length = 16
    jtok.add_tokens(views + objs)
    view_ids = jtok.convert_tokens_to_ids(views)
    obj_ids = jtok.convert_tokens_to_ids(objs)
    assert view_ids + obj_ids == tb.placeholder_token_ids
    defs = {}
    m = jcfg.model

    def trace(kind, num_cond, **kw):
        def init():
            defs[kind], params, consts = jbuilder._init_mapper(
                jcfg, kind, arch, num_cond, **kw)
            return params, consts
        jax.eval_shape(init)

    trace("object", 0, normalize=m.normalize_object_mapper_output,
          output_bypass=m.output_bypass_object,
          bypass_unconstrained=m.bypass_unconstrained_object,
          alpha=m.output_bypass_alpha_object)
    trace("view", 12, normalize=m.normalize_view_mapper_output,
          output_bypass=m.output_bypass_view,
          bypass_unconstrained=m.bypass_unconstrained_view,
          alpha=m.output_bypass_alpha_view, num_view_tokens=len(views))
    table = jvt.build_view_token_table(views, view_ids,
                                       calibration_dir=str(cal))
    text = JTextModels(
        clip=JCLIP(arch.text), clip_vars={"params": clip_p},
        obj_mapper=defs["object"], obj_constants=obj_c,
        view_mapper=defs["view"], view_constants=view_c,
        view_table_ids=jnp.asarray(table.token_ids),
        view_table_params=jnp.asarray(table.params_scaled()),
        obj_norm_scales=jnp.asarray(tb.text.obj_norm_scales.numpy()),
        view_norm_scale=jnp.asarray(float(tb.text.view_norm_scale)))
    frozen = JFrozen(text=text, unet=JUNet(arch.unet),
                     unet_vars={"params": unet_p}, vae=JVAE(arch.vae),
                     vae_vars={"params": vae_p},
                     schedule=JDDPM(prediction_type="epsilon"))
    built = jbuilder.BuiltModels(
        frozen=frozen, trainable=trainable, arch=arch, tokenizer=jtok,
        placeholder_token_ids=view_ids + obj_ids,
        placeholder_object_token_ids=obj_ids,
        placeholder_view_token_ids=view_ids, view_table=table,
        target_norm_object=None, target_norm_view=None)
    return SimpleNamespace(
        cfg=jcfg, built=built, trainable=trainable, tokenizer=jtok,
        placeholder_object_tokens=objs, compute_dtype=jnp.float32,
        logger=SimpleNamespace(log_message=lambda msg: None),
        infer_frozen=lambda: frozen)


@pytest.fixture(scope="module")
def pair(tree, tmp_path_factory):
    """A port Coach with no steps and the JAX package's stack holding the
    same weights, on one config and one exp dir; the step-STEP mapper
    files written by the port, and the live mappers then moved off them on
    both sides (a sweep that does not reload would show it)."""
    rect, cal, _ = tree
    data = config(rect, tmp_path_factory.mktemp("pair"))
    tc = Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
               calibration_dir=str(cal), device="cpu")
    tc.global_step = STEP
    tc._save(f"learned_embeds-steps-{STEP}.msgpack",
             f"mapper-steps-{STEP}.msgpack")
    jc = _jax_stack(tc, jdecode(JRunConfig, data), cal)
    jc.trainable = jax.tree_util.tree_map(lambda a: a + 0.5, jc.trainable)
    with torch.no_grad():
        for p in tc.built.text.view_mapper.parameters():
            p.add_(0.5)
    return jc, tc


def test_dtu_sweep_matches_jax(pair, tree, monkeypatch):
    """Two cameras, two denoising steps, two seeds: the reloaded mappers,
    the view vocabulary extended to every DTU camera, the conditioning, the
    CFG denoise and the decode. uint8 images within +-1 on at most 0.5 %
    of the values, as tests/test_torch_port_pipeline.py holds the slice."""
    jc, tc = pair
    _, cal, _ = tree

    def jax_noise(seeds, h, w, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(s)), (h, w, 4), jnp.float32))
            for s in seeds])).to(device)

    monkeypatch.setattr(tpipe, "initial_latents", jax_noise)
    cams = jinf.get_cam_idxs(6)[0][:2]
    assert cams == tinf.get_cam_idxs(6)[0][:2]
    want = jinf.dtu_generate_camidxs_to_preds(
        jc, jc.trainable, cams, STEP, num_denoising_steps=2, seeds=SEEDS,
        calibration_dir=str(cal), on_missing_ckpt="raise")
    got = tinf.dtu_generate_camidxs_to_preds(
        tc, cams, STEP, num_denoising_steps=2, seeds=SEEDS,
        calibration_dir=str(cal), on_missing_ckpt="raise")
    assert sorted(got) == sorted(want) == sorted(cams)
    for cam in cams:
        assert got[cam].shape == (2, 48, 64, 3) and got[cam].dtype == np.uint8
        diff = np.abs(got[cam].astype(np.int16) - want[cam].astype(np.int16))
        assert diff.max() <= 1, cam
        assert (diff > 0).mean() <= 0.005, cam
    # both extended the view vocabulary to the same ids
    tokens = list(tdtu.dtu_generate_dset_cam_tokens_params(str(cal))[0]
                  .values())
    assert ([tc.tokenizer.convert_tokens_to_ids(t) for t in tokens]
            == [jc.tokenizer.convert_tokens_to_ids(t) for t in tokens])


def test_missing_step_checkpoint_raises_or_warns(pair, tree):
    _, tc = pair
    _, cal, _ = tree
    with pytest.raises(FileNotFoundError, match="mapper-steps-99"):
        tinf.dtu_generate_camidxs_to_preds(
            tc, [0], 99, num_denoising_steps=1, seeds=[0],
            calibration_dir=str(cal), on_missing_ckpt="raise")


def _lpips_pair():
    """JAX's LPIPS from its own init and the port's with those weights."""
    model = jmetrics.LPIPS()
    x = jnp.zeros((1, 16, 16, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    port = tmetrics.LPIPS()
    port.load_state_dict(twp.from_jax_lpips(_np(variables["params"])),
                         strict=True)
    return jax.jit(lambda a, b: model.apply(variables, a, b)), port


def test_result_metrics_match_jax():
    """get_result_metrics_and_grids on the same resized inputs (three
    cameras, one of them a train view, two seeds): every metric mean to
    1e-5 and the grids equal."""
    rng = np.random.RandomState(3)
    gt = rng.rand(3, 30, 40, 3).astype(np.float32)
    pred = np.clip(gt[:, None] + 0.1 * rng.randn(3, 2, 30, 40, 3), 0,
                   1).astype(np.float32)
    masks = np.repeat((rng.rand(3, 30, 40, 1) > 0.3), 3,
                      axis=-1).astype(np.float32)
    plot = np.concatenate([np.zeros((3, 5, 40, 3), np.float32), gt], 1)
    cams, train = [0, 22, 30], [22]
    jl, tl = _lpips_pair()
    want = jinf.get_result_metrics_and_grids(
        cams, train, pred, gt, masks, plot, SEEDS, do_lpips=True,
        lpips_fn=jl)
    got = tinf.get_result_metrics_and_grids(
        cams, train, pred, gt, masks, plot, SEEDS, do_lpips=True,
        lpips_fn=tl, device="cpu")
    keys = [k for k in want if k.endswith("_mean")]
    assert sorted(keys) == sorted(k for k in got if k.endswith("_mean"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for g, w in zip(got["grids"], want["grids"]):
        np.testing.assert_array_equal(g, w)
    assert len(got["figures"]) == 2 and "PSNR: train" in got["figures"][0]


def test_process_imgs_equals_pil():
    """The 300x400 resize (image_io.resize_u8, Pillow's arithmetic) against
    PIL's bicubic in the JAX function, on uint8 predictions, ground truth
    and masks: every array equal."""
    from PIL import Image
    rng = np.random.RandomState(4)
    cams, train = [0, 22], [22]
    preds = {c: rng.randint(0, 256, (2, 48, 64, 3), np.uint8) for c in cams}
    gts = {c: rng.randint(0, 256, (48, 64, 3), np.uint8) for c in cams}
    masks = {c: np.repeat(((rng.rand(96, 128, 1) > 0.5) * 255).astype(
        np.uint8), 3, -1) for c in cams}
    want = jinf.process_imgs(cams, train, preds,
                             {c: Image.fromarray(g) for c, g in gts.items()},
                             {c: Image.fromarray(m) for c, m in masks.items()})
    got = tinf.process_imgs(cams, train, preds, gts, masks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """A tiny port Coach trained 2 steps with validation every 2 steps
    (debug: 2 cameras, 2 denoising steps), the step's checkpoint written
    first. No LPIPS: VGG16 at 300x400 is the one costly metric on the CPU
    (test_result_metrics_match_jax holds it)."""
    rect, cal, masks_root = tree
    exp = tmp_path_factory.mktemp("trained")
    data = config(rect, exp, debug=True,
                  log={"save_steps": 2, "save_dataset_images": True},
                  eval={"validation_steps": 2},
                  optim={"max_train_steps": 2})
    coach = Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
                  calibration_dir=str(cal), device="cpu")
    coach.validator = ValidationHandler(
        coach.cfg, masks_root=str(masks_root), calibration_dir=str(cal))
    rounds = []
    infer = coach.validator.infer

    def record(coach, step):
        rounds.append(infer(coach=coach, step=step))
        return rounds[-1]

    coach.validator.infer = record
    coach.train()
    return coach, exp, rounds


def test_coach_validates_at_its_cadence(trained):
    coach, exp, rounds = trained
    assert len(rounds) == 1
    res = rounds[0]
    bundle = exp / "validation-iter_2-denoisesteps_2_numseeds_2.msgpack"
    assert res["bundle"] == bundle and bundle.exists()
    for name in ("val-dtu-step2-seed0.png", "val-dtu-step2-seed1.png",
                 "val-disentangled-step2.png", "dataset.png"):
        assert (exp / name).exists(), name
    assert res["figures"] == [exp / "val-dtu-step2-seed0.png",
                              exp / "val-dtu-step2-seed1.png"]
    sheet = image_io.read_rgb(exp / "val-dtu-step2-seed0.png")
    # ground truth under its header, prediction, masked, residual
    assert sheet.shape == ((350 + 4) + 3 * (300 + 4), 2 * (400 + 2) + 2, 3)
    log = (exp / "logs" / "log.txt").read_text()
    assert "falling back to LIVE" not in log and "DTU val step 2" in log
    for k in ("mse", "psnr", "ssim"):
        assert np.isfinite(res[f"{k}_test_mean"]), k
    assert res["lpips_test_mean"] == 0 and np.isnan(res["psnr_train_mean"])
    loaded = msgpack_codec.unpackb(bundle.read_bytes())
    assert loaded["imgs_pred"].shape == (2, 2, 300, 400, 3)
    np.testing.assert_array_equal(loaded["seeds"], SEEDS)
    # masks: camera 0 from its file, camera 1 white
    assert 0 < loaded["masks"][0].mean() < 1 and loaded["masks"][1].min() == 1


def test_offline_inference_equals_the_validation_sweep(trained, tree,
                                                       tmp_path,
                                                       monkeypatch):
    """python -m view_neti_tpu_torch.inference on the run at step 2 with
    --debug 1: the same predictions, bit for bit, as the sweep inside
    training (the reference's protocol claim)."""
    _, exp, rounds = trained
    _, cal, masks_root = tree
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    res = tinference.main([
        "--input_dir", str(exp), "--iteration", "2", "--seeds", "[0, 1]",
        "--num_denoising_steps", "2", "--debug", "1", "--torch_dtype",
        "fp32", "--calibration_dir", str(cal), "--masks_root",
        str(masks_root), "--inference_dir", str(tmp_path)], device="cpu")
    assert (tmp_path / "results_all_iter_2.msgpack").exists()
    assert (tmp_path / "preds_iter_2_seed1.png").exists()
    for got, want in zip(res["imgs_pred"], rounds[0]["imgs_pred"]):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tinference.main(["--input_dir", str(exp), "--iteration", "7"],
                        device="cpu")


def _jax_summarize(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_summarize_dtu", REPO / "scripts" / "summarize_dtu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["summarize_dtu.py"] + argv)
    module.main()


def test_summaries_match_jax_and_the_sweep(trained, tmp_path, monkeypatch):
    """The port's bundle scored by the JAX package's scripts/summarize_dtu.py
    and by the port's CLI: the same CSV values (1e-5); the port's per-seed
    means equal the means of the sweep's per-view metrics (1e-6)."""
    import csv
    _, exp, rounds = trained
    args = ["--results_dirs", str(exp), "--iteration", "2"]
    _jax_summarize(args + ["--out", str(tmp_path / "jax.csv")], monkeypatch)
    tsummarize.main(args + ["--out", str(tmp_path / "port.csv")],
                    device="cpu")
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}.csv") as f:
            rows[name] = list(csv.DictReader(f))
    assert len(rows["jax"]) == len(rows["port"]) == 2
    for j, t in zip(rows["jax"], rows["port"]):
        assert (j["scan"], j["bundle"], j["seed"]) == (
            t["scan"], t["bundle"], t["seed"])
        for k in ("mse", "psnr", "ssim", "lpips"):
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    per_view = rounds[0]["per_view"]
    for row in rows["port"]:
        for k in ("mse", "psnr", "ssim", "lpips"):
            np.testing.assert_allclose(
                float(row[k]), per_view[k][int(row["seed"])].mean(),
                rtol=1e-6, err_msg=k)


def test_consecutive_validation_failures_abort(tree, tmp_path):
    """Failures are logged and training goes on; a success resets the
    count; max_validation_failures in a row abort the run."""
    rect, cal, _ = tree
    data = config(rect, tmp_path, eval={"validation_steps": 1,
                                        "max_validation_failures": 2},
                  optim={"max_train_steps": 6})
    coach = Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
                  calibration_dir=str(cal), device="cpu")
    outcomes = iter([False, True, False, False, True, True])
    seen = []

    class Flaky:
        def infer(self, coach, step):
            seen.append(step)
            if not next(outcomes):
                raise OSError(f"disk full at {step}")

    coach.validator = Flaky()
    with pytest.raises(RuntimeError, match="2 consecutive validation"):
        coach.train()
    assert seen == [1, 2, 3, 4] and coach.global_step == 4
    log = (tmp_path / "logs" / "log.txt").read_text()
    assert "1/2 consecutive" in log and "2/2 consecutive" in log
