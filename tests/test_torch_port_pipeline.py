"""The serving slice of view_neti_tpu_torch against the JAX package.

One tiny mode-2 stack (builder.tiny_arch, a seeded synthetic DTU
calibration, FallbackTokenizer(base_vocab_size=512)) is built by the JAX
package and carried across to the port with weight_port.from_jax_*. Both
then run the same prompt and the same numpy initial latents through
conditioning, 3 DPM-Solver++ CFG steps and the fused VAE decode to uint8
(the JAX decode runs the Pallas kernel in interpret mode).
Also here: the entry points refuse to run without a card unless asked for
the CPU, and the port imports nothing of JAX.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu.config import RunConfig as JRunConfig, decode
from view_neti_tpu.data import dtu as jdtu
from view_neti_tpu.inference.pipeline import _decode_jit
from view_neti_tpu.inference.pipeline import encode_uncond as j_encode_uncond
from view_neti_tpu.inference.pipeline import make_denoise_fn as j_make_denoise
from view_neti_tpu.inference.prompt_manager import PromptManager as JPM
from view_neti_tpu.schedulers.dpm_solver import DPMSolverSchedule as JDPM
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training.text_forward import (
    neti_text_conditioning as j_conditioning)

from view_neti_tpu_torch import summarize_dtu
from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import ModelConfig, RunConfig, encode
from view_neti_tpu_torch.inference import offline
from view_neti_tpu_torch.inference import pipeline as tpipe
from view_neti_tpu_torch.inference.prompt_manager import PromptManager
from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
from view_neti_tpu_torch.tokenizer import FallbackTokenizer
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training.text_forward import neti_text_conditioning
from view_neti_tpu_torch.utils import msgpack_codec

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(arch_view_net=15, arch_view_disable_tl=False,
             word_embedding_dim=32, normalize_view_mapper_output=True,
             output_bypass_alpha_view=5.0, pe_sigma_exp_key=2)
DATA = dict(camera_representation="dtu-12d", dtu_subset=6)
STEPS, HEIGHT, WIDTH = 3, 48, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calibration(tmp):
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        (tmp / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    return [jdtu.dtu_cam_params_to_token(
        rng.randn(3, 4).astype(np.float32) * 100, i)
        for i in jdtu.dtu_get_train_idxs(6)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    cal = tmp_path_factory.mktemp("cal")
    view_tokens = _calibration(cal)
    jcfg = decode(JRunConfig, {"learnable_mode": 2, "model": MODEL,
                               "data": DATA})
    jtok = JTok(base_vocab_size=512)
    jb = jbuilder.build_models(jcfg, jtok, view_tokens, ["<skull>"],
                               arch=jbuilder.tiny_arch(),
                               calibration_dir=str(cal))
    cfg = RunConfig(learnable_mode=2, model=ModelConfig(**MODEL))
    tok = FallbackTokenizer(base_vocab_size=512)
    tb = tbuilder.build_models(cfg, tok, view_tokens, ["<skull>"],
                               arch=tbuilder.tiny_arch(),
                               calibration_dir=str(cal), device="cpu")
    assert tb.placeholder_token_ids == jb.placeholder_token_ids

    # carry every weight and constant of the JAX stack across
    fz, text = jb.frozen, jb.frozen.text
    tb.text.clip.load_state_dict(twp.from_jax_clip_text(
        _np(text.clip_vars["params"]), num_layers=2), strict=True)
    tb.unet.load_state_dict(twp.from_jax_unet(_np(fz.unet_vars["params"])),
                            strict=True)
    tb.vae.load_state_dict(twp.from_jax_vae(_np(fz.vae_vars["params"]),
                                            num_blocks=2), strict=True)
    obj = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                 jb.trainable["object"])
    tb.text.obj_mappers[0].load_state_dict(twp.from_jax_mapper(
        obj, _np(text.obj_constants)), strict=True)
    tb.text.view_mapper.load_state_dict(twp.from_jax_mapper(
        _np(jb.trainable["view"]), _np(text.view_constants)), strict=True)
    tb.text.obj_norm_scales = torch.tensor(np.array(text.obj_norm_scales))
    tb.text.view_norm_scale = torch.tensor(float(text.view_norm_scale))
    np.testing.assert_array_equal(tb.text.view_table_params.numpy(),
                                  np.asarray(text.view_table_params))
    return jb, jtok, tb, tok, view_tokens


def test_text_conditioning_matches_jax(stacks):
    jb, jtok, tb, tok, view_tokens = stacks
    prompts = [f"{view_tokens[1]}. A photo of a <skull>",
               "<skull> on a beach", f"{view_tokens[4]}. a dog"]
    ids = np.asarray(jtok(prompts, padding="max_length", truncation=True,
                          max_length=16).input_ids)
    ph_obj = np.where((ids == jb.placeholder_object_token_ids[0]).any(1),
                      jb.placeholder_object_token_ids[0], -1).astype(np.int32)
    vids = np.asarray(jb.placeholder_view_token_ids)
    ph_view = np.array([next((t for t in row if t in vids), -1)
                        for row in ids], np.int32)
    ts = np.array([999.0, 500.0, 21.0], np.float32)
    jc, jcb = j_conditioning(jb.frozen.text, jb.trainable, jnp.asarray(ids),
                             jnp.asarray(ph_obj), jnp.asarray(ph_view),
                             jnp.asarray(ts), jnp.asarray(0, jnp.int32))
    tc, tcb = neti_text_conditioning(
        tb.text, torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(ph_obj.astype(np.int64)),
        torch.from_numpy(ph_view.astype(np.int64)), torch.from_numpy(ts))
    assert tc.shape == (16, 3, 16, 32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), atol=1e-4,
                               rtol=1e-4)


def test_slice_matches_jax(stacks):
    """Contexts to 1e-4, final latents to 1e-3, uint8 images equal except
    +-1 on at most 0.5% of the values."""
    jb, jtok, tb, tok, view_tokens = stacks
    prompt = f"{view_tokens[0]}. A photo of a <skull>"
    jfz = jbuilder.fuse_for_inference(jb.frozen)
    jsched = JDPM()
    jpm = JPM(jtok, jfz.text, jb.trainable, jsched.set_timesteps(STEPS),
              placeholder_view_token_ids=jb.placeholder_view_token_ids,
              placeholder_object_token_ids=jb.placeholder_object_token_ids)
    jctx, jctxb = jpm.embed_prompt(prompt)
    junc = j_encode_uncond(jfz.text.clip, jfz.text.clip_vars, jtok)

    sched = DPMSolverSchedule()
    pm = PromptManager(tok, tb.text, sched.set_timesteps(STEPS),
                       tb.placeholder_view_token_ids,
                       tb.placeholder_object_token_ids)
    ctx, ctxb = pm.embed_prompt(prompt)
    unc = tpipe.encode_uncond(tb.text.clip, tok)
    assert ctx.shape == (STEPS, 16, 1, 16, 32)
    for got, want in ((ctx, jctx), (ctxb, jctxb), (unc, junc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)

    lat0 = np.random.RandomState(5).randn(3, HEIGHT // 2, WIDTH // 2,
                                          4).astype(np.float32)
    jlat = j_make_denoise(jfz.unet, None, jsched, STEPS, 7.5)(
        jnp.asarray(lat0), jfz.unet_vars, jctx, jctxb, junc)
    jimg = np.asarray(_decode_jit(jfz.vae, jfz.vae_vars, jlat))

    vae = tbuilder.fuse_for_inference(tb.vae)
    lat = tpipe.make_denoise_fn(tb.unet, sched, STEPS, 7.5)(
        torch.from_numpy(lat0), ctx, ctxb, unc)
    img = tpipe.decode_to_uint8(vae, lat).numpy()
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=1e-3,
                               rtol=1e-3)
    assert img.shape == jimg.shape == (3, HEIGHT, WIDTH, 3)
    assert img.dtype == np.uint8
    diff = np.abs(img.astype(np.int16) - jimg.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


def test_generate_on_cpu_when_asked(stacks):
    _, _, tb, tok, view_tokens = stacks
    sched = DPMSolverSchedule()
    pm = PromptManager(tok, tb.text, sched.set_timesteps(2),
                       tb.placeholder_view_token_ids,
                       tb.placeholder_object_token_ids)
    ctx, ctxb = pm.embed_prompt(f"{view_tokens[2]}. A photo of a <skull>")
    imgs = tpipe.generate(tb.unet, tb.vae, sched, ctx, ctxb,
                          tpipe.encode_uncond(tb.text.clip, tok), 32, 48,
                          [0, 1], num_inference_steps=2, device="cpu")
    assert imgs.shape == (2, 32, 48, 3) and imgs.dtype == np.uint8
    # seed s gives the same latents in any batch
    a = tpipe.initial_latents([3, 4], 4, 5, torch.device("cpu"))
    b = tpipe.initial_latents([4], 4, 5, torch.device("cpu"))
    torch.testing.assert_close(a[1:], b, rtol=0, atol=0)


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, stacks,
                                                  tmp_path):
    """device=None means the card: with none present the entry points
    raise instead of carrying on on the CPU."""
    _, _, tb, tok, _ = stacks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig(learnable_mode=0, model=ModelConfig(word_embedding_dim=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuilder.build_models(cfg, FallbackTokenizer(base_vocab_size=512), [],
                              ["<thing>"], arch=tbuilder.tiny_arch())
    ctx = torch.zeros(1, 16, 1, 16, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.generate(tb.unet, tb.vae, DPMSolverSchedule(), ctx, ctx,
                       ctx[0, 0], 16, 16, [0], num_inference_steps=1)
    # the offline inference and summary CLIs, on a run's checkpoint
    (tmp_path / "mapper-steps-1_view.msgpack").write_bytes(
        msgpack_codec.packb({"cfg": encode(cfg), "mappers": {}}))
    with pytest.raises(RuntimeError, match="CUDA"):
        offline.main(["--input_dir", str(tmp_path), "--iteration", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        summarize_dtu.main(["--results_dirs", str(tmp_path), "--iteration",
                            "1", "--out", str(tmp_path / "s.csv")])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, and prints no result line, where no
    card is present and where it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "view_neti_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "flax", "view_neti_tpu", "transformers", "yaml", "PIL",
              "safetensors", "matplotlib", "pandas", "msgpack")
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in banned, f"{f.relative_to(REPO)} imports {name}"
