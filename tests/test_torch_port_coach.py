"""The port's training Coach on the CPU, against the JAX package where the
two meet: the msgpack codec against flax, the checkpoint files in both
directions, the Coach's first batches against the JAX Coach's, and tiny
runs of the Coach (preset 7 with the base cache, augmentation 0 with the
latent cache, true accumulation) and of the train CLI.
"""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from view_neti_tpu.checkpoint import CheckpointHandler as JCheckpoint
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.data.dataset import DataLoader as JDataLoader
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training.coach import Coach as JCoach

from view_neti_tpu_torch import train as ttrain
from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.checkpoint import CheckpointHandler as TCheckpoint
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.dataset import (DataLoader,
                                              TextualInversionDataset)
from view_neti_tpu_torch.data.dtu import dtu_get_train_idxs
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import train_step as tts
from view_neti_tpu_torch.training.coach import Coach, step_seed
from view_neti_tpu_torch.utils import msgpack_codec, profiling


# ---------------------------------------------------------- msgpack ----

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "cfg": {"learnable_mode": 2, "seed": -3, "big": 2 ** 40,
                "lr": 1e-3, "name": "x" * 40, "none": None, "flag": False,
                "seeds": [0, 1, 300, -70000], "nested": {"k": "é"}},
        "mappers": {"view": {
            "params": {"net_dense0": {
                "kernel": rng.randn(14, 64).astype(np.float32),
                "bias": rng.randn(64).astype(np.float32)}},
            "constants": {"fourier_w": rng.randn(32, 14).astype(np.float32)},
            "placeholder_object_token": ""}},
        "view_token_ids": list(range(20)),
        "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
        "scalar": np.float32(2.5), "count": np.int64(7),
        "empty": {}, "none_list": [],
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_codec_reads_and_writes_flax(seed):
    """The codec reads flax's bytes, flax restores the codec's, and both
    write the same bytes for the same tree."""
    tree = _tree(seed)
    flax_bytes = serialization.msgpack_serialize(tree)
    ours = msgpack_codec.packb(tree)
    assert ours == flax_bytes
    _assert_trees_equal(msgpack_codec.unpackb(flax_bytes), tree)
    _assert_trees_equal(serialization.msgpack_restore(ours), tree)


# ----------------------------------------------------- tiny DTU tree ----

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny Coach runs thousands of small ops. Beside the other test
    workers, torch's 8-thread parallel regions spend most of their time
    waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(root, size=(64, 48)):
    """A DTU scan of the six dtu_subset-6 cameras (PNG, written by the
    port) and 64 calibration files, in bench.py:_bench_e2e's layout."""
    rect = root / "dtu" / "Rectified" / "scan114"
    cal = root / "dtu" / "Calibration" / "cal18"
    rect.mkdir(parents=True)
    cal.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    for i in dtu_get_train_idxs(6):
        image_io.write_png(rect / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (size[1], size[0], 3),
                                       np.uint8))
    return rect, cal


def tiny_cfg(rect, exp_dir, **optim):
    """The bench's mode-2 recipe at the tiny width (64x48 DTU preprocess)."""
    return {
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
        "eval": {"validation_prompts": None},
        "optim": dict({"mixed_precision": "no", "max_train_steps": 4},
                      **optim),
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("dtu"))


def _coach(tree, tmp_path, name, **changes):
    rect, cal = tree
    data = tiny_cfg(rect, tmp_path / name)
    for section, values in changes.items():
        data[section].update(values)
    return Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
                 calibration_dir=str(cal), device="cpu")


# ------------------------------------------------------------ batches ----

def test_coach_batches_equal_the_jax_coachs(tree, tmp_path):
    """The first two TrainBatches of the port's Coach and of the JAX
    Coach's _build_batch on the same config (preset 7, the base cache: the
    batch carries image indices). The JAX Coach runs no step."""
    rect, cal = tree
    data = tiny_cfg(rect, tmp_path / "jax")
    jc = JCoach(jdecode(JRunConfig, data), arch=jbuilder.tiny_arch(),
                calibration_dir=str(cal))
    tc = _coach(tree, tmp_path, "port")
    assert tc.use_pixel_cache and jc.use_pixel_cache
    assert tc.micro_batch_size == jc.micro_batch_size == 9
    assert (tc.built.placeholder_view_token_ids
            == jc.built.placeholder_view_token_ids)
    for c in (jc, tc):
        c.train_dataset.skip_pixels = True
    jl = JDataLoader(jc.train_dataset, batch_size=9, seed=0)
    tl = DataLoader(tc.train_dataset, batch_size=9, seed=0)
    for _, jb_np, tb_np in zip(range(2), jl, tl):
        jb = jc._build_batch(jb_np)
        tb = tc._build_batch(tb_np)
        for f in ("pixel_values", "input_ids",
                  "input_ids_placeholder_object",
                  "input_ids_placeholder_view"):
            np.testing.assert_array_equal(
                getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                err_msg=f)
        assert tb.pixel_values.dtype == torch.int64
        assert tb.object_idx == int(jb.object_idx)


# ------------------------------------------------------ checkpoints ----

def _mapper_inputs(n=5):
    t = np.linspace(0, 990, n).astype(np.float32)
    layer = (np.arange(n) % 16).astype(np.float32)
    cam = np.random.RandomState(1).uniform(-1, 1, (n, 12)).astype(np.float32)
    return t, layer, cam


def _jtok():
    from view_neti_tpu.tokenizer import FallbackTokenizer
    return FallbackTokenizer(base_vocab_size=512)


def _slice0(tree):
    return {k: _slice0(v) if isinstance(v, dict) else np.asarray(v)[0]
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_stack(tree, tmp_path_factory):
    """The JAX package's tiny mode-2 stack on the tree's cameras (its
    config, its built models), built once for the checkpoint tests."""
    rect, cal = tree
    views = TextualInversionDataset(
        data_root=rect, tokenizer=None, camera_representation="dtu-12d",
        learnable_mode=2, dtu_subset=6,
        calibration_dir=str(cal)).placeholder_view_tokens
    cfg = jdecode(JRunConfig, tiny_cfg(rect, tmp_path_factory.mktemp("j")))
    return cfg, jbuilder.build_models(cfg, _jtok(), views, ["<>"],
                                      arch=jbuilder.tiny_arch(),
                                      calibration_dir=str(cal))


def _assert_mapper_outputs_match(live, module, variables, key):
    """The port mapper and the JAX module on the same inputs: within 1e-6
    (absolute and relative: the outputs reach |2|, where fp32 steps by
    2.4e-7)."""
    t, layer, cam = _mapper_inputs()
    kwargs = (dict(view_params=jnp.asarray(cam),
                   view_rows=jnp.zeros(5, jnp.int32)) if key == "view"
              else {})
    want = module.apply(variables, jnp.asarray(t), jnp.asarray(layer),
                        **kwargs)
    with torch.no_grad():
        got = live(torch.from_numpy(t), torch.from_numpy(layer),
                   view_params=(torch.from_numpy(cam) if key == "view"
                                else None))
    for name in ("word_embedding", "bypass_output"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_port_checkpoints_load_in_jax(tree, tmp_path, jax_stack):
    """The port's final files load in JAX's CheckpointHandler (load_mapper,
    restore_view_table, load_learned_embeds), and the JAX mapper on the
    reloaded params gives the port mapper's output."""
    _, jb = jax_stack
    coach = _coach(tree, tmp_path, "save", optim={"max_train_steps": 1})
    coach.train()
    run = tmp_path / "save"
    text = jb.frozen.text
    for key, live, module in (
            ("view", coach.built.text.view_mapper, text.view_mapper),
            ("object", coach.built.text.obj_mappers[0], text.obj_mapper)):
        cfg, payload = JCheckpoint.load_mapper(
            run / f"mapper-final_{key}.msgpack")
        assert cfg.learnable_mode == 2
        entry = payload["mappers"]["view" if key == "view" else "<>"]
        _assert_mapper_outputs_match(
            live, module, {"params": entry["params"],
                           "constants": entry["constants"]}, key)
    payload = JCheckpoint.load_raw(run / "mapper-final_view.msgpack")
    table = JCheckpoint.restore_view_table(payload)
    assert table.tokens == tuple(coach.placeholder_view_tokens)
    np.testing.assert_array_equal(table.params_raw,
                                  coach.built.view_table.params_raw)
    assert payload["view_token_ids"] == list(
        coach.built.placeholder_view_token_ids)
    embeds = JCheckpoint.load_learned_embeds(
        run / "learned_embeds-final.msgpack")
    assert set(embeds) == set(coach.placeholder_view_tokens
                              + coach.placeholder_object_tokens)


def test_jax_checkpoints_load_in_the_port(tree, tmp_path, jax_stack):
    """Files the JAX CheckpointHandler writes load through the port's, and
    the port mapper with the reloaded params gives the JAX mapper's
    output."""
    cfg, jb = jax_stack
    text = jb.frozen.text
    views = list(jb.view_table.tokens)
    handler = JCheckpoint(cfg, views, jb.placeholder_view_token_ids, ["<>"],
                          jb.placeholder_object_token_ids, tmp_path)
    handler.save_model(jb.trainable, text.obj_constants, text.view_constants,
                       jb.view_table,
                       np.asarray(text.clip_vars["params"]
                                  ["token_embedding"]),
                       "learned_embeds-steps-1.msgpack",
                       "mapper-steps-1.msgpack")
    coach = _coach(tree, tmp_path, "ref", optim={"max_train_steps": 1})
    for key in ("view", "object"):
        tcfg, payload = TCheckpoint.load_mapper(
            tmp_path / f"mapper-steps-1_{key}.msgpack")
        assert tcfg.learnable_mode == 2 and tcfg.model.arch_view_net == 15
        entry = payload["mappers"]["view" if key == "view" else "<>"]
        live = (coach.built.text.view_mapper if key == "view"
                else coach.built.text.obj_mappers[0])
        live.load_state_dict(twp.from_jax_mapper(entry["params"],
                                                 entry["constants"]),
                             strict=True)
        variables = ({"params": jb.trainable["view"],
                      "constants": text.view_constants} if key == "view"
                     else {"params": _slice0(jb.trainable["object"]),
                           "constants": text.obj_constants})
        module = text.view_mapper if key == "view" else text.obj_mapper
        _assert_mapper_outputs_match(live, module, variables, key)
    table = TCheckpoint.restore_view_table(
        TCheckpoint.load_raw(tmp_path / "mapper-steps-1_view.msgpack"))
    assert table.tokens == tuple(views)
    np.testing.assert_array_equal(table.params_raw, jb.view_table.params_raw)
    embeds = TCheckpoint.load_learned_embeds(
        tmp_path / "learned_embeds-steps-1.msgpack")
    assert set(embeds) == set(views + ["<>"])


def test_coach_mode4_starts_from_a_saved_view_mapper(tree, tmp_path):
    """Mode 4 loads model.pretrained_view_mapper, a view checkpoint of the
    port's, into its view mapper before training."""
    src = _coach(tree, tmp_path, "src")
    with torch.no_grad():
        for p in src.built.text.view_mapper.parameters():
            p.add_(0.5)
    src._save("learned_embeds-final.msgpack", "mapper-final.msgpack")
    rect, cal = tree
    data = tiny_cfg(rect, tmp_path / "m4")
    data["learnable_mode"] = 4
    data["model"]["pretrained_view_mapper"] = str(
        tmp_path / "src" / "mapper-final_view.msgpack")
    coach = Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
                  calibration_dir=str(cal), device="cpu")
    want = src.built.text.view_mapper.state_dict()
    got = coach.built.text.view_mapper.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_to_jax_trainable_inverts_from_jax_trainable(tree, tmp_path):
    coach = _coach(tree, tmp_path, "inv", optim={"max_train_steps": 1})
    trainable, obj_c, view_c = coach.jax_trainable()
    back = twp.from_jax_trainable(trainable, obj_c, view_c)
    for got, live in ((back["view"], coach.built.text.view_mapper),
                      (back["object"][0], coach.built.text.obj_mappers[0])):
        sd = live.state_dict()
        assert got.keys() == sd.keys()
        for k in sd:
            assert torch.equal(got[k], sd[k]), k


# --------------------------------------------------------- tiny runs ----

def test_coach_preset7_with_base_cache_runs_saves_and_prunes(tree,
                                                             tmp_path):
    """Mode 2, preset 7 on the card's path (the uint8 base cache, indices
    in the batch): 4 finite steps, the JAX package's file names, and
    checkpoints_total_limit keeping the newest step checkpoint."""
    coach = _coach(tree, tmp_path, "run",
                   log={"save_steps": 2, "checkpoints_total_limit": 1})
    assert coach.augment_spec is not None and coach.use_pixel_cache
    out = coach.train()
    assert out["steps"] == 4 and np.isfinite(out["final_loss"])
    assert len(coach.losses) == 4 and all(np.isfinite(coach.losses))
    assert coach.built.pixel_cache.dtype == torch.uint8
    assert tuple(coach.built.pixel_cache.shape) == (6, 48, 64, 3)
    files = sorted(p.name for p in (tmp_path / "run").glob("*.msgpack"))
    assert files == sorted([
        "learned_embeds-final.msgpack", "learned_embeds-steps-4.msgpack",
        "mapper-final_object.msgpack", "mapper-final_view.msgpack",
        "mapper-steps-4_object.msgpack", "mapper-steps-4_view.msgpack"])
    assert (tmp_path / "run" / "config.yaml").exists()
    assert (tmp_path / "run" / "logs" / "log.txt").exists()


def test_coach_aug0_uses_the_latent_cache(tree, tmp_path):
    coach = _coach(tree, tmp_path, "lat", data={"augmentation_key": 0},
                   optim={"max_train_steps": 2})
    assert coach.cache_latents and coach.augment_spec is None
    out = coach.train()
    assert out["steps"] == 2 and all(np.isfinite(coach.losses))
    cache = coach.built.pixel_cache
    assert cache.dtype == torch.float32 and tuple(cache.shape) == (
        6, 24, 32, 8)


def test_coach_true_accumulation_matches_the_fused_batch(tree, tmp_path):
    """fuse_accumulation false, k = 3: three micro-batches of 3 with the
    fused batch's draws give the fused batch's update (fp32, 1e-5 of the
    largest gradient; the parameters within 2e-2 lr where |g| is not
    tiny, as tests/test_torch_port_train.py holds them)."""
    no_drop = {"use_nested_dropout": False}
    fused = _coach(tree, tmp_path, "fused", model=no_drop)
    split = _coach(tree, tmp_path, "split", model=no_drop,
                   optim={"fuse_accumulation": False})
    assert (fused.micro_batch_size, fused.accum_k) == (9, 1)
    assert (split.micro_batch_size, split.accum_k) == (3, 3)
    for c in (fused, split):
        c.train_dataset.skip_pixels = True
        c._fill_base_cache()
    batch = fused._build_batch(next(iter(DataLoader(fused.train_dataset,
                                                    9))))
    draws = fused._step_draws(0, batch)
    fused.train_step(fused.built, batch, draws)

    def part(x, i):
        return x[3 * i:3 * i + 3]

    for i in range(3):
        sub = dataclasses.replace(
            batch, **{f: part(getattr(batch, f), i)
                      for f in ("pixel_values", "input_ids",
                                "input_ids_placeholder_object",
                                "input_ids_placeholder_view")})
        sub_draws = tts.StepDraws(
            vae_eps=part(draws.vae_eps, i), noise=part(draws.noise, i),
            timesteps=part(draws.timesteps, i),
            augment=type(draws.augment)(**{
                f.name: part(getattr(draws.augment, f.name), i)
                for f in dataclasses.fields(draws.augment)}))
        split.train_step(split.built, sub, sub_draws)
        if i < 2:   # the optimizer steps only at the window's end
            assert split.optimizer.counts["view"] == [0]
    assert split.optimizer.counts == fused.optimizer.counts == {
        "object": [1], "view": [1]}
    lr = fused.lr_schedule(1)
    for key in ("view", "object"):
        a = (fused.built.text.view_mapper if key == "view"
             else fused.built.text.obj_mappers[0])
        b = (split.built.text.view_mapper if key == "view"
             else split.built.text.obj_mappers[0])
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            g = pa.grad.abs()
            torch.testing.assert_close(pb.grad, pa.grad, rtol=0,
                                       atol=1e-5 * g.max().item())
            big = g > 1e-3 * g.max()
            diff = (pa.detach() - pb.detach()).abs()
            assert big.float().mean() > 0.5, name
            assert diff[big].max() <= 2e-2 * lr, (key, name)
            assert diff.max() <= 2 * lr + 1e-6, (key, name)


def test_coach_true_accumulation_loop_counts_optimizer_steps(tree,
                                                             tmp_path):
    coach = _coach(tree, tmp_path, "acc",
                   optim={"fuse_accumulation": False, "max_train_steps": 2})
    coach.train()
    # one coach.step span (one window_step call) an optimizer step of
    # three micro-batches
    steps = profiling.within(coach.loop_span, "coach.step")
    feeds = profiling.within(coach.loop_span, "coach.feed")
    assert coach.global_step == 2 and len(steps) == len(feeds) == 2
    assert len(coach.losses) == 2


def test_step_seeds_depend_on_the_position_only():
    seeds = {step_seed(0, m) for m in range(1000)}
    assert len(seeds) == 1000 and max(seeds) < 2 ** 63
    assert step_seed(0, 5) == step_seed(0, 5) != step_seed(1, 5)


def test_train_cli_runs_two_steps(tree, tmp_path, monkeypatch):
    """python -m view_neti_tpu_torch.train on input_configs/train.yaml with
    dot-overrides and the miniature stack, on the CPU."""
    rect, cal = tree
    # the scan with the ground truth of the debug sweep's two cameras
    scan = tmp_path / "scan114"
    shutil.copytree(rect, scan)
    for i in (0, 1):
        image_io.write_png(scan / f"rect_{i + 1:03d}_3_r5000.png",
                           np.full((48, 64, 3), 60 * (i + 1), np.uint8))
    monkeypatch.setenv("VIEW_NETI_TINY", "1")
    monkeypatch.setenv("DTU_CALIBRATION_DIR", str(cal))
    monkeypatch.delenv("SD_WEIGHTS_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = ttrain.main([
        "--config_path", os.path.join(root, "input_configs", "train.yaml"),
        "--log.exp_dir", str(tmp_path), "--log.report_to", "none",
        "--data.train_data_dir", str(scan), "--data.dtu_subset", "6",
        "--optim.max_train_steps", "2",
        "--model.pretrained_model_name_or_path",
        "runwayml/stable-diffusion-v1-5", "--debug", "true",
        "--eval.validation_steps", "2", "--log.save_steps", "2"],
        device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    run = tmp_path / "train"
    assert (run / "mapper-final_view.msgpack").exists()
    # the CLI validates: one debug sweep (2 cameras, 2 steps) at step 2,
    # on the step's checkpoint
    assert (run / "validation-iter_2-denoisesteps_2_numseeds_2"
                  ".msgpack").exists()
    log = (run / "logs" / "log.txt").read_text()
    assert "DTU val step 2" in log and "falling back to LIVE" not in log
    with pytest.raises(FileExistsError):
        ttrain.main(["--config_path",
                     os.path.join(root, "input_configs", "train.yaml"),
                     "--log.exp_dir", str(tmp_path)], device="cpu")
