"""Mode 3 of the port (one view mapper over several DTU scans, one object
mapper per scan) against the JAX package, on the CPU at the tiny width
(builder.tiny_arch, DTU preprocess -1: 64x48 images).

The grouped loader's stream, the grouped conditioning and the grouped
train step are held against the JAX package's, with the nested-dropout
draws that JAX takes from its keys passed to the port as data (the JAX
stack is assembled around a port Coach's weights, as
tests/test_torch_port_validate.py does); the fused and unfused mode-3 Coach
run as tests/test_mode3_fused.py runs the JAX one. The mode-3 validation
round is in tests/test_torch_port_mode3_validate.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from view_neti_tpu.checkpoint import CheckpointHandler as JCheckpoint
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.data.dataset import DataLoader as JDataLoader
from view_neti_tpu.data.dataset import \
    TextualInversionDataset as JDataset
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training import optim as joptim
from view_neti_tpu.training.coach import Coach as JCoach
from view_neti_tpu.training.text_forward import \
    neti_text_conditioning as j_conditioning
from view_neti_tpu.training.train_step import TrainBatch as JBatch
from view_neti_tpu.training.train_step import make_train_step as j_make_step

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.checkpoint import CheckpointHandler as TCheckpoint
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.dataset import (DataLoader,
                                              TextualInversionDataset)
from view_neti_tpu_torch.data.dtu import dtu_get_train_idxs
from view_neti_tpu_torch.tokenizer import FallbackTokenizer
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.training.text_forward import (
    _object_pass, neti_text_conditioning)

from test_torch_port_validate import _jax_stack

SCANS = ("scan65", "scan125", "scan7", "scan105")
TOKENS = ["<skull>", "<statue>", "<statue2>", "<toy>"]
EVAL_TOKENS = ["<skull>", "<statue>", "<toy>"]
SEEDS = [0, 1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: on one thread they do not wait for cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(root):
    """Four scans of the dtu_subset-3 cameras and of the debug sweep's
    cameras 0 and 1 (each scan's images at its own brightness, so that a
    ground truth read from the wrong scan shows), 64x48 PNGs written by
    the port, and 64 calibration files."""
    rect = root / "dtu" / "Rectified"
    cal = root / "dtu" / "Calibration" / "cal18"
    cal.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    for s, scan in enumerate(SCANS):
        (rect / scan).mkdir(parents=True)
        for i in dtu_get_train_idxs(3) + [0, 1]:
            img = rng.randint(0, 60, (48, 64, 3)) + 60 * s
            image_io.write_png(rect / scan / f"rect_{i + 1:03d}_3_r5000.png",
                               img.astype(np.uint8))
    return rect, cal


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("m3"))


def config(rect, exp_dir, **changes):
    """A tiny mode-3 run on the tree: the four scans and tokens of
    input_configs/train_m3.yaml, preset 5, 3 x 3 fused."""
    data = {
        "learnable_mode": 3,
        "data": {"train_data_dir": str(rect),
                 "train_data_subsets": list(SCANS),
                 "placeholder_object_tokens": TOKENS,
                 "super_category_object_tokens": ["object"] * 4,
                 "camera_representation": "dtu-12d", "dtu_subset": 3,
                 "dtu_preprocess_key": -1, "repeats": 4, "resolution": 16,
                 "augmentation_key": 5},
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 32,
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2,
                  "use_nested_dropout": False},
        "log": {"exp_dir": str(exp_dir), "save_dataset_images": False,
                "report_to": "none", "save_steps": 10 ** 9},
        "eval": {"validation_prompts": None,
                 "eval_placeholder_object_tokens": EVAL_TOKENS,
                 "validation_seeds": SEEDS, "num_validation_images": 2},
        "optim": {"mixed_precision": "no", "max_train_steps": 2,
                  "train_batch_size": 3, "gradient_accumulation_steps": 3},
    }
    for section, values in changes.items():
        if isinstance(values, dict):
            data[section].update(values)
        else:
            data[section] = values
    return data


def _coach(tree, exp_dir, **changes):
    rect, cal = tree
    return Coach(decode(RunConfig, config(rect, exp_dir, **changes)),
                 arch=tbuilder.tiny_arch(), calibration_dir=str(cal),
                 device="cpu")


# ------------------------------------------------------------ stream ----

def _datasets(tree, repeats):
    rect, cal = tree
    kw = dict(data_root=rect, camera_representation="dtu-12d",
              learnable_mode=3, train_data_subsets=list(SCANS),
              placeholder_object_tokens=TOKENS, dtu_subset=3,
              dtu_preprocess_key=-1, repeats=repeats,
              calibration_dir=str(cal), seed=5)
    out = []
    for cls, tok in ((JDataset, JTok(base_vocab_size=512)),
                     (TextualInversionDataset,
                      FallbackTokenizer(base_vocab_size=512))):
        ds = cls(tokenizer=tok, **kw)
        tok.add_tokens(ds.placeholder_tokens)
        ds.skip_pixels = True
        out.append(ds)
    return out


def _stream(loader, n):
    batches = []
    while len(batches) < n:
        for b in loader:
            batches.append(b)
            if len(batches) == n:
                break
    return batches


@pytest.mark.parametrize("group", [3, None])
def test_grouped_stream_equals_jax(tree, group):
    """Six batches of 9 (an epoch is two: the stream crosses two epoch
    boundaries) from the JAX DataLoader and the port's on the same four
    scans, grouped 3 x 3 and ungrouped: the same image paths, captions,
    ids, scenes (object_idx (3,) per group, or one per batch), exactly;
    and a loader started at batch 3 replays the stream from there."""
    jds, tds = _datasets(tree, repeats=2)
    assert [str(p) for p in tds.image_paths_flattened] == [
        str(p) for p in jds.image_paths_flattened]
    assert tds.placeholder_view_tokens == jds.placeholder_view_tokens
    assert tds._subset_offsets == jds._subset_offsets
    want = _stream(JDataLoader(jds, 9, seed=5, group_size=group), 6)
    got = _stream(DataLoader(tds, 9, seed=5, group_size=group), 6)
    scenes = set()
    for w, g in zip(want, got):
        for k in ("input_ids", "input_ids_placeholder_object",
                  "input_ids_placeholder_view", "image_idxs", "object_idx"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        assert g["texts"] == w["texts"]
        assert g["object_idx"].shape == ((3,) if group else ())
        scenes.update(np.atleast_1d(g["object_idx"]).tolist())
        # every prompt of a group names its group's scene's token
        per = 3 if group else 9
        for i, text in enumerate(g["texts"]):
            scene = int(np.atleast_1d(g["object_idx"])[i // per])
            assert text.endswith(TOKENS[scene])
            path = tds.image_paths_flattened[g["image_idxs"][i]]
            assert path.parent.name == SCANS[scene]
    assert len(scenes) >= 2
    resumed = _stream(DataLoader(tds, 9, seed=5, group_size=group,
                                 start_batch=3), 3)
    for w, g in zip(got[3:], resumed):
        np.testing.assert_array_equal(g["image_idxs"], w["image_idxs"])
        np.testing.assert_array_equal(g["object_idx"], w["object_idx"])


def test_indivisible_group_size_rejected(tree):
    _, tds = _datasets(tree, repeats=2)
    with pytest.raises(ValueError, match="not a multiple"):
        DataLoader(tds, 5, group_size=2)
    jds, _ = _datasets(tree, repeats=2)
    with pytest.raises(AssertionError):
        JDataLoader(jds, 5, group_size=2)


# ----------------------------------------- conditioning and the step ----

MODEL = dict(arch_view_net=15, arch_view_disable_tl=False,
             word_embedding_dim=32, normalize_view_mapper_output=True,
             output_bypass_alpha_view=5.0, pe_sigma_exp_key=2,
             use_nested_dropout=True)
B, G, IMG, LR = 6, 3, 16, 1e-3
IDLE = ("object1", "object3")
OBJECT_IDX = [2, 0, 2]      # slices 1 and 3 idle, slice 2 in two groups


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks(tree, tmp_path_factory):
    """A tiny mode-3 port Coach (a bank of four object mappers and the
    view mapper, nested dropout on) and the JAX package's stack assembled
    around its weights (tests/test_torch_port_validate.py::_jax_stack),
    and one grouped batch for each: 3 groups of 2, group g's prompts
    naming object OBJECT_IDX[g]."""
    rect, cal = tree
    data = config(rect, tmp_path_factory.mktemp("stacks"),
                  model={"use_nested_dropout": True})
    tc = Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
               calibration_dir=str(cal), device="cpu")
    jc = _jax_stack(tc, jdecode(JRunConfig, data), cal)
    tb = tc.built
    rng = np.random.RandomState(0)
    tok = tc.tokenizer
    ids = np.full((B, 16), tok.eos_token_id, np.int64)
    ids[:, 0] = tok.bos_token_id
    view_ids = np.asarray(tb.placeholder_view_token_ids)[[0, 1, 2, 0, 1, 2]]
    obj_ids = np.asarray(tb.placeholder_object_token_ids)[
        np.repeat(OBJECT_IDX, B // G)]
    ids[:, 1] = view_ids
    ids[:, 2:7] = 100
    ids[:, 7] = obj_ids
    pixels = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    jbatch = JBatch(pixel_values=jnp.asarray(pixels),
                    input_ids=jnp.asarray(ids, jnp.int32),
                    input_ids_placeholder_object=jnp.asarray(obj_ids,
                                                             jnp.int32),
                    input_ids_placeholder_view=jnp.asarray(view_ids,
                                                           jnp.int32),
                    object_idx=jnp.asarray(OBJECT_IDX, jnp.int32))
    tbatch = tts.TrainBatch(
        pixel_values=torch.from_numpy(pixels),
        input_ids=torch.from_numpy(ids),
        input_ids_placeholder_object=torch.from_numpy(obj_ids),
        input_ids_placeholder_view=torch.from_numpy(view_ids),
        object_idx=torch.tensor(OBJECT_IDX))
    return jc.built, tb, jbatch, tbatch


def _mapper_draws(module, key, rows, dim, prob):
    """The nested-dropout draws a JAX mapper takes from rngs={"dropout":
    key} (neti_mapper.py _nested_dropout): its make_rng("dropout"), split
    into a Bernoulli and a randint key."""
    k = module.apply({}, method=lambda m: m.make_rng("dropout"),
                     rngs={"dropout": key})
    k_apply, k_idx = jax.random.split(k)
    return (torch.tensor(np.asarray(
                jax.random.bernoulli(k_apply, prob, (rows,)))),
            torch.tensor(np.asarray(
                jax.random.randint(k_idx, (rows,), 0, dim)).astype(np.int64)))


def jax_conditioning_draws(jb, tb, rng):
    """The draws of JAX's neti_text_conditioning(rng=rng, train=True) for
    a grouped batch, in the port's layout: the object draws of group g
    (from fold_in(rng_o, g), 16 * B / G rows) one group after another, the
    view draws (from rng_v) for all 16 * B rows."""
    rng_o, rng_v = jax.random.split(rng)
    text = jb.frozen.text
    om, vm = tb.text.obj_mappers[0], tb.text.view_mapper
    n = 16 * B // G
    parts = [_mapper_draws(text.obj_mapper, jax.random.fold_in(rng_o, g), n,
                           om.hidden_dim, om.nested_dropout_prob)
             for g in range(G)]
    obj = tuple(torch.cat([p[i] for p in parts]) for i in range(2))
    view = _mapper_draws(text.view_mapper, rng_v, 16 * B, vm.hidden_dim,
                         vm.nested_dropout_prob)
    return {"object": obj, "view": view}


def test_grouped_conditioning_matches_jax(stacks):
    """JAX's neti_text_conditioning with a (G,) object_idx and its dropout
    key, and the port's with those draws passed in: the context and the
    bypass context to 1e-5 (fp32 CLIP in another summation order). Then
    the port's grouped call against one call per group: the object
    mapper's rows (gathered, mapped, scattered back) exactly, the
    conditioning to 1e-5 (the CLIP pass runs on a third of the rows)."""
    jb, tb, jbatch, tbatch = stacks
    ts = np.array([3, 999, 250, 517, 10, 700], np.int64)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda text, tr, b, t, k: j_conditioning(
        text, tr, b.input_ids, b.input_ids_placeholder_object,
        b.input_ids_placeholder_view, t, object_idx=b.object_idx, rng=k,
        train=True))(jb.frozen.text, jb.trainable, jbatch, jnp.asarray(ts),
                     key)
    draws = jax_conditioning_draws(jb, tb, key)
    args = (tbatch.input_ids, tbatch.input_ids_placeholder_object,
            tbatch.input_ids_placeholder_view, torch.from_numpy(ts))
    with torch.no_grad():
        got = neti_text_conditioning(tb.text, *args,
                                     object_idx=tbatch.object_idx,
                                     train=True, draws=draws)
    for g, w in zip(got, want):
        assert g.shape == (16, B, 16, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # a scalar index and a grouped one with one group agree exactly
    with torch.no_grad():
        one = neti_text_conditioning(tb.text, *args, object_idx=1)
        grouped_one = neti_text_conditioning(tb.text, *args,
                                             object_idx=torch.tensor([1]))
        ctx = neti_text_conditioning(tb.text, *args,
                                     object_idx=tbatch.object_idx)
        K, bs = 16, B // G
        t_k = torch.from_numpy(ts).float().repeat(K)
        l_k = torch.arange(K).float().repeat_interleave(B)
        _, rows, bypass = _object_pass(tb.text, tbatch.object_idx, t_k, l_k,
                                       K, B, None, None)
        for g, idx in enumerate(OBJECT_IDX):
            sl = slice(g * bs, (g + 1) * bs)
            part = neti_text_conditioning(
                tb.text, *(a[sl] for a in args), object_idx=idx)
            for a, b in zip(ctx, part):
                torch.testing.assert_close(a[:, sl], b, rtol=1e-5,
                                           atol=1e-5)

            def take(x):
                return x.reshape(K, G, bs)[:, g].reshape(-1)

            _, w1, b1 = _object_pass(tb.text, idx, take(t_k), take(l_k), K,
                                     bs, None, None)
            assert torch.equal(rows.reshape(K, B, -1)[:, sl],
                               w1.reshape(K, bs, -1))
            assert torch.equal(bypass.reshape(K, B, -1)[:, sl],
                               b1.reshape(K, bs, -1))
    for a, b in zip(one, grouped_one):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def trajectories(stacks):
    """Three grouped steps on both stacks from the same weights and draws:
    the loss, the mapper gradients and the parameters after each."""
    jb, tb, jbatch, tbatch = stacks
    text = jb.frozen.text
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    sched = joptim.make_lr_schedule("constant", LR, 0, 10)
    chain = optax.chain(record, joptim.sliced_adamw(sched))
    jstep = jax.jit(j_make_step(chain))
    trainable, jstate = jb.trainable, chain.init(jb.trainable)
    opt = toptim.SlicedAdamW(tbuilder.trainable_groups(tb),
                             toptim.make_lr_schedule("constant", LR, 0, 10))
    tstep = tts.make_train_step(opt)
    mappers = {f"object{i}": m for i, m in enumerate(tb.text.obj_mappers)}
    mappers["view"] = tb.text.view_mapper
    start = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
             for k, m in mappers.items()}

    def port_tree(tree):
        sds = twp.from_jax_trainable(_np(tree), _np(text.obj_constants),
                                     _np(text.view_constants))
        out = {f"object{i}": sd for i, sd in enumerate(sds["object"])}
        out["view"] = sds["view"]
        return out

    out = {"jax": [], "port": []}
    for s in range(3):
        key = jax.random.PRNGKey(100 + s)
        # the draws of view_neti_tpu/training/train_step.py:145-154
        r_vae, r_noise, r_t, r_drop, _ = jax.random.split(key, 5)
        lat_shape = (B, IMG // 2, IMG // 2, 4)
        draws = tts.StepDraws(
            vae_eps=torch.tensor(np.asarray(
                jax.random.normal(r_vae, lat_shape, jnp.float32))),
            noise=torch.tensor(np.asarray(
                jax.random.normal(r_noise, lat_shape, jnp.float32))),
            timesteps=torch.tensor(np.asarray(
                jax.random.randint(r_t, (B,), 0, 1000)).astype(np.int64)),
            dropout=jax_conditioning_draws(jb, tb, r_drop))
        trainable, jstate, metrics = jstep(trainable, jstate, jb.frozen,
                                           jbatch, key)
        out["jax"].append(dict(loss=float(metrics["total_loss"]),
                               grads=port_tree(jstate[0]),
                               params=port_tree(trainable)))
        loss = tstep(tb, tbatch, draws)["total_loss"]
        out["port"].append(dict(
            loss=float(loss),
            grads={k: {n: (p.grad.clone() if p.grad is not None
                           else torch.zeros_like(p))
                       for n, p in m.named_parameters()}
                   for k, m in mappers.items()},
            params={k: {n: p.detach().clone()
                        for n, p in m.named_parameters()}
                    for k, m in mappers.items()}))
    return out, start, opt


def test_grouped_train_step_matches_jax(trajectories):
    """Three steps of the grouped mode-3 step (3 groups of 2 on object
    slices [2, 0, 2], nested dropout on the object and view mappers with
    JAX's draws): the loss to 1e-4 relative, every mapper gradient within
    1e-3 of its tensor's largest |gradient|, and the parameters after 3
    steps within 2e-2 lr where |g| > 1e-3 max|g| at every step (2 lr a step
    elsewhere: AdamW's first update is lr sign(g)), as
    tests/test_torch_port_train.py holds mode 2. The idle slices 1 and 3
    get no gradient, no count and no update on either side."""
    out, start, opt = trajectories
    for j, t in zip(out["jax"], out["port"]):
        assert np.isfinite(t["loss"])
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        for key in t["grads"]:
            for name, got in t["grads"][key].items():
                if name in ("fourier_w", "neti_w"):
                    continue
                want = j["grads"][key][name].numpy()
                scale = np.abs(want).max()
                assert (scale > 0) == (key not in IDLE), (key, name)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-3 * max(scale, 1e-30),
                                           err_msg=f"{key}.{name}")
    assert opt.counts == {"object": [3, 0, 3, 0], "view": [3]}
    for key, p0 in start.items():
        for name, v0 in p0.items():
            if name in ("fourier_w", "neti_w"):
                continue
            want = out["jax"][2]["params"][key][name].numpy()
            got = out["port"][2]["params"][key][name].numpy()
            if key in IDLE:
                assert np.array_equal(got, v0.numpy())
                np.testing.assert_array_equal(want, v0.numpy())
                continue
            big = np.ones(want.shape, bool)
            for s in range(3):
                g = np.abs(out["jax"][s]["grads"][key][name].numpy())
                big &= g > 1e-3 * g.max()
            diff = np.abs(got - want)
            assert big.mean() > 0.5, (key, name)
            assert diff[big].max() <= 2e-2 * LR, (key, name)
            assert diff.max() <= 2 * LR * 3 + 1e-6, (key, name)


# ------------------------------------------------------------- Coach ----

@pytest.mark.parametrize("fuse", [True, False])
def test_mode3_coach_trains_fused_and_unfused(tree, tmp_path, fuse):
    """tests/test_mode3_fused.py's two runs, one step each: fused, one
    batch of 3 groups of 3 a step, each group's scene its own (object_idx
    (3,) on the host); unfused, 3 micro-batches of 3 a step, each with one
    scene. No latent
    cache in mode 3; preset 5 on the base cache."""
    coach = _coach(tree, tmp_path, optim={"fuse_accumulation": fuse,
                                          "max_train_steps": 1})
    if fuse:
        assert coach.mode3_group_size == 3
        assert (coach.micro_batch_size, coach.accum_k) == (9, 1)
    else:
        assert coach.mode3_group_size is None
        assert (coach.micro_batch_size, coach.accum_k) == (3, 3)
    assert not coach.cache_latents and coach.use_pixel_cache
    seen = []
    step = coach.train_step

    def spy(models, batch, draws):
        seen.append(batch.object_idx)
        return step(models, batch, draws)

    coach.train_step = spy
    out = coach.train()
    assert out["steps"] == 1 and len(coach.losses) == 1
    assert all(np.isfinite(coach.losses))
    if fuse:
        assert len(seen) == 1
        assert all(isinstance(x, torch.Tensor) and x.shape == (3,)
                   and x.device.type == "cpu" for x in seen)
    else:
        assert len(seen) == 3 and all(isinstance(x, int) for x in seen)
    assert tuple(coach.built.pixel_cache.shape) == (12, 48, 64, 3)


def test_mode3_coach_batches_follow_the_jax_stream(tree, tmp_path):
    """The port Coach's first two grouped TrainBatches (its packing of its
    loader's batches: the base cache's indices, the ids and the (3,)
    scenes on the host) against the JAX DataLoader's batches on the same
    config and seed."""
    jds, _ = _datasets(tree, repeats=4)
    jds.seed = 0
    tc = _coach(tree, tmp_path)
    jds.tokenizer.model_max_length = tc.tokenizer.model_max_length
    tc.train_dataset.skip_pixels = True
    jl = JDataLoader(jds, 9, seed=0, group_size=3)
    tl = DataLoader(tc.train_dataset, 9, seed=0,
                    group_size=tc.mode3_group_size)
    for _, jb_np, tb_np in zip(range(2), jl, tl):
        tb = tc._build_batch(tb_np)
        assert tb.pixel_values.dtype == torch.int64
        for f, key in (("pixel_values", "image_idxs"),
                       ("input_ids", "input_ids"),
                       ("input_ids_placeholder_object",
                        "input_ids_placeholder_object"),
                       ("input_ids_placeholder_view",
                        "input_ids_placeholder_view"),
                       ("object_idx", "object_idx")):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          jb_np[key], err_msg=f)


def test_four_object_bank_rows_and_checkpoint(tree, tmp_path):
    """Each of the four object tokens starts from its own super-category's
    row, with that row's norm as its target; the object checkpoint holds
    the whole bank, which the JAX CheckpointHandler reads and which
    reloads into the four mappers bit for bit."""
    supers = ["object", "toy", "statue", "object"]
    coach = _coach(tree, tmp_path,
                   data={"super_category_object_tokens": supers})
    built, tok = coach.built, coach.tokenizer
    table = built.text.clip.text_model.embeddings.token_embedding.weight
    for tid, sup, norm in zip(built.placeholder_object_token_ids, supers,
                              built.target_norm_object):
        sid = tok.encode(sup, add_special_tokens=False)[0]
        assert torch.equal(table[tid], table[sid])
        assert norm == pytest.approx(float(torch.linalg.norm(table[sid])))
    assert built.text.obj_norm_scales.shape == (4,)
    with torch.no_grad():
        for i, m in enumerate(built.text.obj_mappers):
            for p in m.parameters():
                p.add_(0.1 * (i + 1))
    coach._save("learned_embeds-steps-1.msgpack", "mapper-steps-1.msgpack")
    path = tmp_path / "mapper-steps-1_object.msgpack"
    jcfg, jpayload = JCheckpoint.load_mapper(path)
    assert jcfg.learnable_mode == 3 and sorted(jpayload["mappers"]) == sorted(
        TOKENS)
    _, payload = TCheckpoint.load_mapper(path)
    for tokn, mapper in zip(TOKENS, built.text.obj_mappers):
        entry = payload["mappers"][tokn]
        sd = twp.from_jax_mapper(entry["params"], entry["constants"])
        for k, v in mapper.state_dict().items():
            assert torch.equal(sd[k], v), (tokn, k)




def test_pretrained_object_mapper_refused_in_mode3(tree, tmp_path):
    """A pretrained object mapper in mode 3: data.fixed_object_token_or_path
    names an object checkpoint that the JAX CheckpointHandler wrote from a
    four-scan run. The JAX dataset then names one object token, the cfg's
    placeholder_object_token, so the JAX Coach loads that token's mapper
    into a bank of one; its dataset has no token for a scan, and its first
    example raises, so the run cannot train. The port refuses the
    configuration when the Coach is built, naming the option."""
    rect, cal = tree
    src = _coach(tree, tmp_path / "src")
    trainable, obj_c, view_c = src.jax_trainable()
    handler = JCheckpoint(
        jdecode(JRunConfig, config(rect, tmp_path / "src")),
        src.placeholder_view_tokens, src.built.placeholder_view_token_ids,
        list(TOKENS), src.built.placeholder_object_token_ids,
        tmp_path / "pretrained")
    obj_path = handler.save_mapper(trainable, obj_c, view_c, None,
                                   "mapper-pre.msgpack")[0]
    data = config(rect, tmp_path / "run",
                  data={"fixed_object_token_or_path": str(obj_path),
                        "placeholder_object_token": "<statue>"})

    jc = JCoach(jdecode(JRunConfig, data), arch=jbuilder.tiny_arch(),
                calibration_dir=str(cal))
    assert jc.placeholder_object_tokens == ["<statue>"]
    bank = jax.tree_util.tree_map(np.asarray, jc.built.trainable["object"])
    assert jax.tree_util.tree_leaves(bank)[0].shape[0] == 1
    _, payload = TCheckpoint.load_mapper(obj_path)
    loaded = twp.from_jax_mapper(
        jax.tree_util.tree_map(lambda a: a[0], bank),
        payload["mappers"]["<statue>"]["constants"])
    for k, v in src.built.text.obj_mappers[1].state_dict().items():
        assert torch.equal(loaded[k], v), k
    with pytest.raises(AttributeError,
                       match="lookup_object_to_placeholder_object_token"):
        jc.train_dataset[0]

    with pytest.raises(ValueError, match="data.fixed_object_token_or_path"):
        Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
              calibration_dir=str(cal), device="cpu")
