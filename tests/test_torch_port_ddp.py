"""Data parallelism in the port (view_neti_tpu_torch/parallel/dist.py) on
the CPU: ranks spawned by torch.multiprocessing, over gloo and a FileStore,
held against the JAX package's dp mesh and against one process.

The ranks import no JAX (this module imports it only inside the parent's
fixtures): the parent hands them weights, batches and draws as .npz files.
Each world runs once, in a module fixture, and every rank writes what it
saw to a pickle that the tests read.

  (a) the port's step at world size 2 with JAX's draws, against the JAX
      jit_train_step on a dp=2 mesh of the conftest's virtual devices;
  (b) the Coach at world size 2 against one process (tiny mode 2, fused
      2 x 2), its validation round's DTU sweep split over the ranks;
  (c) mode 3 in 2 groups of 3 at world size 3 (rank 1's rows straddle the
      groups) against one process;
  (d) a world-2 run resumed from its train state against the
      uninterrupted world-2 run;
  (e) wrong launches raise;
  (f) a rank's rows of the batch and its draws condition each row as the
      whole batch does;
  (g) the split offline sweep at world size 2 against one process, bit for
      bit, and only rank 0 writes files;
  and the all-reduce's sum in rank order at world size 3, a run directory
  that rank 0 refuses ending both ranks of the train CLI, and the local
  layout of a launch under the JAX package's VIEW_NETI_* variables.
"""
import contextlib
import functools
import importlib
import os
import pickle
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from view_neti_tpu_torch import train as ttrain
from view_neti_tpu_torch.checkpoint import CheckpointHandler
from view_neti_tpu_torch.config import ParallelConfig, RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.dataset import DataLoader
from view_neti_tpu_torch.data.dtu import dtu_get_train_idxs
from view_neti_tpu_torch.inference import offline
from view_neti_tpu_torch.parallel import dist
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.training.inference_dtu import get_cam_idxs
from view_neti_tpu_torch.training.text_forward import neti_text_conditioning
from view_neti_tpu_torch.training.validate import ValidationHandler

REPO = Path(__file__).resolve().parents[1]
# tests/test_parallel.py:238-241, the JAX mesh against one device
MAPPER_RTOL, MAPPER_ATOL = 5e-3, 1e-5
SCANS, TOKENS = ("scan65", "scan125"), ["<skull>", "<statue>"]
VAL_STEP, SEEDS = 4, [0, 1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: on one thread they do not wait for cores
    beside the other test workers (the ranks set the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ data ----

def _calibration(cal, rng):
    cal.mkdir(parents=True)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))


def make_trees(root: Path):
    """Mode 2's scan114 (the dtu_subset-6 train cameras and the first two
    eval cameras, which the debug sweep renders) and mode 3's two scans
    (dtu_subset 3), 64x48 PNGs, and 64 calibration files."""
    rng = np.random.RandomState(0)
    cal = root / "Calibration" / "cal18"
    _calibration(cal, rng)
    rect = root / "Rectified"
    scan = rect / "scan114"
    scan.mkdir(parents=True)
    for i in dtu_get_train_idxs(6) + get_cam_idxs(6)[0][:2]:
        image_io.write_png(scan / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    for s, name in enumerate(SCANS):
        (rect / name).mkdir()
        for i in dtu_get_train_idxs(3):
            img = rng.randint(0, 120, (48, 64, 3)) + 100 * s
            image_io.write_png(rect / name / f"rect_{i + 1:03d}_3_r5000.png",
                               img.astype(np.uint8))
    return {"scan": str(scan), "rect": str(rect), "cal": str(cal),
            "masks": str(root / "no_masks")}


def mode2_data(trees, exp_dir, **changes):
    """The bench's mode-2 recipe at the tiny width, fused 2 x 2, a
    checkpoint and a train state every 2 steps."""
    data = {
        "learnable_mode": 2, "debug": True,
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 32,
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2},
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6,
                 "dtu_preprocess_key": -1, "repeats": 100,
                 "train_data_dir": trees["scan"], "augmentation_key": 7,
                 "resolution": 16},
        "log": {"exp_dir": str(exp_dir), "save_dataset_images": False,
                "report_to": "none", "save_steps": 2,
                "checkpoint_backend": "orbax"},
        "eval": {"validation_prompts": None, "validation_seeds": SEEDS,
                 "num_validation_images": 2},
        "optim": {"mixed_precision": "no", "max_train_steps": 4,
                  "train_batch_size": 2, "gradient_accumulation_steps": 2},
    }
    for section, values in changes.items():
        data.setdefault(section, {}).update(values)
    return data


def mode2_config(trees, exp_dir, **changes):
    return decode(RunConfig, mode2_data(trees, exp_dir, **changes))


# (a): the step without nested dropout (JAX draws its bits inside the
# mapper), on a batch of 2 at 16x16
STEP_MODEL, STEP_B, STEP_IMG, STEP_LR, STEPS = (
    {"use_nested_dropout": False}, 2, 16, 1e-3, 3)


def mode3_config(trees, exp_dir, **changes):
    """Mode 3 on the two scans, preset 5, fused 3 x 2 (two groups of 3),
    nested dropout on in both mappers."""
    data = {
        "learnable_mode": 3,
        "data": {"train_data_dir": trees["rect"],
                 "train_data_subsets": list(SCANS),
                 "placeholder_object_tokens": TOKENS,
                 "super_category_object_tokens": ["object"] * 2,
                 "camera_representation": "dtu-12d", "dtu_subset": 3,
                 "dtu_preprocess_key": -1, "repeats": 4, "resolution": 16,
                 "augmentation_key": 5},
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 32,
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2,
                  "use_nested_dropout": True},
        "log": {"exp_dir": str(exp_dir), "save_dataset_images": False,
                "report_to": "none", "save_steps": 10 ** 9},
        "eval": {"validation_prompts": None},
        "optim": {"mixed_precision": "no", "max_train_steps": 2,
                  "train_batch_size": 3, "gradient_accumulation_steps": 2},
    }
    for section, values in changes.items():
        data.setdefault(section, {}).update(values)
    return decode(RunConfig, data)


def _coach(cfg, trees, dp=None):
    return Coach(cfg, arch=tbuilder.tiny_arch(), calibration_dir=trees["cal"],
                 device="cpu", dist=dp)


def _mappers(coach):
    """Every mapper parameter and buffer, as numpy."""
    text = coach.built.text
    out = {f"object{i}.{k}": v.detach().numpy().copy()
           for i, m in enumerate(text.obj_mappers or [])
           for k, v in m.state_dict().items()}
    out.update({f"view.{k}": v.detach().numpy().copy()
                for k, v in text.view_mapper.state_dict().items()})
    return out


def _offline_argv(run_dir, out_dir, trees, iteration=VAL_STEP):
    return ["--input_dir", str(run_dir), "--iteration", str(iteration),
            "--seeds", "[0, 1]", "--num_denoising_steps", "2", "--debug",
            "1", "--torch_dtype", "fp32", "--calibration_dir", trees["cal"],
            "--masks_root", trees["masks"], "--inference_dir", str(out_dir)]


# ---------------------------------------------------- the rank side ----

def _rank(rank, world, root, jobs):
    """One spawned rank: run the jobs in order, write what they returned to
    root/rank<r>.pkl. The "cli" job launches itself from the environment;
    the others share a group joined over root/store, and are JOBS' or,
    named "module:function", another test module's. Ranks other than 0
    record every file they open to write, create or remove under root/runs
    (an audit hook)."""
    torch.set_num_threads(1)
    root = Path(root)
    watched, writes = str(root / "runs"), []

    def hook(event, args):
        if not watching:
            return
        if event == "open":
            path, mode, flags = args
            writing = (any(c in mode for c in "wax+") if mode else
                       bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
        elif event in ("os.mkdir", "os.remove", "os.rename"):
            path, writing = args[0], True
        else:
            return
        if writing and not isinstance(path, int) and \
                os.fsdecode(path).startswith(watched):
            writes.append((event, os.fsdecode(path)))

    watching = rank != 0
    sys.addaudithook(hook)
    os.environ["VIEW_NETI_TINY"] = "1"
    out, dp = {}, None
    for name, kwargs in jobs:
        if name == "cli":
            out[name] = job_cli(rank, world, **kwargs)
            continue
        if dp is None:
            dp = dist.init_distributed("cpu", store=tdist.FileStore(
                str(root / "store"), world), rank=rank, world_size=world,
                timeout_s=240)
        if ":" in name:
            module, _, fn = name.partition(":")
            job = getattr(importlib.import_module(module), fn)
        else:
            job = JOBS[name]
        out[name] = job(dp, **kwargs)
    watching = False
    out["writes"] = writes
    dist.barrier(dp)
    dist.destroy(dp)
    (root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _spawn(world, root: Path, jobs):
    (root / "runs").mkdir(parents=True, exist_ok=True)
    return mp.start_processes(_rank, args=(world, str(root), jobs),
                              nprocs=world, join=False,
                              start_method="spawn")


def _join(context, root: Path, world: int, timeout_s: float = 600):
    deadline = time.time() + timeout_s
    while not context.join(timeout=5):
        if time.time() > deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks did not finish")
    return [pickle.loads((root / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _cli_argv(trees, exp_dir):
    """The train CLI on input_configs/train.yaml with the tiny stack, fused
    2 x 2 in fp32, a checkpoint and a debug validation round at step 2."""
    return ["--config_path", str(REPO / "input_configs" / "train.yaml"),
            "--log.exp_dir", str(exp_dir), "--log.report_to", "none",
            "--data.train_data_dir", trees["scan"], "--data.dtu_subset", "6",
            "--model.pretrained_model_name_or_path",
            "runwayml/stable-diffusion-v1-5", "--debug", "true",
            "--optim.max_train_steps", "2", "--optim.mixed_precision", "no",
            "--optim.train_batch_size", "2",
            "--optim.gradient_accumulation_steps", "2",
            "--eval.validation_steps", "2", "--log.save_steps", "2"]


def job_cli(rank, world, trees, runs, ports, extra=()):
    """The CLIs as users launch them, before any group exists: the train
    CLI under torchrun's variables, then offline inference on its run under
    the JAX package's VIEW_NETI_* variables (each entry point joins its
    group and leaves it); extra: arguments both CLIs take (--parallel.*)."""
    runs = Path(runs)
    os.environ["DTU_CALIBRATION_DIR"] = trees["cal"]
    launch = {"RANK": str(rank), "WORLD_SIZE": str(world),
              "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
              "MASTER_ADDR": "localhost", "MASTER_PORT": str(ports[0])}
    os.environ.update(launch)
    train = ttrain.main(_cli_argv(trees, runs / "cli") + list(extra),
                        device="cpu")
    for k in launch:
        del os.environ[k]
    launch = {"VIEW_NETI_COORDINATOR": f"localhost:{ports[1]}",
              "VIEW_NETI_NUM_PROCESSES": str(world),
              "VIEW_NETI_PROCESS_ID": str(rank)}
    os.environ.update(launch)
    res = offline.main(_offline_argv(runs / "cli" / "train",
                                     runs / "cli_offline", trees, 2)
                       + list(extra), device="cpu")
    for k in launch:
        del os.environ[k]
    # the train CLI again on its non-empty directory: rank 0 refuses it
    launch = {"RANK": str(rank), "WORLD_SIZE": str(world),
              "MASTER_ADDR": "localhost", "MASTER_PORT": str(ports[2])}
    os.environ.update(launch)
    try:
        ttrain.main(_cli_argv(trees, runs / "cli") + list(extra),
                    device="cpu")
        refused = None
    except Exception as e:
        refused = f"{type(e).__name__}: {e}"
    for k in launch:
        del os.environ[k]
    return dict(train=train, initialized_after=tdist.is_initialized(),
                offline=None if res is None else np.stack(res["imgs_pred"]),
                refused=refused)


def job_step(dp, trees, runs, stack):
    """(a): a tiny mode-2 Coach's stack holding the parent's weights from
    its .npz, each rank on its rows, three steps with JAX's draws."""
    d = dict(np.load(stack))
    tb = _coach(mode2_config(trees, Path(runs) / "stack", model=STEP_MODEL),
                trees, dp).built
    named = {"clip": tb.text.clip, "unet": tb.unet, "vae": tb.vae,
             "object": tb.text.obj_mappers[0], "view": tb.text.view_mapper}
    for name, module in named.items():
        module.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v)
                                for k, v in d.items()
                                if k.startswith(name + ".")}, strict=True)
    opt = toptim.SlicedAdamW(tbuilder.trainable_groups(tb),
                             toptim.make_lr_schedule("constant", STEP_LR,
                                                     0, 10))
    step = tts.make_train_step(opt, reduce=functools.partial(
        dist.all_reduce_step_, dp, opt))
    t = {k: torch.from_numpy(d[k]) for k in ("pixels", "ids", "obj", "view")}
    batch = tts.TrainBatch(*(dist.shard_rows(t[k], dp)
                             for k in ("pixels", "ids", "obj", "view")))
    out = []
    for s in range(STEPS):
        draws = dist.shard_draws(tts.StepDraws(
            *(torch.from_numpy(d[f"{k}{s}"])
              for k in ("vae_eps", "noise", "timesteps"))), dp, STEP_B)
        loss = float(step(tb, batch, draws)["total_loss"])
        out.append(dict(
            loss=loss,
            grads={k: {n: p.grad.numpy().copy()
                       for n, p in m.named_parameters()}
                   for k, m in named.items() if k in ("object", "view")},
            params={k: {n: p.detach().numpy().copy()
                        for n, p in m.named_parameters()}
                    for k, m in named.items() if k in ("object", "view")}))
    return out


@contextlib.contextmanager
def _all_gathers():
    """The bytes of every all-gather this rank sends meanwhile (the one
    collective of dist.all_reduce_mean_), by wrapping
    torch.distributed.all_gather."""
    gather, sent = tdist.all_gather, []

    def counted(parts, tensor, *args, **kwargs):
        sent.append(tensor.numel() * tensor.element_size())
        return gather(parts, tensor, *args, **kwargs)
    tdist.all_gather = counted
    try:
        yield sent
    finally:
        tdist.all_gather = gather


def job_coach(dp, trees, runs):
    """(b), (d), (e), (g) on one world: the straight run with its
    validation round, a run stopped at step 2 and its resumption, and the
    wrong launches."""
    runs = Path(runs)
    out = {}
    straight = _coach(mode2_config(
        trees, runs / "straight",
        eval={"validation_prompts": ["A photo of a {}"],
              "validation_steps": VAL_STEP}), trees, dp)
    straight.validator = ValidationHandler(
        straight.cfg, masks_root=trees["masks"],
        calibration_dir=trees["cal"])
    with _all_gathers() as sent:
        straight.train()
    out["straight"] = dict(
        losses=straight.losses, mappers=_mappers(straight),
        counts=straight.optimizer.counts, reduce_bytes=sorted(set(sent)),
        reduces=len(sent),
        trainable=sum(p.numel() for g in
                      straight.optimizer.optimizer.param_groups
                      for p in g["params"]))
    _coach(mode2_config(trees, runs / "parts",
                        optim={"max_train_steps": 2}), trees, dp).train()
    resumed = _coach(mode2_config(trees, runs / "parts",
                                  log={"resume_from": "latest"}), trees, dp)
    start = resumed.global_step
    resumed.train()
    out["resumed"] = dict(start=start, losses=resumed.losses,
                          mappers=_mappers(resumed),
                          counts=resumed.optimizer.counts)
    wrong = {}
    for name, changes in (
            ("indivisible", {"optim": {"train_batch_size": 3,
                                       "gradient_accumulation_steps": 1}}),
            ("tp", {"parallel": {"tp": 3}}),
            ("no_mesh", {"parallel": {"use_mesh": False}})):
        try:
            _coach(mode2_config(trees, runs / name, **changes), trees, dp)
            wrong[name] = None
        except ValueError as e:
            wrong[name] = f"{type(e).__name__}: {e}"
    out["wrong"] = wrong
    return out


def job_mode3(dp, trees, runs):
    """(c): two steps of mode 3 in two groups of three."""
    coach = _coach(mode3_config(trees, Path(runs) / "m3"), trees, dp)
    coach.train()
    return dict(losses=coach.losses, mappers=_mappers(coach),
                counts=coach.optimizer.counts)


def _order_values(seed, shape):
    """fp32 normals scaled over magnitudes 1e-8 to 1e8, whose sum depends
    on its order."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 10.0 ** rng
                             .uniform(-8, 8, shape)).astype(np.float32))


def job_order(dp):
    """all_reduce_mean_ on a (3, 5) and a (7,) tensor through one buffer,
    rank r's _order_values from seeds r and 100 + r."""
    a = _order_values(dp.rank, (3, 5))
    b = _order_values(100 + dp.rank, (7,))
    dist.all_reduce_mean_(dp, [a, b])
    return dict(a=a.numpy(), b=b.numpy())


JOBS = {"step": job_step, "coach": job_coach, "mode3": job_mode3,
        "order": job_order}


# --------------------------------------------------- the parent side ----

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return make_trees(tmp_path_factory.mktemp("ddp_dtu"))


def _jax_draws(B, img, steps):
    """The draws of each step that the JAX step takes from its key
    (view_neti_tpu/training/train_step.py:129-154), for the port."""
    import jax
    draws = {}
    for s in range(steps):
        r_vae, r_noise, r_t, _, _ = jax.random.split(
            jax.random.PRNGKey(100 + s), 5)
        shape = (B, img // 2, img // 2, 4)
        draws[f"vae_eps{s}"] = np.asarray(jax.random.normal(r_vae, shape))
        draws[f"noise{s}"] = np.asarray(jax.random.normal(r_noise, shape))
        draws[f"timesteps{s}"] = np.asarray(
            jax.random.randint(r_t, (B,), 0, 1000)).astype(np.int64)
    return draws


def _jax_dp2_steps(jb, jbatch, steps, lr, n_tp=1):
    """The JAX jit_train_step on a dp=2 mesh (the pattern of
    tests/test_train_step.py:323-337), or with n_tp > 1 a dp=2 x tp=n_tp
    mesh whose frozen UNet and CLIP are placed by
    frozen_param_shardings(tensor_parallel=True) as the JAX Coach's
    _place_frozen_on_mesh places them: each step's loss, mapper gradients
    and parameters in the port's layout."""
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    import optax
    from view_neti_tpu.parallel import mesh as pmesh
    from view_neti_tpu.training import optim as joptim
    from view_neti_tpu.training.train_step import (jit_train_step,
                                                   make_train_step)
    from view_neti_tpu_torch import weight_port as twp

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    text = jb.frozen.text
    # a pass-through ahead of the sliced AdamW keeps the step's gradients
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(record, joptim.sliced_adamw(
        joptim.make_lr_schedule("constant", lr, 0, 10)))
    mesh = pmesh.make_mesh(n_dp=2, n_tp=n_tp,
                           devices=jax.devices("cpu")[:2 * n_tp])
    rep = pmesh.replicated(mesh)
    shardings = pmesh.batch_shardings_for(jbatch, mesh)
    frozen_sh = jax.tree_util.tree_map(lambda _: rep, jb.frozen)
    if n_tp > 1:
        frozen_sh = dc.replace(
            frozen_sh, unet_vars=pmesh.frozen_param_shardings(
                jb.frozen.unet_vars, mesh, tensor_parallel=True),
            text=dc.replace(frozen_sh.text,
                            clip_vars=pmesh.frozen_param_shardings(
                                jb.frozen.text.clip_vars, mesh,
                                tensor_parallel=True)))
    step = jit_train_step(make_train_step(tx), mesh=mesh, replicated=rep,
                          batch_sharding=shardings,
                          frozen_sharding=frozen_sh)
    # everything placed as the step's outputs come back, so that the step
    # compiles once
    frozen = jax.device_put(jb.frozen, frozen_sh)
    trainable = jax.device_put(
        jax.tree_util.tree_map(jnp.copy, jb.trainable), rep)
    state = jax.device_put(tx.init(trainable), rep)
    jbatch = jax.device_put(jbatch, shardings)
    out = []
    for s in range(steps):
        trainable, state, metrics = step(
            trainable, state, frozen, jbatch,
            jax.device_put(jax.random.PRNGKey(100 + s), rep))
        grads, params = (twp.from_jax_trainable(
            np_tree(tree), np_tree(text.obj_constants),
            np_tree(text.view_constants)) for tree in (state[0], trainable))
        out.append(dict(
            loss=float(metrics["total_loss"]),
            grads={"object": grads["object"][0], "view": grads["view"]},
            params={"object": params["object"][0], "view": params["view"]}))
    return out


@pytest.fixture(scope="module")
def world2(trees, tmp_path_factory):
    """The world-2 ranks of (a), (b), (d), (e) and (g); while they run, the
    JAX dp=2 reference of (a), on the JAX stack assembled around a port
    Coach's weights (tests/test_torch_port_validate.py::_jax_stack), and
    the one-process run of (b); after them, the one-process offline sweep
    of the world-2 run's checkpoint."""
    import jax.numpy as jnp
    from view_neti_tpu.config import RunConfig as JRunConfig
    from view_neti_tpu.config import decode as jdecode
    from view_neti_tpu.training.train_step import TrainBatch as JBatch
    from test_torch_port_validate import _jax_stack
    root = tmp_path_factory.mktemp("world2")
    data = mode2_data(trees, root / "stack", model=STEP_MODEL)
    tc = _coach(decode(RunConfig, data), trees)
    jc = _jax_stack(tc, jdecode(JRunConfig, data), trees["cal"])
    tok, tb = tc.tokenizer, tc.built
    ids = np.full((STEP_B, 16), tok.eos_token_id, np.int64)
    ids[:, 0] = tok.bos_token_id
    ids[:, 1] = view_id = tb.placeholder_view_token_ids[0]
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id = tb.placeholder_object_token_ids[0]
    pixels = np.random.RandomState(0).uniform(
        -1, 1, (STEP_B, STEP_IMG, STEP_IMG, 3)).astype(np.float32)
    obj = np.full(STEP_B, obj_id, np.int64)
    view = np.full(STEP_B, view_id, np.int64)
    jbatch = JBatch(pixel_values=jnp.asarray(pixels),
                    input_ids=jnp.asarray(ids, jnp.int32),
                    input_ids_placeholder_object=jnp.asarray(obj, jnp.int32),
                    input_ids_placeholder_view=jnp.asarray(view, jnp.int32),
                    object_idx=jnp.asarray(0, jnp.int32))
    arrays = {f"{name}.{k}": v.detach().numpy()
              for name, module in (("clip", tb.text.clip), ("unet", tb.unet),
                                   ("vae", tb.vae),
                                   ("object", tb.text.obj_mappers[0]),
                                   ("view", tb.text.view_mapper))
              for k, v in module.state_dict().items()}
    arrays.update(_jax_draws(STEP_B, STEP_IMG, STEPS), pixels=pixels,
                  ids=ids, obj=obj, view=view)
    np.savez(root / "stack.npz", **arrays)
    runs = str(root / "runs")
    ranks = _spawn(2, root, [
        ("cli", {"trees": trees, "runs": runs, "ports": _free_ports(3)}),
        ("step", {"trees": trees, "runs": runs,
                  "stack": str(root / "stack.npz")}),
        ("coach", {"trees": trees, "runs": runs})])
    jax_steps = _jax_dp2_steps(jc.built, jbatch, STEPS, STEP_LR)
    single = _coach(mode2_config(
        trees, root / "single",
        eval={"validation_prompts": ["A photo of a {}"],
              "validation_steps": VAL_STEP}), trees)
    single.validator = ValidationHandler(
        single.cfg, masks_root=trees["masks"], calibration_dir=trees["cal"])
    single.train()
    os.environ["VIEW_NETI_TINY"] = "1"
    os.environ["DTU_CALIBRATION_DIR"] = trees["cal"]
    try:
        cli = ttrain.main(_cli_argv(trees, root / "cli1"), device="cpu")
        out = _join(ranks, root, 2)
        sweep = offline.main(_offline_argv(root / "runs" / "straight",
                                           root / "offline1", trees),
                             device="cpu")
        cli_sweep = offline.main(_offline_argv(
            root / "runs" / "cli" / "train", root / "cli_offline1", trees,
            2), device="cpu")
    finally:
        del os.environ["VIEW_NETI_TINY"], os.environ["DTU_CALIBRATION_DIR"]
    return dict(ranks=out, root=root, jax=jax_steps, lr=STEP_LR,
                start={key: {k: v.detach().numpy().copy()
                             for k, v in m.named_parameters()}
                       for key, m in (("object", tb.text.obj_mappers[0]),
                                      ("view", tb.text.view_mapper))},
                single=dict(losses=single.losses, mappers=_mappers(single),
                            counts=single.optimizer.counts,
                            files=sorted(p.name for p in
                                         (root / "single").iterdir())),
                sweep=np.stack(sweep["imgs_pred"]), cli=cli,
                cli_sweep=np.stack(cli_sweep["imgs_pred"]))


def _free_ports(n):
    """n ports free on localhost now, for the ranks' rendezvous."""
    socks = [socket.socket() for _ in range(n)]
    for sock in socks:
        sock.bind(("localhost", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    return ports


@pytest.fixture(scope="module")
def world3(trees, tmp_path_factory):
    """(c): the world-3 ranks, and the one-process run while they run; the
    ranks' all-reduce on values whose sum depends on its order."""
    root = tmp_path_factory.mktemp("world3")
    ranks = _spawn(3, root, [("order", {}),
                             ("mode3", {"trees": trees,
                                        "runs": str(root / "runs")})])
    single = _coach(mode3_config(trees, root / "single"), trees)
    single.train()
    out = _join(ranks, root, 3)
    return dict(ranks=[r["mode3"] for r in out],
                order=[r["order"] for r in out],
                single=dict(losses=single.losses, mappers=_mappers(single),
                            counts=single.optimizer.counts))


def _assert_mappers_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=MAPPER_RTOL,
                                   atol=MAPPER_ATOL, err_msg=k)


# ------------------------------------------------------------- tests ----

def test_step_at_world2_matches_the_jax_dp2_mesh(world2):
    """(a) The tolerances of tests/test_torch_port_train.py:465-515 on
    each of the three steps: the loss (the mean over both ranks) within
    1e-4 relative; every mapper gradient (the ranks' mean) within 1e-3 of
    its tensor's largest; the parameters within 2e-2 lr where |g| > 1e-3
    max|g| at every step so far, else within the sign-flip bound of 2 lr a
    step. Both ranks hold the same mappers, bit for bit."""
    port = [r["step"] for r in world2["ranks"]]
    lr = world2["lr"]
    for a, b in zip(*port):
        assert a["loss"] == b["loss"]
        for key in a["params"]:
            for name in a["params"][key]:
                np.testing.assert_array_equal(a["params"][key][name],
                                              b["params"][key][name])
    for j, t in zip(world2["jax"], port[0]):
        assert np.isfinite(t["loss"])
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        for key in ("object", "view"):
            for name, got in t["grads"][key].items():
                want = j["grads"][key][name].numpy()
                scale = np.abs(want).max()
                assert scale > 0, (key, name)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-3 * scale,
                                           err_msg=f"{key}.{name}")
    for after in range(1, len(port[0]) + 1):
        for key, start in world2["start"].items():
            for name, p0 in start.items():
                want = world2["jax"][after - 1]["params"][key][name].numpy()
                got = port[0][after - 1]["params"][key][name]
                big = np.ones(want.shape, bool)
                for s in range(after):
                    g = np.abs(world2["jax"][s]["grads"][key][name].numpy())
                    big &= g > 1e-3 * g.max()
                diff = np.abs(got - want)
                assert big.mean() > 0.5, (key, name)
                assert diff[big].max() <= 2e-2 * lr, (key, name)
                assert diff.max() <= 2 * lr * after + 1e-6, (key, name)
                assert np.median(np.abs(got - p0)[big]) > 0.5 * lr


def test_coach_at_world2_equals_one_process(world2):
    """(b) Tiny mode 2, fused 2 x 2, 4 steps: each logged loss (the global
    mean, read one step behind) within 1e-6 relative of the one-process
    run's; the mappers within tests/test_parallel.py's tolerance; the same
    per-slice counts. One all-reduce a step, of every mapper gradient and
    the loss; both ranks end with the same mappers, bit for bit."""
    single = world2["single"]
    ranks = [r["coach"]["straight"] for r in world2["ranks"]]
    for r in ranks:
        assert len(r["losses"]) == 4
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-6)
        _assert_mappers_close(r["mappers"], single["mappers"])
        assert r["counts"] == single["counts"]
        assert r["reduces"] == 4
        assert r["reduce_bytes"] == [4 * (r["trainable"] + 1)]
    for k, v in ranks[0]["mappers"].items():
        np.testing.assert_array_equal(v, ranks[1]["mappers"][k])


def test_only_rank0_writes_files(world2):
    """(b, g) Rank 1 opened no file to write, created and removed none,
    through training, checkpoints, train states and their pruning, the
    validation round and the offline sweep. Rank 0 wrote one set of
    checkpoint files: the one-process run's names."""
    root = world2["root"]
    assert world2["ranks"][1]["writes"] == []
    assert world2["ranks"][0]["writes"] == []     # rank 0 is not watched
    files = sorted(p.name for p in (root / "runs" / "straight").iterdir())
    assert files == world2["single"]["files"]
    assert "mapper-steps-4_view.msgpack" in files
    log = (root / "runs" / "straight" / "logs" / "log.txt").read_text()
    assert "data parallel: 2 ranks over gloo, 2 of the 4 rows" in log
    assert log.count("***** Running training *****") == 1


def test_cli_under_torchrun_and_view_neti_variables(world2):
    """The train CLI launched as torchrun launches it (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT) at world size 2: rank 0 prepared the directory and
    wrote the one-process run's files, the final loss within 1e-6 and the
    final mappers within tolerance of the one-process CLI run; offline
    inference on that run under VIEW_NETI_COORDINATOR /
    VIEW_NETI_NUM_PROCESSES / VIEW_NETI_PROCESS_ID ran (its sweep:
    test_split_sweeps_equal_one_process). Each entry point left its
    group."""
    root = world2["root"]
    single = root / "cli1" / "train"
    run = root / "runs" / "cli" / "train"
    assert (sorted(p.name for p in run.iterdir())
            == sorted(p.name for p in single.iterdir()))
    for r in world2["ranks"]:
        cli = r["cli"]
        assert not cli["initialized_after"]
        assert cli["train"]["steps"] == 2
        assert cli["train"]["final_loss"] == pytest.approx(
            world2["cli"]["final_loss"], rel=1e-6)
    for key in ("view", "object"):
        _, got = CheckpointHandler.load_mapper(
            run / f"mapper-final_{key}.msgpack")
        _, want = CheckpointHandler.load_mapper(
            single / f"mapper-final_{key}.msgpack")
        name = "view" if key == "view" else "<object>"
        flat_got, flat_want = ({}, {})
        for flat, tree in ((flat_got, got), (flat_want, want)):
            def walk(prefix, t, flat=flat):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(f"{prefix}.{k}", v)
                else:
                    flat[prefix] = np.asarray(t)
            walk(name, tree["mappers"][name]["params"])
        _assert_mappers_close(flat_got, flat_want)


def test_a_refused_directory_ends_every_rank(world2):
    """The train CLI at world size 2 on its own non-empty run directory
    (no overwrite_ok): rank 0's FileExistsError reaches rank 1, which
    raises naming it instead of waiting on a barrier; both left the
    group (test_cli_under_torchrun_and_view_neti_variables)."""
    rank0, rank1 = (r["cli"]["refused"] for r in world2["ranks"])
    assert rank0.startswith("FileExistsError: ")
    assert "overwrite_ok" in rank0
    assert rank1.startswith("RuntimeError: rank 0 could not prepare ")
    assert "FileExistsError" in rank1


def test_resumed_world2_run_replays_the_straight_one(world2):
    """(d) A world-2 run stopped at step 2 and resumed from its train state
    ("latest") for steps 3-4 equals the straight world-2 run bit for bit:
    the losses and every mapper parameter and buffer."""
    for r in world2["ranks"]:
        straight, resumed = r["coach"]["straight"], r["coach"]["resumed"]
        assert resumed["start"] == 2
        assert resumed["losses"] == straight["losses"][2:]
        assert resumed["counts"] == straight["counts"]
        for k, v in straight["mappers"].items():
            np.testing.assert_array_equal(resumed["mappers"][k], v,
                                          err_msg=k)


def test_wrong_launches_raise_on_every_rank(world2):
    """(e) On both ranks of the world-2 launch: a fused batch of 3, a tp
    of 3 (which does not divide the world size) and use_mesh false each
    raise before any model is built."""
    for r in world2["ranks"]:
        wrong = r["coach"]["wrong"]
        assert wrong["indivisible"].startswith("ValueError: effective batch "
                                               "3 not divisible by dp=2")
        assert "[1, 3]" in wrong["indivisible"]
        assert wrong["tp"].startswith("ValueError: parallel.tp=3 does not "
                                      "divide the world size 2")
        assert wrong["no_mesh"].startswith("ValueError: parallel.use_mesh")


@pytest.mark.parametrize("parallel,batch,world,error", [
    ({}, 9, 2, "effective batch 9 not divisible by dp=2"),
    ({"dp": 2}, 9, 3, "dp must be the world size"),
    ({"tp": 3}, 8, 4, "parallel.tp=3 does not divide the world size 4"),
    ({"tp": 2, "dp": 4, "tensor_parallel": True}, 8, 4,
     "dp must be the world size / tp \\(2\\)"),
    ({"use_mesh": False}, 9, 3, "use_mesh is false"),
])
def test_resolve_refuses_a_wrong_launch(parallel, batch, world, error):
    """(e) dist.resolve, the counterpart of coach.py:194-218: where the JAX
    auto mode would shrink dp (batch 9 on 2 devices), the port raises; so
    it does for a tp that does not divide the world size and for a dp
    other than world / tp."""
    with pytest.raises(ValueError, match=error):
        dist.resolve(ParallelConfig(**parallel), batch, world)


@pytest.mark.parametrize("parallel,batch,world,dp", [
    ({}, 9, 3, 3), ({"dp": 3, "use_mesh": True}, 9, 3, 3), ({}, 9, 9, 9),
    ({"use_mesh": False, "tp": 2}, 9, 1, 1), ({"dp": 4}, 5, 1, 1),
    ({"tp": 2}, 9, 2, 1), ({"tp": 2, "tensor_parallel": True}, 8, 4, 2),
    ({"tp": 2, "dp": 3, "tensor_parallel": True}, 9, 6, 3),
    ({"tensor_parallel": True}, 8, 2, 2)])
def test_resolve_accepts(parallel, batch, world, dp):
    """dp 0 is world / tp; one process is dp 1 whatever the config;
    tensor_parallel at tp 1 is plain data parallelism."""
    assert dist.resolve(ParallelConfig(**parallel), batch, world) == dp


def test_mode3_at_world3_equals_one_process(world3):
    """(c) Mode 3, two groups of three (rank 1's rows are the last of group
    0 and the first of group 1), nested dropout on: the same per-slice
    counts, losses within 1e-6 relative, mappers within tolerance, every
    rank's mappers equal."""
    single = world3["single"]
    for r in world3["ranks"]:
        assert r["counts"] == single["counts"]
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-6)
        _assert_mappers_close(r["mappers"], single["mappers"])
        for k, v in r["mappers"].items():
            np.testing.assert_array_equal(v, world3["ranks"][0]["mappers"][k])


def test_all_reduce_mean_adds_in_rank_order(world3):
    """all_reduce_mean_ at world size 3 equals ((x0 + x1) + x2) / 3 in fp32
    on every rank, bit for bit, each tensor back in its shape; on these
    values another order of the sum (that of a ring starting at rank 1)
    differs, so the test tells the orders apart."""
    for key, seed, shape in (("a", 0, (3, 5)), ("b", 100, (7,))):
        x = [_order_values(seed + r, shape) for r in range(3)]
        want = ((x[0] + x[1]) + x[2]).div_(3).numpy()
        ring = ((x[1] + x[2]) + x[0]).div_(3).numpy()
        for r in world3["order"]:
            assert r[key].shape == shape
            np.testing.assert_array_equal(r[key], want)
        if key == "a":
            assert not np.array_equal(ring, want)


def test_split_sweeps_equal_one_process(world2):
    """(g) The validation round's sweep inside the world-2 training (step 4,
    2 cameras: one a rank) against one process's offline sweep of the same
    checkpoint, and the offline CLI's sweep split over 2 ranks against one
    process's (test_cli_under_torchrun_and_view_neti_variables): uint8
    images bit for bit; rank 1's CLI returned None, rank 0 wrote the
    one-process sweep's files."""
    root = world2["root"]
    from view_neti_tpu_torch.utils import msgpack_codec
    bundle = msgpack_codec.unpackb((
        root / "runs" / "straight" /
        f"validation-iter_{VAL_STEP}-denoisesteps_2_numseeds_2.msgpack"
    ).read_bytes())
    assert bundle["imgs_pred"].shape == (2, 2, 300, 400, 3)
    np.testing.assert_array_equal(bundle["imgs_pred"], world2["sweep"])
    assert world2["ranks"][1]["cli"]["offline"] is None
    np.testing.assert_array_equal(world2["ranks"][0]["cli"]["offline"],
                                  world2["cli_sweep"])
    assert (sorted(p.name for p in (root / "runs" / "cli_offline").iterdir())
            == sorted(p.name for p in (root / "cli_offline1").iterdir()))


# ----------------------------------------------- rows without a group ----

@pytest.fixture(scope="module")
def coaches(trees, tmp_path_factory):
    root = tmp_path_factory.mktemp("rows")
    return {2: _coach(mode2_config(trees, root / "m2",
                                   model={"use_nested_dropout": True}),
                      trees),
            3: _coach(mode3_config(trees, root / "m3"), trees)}


@pytest.mark.parametrize("mode,world", [(2, 2), (2, 4), (3, 2), (3, 3),
                                        (3, 6)])
def test_rank_rows_condition_as_the_whole_batch(coaches, mode, world):
    """(f) For every rank of a world (no process group: the record
    alone), its rows of a packed batch and its share of the micro-step's
    draws (shard_draws) against the whole batch's: every per-row draw, the
    augmentation's included, is the whole batch's row; the layer-major
    nested-dropout draws (the view mapper's, mode 2's object mapper's)
    and mode 3's group-major object draws give each row its own; and the
    text conditioning of the rank's rows (mode 3: the rank's regrouped
    object_idx) equals the whole batch's at those rows."""
    coach = coaches[mode]
    coach._fill_base_cache()
    whole_dp = coach.dist
    B = coach.micro_batch_size
    ds = coach.train_dataset
    ds.skip_pixels = True
    batch_np = next(iter(DataLoader(ds, B, seed=3,
                                    group_size=coach.mode3_group_size)))
    whole = coach._to_device(coach._pack(batch_np))
    draws = coach._step_draws(5, whole)
    text = coach.built.text

    def conditioning(batch, d):
        return neti_text_conditioning(
            text, batch.input_ids, batch.input_ids_placeholder_object,
            batch.input_ids_placeholder_view, d.timesteps,
            object_idx=batch.object_idx, train=True, draws=d.dropout)[0]

    with torch.no_grad():
        ctx = conditioning(whole, draws)
    assert set(draws.dropout) == {"object", "view"}
    K = ctx.shape[0]
    try:
        for rank in range(world):
            coach.dist = dist.DataParallel(rank=rank, world=world,
                                           backend="gloo")
            lo, hi = dist.rows(coach.dist, B)
            local = coach._to_device(coach._pack(batch_np))
            part = coach._step_draws(5, local)
            torch.testing.assert_close(local.input_ids,
                                       whole.input_ids[lo:hi], rtol=0, atol=0)
            for f in ("vae_eps", "noise", "timesteps"):
                torch.testing.assert_close(getattr(part, f),
                                           getattr(draws, f)[lo:hi],
                                           rtol=0, atol=0)
            for f in ("brightness", "jitter_order", "crop_h", "flip"):
                torch.testing.assert_close(getattr(part.augment, f),
                                           getattr(draws.augment, f)[lo:hi],
                                           rtol=0, atol=0)
            for t, w in zip(part.dropout["view"], draws.dropout["view"]):
                torch.testing.assert_close(
                    t, w.reshape(K, B)[:, lo:hi].reshape(-1), rtol=0, atol=0)
            if mode == 2:
                for t, w in zip(part.dropout["object"],
                                draws.dropout["object"]):
                    torch.testing.assert_close(
                        t, w.reshape(K, B)[:, lo:hi].reshape(-1),
                        rtol=0, atol=0)
            with torch.no_grad():
                got = conditioning(local, part)
            torch.testing.assert_close(got, ctx[:, lo:hi], rtol=1e-5,
                                       atol=1e-6)
    finally:
        coach.dist = whole_dp


def test_one_process_needs_no_group(monkeypatch):
    """Without a launch (no torchrun or VIEW_NETI_* variables, no store)
    init_distributed returns the one-process record and joins nothing."""
    for k in ("RANK", "WORLD_SIZE", "VIEW_NETI_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    dp = dist.init_distributed("cpu")
    assert (dp.rank, dp.world, dp.backend, dp.is_main, dp.active) == (
        0, 1, None, True, False)
    assert not tdist.is_initialized()
    assert dist.split_items(range(7), 2, 3) == [5, 6]
    assert dist.gather_to_main(dp, "x") == ["x"]


@pytest.mark.parametrize("local,want", [
    ({}, (0, 1)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, (1, 2)),
    ({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "2"}, "LOCAL_RANK=2 outside"),
])
def test_view_neti_launch_is_one_process_a_host(monkeypatch, local, want):
    """Under the JAX package's VIEW_NETI_* variables a rank is alone on its
    host (mesh.py's launch), unless LOCAL_RANK and LOCAL_WORLD_SIZE say
    how many ranks share it; a local rank outside them raises."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VIEW_NETI_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("VIEW_NETI_NUM_PROCESSES", "4")
    monkeypatch.setenv("VIEW_NETI_PROCESS_ID", "3")
    for k, v in local.items():
        monkeypatch.setenv(k, v)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            dist._launch(None, None, None)
        return
    init, rank, world, local_rank, local_world = dist._launch(None, None,
                                                              None)
    assert init == dict(init_method="tcp://localhost:1234", rank=3,
                        world_size=4)
    assert (rank, world, local_rank, local_world) == (3, 4) + want
