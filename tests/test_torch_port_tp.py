"""Tensor parallelism in the port (view_neti_tpu_torch/parallel/tensor.py,
the dp x tp layout of parallel/dist.py) on the CPU: ranks spawned by
torch.multiprocessing over gloo and a FileStore, as in
tests/test_torch_port_ddp.py (whose rank helpers, data and configs this
file shares), held against the JAX package's tp mesh and against one
process.

The ranks import no JAX: the parent hands them weights, batches, draws
and latents as .npz files. Each world runs once, in a module fixture:

  world 2 (dp 1 x tp 2): the train and inference CLIs with --parallel.tp
      2 --parallel.tensor_parallel true, the tiny mode-2 Coach with its
      validation round, and a render of two prompts through the split
      UNet and CLIP;
  world 4 (dp 2 x tp 2): the train step with JAX's draws, the same step
      with copy_to_tp's backward sum planted out, and the Coach.

Without a group: the table against JAX's frozen_param_shardings, the
slices rebuilding every full tensor, and SD-2.1's head rule.
"""
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_ddp import (MAPPER_ATOL, MAPPER_RTOL, SEEDS, STEP_B,
                                 STEP_IMG, STEP_LR, STEP_MODEL, STEPS,
                                 VAL_STEP, _cli_argv, _coach, _free_ports,
                                 _jax_draws, _jax_dp2_steps, _join,
                                 _mappers, _offline_argv, _spawn,
                                 make_trees, mode2_config, mode2_data)
from view_neti_tpu_torch import train as ttrain
from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.inference import offline
from view_neti_tpu_torch.inference import pipeline as tpipe
from view_neti_tpu_torch.inference.prompt_manager import PromptManager
from view_neti_tpu_torch.models.clip_text import (NeTICLIPTextEncoder,
                                                  sd15_text_config,
                                                  sd21_text_config)
from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                             sd15_unet_config,
                                             sd21_unet_config)
from view_neti_tpu_torch.parallel import dist
from view_neti_tpu_torch.parallel import tensor
from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import inference_dtu
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts
from view_neti_tpu_torch.training.validate import ValidationHandler

TP = {"tp": 2, "tensor_parallel": True}
TP_ARGS = ["--parallel.tp", "2", "--parallel.tensor_parallel", "true"]
RENDER_STEPS, RENDER_RES = 2, 16
MODULE = "test_torch_port_tp"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return make_trees(tmp_path_factory.mktemp("tp_dtu"))


# ---------------------------------------------------- the rank side ----

def _split_stack(dp, trees, runs, stack):
    """A one-process tiny mode-2 stack (no nested dropout) holding the
    parent's weights from its .npz, then split over the rank's tp group
    (dp 2 x tp 2 at world 4, tp 2 at world 2): (its Coach, the layout).
    Its Coach logs beside the watched runs directory."""
    d = dict(np.load(stack))
    coach = _coach(mode2_config(trees, Path(runs).parent / f"stack{dp.rank}",
                                model=STEP_MODEL), trees)
    tb = coach.built
    for name, module in _named(tb).items():
        module.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v)
                                for k, v in d.items()
                                if k.startswith(name + ".")}, strict=True)
    layout = dist.with_layout(dp, 2, True)
    tensor.shard_frozen_(tb.unet, tb.text.clip, layout, log=lambda m: None)
    return coach, layout


def _named(tb):
    return {"clip": tb.text.clip, "unet": tb.unet, "vae": tb.vae,
            "object": tb.text.obj_mappers[0], "view": tb.text.view_mapper}


def job_step(dp, trees, runs, stack, steps=STEPS):
    """Three train steps with JAX's draws, the rows and draws of the rank's
    dp group, the gradient mean over the dp group: each step's loss,
    mapper gradients and parameters."""
    coach, layout = _split_stack(dp, trees, runs, stack)
    tb = coach.built
    d = np.load(stack)
    named = _named(tb)
    opt = toptim.SlicedAdamW(tbuilder.trainable_groups(tb),
                             toptim.make_lr_schedule("constant", STEP_LR,
                                                     0, 10))
    step = tts.make_train_step(opt, reduce=functools.partial(
        dist.all_reduce_step_, layout, opt))
    t = {k: torch.from_numpy(d[k]) for k in ("pixels", "ids", "obj", "view")}
    batch = tts.TrainBatch(*(dist.shard_rows(t[k], layout)
                             for k in ("pixels", "ids", "obj", "view")))
    out = []
    for s in range(steps):
        draws = dist.shard_draws(tts.StepDraws(
            *(torch.from_numpy(d[f"{k}{s}"])
              for k in ("vae_eps", "noise", "timesteps"))), layout, STEP_B)
        loss = float(step(tb, batch, draws)["total_loss"])
        out.append(dict(
            loss=loss,
            grads={k: {n: p.grad.numpy().copy()
                       for n, p in named[k].named_parameters()}
                   for k in ("object", "view")},
            params={k: {n: p.detach().numpy().copy()
                        for n, p in named[k].named_parameters()}
                    for k in ("object", "view")}))
    return out


def job_fault(dp, trees, runs, stack):
    """The first train step with a planted fault: copy_to_tp's backward
    passes each rank's part of the gradient on without the sum over the
    tp group."""
    backward = tensor._CopyToTP.backward
    tensor._CopyToTP.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        return job_step(dp, trees, runs, stack, steps=1)
    finally:
        tensor._CopyToTP.backward = backward


def job_render(dp, trees, runs, stack, latents):
    """Two prompts (C = 2, seed 0) conditioned through the split CLIP,
    denoised by the split UNet from JAX's initial latents
    (RENDER_STEPS DPM-Solver++ steps, CFG 7.5) and decoded to uint8."""
    coach, _ = _split_stack(dp, trees, runs, stack)
    tb = coach.built
    sched = DPMSolverSchedule()
    pm = PromptManager(tb.tokenizer, tb.text,
                       sched.set_timesteps(RENDER_STEPS),
                       tb.placeholder_view_token_ids,
                       tb.placeholder_object_token_ids)
    with torch.no_grad():
        pairs = [pm.embed_prompt(p) for p in _prompts(coach)]
        ctx = torch.cat([c for c, _ in pairs], dim=2)
        ctx_b = torch.cat([b for _, b in pairs], dim=2)
        uncond = tpipe.encode_uncond(tb.text.clip, tb.tokenizer)
        lat = tpipe.make_denoise_fn(tb.unet, sched, RENDER_STEPS, 7.5)(
            torch.from_numpy(np.load(latents)["lat0"]), ctx, ctx_b, uncond)
        return tpipe.decode_to_uint8(tb.vae, lat).numpy()


def _prompts(coach):
    obj = coach.placeholder_object_tokens[0]
    return [f"{v}. A photo of a {obj}"
            for v in coach.placeholder_view_tokens[:2]]


def job_coach(dp, trees, runs, parallel):
    """The tiny mode-2 Coach (fused 2 x 2, 4 steps) in the layout, with a
    validation round at step 4: its DTU sweep split over the dp groups
    (each rank's rendered cameras recorded), the object render by rank 0's
    tp group."""
    rendered = []
    render = inference_dtu.render_cameras

    def recording(coach, cams, *args, **kwargs):
        rendered.append(list(cams))
        return render(coach, cams, *args, **kwargs)
    inference_dtu.render_cameras = recording
    try:
        coach = _coach(_val_config(trees, Path(runs) / "coach", parallel),
                       trees, dp)
        coach.validator = ValidationHandler(
            coach.cfg, masks_root=trees["masks"],
            calibration_dir=trees["cal"])
        coach.train()
    finally:
        inference_dtu.render_cameras = render
    return dict(losses=coach.losses, mappers=_mappers(coach),
                counts=coach.optimizer.counts, rendered=rendered,
                layout=(coach.dist.dp_index, coach.dist.tp_index,
                        coach.dist.dp_world, coach.dist.tp_world))


def _val_config(trees, exp_dir, parallel):
    return mode2_config(trees, exp_dir, parallel=parallel,
                        eval={"validation_prompts": ["A photo of a {}"],
                              "validation_steps": VAL_STEP},
                        log={"save_steps": VAL_STEP})


# --------------------------------------------------- the parent side ----

@pytest.fixture(scope="module")
def stack(trees, tmp_path_factory):
    """The tiny stack's weights, a batch and JAX's draws in an .npz, the
    JAX package's stack around the same weights
    (tests/test_torch_port_validate.py::_jax_stack), and the port Coach
    that holds them."""
    import jax.numpy as jnp
    from view_neti_tpu.config import RunConfig as JRunConfig
    from view_neti_tpu.config import decode as jdecode
    from test_torch_port_validate import _jax_stack
    root = tmp_path_factory.mktemp("tp_stack")
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
    arrays = {f"{name}.{k}": v.detach().numpy()
              for name, module in _named(tb).items()
              for k, v in module.state_dict().items()}
    arrays.update(_jax_draws(STEP_B, STEP_IMG, STEPS), pixels=pixels,
                  ids=ids, obj=obj, view=view)
    np.savez(root / "stack.npz", **arrays)
    from view_neti_tpu.training.train_step import TrainBatch as JBatch
    jbatch = JBatch(pixel_values=jnp.asarray(pixels),
                    input_ids=jnp.asarray(ids, jnp.int32),
                    input_ids_placeholder_object=jnp.asarray(obj, jnp.int32),
                    input_ids_placeholder_view=jnp.asarray(view, jnp.int32),
                    object_idx=jnp.asarray(0, jnp.int32))
    return dict(path=str(root / "stack.npz"), jax=jc, jbatch=jbatch,
                coach=tc)


def _jax_tp_render(jc, tc, latents_path):
    """JAX's generate_batch on a dp 2 x tp 2 mesh with the UNet placed by
    frozen_param_shardings(tensor_parallel=True)
    (tests/test_parallel.py:168-203), the two prompts of job_render at
    seed 0; writes its initial latents for the ranks."""
    import jax
    import jax.numpy as jnp
    from view_neti_tpu.inference.pipeline import encode_uncond, generate_batch
    from view_neti_tpu.inference.prompt_manager import PromptManager as JPM
    from view_neti_tpu.parallel import mesh as pmesh
    from view_neti_tpu.schedulers.dpm_solver import DPMSolverSchedule as JDPM
    jb = jc.built
    frozen = jb.frozen
    mesh = pmesh.make_mesh(n_dp=2, n_tp=2, devices=jax.devices("cpu")[:4])
    sh = pmesh.frozen_param_shardings(frozen.unet_vars, mesh,
                                      tensor_parallel=True)
    schedule = JDPM()
    pm = JPM(jb.tokenizer, frozen.text, jb.trainable,
             schedule.set_timesteps(RENDER_STEPS),
             placeholder_view_token_ids=jb.placeholder_view_token_ids,
             placeholder_object_token_ids=jb.placeholder_object_token_ids)
    pairs = [pm.embed_prompt(p) for p in _prompts(tc)]
    uncond = encode_uncond(frozen.text.clip, frozen.text.clip_vars,
                           jb.tokenizer, max_length=16)
    scale = 2 ** (len(frozen.vae.config.channel_mults) - 1)
    lat = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (RENDER_RES // scale, RENDER_RES // scale, 4),
        jnp.float32))
    np.savez(latents_path, lat0=np.stack([lat, lat]))
    return generate_batch(
        frozen.unet, pmesh.shard_pytree(frozen.unet_vars, sh), frozen.vae,
        frozen.vae_vars, schedule,
        jnp.concatenate([c for c, _ in pairs], axis=2),
        jnp.concatenate([b for _, b in pairs], axis=2), uncond,
        height=RENDER_RES, width=RENDER_RES, seeds=[0],
        num_inference_steps=RENDER_STEPS, mesh=mesh)


def _single(trees, root):
    single = _coach(_val_config(trees, root / "single", {}), trees)
    single.validator = ValidationHandler(
        single.cfg, masks_root=trees["masks"], calibration_dir=trees["cal"])
    single.train()
    return dict(losses=single.losses, mappers=_mappers(single),
                counts=single.optimizer.counts, dir=root / "single")


@pytest.fixture(scope="module")
def world2(trees, stack, tmp_path_factory):
    """The world-2 ranks (tp 2): the CLIs, the Coach and the render;
    meanwhile JAX's tp render and the one-process Coach and train CLI;
    after them, one process's offline sweep of the ranks' CLI run."""
    root = tmp_path_factory.mktemp("tp_world2")
    runs = str(root / "runs")
    latents = root / "latents.npz"
    jax_imgs = _jax_tp_render(stack["jax"], stack["coach"], latents)
    ranks = _spawn(2, root, [
        ("cli", {"trees": trees, "runs": runs, "ports": _free_ports(3),
                 "extra": TP_ARGS}),
        (f"{MODULE}:job_coach", {"trees": trees, "runs": runs,
                                 "parallel": TP}),
        (f"{MODULE}:job_render", {"trees": trees, "runs": runs,
                                  "stack": stack["path"],
                                  "latents": str(latents)})])
    single = _single(trees, root)
    os.environ["VIEW_NETI_TINY"] = "1"
    os.environ["DTU_CALIBRATION_DIR"] = trees["cal"]
    try:
        cli = ttrain.main(_cli_argv(trees, root / "cli1"), device="cpu")
        out = _join(ranks, root, 2)
        sweep = offline.main(_offline_argv(
            root / "runs" / "cli" / "train", root / "cli_offline1", trees,
            2), device="cpu")
    finally:
        del os.environ["VIEW_NETI_TINY"], os.environ["DTU_CALIBRATION_DIR"]
    return dict(ranks=out, root=root, single=single, cli=cli,
                cli_sweep=np.stack(sweep["imgs_pred"]),
                jax_render=np.asarray(jax_imgs))


@pytest.fixture(scope="module")
def world4(trees, stack, tmp_path_factory):
    """The world-4 ranks (dp 2 x tp 2): the train step, the planted fault
    and the Coach; meanwhile JAX's step on its dp 2 x tp 2 mesh and the
    one-process Coach."""
    root = tmp_path_factory.mktemp("tp_world4")
    runs = str(root / "runs")
    step = {"trees": trees, "runs": runs, "stack": stack["path"]}
    ranks = _spawn(4, root, [
        (f"{MODULE}:job_step", step), (f"{MODULE}:job_fault", step),
        (f"{MODULE}:job_coach", {"trees": trees, "runs": runs,
                                 "parallel": TP})])
    jax_steps = _jax_dp2_steps(stack["jax"].built, stack["jbatch"], STEPS,
                               STEP_LR, n_tp=2)
    single = _single(trees, root)
    return dict(ranks=_join(ranks, root, 4), root=root, single=single,
                jax=jax_steps)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=MAPPER_RTOL,
                               atol=MAPPER_ATOL)


# ------------------------------------------------------------- tests ----

def test_table_splits_what_jax_splits(stack):
    """1. On the tiny stack, every kernel that JAX's
    frozen_param_shardings(tensor_parallel=True) splits over a dp 2 x tp 2
    mesh is split by the port's plan, and nothing JAX replicates, except
    the time embedding's two layers, which the port keeps whole (JAX's
    fc1$ / fc2$ match time_fc1 / time_fc2). A bias follows its layer: cut
    with a column layer's outputs, whole under a row layer."""
    import jax
    from view_neti_tpu.parallel import mesh as pmesh
    jb = stack["jax"].built
    tb = stack["coach"].built
    mesh = pmesh.make_mesh(n_dp=2, n_tp=2, devices=jax.devices("cpu")[:4])
    time_fc = {"time_embedding.linear_1.weight",
               "time_embedding.linear_2.weight"}
    n_split = 0
    for module, variables, table in (
            (tb.unet, jb.frozen.unet_vars,
             twp.unet_mapping(len(tb.arch.unet.block_out_channels))),
            (tb.text.clip, jb.frozen.text.clip_vars,
             twp.clip_text_mapping(tb.arch.text.num_layers))):
        sh = pmesh.frozen_param_shardings(variables, mesh,
                                          tensor_parallel=True)
        specs = {tuple(getattr(p, "key", str(p)) for p in path[1:]):
                 s.spec
                 for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]}
        plan = tensor.tp_plan(module, 2)
        for key in module.state_dict():
            if key not in table:
                continue
            jax_split = "tp" in tuple(specs[table[key][0]])
            rule = plan.get(key, "replicated")
            if key.endswith(".bias"):
                assert not jax_split, key
                layer = plan.get(key[:-len("bias")] + "weight")
                assert rule == (layer if layer in ("column", "geglu")
                                else "replicated"), key
                continue
            n_split += rule != "replicated"
            if key in time_fc:
                assert jax_split and rule == "replicated", key
            else:
                assert jax_split == (rule != "replicated"), (key, rule)
    # 16 blocks x (2 x 4 attention + 2 feed-forward) and 2 CLIP MLPs x 2
    assert n_split == 16 * 10 + 2 * 2


def _rebuild(pieces, rule):
    if rule == "replicated":
        for p in pieces[1:]:
            torch.testing.assert_close(p, pieces[0], rtol=0, atol=0)
        return pieces[0]
    if rule == "row":
        return torch.cat(pieces, dim=1)
    if rule == "geglu":
        halves = [p.chunk(2, dim=0) for p in pieces]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves])
    return torch.cat(pieces, dim=0)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("which", ["unet", "clip"])
def test_slices_rebuild_every_full_tensor(stack, tp, which):
    """2. At tp 2 and 4 the ranks' pieces (tp_shard_state_dict) put back
    together give every full tensor, GEGLU's value and gate halves
    included; shard_frozen_ leaves each rank's modules holding exactly its
    pieces. The tiny UNet's 2-head attentions stay whole at tp 4."""
    import copy
    tb = stack["coach"].built
    module = tb.unet if which == "unet" else tb.text.clip
    sd = module.state_dict()
    plan = tensor.tp_plan(module, tp)
    pieces = [tensor.tp_shard_state_dict(sd, r, tp, plan) for r in range(tp)]
    for key, full in sd.items():
        got = _rebuild([p[key] for p in pieces], plan.get(key, "replicated"))
        torch.testing.assert_close(got, full, rtol=0, atol=0, msg=key)
    rules = set(plan.values())
    if which == "unet":
        assert {"geglu", "row"} <= rules
        heads_split = any(k.endswith("attn1.to_q.weight") and r == "column"
                          for k, r in plan.items())
        assert heads_split == (tp == 2)
    for r in range(tp):
        unet, clip = copy.deepcopy(tb.unet), copy.deepcopy(tb.text.clip)
        tensor.shard_frozen_(unet, clip, dist.DataParallel(
            rank=r, world=tp, backend="gloo", tp_world=tp,
            tensor_parallel=True), log=lambda m: None)
        local = (unet if which == "unet" else clip).state_dict()
        assert local.keys() == pieces[r].keys()
        for key, want in pieces[r].items():
            torch.testing.assert_close(local[key], want, rtol=0, atol=0,
                                       msg=key)


def test_head_rule_on_the_published_configs():
    """3. From the published configs (on the meta device): SD-2.1's
    320-channel level has 5 heads of 64, so at tp 2 its attentions stay
    whole, while its feed-forwards and the 640 and 1280 levels split;
    SD-1.5 (8 heads everywhere) and both CLIPs split everything the table
    names."""
    with torch.device("meta"):
        unets = {name: UNet2DCondition(cfg()) for name, cfg in
                 (("sd15", sd15_unet_config), ("sd21", sd21_unet_config))}
        clips = [NeTICLIPTextEncoder(c()) for c in
                 (sd15_text_config, sd21_text_config)]
    for name, unet in unets.items():
        plan = tensor.tp_plan(unet, 2)
        for path, unit, width, heads in tensor._units(unet):
            rule = plan[f"{path}.{'to_q' if heads else 'net.2'}.weight"]
            whole = heads == 5
            assert (rule == "replicated") == whole, (name, path)
            assert whole == (name == "sd21" and width == 320
                             and heads is not None), (name, path)
    for clip in clips:
        plan = tensor.tp_plan(clip, 2)
        assert {plan[k] for k in plan if k.endswith("weight")} == {
            "column", "row"}


def test_step_at_dp2_tp2_matches_the_jax_mesh(world4):
    """4. The train step at world 4 (dp 2 x tp 2) with JAX's draws against
    JAX's jit_train_step on a dp 2 x tp 2 mesh with the frozen UNet and
    CLIP tp-split: each step's loss, mapper gradients and parameters at
    rtol 5e-3, atol 1e-5; the four ranks bit-equal."""
    port = [r[f"{MODULE}:job_step"] for r in world4["ranks"]]
    for other in port[1:]:
        for a, b in zip(port[0], other):
            assert a["loss"] == b["loss"]
            for kind in ("grads", "params"):
                for key in a[kind]:
                    for name, v in a[kind][key].items():
                        np.testing.assert_array_equal(v, b[kind][key][name])
    for j, t in zip(world4["jax"], port[0]):
        _close(t["loss"], j["loss"])
        for kind in ("grads", "params"):
            for key in ("object", "view"):
                for name, got in t[kind][key].items():
                    np.testing.assert_allclose(
                        got, j[kind][key][name].numpy(), rtol=MAPPER_RTOL,
                        atol=MAPPER_ATOL, err_msg=f"{kind} {key}.{name}")


def test_a_missing_backward_sum_leaves_the_tolerance(world4):
    """7. With copy_to_tp's backward sum planted out (each rank keeps its
    own part of the input gradients), the first step's mapper gradients
    leave the tolerance that the sound step meets."""
    jax0 = world4["jax"][0]["grads"]
    fault = world4["ranks"][0][f"{MODULE}:job_fault"][0]["grads"]
    outside = 0
    for key in ("object", "view"):
        for name, got in fault[key].items():
            want = jax0[key][name].numpy()
            outside += int((np.abs(got - want) > MAPPER_ATOL
                            + MAPPER_RTOL * np.abs(want)).sum())
    assert outside > 0


@pytest.mark.parametrize("world", [2, 4])
def test_coach_in_tp_layout_equals_one_process(world2, world4, world):
    """5. The tiny mode-2 Coach at world 2 (tp 2) and world 4 (dp 2 x tp
    2) against one process: each loss within 1e-6 relative, the mappers at
    rtol 5e-3, atol 1e-5, the same per-slice counts, every rank bit-equal;
    the validation round's sweep (2 cameras) split over the dp groups, the
    ranks of a tp group rendering the same cameras; rank 0's bundle within
    one uint8 level of one process's, and its object render too. Only rank
    0 wrote files."""
    run = {2: world2, 4: world4}[world]
    ranks = [r[f"{MODULE}:job_coach"] for r in run["ranks"]]
    single = run["single"]
    for r, got in enumerate(ranks):
        assert got["layout"] == (r // 2, r % 2, world // 2, 2)
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=1e-6)
        assert got["counts"] == single["counts"]
        for k, v in single["mappers"].items():
            _close(got["mappers"][k], v)
            np.testing.assert_array_equal(got["mappers"][k],
                                          ranks[0]["mappers"][k])
        cams = inference_dtu.get_cam_idxs(6)[0][:2]
        assert got["rendered"] == [dist.split_items(cams, r // 2,
                                                    world // 2)]
    for r in run["ranks"][1:]:
        assert r["writes"] == []
    from view_neti_tpu_torch.utils import msgpack_codec
    name = f"validation-iter_{VAL_STEP}-denoisesteps_2_numseeds_2.msgpack"
    got = msgpack_codec.unpackb(
        (run["root"] / "runs" / "coach" / name).read_bytes())["imgs_pred"]
    want = msgpack_codec.unpackb(
        (single["dir"] / name).read_bytes())["imgs_pred"]
    assert got.shape == want.shape == (2, len(SEEDS), 300, 400, 3)
    assert np.abs(got - want).max() <= 1 / 255 + 1e-6
    sheet = f"val-disentangled-step{VAL_STEP}.png"
    got = image_io.read_rgb(run["root"] / "runs" / "coach" / sheet)
    want = image_io.read_rgb(single["dir"] / sheet)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (sorted(p.name for p in (run["root"] / "runs" / "coach")
                   .iterdir())
            == sorted(p.name for p in single["dir"].iterdir()))


def test_clis_take_the_tp_options(world2):
    """The train CLI under torchrun's variables and offline inference under
    the VIEW_NETI_* variables, both with --parallel.tp 2
    --parallel.tensor_parallel true at world 2: the run logs its mesh, ends
    within 1e-6 of the one-process CLI run's loss with its files; the
    split offline sweep (rank 0's; rank 1 returns None) within one uint8
    level of one process's sweep of the same run; a refused run directory
    ends both ranks; each entry point left its group."""
    root = world2["root"]
    run = root / "runs" / "cli" / "train"
    assert (sorted(p.name for p in run.iterdir())
            == sorted(p.name for p in (root / "cli1" / "train").iterdir()))
    log = (run / "logs" / "log.txt").read_text()
    assert "device mesh: dp=1 tp=2 (tensor_parallel=True)" in log
    for r in world2["ranks"]:
        cli = r["cli"]
        assert not cli["initialized_after"]
        assert cli["train"]["steps"] == 2
        assert cli["train"]["final_loss"] == pytest.approx(
            world2["cli"]["final_loss"], rel=1e-6)
    rank0, rank1 = (r["cli"] for r in world2["ranks"])
    assert rank1["offline"] is None
    assert rank0["offline"].shape == world2["cli_sweep"].shape
    assert np.abs(rank0["offline"] - world2["cli_sweep"]).max() <= (
        1 / 255 + 1e-6)
    assert rank0["refused"].startswith("FileExistsError: ")
    assert rank1["refused"].startswith("RuntimeError: rank 0 could not "
                                       "prepare ")


def test_render_matches_the_jax_tp_mesh(world2):
    """6. Two prompts through the split CLIP and UNet from JAX's initial
    latents against JAX's generate_batch on a dp 2 x tp 2 mesh with the
    tp-placed UNet: uint8 within one level; both ranks bit-equal."""
    a, b = (r[f"{MODULE}:job_render"] for r in world2["ranks"])
    np.testing.assert_array_equal(a, b)
    want = world2["jax_render"].reshape(a.shape)
    assert a.shape == (2, RENDER_RES, RENDER_RES, 3)
    assert np.abs(a.astype(int) - want).max() <= 1


def test_with_layout_places_every_rank():
    """Rank r of a dp x tp layout sits at dp index r // tp and tp index
    r % tp (mesh.py's reshape(n_dp, n_tp)) and keeps its dp group's rows;
    tensor_parallel at tp 1 and one process split nothing."""
    for world, tp in ((4, 2), (6, 3), (6, 2)):
        for r in range(world):
            rec = dist.DataParallel(rank=r, world=world, backend="gloo",
                                    tp_world=tp, tensor_parallel=True)
            assert (rec.dp_index, rec.tp_index, rec.dp_world) == (
                r // tp, r % tp, world // tp)
            assert rec.sharded
            n = 12 // (world // tp)
            assert dist.rows(rec, 12) == ((r // tp) * n, (r // tp + 1) * n)
    one = dist.DataParallel(rank=1, world=2, backend="gloo")
    assert not dist.with_layout(one, 1, True).sharded
    alone = dist.DataParallel()
    assert dist.with_layout(alone, 2, True) == alone
