"""The port's dispatch windows (optim.steps_per_dispatch), on the CPU: the
window sizes against the JAX Coach's own `_dispatch_window`, the default
window against its rule, the optimizer that decides every step on the
device against its earlier host-read form and JAX's `sliced_adamw`, and a
tiny Coach at steps_per_dispatch 4 against 1 (a save and a validation
boundary inside a 4-step window, a resume in the middle). On the CPU the
windows run eagerly; the CUDA graphs that replay them on the card are held
by tests/test_torch_port_kernels.py and chip_smoke.py.
"""
import ast
import inspect
import itertools
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from view_neti_tpu.training import optim as joptim
from view_neti_tpu.training.coach import Coach as JCoach
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import coach as tcoach
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.utils import msgpack_codec

import test_torch_port_coach as mode2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ windows ----

def _cfg(max_steps, save, val, prompts):
    return SimpleNamespace(
        optim=SimpleNamespace(max_train_steps=max_steps),
        log=SimpleNamespace(save_steps=save),
        eval=SimpleNamespace(validation_steps=val,
                             validation_prompts=prompts))


@pytest.mark.parametrize("spd,accum_k,validator", list(itertools.product(
    [0, 1, 2, 4, 5], [1, 3], [False, True])))
def test_dispatch_window_equals_the_jax_coachs(spd, accum_k, validator):
    """Every global step of runs of 9 and 13 steps, saves every 3, 4 or 10,
    validation every 4, 5 or 7 (prompts set or not), against
    view_neti_tpu.training.coach.Coach._dispatch_window called unbound."""
    for max_steps, save, val, prompts in itertools.product(
            (9, 13), (3, 4, 10), (4, 5, 7), (None, ["a {}"])):
        cfg = _cfg(max_steps, save, val, prompts)
        for step in range(max_steps):
            jax_self = SimpleNamespace(
                cfg=cfg, steps_per_dispatch=spd, global_step=step,
                validator=object() if validator else None, accum_k=accum_k)
            want = JCoach._dispatch_window(jax_self)
            got = tcoach.dispatch_window(cfg, spd, step, validator, accum_k)
            assert got == want, (max_steps, save, val, prompts, step)


def _jax_default_rule():
    """The JAX Coach's resolution of optim.steps_per_dispatch, read out of
    its __init__ (the statements from `spd = cfg.optim.steps_per_dispatch`
    to `self.steps_per_dispatch = spd`) as a function of (cfg, self)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(JCoach.__init__)))
    body = tree.body[0].body
    first = next(i for i, st in enumerate(body)
                 if ast.unparse(st) == "spd = cfg.optim.steps_per_dispatch")
    last = next(i for i, st in enumerate(body)
                if ast.unparse(st) == "self.steps_per_dispatch = spd")
    src = "def rule(cfg, self):\n" + textwrap.indent("\n".join(
        ast.unparse(st) for st in body[first:last + 1]), "    ")
    src += "\n    return self.steps_per_dispatch\n"
    space = {}
    exec(src, space)
    return space["rule"]


@pytest.mark.parametrize("cache", [False, True])
def test_default_steps_per_dispatch_follows_the_jax_rule(cache):
    rule = _jax_default_rule()
    for spd in (0, 1, 2, 3, 4, 8):
        cfg = SimpleNamespace(optim=SimpleNamespace(steps_per_dispatch=spd))
        want = rule(cfg, SimpleNamespace(use_pixel_cache=cache))
        assert tcoach.resolve_steps_per_dispatch(spd, cache) == want


@pytest.mark.parametrize("device_augment", [True, False])
def test_coach_resolves_its_window(tree, tmp_path, device_augment):
    """Preset 7 with the base cache on the card: 4; on the host (no
    cache): 1, as the JAX Coach resolves them."""
    coach = _coach(tree, tmp_path, "w", data={
        "device_augment": device_augment})
    assert coach.use_pixel_cache == device_augment
    assert coach.steps_per_dispatch == (4 if device_augment else 1)


# ---------------------------------------------------------- optimizer ----

def _host_read_adamw(slices, schedule, kw, grads_per_step):
    """The optimizer's earlier form: torch.optim.AdamW with one group per
    slice, the activity read to the host, an inactive slice's gradients
    set to None, the counts and the learning rate on the host. Returns
    the parameters after each step, the counts and the rates."""
    groups, counts = [], {}
    for key, sl in slices.items():
        counts[key] = [0] * len(sl)
        for i, params in enumerate(sl):
            groups.append({"params": params, "key": key, "slice": i})
    opt = torch.optim.AdamW(groups, lr=schedule(1), betas=(kw["b1"],
                                                           kw["b2"]),
                            eps=kw["eps"], weight_decay=kw["weight_decay"])
    history = []
    for grads in grads_per_step:
        for g, gg in zip(groups, grads):
            for p, x in zip(g["params"], gg):
                p.grad = torch.from_numpy(x.copy())
        for g in groups:
            if sum(float(p.grad.abs().sum()) for p in g["params"]) > 0:
                counts[g["key"]][g["slice"]] += 1
            else:
                for p in g["params"]:
                    p.grad = None
        for g in groups:
            g["lr"] = schedule(max(counts[g["key"]]))
        opt.step()
        history.append(([[p.detach().clone() for p in g["params"]]
                         for g in groups],
                        {k: list(v) for k, v in counts.items()},
                        {k: schedule(max(v)) for k, v in counts.items()}))
    return history


@pytest.mark.parametrize("kind", ["constant_with_warmup", "cosine"])
def test_device_side_adamw(kind):
    """A bank of three object slices and a view mapper over six steps, the
    slices idle in some of them, under a warm-up schedule: the counts,
    each key's learning rate and the parameters equal the earlier
    host-read optimizer's bit for bit, and JAX's sliced_adamw within
    1e-6 + 1e-6 |p| (fp32 on both sides: a few ulps of rounding order
    over six steps)."""
    rng = np.random.RandomState(3)
    n_obj, steps = 3, 6
    shapes = {"object": {"w": (5, 3), "b": (3,)}, "view": {"w": (4, 4)}}
    init = {"object": {n: rng.randn(n_obj, *s).astype(np.float32)
                       for n, s in shapes["object"].items()},
            "view": {"w": rng.randn(4, 4).astype(np.float32)}}
    idle = {1: [1], 2: [0, 2], 3: ["view"], 4: [0, 1, 2]}
    grads = []
    for step in range(steps):
        g = {"object": {n: rng.randn(n_obj, *s).astype(np.float32)
                        for n, s in shapes["object"].items()},
             "view": {"w": rng.randn(4, 4).astype(np.float32)}}
        for i in idle.get(step, []):
            if i == "view":
                g["view"]["w"][:] = 0
            else:
                for n in g["object"]:
                    g["object"][n][i] = 0
        grads.append(g)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    schedule = toptim.make_lr_schedule(kind, 0.05, 3, 8)

    def slices():
        bank = [[torch.nn.Parameter(torch.from_numpy(
            init["object"][n][i].copy())) for n in ("w", "b")]
            for i in range(n_obj)]
        return {"object": bank, "view": [[torch.nn.Parameter(
            torch.from_numpy(init["view"]["w"].copy()))]]}

    def slice_grads(g):
        return ([[g["object"][n][i] for n in ("w", "b")]
                 for i in range(n_obj)] + [[g["view"]["w"]]])

    ref = _host_read_adamw(slices(), schedule, kw,
                           [slice_grads(g) for g in grads])
    jopt = joptim.sliced_adamw(joptim.make_lr_schedule(kind, 0.05, 3, 8),
                               **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    jstate = jopt.init(jparams)
    sl = slices()
    opt = toptim.SlicedAdamW(sl, schedule, schedule_steps=8, **kw)
    params = [p for key in ("object", "view") for s in sl[key] for p in s]
    for g, (want, counts, rates) in zip(grads, ref):
        opt.zero_grad()
        for p, x in zip(params, [x for s in slice_grads(g) for x in s]):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert opt.counts == counts
        assert opt.learning_rates() == rates
        for p, w in zip(params, [w for s in want for w in s]):
            torch.testing.assert_close(p.detach(), w, rtol=0, atol=0)
        for n in ("w", "b"):
            got = torch.stack([sl["object"][i][("w", "b").index(n)].detach()
                               for i in range(n_obj)]).numpy()
            np.testing.assert_allclose(got, np.asarray(jparams["object"][n]),
                                       atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(sl["view"][0][0].detach().numpy(),
                                   np.asarray(jparams["view"]["w"]),
                                   atol=1e-6, rtol=1e-6)
    assert opt.counts == {"object": [4, 4, 4], "view": [5]}


# -------------------------------------------------------------- coach ----

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return mode2.make_tree(tmp_path_factory.mktemp("dtu"))


def _coach(tree, tmp_path, name, **changes):
    rect, cal = tree
    data = mode2.tiny_cfg(rect, tmp_path / name)
    for section, values in changes.items():
        data[section].update(values)
    return tcoach.Coach(decode(RunConfig, data), arch=tbuilder.tiny_arch(),
                        calibration_dir=str(cal), device="cpu")


class RecordingValidator:
    """Stands in for ValidationHandler: records each round's step and the
    view mapper it would render."""

    def __init__(self):
        self.rounds = []

    def infer(self, coach, step):
        self.rounds.append((step, {
            k: v.clone()
            for k, v in coach.built.text.view_mapper.state_dict().items()}))


def _run(tree, tmp_path, name, spd, steps, resume=False):
    coach = _coach(
        tree, tmp_path, name,
        optim={"steps_per_dispatch": spd, "max_train_steps": steps,
               "lr_scheduler": "constant_with_warmup",
               "lr_warmup_steps": 4},
        log={"save_steps": 3, "checkpoint_backend": "orbax",
             "resume_from": "latest" if resume else None},
        eval={"validation_prompts": ["A photo of a {}"],
              "validation_steps": 4})
    coach.validator = RecordingValidator()
    logged, windows = [], []
    log_metrics = coach.logger.log_metrics
    coach.logger.log_metrics = lambda m, step=None: (
        logged.append((step, m["total_loss"], m["lr"])),
        log_metrics(m, step=step))
    run_window = coach._run_window
    coach._run_window = lambda w, *a: (windows.append(w),
                                       run_window(w, *a))[1]
    start = coach.global_step
    coach.train()
    files = {}
    for p in sorted(Path(coach.cfg.log.exp_dir).rglob("*.msgpack")):
        payload = msgpack_codec.unpackb(p.read_bytes())
        if isinstance(payload, dict) and "cfg" in payload:
            # the saved config names the run's directory and its window
            payload = {k: v for k, v in payload.items() if k != "cfg"}
        files[p.name] = msgpack_codec.packb(payload)
    return dict(start=start, coach=coach, logged=logged, windows=windows,
                files=files, counts=coach.optimizer.counts,
                rounds=coach.validator.rounds)


@pytest.fixture(scope="module")
def windowed(tree, tmp_path_factory):
    """7 steps in 4-step windows, saves every 3, validation every 4."""
    return _run(tree, tmp_path_factory.mktemp("w4"), "run", 4, 7)


def test_window_of_four_equals_one_step_at_a_time(tree, tmp_path, windowed):
    """7 steps, saves every 3 and validation every 4: the 4-step windows
    shrink to 3, 1, 2, 1 to land on them. Losses, learning rates, the
    validation rounds, the optimizer counts and every checkpoint and
    train-state file equal those of steps_per_dispatch 1."""
    win, one = windowed, _run(tree, tmp_path, "w1", 1, 7)
    assert win["windows"] == [3, 1, 2, 1] and one["windows"] == [1] * 7
    assert win["coach"].global_step == one["coach"].global_step == 7
    assert [s for s, _, _ in win["logged"]] == list(range(1, 8))
    assert win["logged"] == one["logged"]
    assert win["coach"].losses == one["coach"].losses
    assert win["counts"] == one["counts"] == {"object": [7], "view": [7]}
    assert [s for s, _ in win["rounds"]] == [s for s, _ in one["rounds"]] \
        == [4]
    for (_, a), (_, b) in zip(win["rounds"], one["rounds"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(win["files"]) == sorted(one["files"])
    assert {"state-3.msgpack", "state-6.msgpack"} <= set(win["files"])
    for name, data in win["files"].items():
        assert data == one["files"][name], name
    log = (Path(win["coach"].cfg.log.exp_dir) / "logs" / "log.txt").read_text()
    assert "running an additional 1-microbatch dispatch window" in log


def test_window_resumed_in_the_middle(tree, tmp_path, windowed):
    """A 4-step-window run stopped at step 5 and resumed from its latest
    state to step 7 equals the straight one: the windows from step 5,
    losses, counts and final files."""
    _run(tree, tmp_path, "run", 4, 5)
    resumed = _run(tree, tmp_path, "run", 4, 7, resume=True)
    assert resumed["start"] == 5 and resumed["windows"] == [1, 1]
    assert resumed["coach"].losses == windowed["coach"].losses[5:]
    assert resumed["counts"] == windowed["counts"]
    for name in ("mapper-final_view.msgpack", "mapper-final_object.msgpack",
                 "learned_embeds-final.msgpack", "state-6.msgpack",
                 "state-7.msgpack"):
        assert resumed["files"][name] == windowed["files"][name], name
