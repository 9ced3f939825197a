"""The training traffic: the port's Coach (training/coach.py Coach.train)
on a recipe, one synthetic DTU scan, its loop as the client.

Set-up writes the scan's PNGs and the calibration files under TMPDIR,
builds the Coach, loads the run's weights into it and starts its loop.
The benchmark wraps `coach.window_step`, the call that runs one optimizer
step (a CUDA graph replay on the card): the wrapper keeps the first
`check_steps` steps' feed (batches and draws), the mappers before the
first step, the optimizer's first moments after it and the mappers before
step check_steps + 1; after `warmup_steps` steps it synchronizes and
opens the window; at the first step boundary after `seconds` (or, traced,
after `trace_steps` steps) it synchronizes and closes it, and ends the
loop by lowering the recipe's max_train_steps to 0, which the loop reads
after its current dispatch window. The final checkpoint, which lies
after the window, is not written.

After the window, the reference follows the kept steps from the same
weights, scan and feed (reference: augmentation, VAE encode, noising,
conditioning, UNet, loss, gradients and AdamW) in float32, and the
comparison reads each step's loss, the first gradient of every mapper
leaf (the optimizer's first moment / (1 - beta1)) and the change of every
leaf over the kept steps.
"""
from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.reference import augment as ref_augment
from benchmark.reference import neti, prec, sched


class StepClock:
    """Takes the place of `coach.window_step` and calls it: keeps what the
    check reads from the first steps, opens the window after the warm-up
    and closes it at the first step boundary past its length (module
    docstring)."""

    def __init__(self, coach, t, seconds: float, trace):
        self.coach, self.inner = coach, coach.window_step
        self.t, self.seconds, self.trace = t, seconds, trace
        self.spans = common.Spans()
        self.n = 0
        self.feed: List = []
        self.losses: List[torch.Tensor] = []
        self.p0 = self.p_check = self.m1 = None
        self.t0 = self.t1 = None
        self.window_steps = 0
        self.done = False
        coach.window_step = self

    def _leaves(self):
        return common.mapper_leaves(self.coach.built)

    def _snapshot(self):
        common.sync(self.coach.device)
        return {k: p.detach().clone() for k, p in self._leaves().items()}

    def __call__(self, group, draws):
        t = self.t
        n = self.n
        if n == 0:
            self.t_first = time.perf_counter()
            self.p0 = self._snapshot()
        if n == t["check_steps"]:
            self.p_check = self._snapshot()
        if n < t["check_steps"]:
            self.feed.append(_clone((group, draws)))
        if n == t["warmup_steps"]:
            common.sync(self.coach.device)
            if self.trace is not None:
                self.trace.start()
            self.t0 = time.perf_counter()
        in_window = self.t0 is not None and not self.done
        if in_window:
            with self.spans("bench.train_step"):
                loss = self.inner(group, draws)
        else:
            loss = self.inner(group, draws)
        if n < t["check_steps"]:
            self.losses.append(loss.detach().clone())
        if n == 0:
            common.sync(self.coach.device)
            opt = self.coach.optimizer
            self.m1 = {k: opt.optimizer.state[p]["exp_avg"].detach().clone()
                       / (1 - opt.b1) for k, p in self._leaves().items()}
        self.n += 1
        if in_window:
            self.window_steps += 1
            over = (self.window_steps >= t["trace_steps"]
                    if self.trace is not None
                    else time.perf_counter() - self.t0 >= self.seconds)
            if over:
                common.sync(self.coach.device)
                self.t1 = time.perf_counter()
                if self.trace is not None:
                    self.trace.stop()
                self.done = True
                self.coach.cfg.optim.max_train_steps = 0
        return loss


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: _clone(getattr(x, k))
                          for k in x.__dataclass_fields__})
    return x


def setup_files(root: str, seed: int, t: Dict):
    """The scan's PNGs (random uint8, drawn from the seed) and the
    calibration files; returns (scan dir, calibration dir, {camera: the
    image's array}, every camera's (n, 12) matrix)."""
    rng = np.random.default_rng([int(seed), 1])
    s = t["scan"]
    scan_dir = os.path.join(root, "dtu", "Rectified", s["name"])
    cal = os.path.join(root, "dtu", "Calibration", "cal18")
    cams = common.write_calibration(rng, cal, s["calibration_cams"])
    os.makedirs(scan_dir)
    images = {}
    for c in s["cams"]:
        images[c] = rng.integers(0, 256, (s["height"], s["width"], 3),
                                 dtype=np.uint8)
        common.write_png(os.path.join(
            scan_dir, f"rect_{c + 1:03d}_{s['lighting']}_r5000.png"),
            images[c])
    return scan_dir, cal, images, cams


def run(ctx) -> Dict:
    """Set up, warm up, measure and check one run; returns the run's
    record for benchmark.run."""
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.training.coach import Coach

    cfg, t, device = ctx.config, ctx.traffic, ctx.device
    root = ctx.tmpdir
    marks = [("start", time.perf_counter())]
    scan_dir, cal, images, cams = setup_files(root, ctx.seed, t)
    marks.append(("files", time.perf_counter()))
    recipe = {k: dict(v) if isinstance(v, dict) else v
              for k, v in t["recipe"].items()}
    recipe["seed"] = int(ctx.seed)
    recipe["model"] = dict(cfg["recipe_model"])
    recipe["data"]["train_data_dir"] = scan_dir
    recipe["log"]["exp_dir"] = os.path.join(root, "run")
    recipe["eval"]["validation_prompts"] = None
    run_cfg = decode(RunConfig, recipe)
    coach = Coach(run_cfg, arch=common.program_arch(cfg),
                  calibration_dir=cal, device=device)
    common.sync(device)
    marks.append(("coach", time.perf_counter()))
    common.load_program_weights(coach.built, cfg, ctx.seed, device, run_cfg,
                                coach.tokenizer)
    common.sync(device)
    marks.append(("weights", time.perf_counter()))
    coach._save = lambda *a, **k: None
    clock = StepClock(coach, t, ctx.seconds, ctx.trace)
    coach.train()
    if clock.t1 is None:
        raise RuntimeError("the loop ended before the window closed")
    marks += [("first_step", clock.t_first), ("warmup", clock.t0)]
    common.note_phases(marks)
    ds = coach.train_dataset
    B = coach.micro_batch_size * coach.accum_k
    window_losses = coach.losses[t["warmup_steps"]:
                                 t["warmup_steps"] + clock.window_steps]
    out = SimpleNamespace(
        t0=clock.t0, t1=clock.t1, steps=clock.window_steps,
        images=clock.window_steps * B, attempted=clock.window_steps,
        failed=sum(not np.isfinite(v) for v in window_losses))
    out.peak_bytes = ctx.read_peak()
    # what the check reads, then the program's state freed
    tok = coach.tokenizer
    obj_tok = run_cfg.data.placeholder_object_token
    views = list(coach.placeholder_view_tokens)
    keep = dict(
        feed=clock.feed, losses=[float(x) for x in clock.losses],
        p0=clock.p0, p_check=clock.p_check, m1=clock.m1,
        cache=(coach.built.pixel_cache.cpu()
               if coach.built.pixel_cache is not None else None),
        paths=list(ds.image_paths_flattened),
        ids=dict(obj=tok.convert_tokens_to_ids(obj_tok),
                 obj_super=tok.encode(run_cfg.data.super_category_object_token,
                                      add_special_tokens=False)[0],
                 view=tok.convert_tokens_to_ids(views),
                 view_super=tok.encode(run_cfg.data.super_category_view_token,
                                       add_special_tokens=False)[0]),
        view_cams=[int(v.split("_")[2][3:]) for v in views])
    del clock, coach
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.keep, out.images_raw, out.cams = keep, images, cams
    return out


# ------------------------------------------------------------- check ----

def bases(images: Dict[int, np.ndarray], paths: List[str],
          size) -> torch.Tensor:
    """The uint8 training bases the reference works out from the raw
    images: antialiased bicubic resize, rounded, on the CPU."""
    H, W = size
    out = []
    for p in paths:
        cam = int(os.path.basename(p).split("_")[1]) - 1
        x = torch.from_numpy(images[cam]).permute(2, 0, 1)[None].float()
        y = torch.nn.functional.interpolate(x, size=(H, W), mode="bicubic",
                                            antialias=True,
                                            align_corners=False)
        out.append(torch.clamp(torch.round(y), 0, 255).to(torch.uint8)[0]
                   .permute(1, 2, 0))
    return torch.stack(out)


def reference_steps(ctx, out, mode: str = "fp32", fault=None) -> Dict:
    """The kept steps in the reference; returns its losses, first
    gradients and changes by leaf. fault: a fault planted in it, to read
    what the comparison makes of it: "half_batch" (the mean over the first
    half of the rows only) or "token_altered" (every prompt's second
    token, its view token, changed before the conditioning)."""
    cfg, t, device, k = ctx.config, ctx.traffic, ctx.device, out.keep
    stack, cond = common.reference_conditioner(
        cfg, ctx.seed, device, k["ids"], out.cams, k["view_cams"])
    base = bases(out.images_raw, k["paths"], t["train_size"]).to(device)
    spec = SimpleNamespace(**t["augment"])
    leaves = {**{f"object_mapper.{n}": p for n, p in
                 stack.object_mapper.named_parameters()},
              **{f"view_mapper.{n}": p for n, p in
                 stack.view_mapper.named_parameters()}}
    for p in leaves.values():
        p.requires_grad_(True)
    p0 = {n: p.detach().clone() for n, p in leaves.items()}
    a = t["adamw"]
    b1, b2, eps, wd = a["beta1"], a["beta2"], a["eps"], a["weight_decay"]
    o = t["recipe"]["optim"]
    # the recipe's scale_lr (on by default): lr x batch x accumulation
    lr = (o["learning_rate"] * o["train_batch_size"]
          * o["gradient_accumulation_steps"])
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    losses, g1 = [], None
    rows = t["check_rows"]
    with prec.use(mode):
        for step, (group, draws) in enumerate(k["feed"]):
            for p in leaves.values():
                p.grad = None
            batch, d = group[0], draws[0]
            B = batch.input_ids.shape[0]
            ids = batch.input_ids
            if fault == "token_altered":
                ids = ids.clone()
                ids[:, 1] = (ids[:, 1] + 1) % cfg["text"]["vocab_size"]
            n_rows = B // 2 if fault == "half_batch" else B
            total = 0.0
            for s in range(0, n_rows, rows):
                sl = slice(s, min(s + rows, n_rows))
                dsub = SimpleNamespace(**{
                    f: getattr(d.augment, f)[sl]
                    for f in d.augment.__dataclass_fields__})
                with torch.no_grad():
                    x = ref_augment.augment_batch(
                        spec, dsub, base[batch.pixel_values[sl]])
                    lat = stack.vae.encode_sample(x, d.vae_eps[sl].float())
                xt, target = sched.noised_and_target(
                    lat, d.noise[sl].float(), d.timesteps[sl],
                    stack.prediction)
                c, cb = neti.conditioning(cond, ids[sl], d.timesteps[sl])
                pred = stack.unet(xt, d.timesteps[sl].float(), c, cb)
                part = ((pred - target) ** 2).sum() / target[0].numel() / n_rows
                part.backward()
                total += float(part.detach())
            losses.append(total)
            with torch.no_grad():
                if step == 0:
                    g1 = {n: p.grad.detach().clone()
                          for n, p in leaves.items()}
                tt = step + 1
                for n, p in leaves.items():
                    g = p.grad
                    p.mul_(1 - lr * wd)
                    m[n].lerp_(g, 1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / (1 - b2 ** tt) ** 0.5).add_(eps)
                    p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** tt))
    change = {n: (p.detach() - p0[n]) for n, p in leaves.items()}
    return dict(losses=losses, g1=g1, change=change)


reference = reference_steps


def as_program(ctx, out, ref: Dict):
    """The run's record with the reference's outputs in the program's
    place (the control)."""
    keep = dict(out.keep, losses=list(ref["losses"]), m1=ref["g1"],
                p0={n: torch.zeros_like(v) for n, v in ref["change"].items()},
                p_check=ref["change"])
    return SimpleNamespace(**{**vars(out), "keep": keep})


def _leaf_gap(prog: Dict, ref: Dict, skip: set) -> float:
    norms = {n: float(torch.linalg.norm(ref[n].double())) for n in ref}
    med = float(np.median([norms[n] for n in ref]))
    worst = 0.0
    for n in ref:
        if n in skip:
            continue
        a = float(torch.linalg.norm(prog[n].double().to(ref[n].device)))
        worst = max(worst, abs(a - norms[n]) / max(norms[n], med))
    return worst


def readings(ctx, out, ref: Dict) -> Dict[str, float]:
    """The numbers compared with their limits."""
    k = out.keep
    g_norm = {n: float(torch.linalg.norm(g.double()))
              for n, g in ref["g1"].items()}
    med = float(np.median(list(g_norm.values())))
    skip = {n for n, g in g_norm.items() if g < 1e-3 * med}
    step_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(k["losses"], ref["losses"])]
    prog_change = {n: k["p_check"][n] - k["p0"][n] for n in k["p0"]}
    base_ref = bases(out.images_raw, k["paths"], ctx.traffic["train_size"])
    bases_diff = (float((k["cache"].int() - base_ref.int()).abs().max())
                  if k["cache"] is not None else float("nan"))
    return {"loss_gap": max(step_gaps),
            **{f"loss_gap.{i + 1}": g for i, g in enumerate(step_gaps)},
            "grad_gap": _leaf_gap(k["m1"], ref["g1"], skip),
            "change_gap": _leaf_gap(prog_change, ref["change"], skip),
            "bases_max_diff": bases_diff}
