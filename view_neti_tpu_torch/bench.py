"""One JSON line per mode on the card: the port's counterpart of the JAX
package's bench.py.

    python -m view_neti_tpu_torch.bench            (BENCH_* in the environment)

Modes, chosen by the JAX bench's variables:
  BENCH_E2E=0    the raw mode-2 train step (training/train_step.py
                 make_train_step) on synthetic batches: B = BENCH_BATCH (9)
                 at BENCH_HW (384,512), BENCH_AUG=1 for uint8 bases and
                 preset 7 on the card, BENCH_REMAT=1 for the UNet's gradient
                 checkpointing; imgs/sec/chip;
  (default)      the Coach end to end (training/coach.py Coach.train) on the
                 shipped mode-2 recipe: one synthetic 1600x1200 PNG scan,
                 preset 7, DTU preprocess 1, fused batch 9 (BENCH_FUSE=0
                 accumulates 3 x 3), windows of BENCH_SPD steps (0: auto);
                 imgs/sec/chip;
  BENCH_MODE=3   the same on mode 3's recipe: two scans, preset 5;
  BENCH_INFER=1  serving (inference/pipeline.py generate): 768x576,
                 BENCH_INFER_STEPS (30) DPM-Solver++ steps, CFG 7.5, seeds
                 [0, 1, 2] in one batch, three timed rounds; sec/image;
  BENCH_VAL=1    the DTU sweep (pipeline.generate_batch over the 34 views of
                 training/inference_dtu.get_cam_idxs(6), BENCH_VIEW_BATCH
                 (1) views a batch, seeds [0, 1, 2], 768x576,
                 BENCH_INFER_STEPS steps); seconds.
BENCH_STEPS sets the train steps (20 raw, 40 end to end, rounded up to a
multiple of 4). BENCH_TINY=1 runs the miniature stack, for the CPU.
Frozen weights are seeded, as in the JAX bench. On the card the VAE runs
through the fused conv (K4); BENCH_FUSE_UNET=1 fuses the UNet's ResNet
convs too (training/builder.py fuse_for_inference), read by the serving
and sweep modes only, as in the JAX bench; off by default.

Refused: BENCH_FLASH other than 1, BENCH_FUSECONV other than 1 and
BENCH_CHECK_FLASH other than 0. Each selects a path of the JAX package
around its Pallas kernels; on the card it would put a kernel's plain
version on the main path.

The line: "metric" (the JAX bench's name for the same environment),
"value", "unit", "vs_baseline" (against the reference's own estimates: 6
imgs/sec, 6 s an image, 600 s a sweep), "device" (the card's name and power
limit as nvidia-smi gives them, or "cpu"), "flops_per_image",
"tflops_per_sec" and, on the card, "mfu": tflops_per_sec over 989 TFLOP/s,
the H100 SXM's dense bf16 peak at 700 W. The model FLOPs come from shapes
(ops/flop_count.py), counted in one eager call of the timed work, outside
the timed window. Everything else goes to stderr as "# " lines, the
kernels' launches in the timed run among them.

Timing: every timed window starts and ends at a synchronize. The raw step,
the serving loop, the decode and the sweep run as CUDA graphs
(utils/graphs.py), warmed up until the timed calls replay: one eager call,
then the capture, for every shape. The Coach runs its own windows and is
timed from a synchronize after the first half of its steps to the loop's
end (`SyncAfter`, Coach.loop_end_s).

A failure prints the JAX bench's error line ("unit": "error") and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from view_neti_tpu_torch.utils.graphs import Graphed, launch_counts

A100_IMGS_PER_SEC_EST = 6.0     # bench.py:34, the reference on an A100
REF_SEC_PER_IMAGE = 6.0         # bench.py:621
REF_SWEEP_S = 600.0             # bench.py:750, the reference's ~10 min
PEAK_BF16_TFLOPS = 989.0        # H100 SXM, dense bf16, 700 W

# switch -> the values that keep the port's one path (unset reads as "")
REFUSED = {"BENCH_FLASH": ("", "1"), "BENCH_FUSECONV": ("", "1"),
           "BENCH_CHECK_FLASH": ("", "0")}

SD15 = "runwayml/stable-diffusion-v1-5"
MODEL = {"arch_view_net": 15, "arch_view_disable_tl": False,
         "pretrained_model_name_or_path": SD15,
         "normalize_view_mapper_output": True,
         "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2}


def metric_name(env: Mapping[str, str]) -> str:
    """The JAX bench's _metric_name (bench.py:55) for env."""
    if env.get("BENCH_VAL", "0") == "1":
        return "seconds for the full DTU validation sweep"
    if env.get("BENCH_INFER", "0") == "1":
        n = env.get("BENCH_INFER_STEPS", "30")
        return (f"sec/image SD-1.5 NVS inference (768x576, {n} DPM++ "
                "steps, CFG, 3 seeds batched)")
    if env.get("BENCH_E2E", "1") == "1":
        mode = env.get("BENCH_MODE", "2")
        return (f"imgs/sec/chip mode-{mode} SD-1.5 TI train "
                "(augmented recipe, end-to-end)")
    return "imgs/sec/chip mode-2 SD-1.5 TI train (512x384, bf16)"


def error_record(env: Mapping[str, str], msg: str) -> Dict:
    """The JAX bench's error line (bench.py:69)."""
    return {"metric": metric_name(env), "value": 0.0, "unit": "error",
            "vs_baseline": 0.0, "error": msg}


def refuse_switches(env: Mapping[str, str]) -> None:
    for name, keeps in REFUSED.items():
        if env.get(name, "") not in keeps:
            raise ValueError(
                f"{name}={env[name]} selects the JAX package's path around "
                f"a Pallas kernel; the port runs its kernels on the main "
                f"path and has no such switch")


def note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SyncAfter:
    """A Coach's window_step with one synchronize after the optimizer step
    that reaches `step`: the card is idle there, so the host clock from
    that moment (`at`) to the loop's end (Coach.loop_end_s) times all the
    work of the steps after it, whatever the windows queue ahead of the
    host. `args` keeps the last call's arguments (one optimizer step's
    batches and draws). Everything else is the wrapped step's."""

    def __init__(self, coach, step: int):
        self.device, self.inner = coach.device, coach.window_step
        self.left, self.at, self.args = step - coach.global_step, None, None
        coach.window_step = self

    def __call__(self, *args):
        out = self.inner(*args)
        self.args = args
        self.left -= 1
        if self.left == 0:
            sync(self.device)
            self.at = time.perf_counter()
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ------------------------------------------------------------ recipes ----

def write_calibration(rng: np.random.RandomState, caldir: str) -> None:
    """64 synthetic DTU calibration files, pos_001.txt .. pos_064.txt."""
    os.makedirs(caldir, exist_ok=True)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        with open(os.path.join(caldir, f"pos_{i:03d}.txt"), "w") as f:
            f.write("\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))


def synthetic_view_tokens(rng: np.random.RandomState) -> List[str]:
    """The view tokens of six random cameras at the dtu_subset-6 indices."""
    from view_neti_tpu_torch.data import dtu
    return [dtu.dtu_cam_params_to_token(
        rng.randn(3, 4).astype(np.float32) * 100, i)
        for i in dtu.dtu_get_train_idxs(6)]


def raw_batch(rng: np.random.RandomState, B: int, H: int, W: int, L: int,
              tokenizer, view_id: int, obj_id: int,
              augmented: bool) -> Dict[str, np.ndarray]:
    """The raw step's batch (bench.py:201-218): BOS, the view token, five
    filler ids, the object token, then EOS; pixels uint8 bases for the
    augmented step, else uniform in [-1, 1]."""
    ids = np.full((B, L), tokenizer.eos_token_id, np.int64)
    ids[:, 0] = tokenizer.bos_token_id
    ids[:, 1] = view_id
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id
    pixels = (rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8) if augmented
              else rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32))
    return {"pixel_values": pixels, "input_ids": ids,
            "input_ids_placeholder_object": np.full((B,), obj_id, np.int64),
            "input_ids_placeholder_view": np.full((B,), view_id, np.int64)}


def _tiny(env: Mapping[str, str]) -> bool:
    return env.get("BENCH_TINY", "0") == "1"


def fuses(device: torch.device) -> bool:
    """The JAX bench's auto for the fused conv: on for the accelerator,
    off on the CPU."""
    return device.type == "cuda"


def _fuse_unet(env: Mapping[str, str]) -> bool:
    return env.get("BENCH_FUSE_UNET", "") == "1"


def _stack(env, device, view_tokens, caldir, compute_dtype, arch=None,
           fuse_unet=False):
    """The mode-2 stack of the raw, serving and sweep modes: seeded
    weights, one object token <skull>; where the fused conv is on, the VAE
    and, with fuse_unet, the UNet run through it. Returns (built,
    tokenizer)."""
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder
    tiny = _tiny(env)
    cfg = decode(RunConfig, {
        "learnable_mode": 2,
        "model": dict(MODEL, word_embedding_dim=32 if tiny else 768),
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6},
        "optim": {"mixed_precision": "bf16"}})
    arch = arch or (builder.tiny_arch() if tiny
                    else builder.resolve_arch(SD15, 768))
    tok = (FallbackTokenizer(base_vocab_size=512) if tiny
           else FallbackTokenizer())
    built = builder.build_models(cfg, tok, view_tokens, ["<skull>"],
                                 arch=arch, compute_dtype=compute_dtype,
                                 calibration_dir=caldir, device=device)
    if fuses(device):
        builder.fuse_for_inference(built.vae,
                                   unet=built.unet if fuse_unet else None)
    return built, tok


def _flop_fields(device, flops_per_image: float,
                 imgs_per_sec: float) -> Dict:
    tflops = flops_per_image * imgs_per_sec / 1e12
    out = {"flops_per_image": flops_per_image, "tflops_per_sec": tflops}
    if device.type == "cuda":
        out["mfu"] = tflops / PEAK_BF16_TFLOPS
    return out


def _report_counts(launches, flops, per) -> float:
    """Print the launches and the FLOPs per image by source; returns the
    FLOPs per image."""
    note(f"launches {json.dumps(launches)}")
    note(f"flops per image by source "
         f"{json.dumps({k: v / per for k, v in flops.items()})}")
    return sum(flops.values()) / per


# -------------------------------------------------------------- modes ----

def bench_raw(env, device) -> Dict:
    """bench.py:117 main: the raw mode-2 train step."""
    from view_neti_tpu_torch.ops import device_augment
    from view_neti_tpu_torch.ops.flop_count import count_flops
    from view_neti_tpu_torch.training import builder, optim
    from view_neti_tpu_torch.training import train_step as ts

    tiny = _tiny(env)
    steps = int(env.get("BENCH_STEPS", "20"))
    B = int(env.get("BENCH_BATCH", "9"))
    if tiny:
        arch, (H, W) = builder.tiny_arch(), (16, 16)
    else:
        arch = builder.resolve_arch(SD15, 768)
        H, W = (int(x) for x in env.get("BENCH_HW", "384,512").split(","))
    if env.get("BENCH_REMAT", "0") == "1":
        arch = dataclasses.replace(arch, unet=dataclasses.replace(
            arch.unet, gradient_checkpointing=True))
    cd = torch.bfloat16
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    view_tokens = synthetic_view_tokens(rng)
    with tempfile.TemporaryDirectory() as caldir:
        write_calibration(rng, caldir)
        built, tok = _stack(env, device, view_tokens, caldir, cd, arch)
    lr = optim.scaled_learning_rate(1e-3, True, B, 3, 1)
    opt = optim.SlicedAdamW(builder.trainable_groups(built),
                            optim.make_lr_schedule("constant", lr, 0, 3000))
    aug = (device_augment.from_augmentation_key(7)
           if env.get("BENCH_AUG", "0") == "1" else None)
    step = ts.make_train_step(opt, compute_dtype=cd, augment=aug)
    arrays = raw_batch(rng, B, H, W, built.arch.text.max_position_embeddings,
                       tok, built.placeholder_view_token_ids[0],
                       built.placeholder_object_token_ids[0], aug is not None)
    batch = ts.TrainBatch(**{k: torch.from_numpy(v).to(device)
                             for k, v in arrays.items()})
    g = torch.Generator(device).manual_seed(0)

    def one_step(batch, draws):
        return step(built, batch, draws)["total_loss"]

    graphed = Graphed(one_step, "train step")

    def run():
        return graphed(batch, ts.sample_step_draws(g, built, batch,
                                                   augment=aug))

    sync(device)
    build_s = time.perf_counter() - t0
    launch_counts(reset=True)
    t0 = time.perf_counter()
    for _ in range(2):      # the eager warm-up, then the capture
        loss = run()
    sync(device)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = run()
    sync(device)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    loss = float(loss)
    if not np.isfinite(loss):
        raise FloatingPointError(f"the train step's loss is {loss}")
    flops = count_flops(
        lambda: one_step(batch, ts.sample_step_draws(g, built, batch,
                                                     augment=aug)),
        recompute_modules=(built.unet, built.text.clip))
    imgs_per_sec = B * steps / dt
    note(f"build_s={build_s:.3f} warmup_s={warm_s:.3f} steps={steps} "
         f"batch={B} hw={H}x{W} step_ms={1e3 * dt / steps:.4f} "
         f"loss={loss:.6f} augment={aug is not None}")
    per_image = _report_counts(launches, flops, B)
    return dict({"value": imgs_per_sec, "unit": "imgs/sec/chip",
                 "vs_baseline": imgs_per_sec / A100_IMGS_PER_SEC_EST},
                **_flop_fields(device, per_image, imgs_per_sec))


def write_scans(root: str, rng: np.random.RandomState, scans: List[str],
                shape: Tuple[int, int]) -> Tuple[str, str]:
    """bench.py:375-392: 64 calibration files, then each scan's
    dtu_subset-6 images, random uint8 in RandomState order, written as PNG
    by the port's writer. Returns (the Rectified directory, the
    calibration directory)."""
    from view_neti_tpu_torch.data import dtu, image_io
    rect = os.path.join(root, "dtu", "Rectified")
    cal = os.path.join(root, "dtu", "Calibration", "cal18")
    write_calibration(rng, cal)
    jobs = []
    for s in scans:
        os.makedirs(os.path.join(rect, s))
        for i in dtu.dtu_get_train_idxs(6):
            name = f"rect_{i + 1:03d}_3_r5000.png"
            jobs.append((os.path.join(rect, s, name),
                         rng.randint(0, 255, shape + (3,), np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(image_io.write_png, p, img)
                  for p, img in jobs]:
            f.result()
    return rect, cal


def bench_e2e(env, device) -> Dict:
    """bench.py:352 _bench_e2e: the Coach on the shipped mode-2 or mode-3
    recipe. The logger writes no event files (log.report_to none)."""
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.ops.flop_count import count_flops
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach

    mode = env.get("BENCH_MODE", "2")
    if mode not in ("2", "3"):
        raise ValueError(f"BENCH_MODE={mode}: the bench trains mode 2 or 3")
    mode = int(mode)
    steps = int(env.get("BENCH_STEPS", "40"))
    if steps < 1:
        raise ValueError(f"BENCH_STEPS={steps}")
    tiny = _tiny(env)
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        scans = ["scan114"] if mode == 2 else ["scan110", "scan118"]
        rect, cal = write_scans(root, rng, scans,
                                (48, 64) if tiny else (1200, 1600))
        write_s = time.perf_counter() - t0
        data = {"camera_representation": "dtu-12d", "dtu_subset": 6,
                "dtu_preprocess_key": -1 if tiny else 1, "repeats": 100}
        if tiny:
            data["resolution"] = 16
        if mode == 2:
            data.update(train_data_dir=os.path.join(rect, scans[0]),
                        augmentation_key=7)
        else:
            data.update(train_data_dir=rect, train_data_subsets=scans,
                        augmentation_key=5,
                        placeholder_object_tokens=[f"<{s}>" for s in scans],
                        super_category_object_tokens=["object"] * len(scans))
        cfg = decode(RunConfig, {
            "learnable_mode": mode,
            "model": dict(MODEL, word_embedding_dim=32 if tiny else 768),
            "data": data,
            "log": {"exp_dir": os.path.join(root, "run"),
                    "save_dataset_images": False, "save_steps": 10 ** 9,
                    "report_to": "none"},
            "eval": {"validation_prompts": None},
            "optim": {"mixed_precision": "no" if tiny else "bf16",
                      "fuse_accumulation": env.get("BENCH_FUSE", "1") == "1",
                      "steps_per_dispatch": int(env.get("BENCH_SPD", "0")),
                      "max_train_steps": -(steps // -4) * 4}})
        t0 = time.perf_counter()
        coach = Coach(cfg, arch=builder.tiny_arch() if tiny else None,
                      calibration_dir=cal, device=device)
        sync(device)
        build_s = time.perf_counter() - t0
        n = cfg.optim.max_train_steps
        warm = n // 2            # the JAX bench's warm-up half
        timer = SyncAfter(coach, warm)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        result = coach.train()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        dt = coach.loop_end_s - timer.at
        imgs_per_step = coach.micro_batch_size * coach.accum_k
        imgs_per_sec = imgs_per_step * (n - warm) / dt
        if not all(np.isfinite(coach.losses)):
            raise FloatingPointError(f"the Coach's losses {coach.losses}")
        flops = count_flops(coach._optimizer_step, *timer.args,
                            recompute_modules=(coach.built.unet,
                                               coach.built.text.clip))
    note(f"wall={wall:.3f}s steps={result['steps']} warmup_steps={warm} "
         f"timed_s={dt:.4f} imgs_per_step={imgs_per_step} "
         f"steps_per_dispatch={coach.steps_per_dispatch} "
         f"graphed={coach.window_step.enabled} write_scans_s={write_s:.3f} "
         f"build_s={build_s:.3f} cache_fill_s={coach.cache_fill_s} "
         f"final_loss={result['final_loss']:.6f}")
    per_image = _report_counts(launches, flops, imgs_per_step)
    return dict({"value": imgs_per_sec, "unit": "imgs/sec/chip",
                 "vs_baseline": imgs_per_sec / A100_IMGS_PER_SEC_EST},
                **_flop_fields(device, per_image, imgs_per_sec))


def bench_infer(env, device) -> Dict:
    """bench.py:513 _bench_infer: serving, three seeds in one batch."""
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.ops.flop_count import count_flops
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule

    tiny = _tiny(env)
    dtype = torch.float32 if tiny else torch.bfloat16
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as caldir:
        write_calibration(rng, caldir)
        view_tokens = synthetic_view_tokens(rng)
        built, tok = _stack(env, device, view_tokens, caldir, dtype,
                            fuse_unet=_fuse_unet(env))
    sched = DPMSolverSchedule()
    n_steps = int(env.get("BENCH_INFER_STEPS", "30"))
    pm = PromptManager(tok, built.text, sched.set_timesteps(n_steps),
                       built.placeholder_view_token_ids,
                       built.placeholder_object_token_ids)
    vt = [t for t in tok.added_tokens if t.startswith("<view")][0]
    ctx, ctx_b = pm.embed_prompt(f"{vt}. A photo of a <skull>")
    uncond = pipeline.encode_uncond(built.text.clip, tok)
    seeds = [0, 1, 2]
    H, W = (16, 16) if tiny else (576, 768)

    def sampler(graph):
        return (pipeline.make_denoise_fn(built.unet, sched, n_steps, 7.5,
                                         dtype, graph=graph),
                pipeline.make_decode_fn(built.vae, graph=graph))

    graphed = sampler(True)

    def run(seed_offset, fns=graphed):
        return pipeline.generate(
            built.unet, built.vae, sched, ctx, ctx_b, uncond, H, W,
            [s + seed_offset for s in seeds], n_steps, 7.5, dtype,
            denoise_fn=fns[0], device=device, decode_fn=fns[1])

    sync(device)
    build_s = time.perf_counter() - t0
    launch_counts(reset=True)
    t0 = time.perf_counter()
    run(0)                  # the eager warm-up
    run(1)                  # the capture
    sync(device)
    warm_s = time.perf_counter() - t0
    rounds = 3
    t0 = time.perf_counter()
    for r in range(2, rounds + 2):
        imgs = run(r)
    sync(device)
    dt = (time.perf_counter() - t0) / (rounds * len(seeds))
    launches = launch_counts()
    if imgs.shape != (3, H, W, 3) or imgs.dtype != np.uint8:
        raise ValueError(f"images {imgs.shape} {imgs.dtype}")
    flops = count_flops(run, rounds + 2, sampler(False))
    note(f"build_s={build_s:.3f} warmup_s={warm_s:.3f} rounds={rounds} "
         f"steps={n_steps} sec_per_image={dt:.6f} hw={H}x{W} "
         f"fused_unet={built.unet.config.fuse_conv}")
    per_image = _report_counts(launches, flops, len(seeds))
    return dict({"value": dt, "unit": "sec/image",
                 "vs_baseline": REF_SEC_PER_IMAGE / dt},
                **_flop_fields(device, per_image, 1.0 / dt))


def bench_val(env, device) -> Dict:
    """bench.py:629 _bench_val: the DTU sweep over the 34 eval views,
    conditioning included, one chunk deep (bench.py:719-735)."""
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.ops.flop_count import count_flops
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    from view_neti_tpu_torch.training.inference_dtu import get_cam_idxs

    tiny = _tiny(env)
    dtype = torch.float32 if tiny else torch.bfloat16
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    cam_idxs = get_cam_idxs(6)[0]
    if tiny:
        cam_idxs = cam_idxs[:3]
    with tempfile.TemporaryDirectory() as caldir:
        write_calibration(rng, caldir)
        # the vocabulary of all 64 cameras, evaluated on the 34 views
        lookup_tok, _ = dtu.dtu_generate_dset_cam_tokens_params(
            calibration_dir=caldir)
        built, tok = _stack(env, device,
                            [lookup_tok[i] for i in sorted(lookup_tok)],
                            caldir, dtype, fuse_unet=_fuse_unet(env))
    sched = DPMSolverSchedule()
    n_steps = int(env.get("BENCH_INFER_STEPS", "2" if tiny else "30"))
    pm = PromptManager(tok, built.text, sched.set_timesteps(n_steps),
                       built.placeholder_view_token_ids,
                       built.placeholder_object_token_ids, dtype=dtype)
    uncond = pipeline.encode_uncond(built.text.clip, tok)
    seeds = [0] if tiny else [0, 1, 2]
    H, W = (16, 16) if tiny else (576, 768)
    vb = int(env.get("BENCH_VIEW_BATCH", "1"))

    def sampler(graph):
        return (pipeline.make_denoise_fn(built.unet, sched, n_steps, 7.5,
                                         dtype, graph=graph),
                pipeline.make_decode_fn(built.vae, graph=graph))

    graphed = sampler(True)

    def gen_chunk(chunk, fns=graphed):
        ctx, ctx_b = pm.embed_prompts(
            [f"{lookup_tok[ci]}. A photo of a <skull>" for ci in chunk])
        return pipeline.generate_batch(
            built.unet, built.vae, sched, ctx, ctx_b, uncond, H, W, seeds,
            n_steps, 7.5, dtype, denoise_fn=fns[0], as_numpy=False,
            device=device, decode_fn=fns[1])

    def sweep():
        # the next chunk is launched before this one's images are copied
        imgs, pending = {}, None

        def drain(p):
            out = p[1].cpu().numpy()
            for j, ci in enumerate(p[0]):
                imgs[ci] = out[j]

        for s in range(0, len(cam_idxs), vb):
            chunk = cam_idxs[s:s + vb]
            dev_imgs = gen_chunk(chunk)
            if pending is not None:
                drain(pending)
            pending = (chunk, dev_imgs)
        if pending is not None:
            drain(pending)
        return imgs

    # every chunk width the sweep runs, and how often
    n_calls: Dict[int, int] = {}
    for s in range(0, len(cam_idxs), vb):
        w = len(cam_idxs[s:s + vb])
        n_calls[w] = n_calls.get(w, 0) + 1
    sync(device)
    build_s = time.perf_counter() - t0
    launch_counts(reset=True)
    t0 = time.perf_counter()
    for w in sorted(n_calls):
        for _ in range(2):  # the eager warm-up, then the capture
            gen_chunk(cam_idxs[:w])
    sync(device)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imgs = sweep()
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_imgs = len(cam_idxs) * len(seeds)
    if len(imgs) != len(cam_idxs) or any(
            v.shape != (len(seeds), H, W, 3) for v in imgs.values()):
        raise ValueError(f"the sweep made {len(imgs)} views of "
                         f"{len(cam_idxs)}")
    eager = sampler(False)
    flops: Dict[str, int] = {}
    for w, n in n_calls.items():
        for k, v in count_flops(gen_chunk, cam_idxs[:w], eager).items():
            flops[k] = flops.get(k, 0) + n * v
    note(f"{len(cam_idxs)} views x {len(seeds)} seeds, {W}x{H}, {n_steps} "
         f"DPM++ steps, CFG, view_batch={vb}: wall={wall:.4f}s "
         f"sec_per_image={wall / n_imgs:.6f} build_s={build_s:.3f} "
         f"warmup_s={warm_s:.3f} fused_unet={built.unet.config.fuse_conv}")
    per_image = _report_counts(launches, flops, n_imgs)
    return dict({"value": wall, "unit": "seconds",
                 "vs_baseline": REF_SWEEP_S / wall},
                **_flop_fields(device, per_image, n_imgs / wall))


def select(env: Mapping[str, str]) -> Callable:
    """The mode's function, in the JAX bench's order of precedence."""
    if env.get("BENCH_VAL", "0") == "1":
        return bench_val
    if env.get("BENCH_INFER", "0") == "1":
        return bench_infer
    if env.get("BENCH_E2E", "1") == "1":
        return bench_e2e
    return bench_raw


def main(argv: Optional[List[str]] = None,
         env: Optional[Mapping[str, str]] = None, device=None) -> int:
    """Run the mode that env (default os.environ) selects on `device`
    (None: the card, raising without one) and print its line. Returns the
    exit code: 0, or 1 after the error line."""
    argparse.ArgumentParser(
        prog="python -m view_neti_tpu_torch.bench",
        description=__doc__.split("\n\n")[0],
        epilog="Modes and variables: see the module's docstring.",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    ).parse_args(argv)
    env = dict(os.environ if env is None else env)
    try:
        refuse_switches(env)
        from view_neti_tpu_torch.utils.device import resolve_device
        device = resolve_device(device)
        card = card_name(device)
        note(f"device {card}")
        # what the modules print (the Coach's log) goes to stderr: stdout
        # holds the one line
        with contextlib.redirect_stdout(sys.stderr):
            record = dict({"metric": metric_name(env)},
                          **select(env)(env, device), device=card)
    except Exception as e:  # the boundary: the error line, a failed exit
        traceback.print_exc(file=sys.stderr)
        print(json.dumps(error_record(env, f"{type(e).__name__}: {e}")),
              flush=True)
        return 1
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
