#!/usr/bin/env python3
"""Time one checkout of the port on the card, for A/B comparisons of two
checkouts run alternately in one machine session.

    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR attention
    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR backward \
        [--launches N]
    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR train [--steps N]
    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR optim \
        [--steps N] [--mappers M]

DIR is the root of a checkout (its view_neti_tpu_torch is imported, its
kernels are built under DIR/build/kernels). Each mode prints the card's
name and power limit, then one JSON line:

  attention -- K1 at the cross-attention (77 keys) and self-attention shapes
               of the serving path (B 6) and the train step (B 9): the
               median device time of one launch from torch.profiler over
               --launches back-to-back launches, beside the host's time per
               launch of the same loop (CUDA events);
  backward  -- K2 and K3, each in both designs (the Hopper "sm90" and the
               mma.sync one), at every backward shape of the training
               paths (BACKWARD_SHAPES: SD-1.5's train step, SD-2.1's, the
               folders path's 512x512 one, B 9): the device time of one
               call from torch.profiler (the kernel and, where K3 splits
               the queries, its reduction), the mean over --launches
               back-to-back calls, timed in the order sm90, mma.sync,
               mma.sync, sm90 and averaged over the two rounds of each;
               and each step's sums over its 30 K2 and 31 K3 launches
               (BACKWARD_LAUNCHES), with every shape on the design
               bwd_design names, on sm90, and on mma.sync;
  train     -- the mode-2 train step of chip_smoke.py's train phase (B 9,
               384x512, SD-1.5 at full width, seeded random weights): 2
               warm-up steps, then --steps steps each timed on the host's
               clock between synchronizes;
  optim     -- SlicedAdamW.step of a mode-3 run (input_configs/train_m3.yaml:
               SD-2.1's 1024-wide mappers) with an object bank of --mappers
               mappers (88: one per DTU training scan) and the view mapper;
               each step gives gradients to the view mapper and to the
               object mappers of a batch's 3 groups (3 distinct scans),
               the others have none, as in the train step. 3 warm-up
               steps, then --steps steps each timed on the host's clock
               between synchronizes, and the kernels one step launches
               (torch.profiler).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the checkout that holds this script (its input_configs)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ATTENTION_SHAPES = (  # (B, Lq, Lk, H, d)
    (6, 6912, 77, 8, 40), (6, 1728, 77, 8, 80), (6, 432, 77, 8, 160),
    (6, 108, 77, 8, 160), (9, 3072, 77, 8, 40), (9, 768, 77, 8, 80),
    (9, 192, 77, 8, 160), (9, 48, 77, 8, 160), (6, 6912, 6912, 8, 40),
    (9, 3072, 3072, 8, 40))

BACKWARD_STEPS = {  # a train step's levels: lengths, head dims, heads
    "sd15_384x512": ((3072, 768, 192, 48), (40, 80, 160, 160), (8,) * 4),
    "sd21_384x512": ((3072, 768, 192, 48), (64,) * 4, (5, 10, 20, 20)),
    "sd15_512x512": ((4096, 1024, 256, 64), (40, 80, 160, 160), (8,) * 4)}
# K2's and K3's launches a step at a level's self- and cross-attention: 5
# blocks on levels 0 to 2 and 1 in the mid block; level 0's first
# self-attention has no backward and its first cross-attention's q needs
# no gradient (no K2)
BACKWARD_LAUNCHES = {(0, "self"): (4, 4), (0, "cross"): (4, 5),
                     (1, "self"): (5, 5), (1, "cross"): (5, 5),
                     (2, "self"): (5, 5), (2, "cross"): (5, 5),
                     (3, "self"): (1, 1), (3, "cross"): (1, 1)}
BACKWARD_SHAPES = tuple(  # (B, Lq, Lk, H, d): self- and cross-attention
    (9, L, Lk, H, d)
    for lengths, dims, heads in BACKWARD_STEPS.values()
    for L, d, H in zip(lengths, dims, heads) for Lk in (L, 77))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def attention(torch, launches: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from view_neti_tpu_torch.ops import flash_attention as fa
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for B, Lq, Lk, H, d in ATTENTION_SHAPES:
        q, k, v = (torch.randn(B, L, H, d, generator=g, device="cuda")
                   .bfloat16() for L in (Lq, Lk, Lk))
        for _ in range(3):
            fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(launches):
                fa.flash_attention(q, k, v)
            end.record()
            torch.cuda.synchronize()
        device_ms = [(e.time_range.end - e.time_range.start) / 1e3
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "flash_fwd_kernel" in e.name]
        if len(device_ms) != launches:
            raise RuntimeError(f"profiler saw {len(device_ms)} K1 launches "
                               f"of {launches} at {(B, Lq, Lk, H, d)}")
        rows.append(dict(shape=[B, Lq, Lk, H, d],
                         device_ms=statistics.median(device_ms),
                         device_ms_min=min(device_ms),
                         device_ms_max=max(device_ms),
                         host_ms_per_launch=start.elapsed_time(end) / launches))
    return dict(mode="attention", launches=launches, rows=rows)


def backward(torch, launches: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from view_neti_tpu_torch.ops import flash_attention as fa
    g = torch.Generator("cuda").manual_seed(0)
    calls = {"dq": fa._launch_bwd_dq, "dkv": fa._launch_bwd_dkv}

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        return sum((e.time_range.end - e.time_range.start) / 1e3
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "flash_bwd" in e.name) / launches

    rows = []
    for B, Lq, Lk, H, d in BACKWARD_SHAPES:
        q, k, v, do = (torch.randn(B, L, H, d, generator=g, device="cuda")
                       .bfloat16() for L in (Lq, Lk, Lk, Lq))
        o, lse = fa.flash_attention(q, k, v)
        delta = fa.attention_delta(o, do)
        row = dict(shape=[B, Lq, Lk, H, d], design=fa.bwd_design(d, Lk))
        for kernel, launch in calls.items():
            times = {"sm90": [], "mma_sync": []}
            for design in ("sm90", "mma_sync", "mma_sync", "sm90"):
                times[design].append(device_ms(
                    lambda: launch(q, k, v, do, lse, delta, design)))
            for design, ms in times.items():
                row[f"{kernel}_{design}_ms"] = statistics.mean(ms)
                row[f"{kernel}_{design}_rounds_ms"] = ms
            row[f"{kernel}_design"] = fa.bwd_design(d, Lk, Lq, kernel)
        rows.append(row)
    steps = {}
    for i, name in enumerate(BACKWARD_STEPS):
        sums = {f"{k}_{w}_ms": 0.0 for k in calls
                for w in ("as_run", "sm90", "mma_sync")}
        for j, row in enumerate(rows[8 * i:8 * i + 8]):
            n = dict(zip(calls, BACKWARD_LAUNCHES[
                (j // 2, "cross" if j % 2 else "self")]))
            for k in calls:
                for w in ("sm90", "mma_sync"):
                    sums[f"{k}_{w}_ms"] += n[k] * row[f"{k}_{w}_ms"]
                sums[f"{k}_as_run_ms"] += n[k] * row[
                    f"{k}_{row[k + '_design']}_ms"]
        for w in ("as_run", "sm90", "mma_sync"):
            sums[f"pair_{w}_ms"] = sums[f"dq_{w}_ms"] + sums[f"dkv_{w}_ms"]
        steps[name] = sums
    return dict(mode="backward", launches=launches, rows=rows,
                steps=steps)


def train(torch, steps: int):
    import numpy as np
    from view_neti_tpu_torch.config import ModelConfig, RunConfig
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder, optim
    from view_neti_tpu_torch.training import train_step as ts

    dev, B, cd = torch.device("cuda"), 9, torch.bfloat16
    cfg = RunConfig(
        learnable_mode=2,
        model=ModelConfig(arch_view_net=15, arch_view_disable_tl=False,
                          word_embedding_dim=768,
                          normalize_view_mapper_output=True,
                          output_bypass_alpha_view=5.0, pe_sigma_exp_key=2))
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as caldir:
        for i in range(1, 65):
            m = rng.randn(3, 4) * 100
            with open(os.path.join(caldir, f"pos_{i:03d}.txt"), "w") as f:
                f.write("\n".join(" ".join(f"{x:.4f}" for x in r)
                                  for r in m))
        tok = FallbackTokenizer()
        view_tokens = [dtu.dtu_cam_params_to_token(
            rng.randn(3, 4).astype(np.float32) * 100, i)
            for i in dtu.dtu_get_train_idxs(6)]
        built = builder.build_models(cfg, tok, view_tokens, ["<skull>"],
                                     arch=builder.resolve_arch("sd-1.5", 768),
                                     compute_dtype=cd, calibration_dir=caldir,
                                     device=dev)
    builder.fuse_vae_for_training(built.vae)
    lr = optim.scaled_learning_rate(1e-3, True, B, 3, 1)
    opt = optim.SlicedAdamW(builder.trainable_groups(built),
                            optim.make_lr_schedule("constant", lr, 0, 3000))
    step = ts.make_train_step(opt, compute_dtype=cd)
    view_id = built.placeholder_view_token_ids[0]
    obj_id = built.placeholder_object_token_ids[0]
    ids = torch.full((B, built.arch.text.max_position_embeddings),
                     tok.eos_token_id, dtype=torch.long)
    ids[:, 0] = tok.bos_token_id
    ids[:, 1] = view_id
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id
    g = torch.Generator(dev).manual_seed(0)
    batch = ts.TrainBatch(
        pixel_values=torch.rand(B, 384, 512, 3, generator=g,
                                device=dev) * 2 - 1,
        input_ids=ids.to(dev),
        input_ids_placeholder_object=torch.full((B,), obj_id, device=dev),
        input_ids_placeholder_view=torch.full((B,), view_id, device=dev))

    def run_step():
        return step(built, batch, ts.sample_step_draws(g, built, batch))

    for _ in range(2):
        run_step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(mode="train", steps=steps, ms_per_step=ms,
                median_ms=statistics.median(ms), min_ms=min(ms),
                max_ms=max(ms))


def optim_step(torch, dev, steps: int, mappers: int):
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from view_neti_tpu_torch.config import load_config
    from view_neti_tpu_torch.training import builder, optim

    cfg = load_config(os.path.join(REPO, "input_configs", "train_m3.yaml"))
    m = cfg.model
    g = torch.Generator(dev).manual_seed(0)
    bank = [builder._init_mapper(
        cfg, "object", 0, normalize=m.normalize_object_mapper_output,
        output_bypass=m.output_bypass_object,
        bypass_unconstrained=m.bypass_unconstrained_object,
        alpha=m.output_bypass_alpha_object, generator=g, device=dev)
        for _ in range(mappers)]
    view = builder._init_mapper(
        cfg, "view", 12, normalize=m.normalize_view_mapper_output,
        output_bypass=m.output_bypass_view,
        bypass_unconstrained=m.bypass_unconstrained_view,
        alpha=m.output_bypass_alpha_view, generator=g, device=dev)
    groups = {"object": [list(x.requires_grad_(True).parameters())
                         for x in bank],
              "view": [list(view.requires_grad_(True).parameters())]}
    opt = optim.make_optimizer(groups, cfg.optim, mode=3)
    rng = np.random.RandomState(0)

    def one_step():
        opt.zero_grad()
        chosen = [groups["object"][i]
                  for i in rng.choice(mappers, 3, replace=False)]
        for params in chosen + groups["view"]:
            for p in params:
                p.grad = torch.randn(p.shape, generator=g, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        one_step()
    ms = [one_step() for _ in range(steps)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_step()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return dict(mode="optim", mappers=mappers, steps=steps,
                parameters=sum(p.numel() for x in groups.values()
                               for s in x for p in s),
                ms_per_step=ms, median_ms=statistics.median(ms),
                min_ms=min(ms), max_ms=max(ms),
                kernels_per_step=kernels or None)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True,
                        help="root of the checkout to time")
    parser.add_argument("mode", choices=("attention", "backward", "train",
                                         "optim"))
    parser.add_argument("--launches", type=int, default=200)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--mappers", type=int, default=88)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("ab_times: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    if args.mode == "attention":
        out = attention(torch, args.launches)
    elif args.mode == "backward":
        out = backward(torch, args.launches)
    elif args.mode == "train":
        out = train(torch, args.steps)
    else:
        out = optim_step(torch, torch.device("cuda"), args.steps,
                         args.mappers)
    out["root"] = args.root
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
