#!/usr/bin/env python3
"""Time one checkout of the port on the card, for A/B comparisons of two
checkouts run alternately in one machine session.

    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR attention
    python3 view_neti_tpu_torch/tools/ab_times.py --root DIR train [--steps N]

DIR is the root of a checkout (its view_neti_tpu_torch is imported, its
kernels are built under DIR/build/kernels). Each mode prints the card's
name and power limit, then one JSON line:

  attention -- K1 at the cross-attention (77 keys) and self-attention shapes
               of the serving path (B 6) and the train step (B 9): the
               median device time of one launch from torch.profiler over
               --launches back-to-back launches, beside the host's time per
               launch of the same loop (CUDA events);
  train     -- the mode-2 train step of chip_smoke.py's train phase (B 9,
               384x512, SD-1.5 at full width, seeded random weights): 2
               warm-up steps, then --steps steps each timed on the host's
               clock between synchronizes.
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

ATTENTION_SHAPES = (  # (B, Lq, Lk, H, d)
    (6, 6912, 77, 8, 40), (6, 1728, 77, 8, 80), (6, 432, 77, 8, 160),
    (6, 108, 77, 8, 160), (9, 3072, 77, 8, 40), (9, 768, 77, 8, 80),
    (9, 192, 77, 8, 160), (9, 48, 77, 8, 160), (6, 6912, 6912, 8, 40),
    (9, 3072, 3072, 8, 40))


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True,
                        help="root of the checkout to time")
    parser.add_argument("mode", choices=("attention", "train"))
    parser.add_argument("--launches", type=int, default=200)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("ab_times: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    out = (attention(torch, args.launches) if args.mode == "attention"
           else train(torch, args.steps))
    out["root"] = args.root
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
