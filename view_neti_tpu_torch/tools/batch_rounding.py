#!/usr/bin/env python3
"""Where does a rank's share of a fused batch round differently from the
same rows of the whole batch? On the card, for chip_smoke.py's coach
recipe (mode 2, SD-1.5 at full width with seeded weights, preset 7 on the
base cache, B = 9 at 384x512, bf16):

    python3 view_neti_tpu_torch/tools/batch_rounding.py [--rows 3]

Each stage of the train step's forward runs on the whole batch and on rows
3..3+rows alone, fed the same inputs (the whole batch's, sliced): the
augmentation, the VAE encode, the text conditioning and the UNet. It
prints the card's name and power limit, then one JSON line per setting
(the defaults; cuDNN off) with each stage's largest absolute difference
and the share of its output elements that differ. Data-parallel ranks
compute such shares (parallel/dist.py); whatever differs here is a
difference of batch shape, not of the distributed path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def stages(torch, coach, rows: int):
    """{stage: (largest |whole - alone|, share of differing elements)}."""
    from view_neti_tpu_torch.data.dataset import DataLoader
    from view_neti_tpu_torch.ops import device_augment as da
    from view_neti_tpu_torch.training.text_forward import \
        neti_text_conditioning
    built, bf16 = coach.built, torch.bfloat16
    ds = coach.train_dataset
    batch = coach._build_batch(next(iter(DataLoader(
        ds, coach.micro_batch_size, seed=coach.cfg.seed))))
    draws = coach._step_draws(0, batch)
    sl = slice(3, 3 + rows)

    def diff(whole, alone):
        d = whole[sl].float() - alone.float()
        return float(d.abs().max()), float((d != 0).float().mean())

    out = {}
    with torch.no_grad():
        bases = built.pixel_cache[batch.pixel_values]
        aug = da.augment_batch(coach.augment_spec, draws.augment, bases)
        part = dataclasses.replace(draws.augment, **{
            f.name: getattr(draws.augment, f.name)[sl]
            for f in dataclasses.fields(draws.augment)})
        out["augment"] = diff(aug, da.augment_batch(coach.augment_spec, part,
                                                    bases[sl]))
        lat = built.vae.encode_sample(aug.to(bf16), draws.vae_eps).float()
        out["vae_encode"] = diff(lat, built.vae.encode_sample(
            aug[sl].to(bf16), draws.vae_eps[sl]))

        def conditioning(s):
            return neti_text_conditioning(
                built.text, batch.input_ids[s],
                batch.input_ids_placeholder_object[s],
                batch.input_ids_placeholder_view[s], draws.timesteps[s],
                object_idx=batch.object_idx)
        ctx, ctx_b = conditioning(slice(None))
        c3 = conditioning(sl)[0]
        d = ctx[:, sl].float() - c3.float()
        out["conditioning"] = (float(d.abs().max()),
                               float((d != 0).float().mean()))
        noisy = built.schedule.add_noise(lat, draws.noise, draws.timesteps)
        pred = built.unet(noisy.to(bf16), draws.timesteps, ctx.to(bf16),
                          ctx_b.to(bf16))
        out["unet"] = diff(pred, built.unet(
            noisy[sl].to(bf16), draws.timesteps[sl], ctx[:, sl].to(bf16),
            ctx_b[:, sl].to(bf16)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=3,
                        help="rows computed alone (default 3, a rank's "
                             "share at world size 3)")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("batch_rounding: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.ops import build
    from view_neti_tpu_torch.training.coach import Coach
    card = card_line()
    print(card, flush=True)
    build.build()
    with tempfile.TemporaryDirectory() as root:
        rect, cal, _, _ = chip_smoke.write_scan(root, image_io, dtu, np)
        coach = Coach(chip_smoke.ddp_config(rect, os.path.join(root, "run")),
                      calibration_dir=cal, device="cuda")
        coach._fill_base_cache()
        coach.train_dataset.skip_pixels = True
        for setting in ("defaults", "cudnn_off"):
            torch.backends.cudnn.enabled = setting != "cudnn_off"
            result = {k: {"max_abs_diff": a, "share_differing": b}
                      for k, (a, b) in stages(torch, coach, args.rows).items()}
            print(f"batch_rounding {setting} rows {args.rows} of "
                  f"{coach.micro_batch_size} [{card}]: "
                  f"{json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
