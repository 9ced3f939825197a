"""Score saved DTU result bundles into a CSV (scripts/summarize_dtu.py of
the JAX package):

    python -m view_neti_tpu_torch.summarize_dtu --results_dirs outputs/scan* \
        --iteration 3000 [--out results/summarize_dtu.csv] [--do_lpips]
        [--lpips_weights lpips_vgg.npz]

For each directory it scores the offline bundles results_all_iter_{it}*
.msgpack or, where there are none, the in-training ones
validation-iter_{it}-*.msgpack: masked MSE, PSNR, SSIM and LPIPS per seed
(the mean over the bundle's views), on the card. It writes one CSV row
per (scan, bundle, seed) with the csv module and prints the means per
seed. LPIPS is 0 unless --do_lpips or --lpips_weights (LPIPS_WEIGHTS);
without weights its VGG is random (relative numbers only).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FIELDS = ("scan", "bundle", "seed", "mse", "psnr", "ssim", "lpips")


def main(argv: Optional[List[str]] = None, device=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results_dirs", type=Path, nargs="+", required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--out", type=Path,
                    default=Path("results/summarize_dtu.csv"))
    ap.add_argument("--do_lpips", action="store_true")
    ap.add_argument("--lpips_weights", type=str,
                    default=os.environ.get("LPIPS_WEIGHTS"),
                    help="an .npz of LPIPS weights; implies --do_lpips")
    args = ap.parse_args(argv)

    from view_neti_tpu_torch.training.inference_dtu import score
    from view_neti_tpu_torch.utils import msgpack_codec
    from view_neti_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    lpips_fn = None
    if args.do_lpips or args.lpips_weights:
        from view_neti_tpu_torch.ops.metrics import make_lpips
        if not args.lpips_weights:
            print("warn: LPIPS with RANDOM VGG weights (relative numbers "
                  "only); pass --lpips_weights or set LPIPS_WEIGHTS for "
                  "real LPIPS", file=sys.stderr)
        lpips_fn = make_lpips(args.lpips_weights, device=device)

    rows: List[Dict] = []
    for d in args.results_dirs:
        # offline bundles first, then the in-training ones; every match
        # is scored (mode 3 writes one bundle per evaluated token)
        matches = (
            sorted(d.glob(f"results_all_iter_{args.iteration}*.msgpack"))
            or sorted(d.glob(f"validation-iter_{args.iteration}-*.msgpack")))
        if not matches:
            print(f"warn: no results bundle in {d}")
            continue
        for path in matches:
            bundle = msgpack_codec.unpackb(path.read_bytes())
            preds = np.asarray(bundle["imgs_pred"])     # (S, bs, h, w, 3)
            gt = np.asarray(bundle["imgs_gt"])          # (bs, h, w, 3)
            masks = np.asarray(bundle["masks"])
            for si in range(preds.shape[0]):
                vals = score(preds[si], gt, masks, lpips_fn, device)
                rows.append(dict(scan=d.name, bundle=path.stem, seed=si,
                                 **{k: float(vals[k].mean())
                                    for k in FIELDS[3:]}))
    for seed in sorted({r["seed"] for r in rows}):
        sel = [r for r in rows if r["seed"] == seed]
        print(f"seed {seed}: " + "  ".join(
            f"{k} {np.mean([r[k] for r in sel]):.6f}" for k in FIELDS[3:]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
