"""The acceptance run (tools/acceptance.py of the JAX package): the
quality protocol of BASELINE.md as one command, on the card.

    python -m view_neti_tpu_torch.acceptance --dtu_root /data/dtu \\
        --out outputs/acceptance [--scan scan114] [--steps 3000] \\
        [--dtu_subset 6] [--seeds 0 1 2] [--denoise_steps 30] \\
        [--reference_lpips 0.XXX]
    python -m view_neti_tpu_torch.acceptance --smoke --out /tmp/acc

It trains the mode-2 single-scene recipe (scan114, dtu_subset 6, 3000
steps, the reference README's mode-2 command) with the Coach, then runs
the offline evaluation protocol on the step's checkpoint: the 34-view
sweep (ValidationHandler.infer_dtu, raising where the checkpoint is
missing) and its masked MSE / PSNR / SSIM / LPIPS at 300x400. It prints
the metric table and writes <out>/acceptance.json. With
--reference_lpips (the reference run's lpips_test_mean) a relative
difference above 1 % exits 2, after the file is written.

The environment names the assets; each one missing degrades the run to
seeded weights (or white masks) and labels it meaningful_for_quality
false:
  SD_WEIGHTS_DIR    a diffusers-layout SD-1.5 directory (weight_port.py)
  TOKENIZER_PATH    a directory with vocab.json and merges.txt
  LPIPS_WEIGHTS     an .npz of LPIPS weights (else a seeded VGG)
  DTU_MASKS_DIR     the IDR object masks
  WEIGHTS_MANIFEST  a sha256 manifest (python -m
                    view_neti_tpu_torch.weights_manifest), by default
                    $SD_WEIGHTS_DIR/MANIFEST.sha256 where it exists; a
                    mismatch stops the run before training.

--smoke writes a synthetic DTU scan (48x64 PNGs of every camera the
protocol reads) and runs the whole path with the miniature stack
(builder.tiny_arch(), 16-pixel resolution, fp32, batch 2), at most 2
steps, 2 denoising steps and one seed. It runs on the card like the real
run; `main(argv, device="cpu")` runs it on the CPU. One process: the JAX
tool has no data-parallel option, and neither has this one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

LPIPS_REL_LIMIT = 0.01   # BASELINE.md: val LPIPS within 1 % of the reference
METRICS = ("mse", "psnr", "ssim", "lpips")


def asset_report(dtu_root: Optional[Path]) -> Tuple[Dict, bool]:
    """Print which assets are present; returns (report, all real)."""
    assets = {name: os.environ.get(name) for name in (
        "SD_WEIGHTS_DIR", "TOKENIZER_PATH", "LPIPS_WEIGHTS",
        "DTU_MASKS_DIR")}
    assets["dtu_root"] = str(dtu_root) if dtu_root else None
    report = {}
    for name, path in assets.items():
        ok = bool(path) and Path(path).exists()
        report[name] = {"path": path, "present": ok}
        print(f"  {name:16s} {'OK   ' if ok else 'MISS '} {path or '-'}")
    all_real = all(v["present"] for v in report.values())
    if not all_real:
        print("  -> some assets missing: run completes but quality numbers"
              " are NOT meaningful (random weights / white masks)")
    return report, all_real


def check_weights_manifest() -> Optional[str]:
    """Check SD_WEIGHTS_DIR against WEIGHTS_MANIFEST, else its own
    MANIFEST.sha256; SystemExit naming each problem. Returns the manifest
    checked, or None where there is none."""
    from view_neti_tpu_torch.weight_port import check_manifest
    root = os.environ.get("SD_WEIGHTS_DIR")
    manifest = os.environ.get("WEIGHTS_MANIFEST")
    if not manifest and root and (Path(root) / "MANIFEST.sha256").exists():
        manifest = str(Path(root) / "MANIFEST.sha256")
    if not (manifest and root):
        return None
    problems = check_manifest(root, manifest)
    if problems:
        raise SystemExit("weights manifest verification FAILED:\n  "
                         + "\n  ".join(problems))
    print(f"  manifest OK: {manifest}")
    return manifest


def make_smoke_dtu(root: Path) -> Path:
    """A synthetic DTU tree (64 cal18 matrices, scan114 at 48x64) over
    every eval and train camera, pixels from RandomState(0) in the JAX
    tool's order, written by the port's PNG writer."""
    from view_neti_tpu_torch.data import image_io
    from view_neti_tpu_torch.training import inference_dtu
    rng = np.random.RandomState(0)
    cal = root / "Calibration" / "cal18"
    cal.mkdir(parents=True, exist_ok=True)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    scan = root / "Rectified" / "scan114"
    scan.mkdir(parents=True, exist_ok=True)
    cam_idxs, cam_idxs_train, _ = inference_dtu.get_cam_idxs(6)
    for i in sorted(set(cam_idxs) | set(cam_idxs_train)):
        image_io.write_png(scan / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    return root


def recipe(args, scan_dir: Path, tiny: bool):
    """The mode-2 single-scene recipe (the reference README's command and
    train.yaml's optim block) on SD-1.5 / 768-D, as the JAX tool builds it
    (tools/acceptance.py:150-177); tiny: the smoke's miniature protocol."""
    from view_neti_tpu_torch.config import RunConfig, decode
    tokenizer = os.environ.get("TOKENIZER_PATH")
    return decode(RunConfig, {
        "learnable_mode": 2,
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 768,
                  "pretrained_model_name_or_path":
                      "runwayml/stable-diffusion-v1-5",
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0,
                  "pe_sigma_exp_key": 2},
        "data": {"train_data_dir": str(scan_dir),
                 "camera_representation": "dtu-12d",
                 "dtu_subset": args.dtu_subset,
                 "dtu_preprocess_key": -1 if tiny else 1,
                 "augmentation_key": 7, "repeats": 100,
                 "placeholder_object_token": "<skull>",
                 **({"resolution": 16} if tiny else {}),
                 **({"tokenizer_path": tokenizer} if tokenizer else {})},
        "log": {"exp_dir": str(args.out / "run"), "overwrite_ok": True,
                "save_dataset_images": False, "save_steps": args.steps},
        "eval": {"validation_prompts": None,
                 "validation_seeds": list(args.seeds),
                 "num_validation_images": len(args.seeds)},
        "optim": {"mixed_precision": "no" if tiny else "bf16",
                  "max_train_steps": args.steps,
                  "train_batch_size": 2 if tiny else 3,
                  "gradient_accumulation_steps": 1 if tiny else 3},
    })


def lpips_verdict(got: float, reference: float) -> Dict:
    """The acceptance criterion: lpips_test_mean within LPIPS_REL_LIMIT of
    the reference's, relative."""
    rel = abs(got - reference) / max(reference, 1e-9)
    return {"lpips_test_mean": got, "reference": reference,
            "rel_diff": rel, "pass": bool(rel <= LPIPS_REL_LIMIT)}


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtu_root", type=Path, default=None,
                    help="dir containing Rectified/ + Calibration/cal18/")
    ap.add_argument("--scan", default="scan114")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--dtu_subset", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--denoise_steps", type=int, default=30)
    ap.add_argument("--reference_lpips", type=float, default=None,
                    help="reference run's lpips_test_mean; checks the "
                         "within-1%% acceptance criterion")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic DTU + tiny arch: proves the harness "
                         "end-to-end without real assets")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device=None
         ) -> Tuple[Dict, Dict]:
    """Returns (the acceptance.json payload, the sweep's results). The
    payload's wall times are rounded to 0.1 s, as the JAX tool writes
    them; the results carry them unrounded under "wall_s"."""
    args = parse_args(argv)
    print("== acceptance assets ==")
    if args.smoke:
        args.dtu_root = make_smoke_dtu(args.out / "smoke_dtu")
        args.steps = min(args.steps, 2)
        args.denoise_steps = min(args.denoise_steps, 2)
        args.seeds = args.seeds[:1]
    report, all_real = asset_report(args.dtu_root)
    manifest = check_weights_manifest()
    if args.dtu_root is None:
        raise SystemExit("--dtu_root is required (or --smoke)")

    from view_neti_tpu_torch.ops.metrics import make_lpips
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.validate import ValidationHandler
    from view_neti_tpu_torch.utils.misc import fixseed

    tiny = args.smoke or bool(os.environ.get("VIEW_NETI_TINY"))
    scan_dir = Path(args.dtu_root) / "Rectified" / args.scan
    cal_dir = Path(args.dtu_root) / "Calibration" / "cal18"
    cfg = recipe(args, scan_dir, tiny)
    arch = builder.tiny_arch() if tiny else None
    if tiny:
        cfg.model.word_embedding_dim = arch.text.hidden_size
    fixseed(cfg.seed)

    lpips_weights = os.environ.get("LPIPS_WEIGHTS")
    if not lpips_weights:
        print("warn: LPIPS with RANDOM VGG weights (relative numbers "
              "only)", file=sys.stderr)
    lpips_fn = make_lpips(lpips_weights, device=device)

    print(f"== training {args.steps} steps (mode 2, {args.scan}, "
          f"subset {args.dtu_subset}) ==")
    t0 = time.perf_counter()
    coach = Coach(cfg, arch=arch, calibration_dir=str(cal_dir),
                  weights_dir=os.environ.get("SD_WEIGHTS_DIR"),
                  device=device)
    coach.train()
    train_wall = time.perf_counter() - t0

    print(f"== eval: {args.denoise_steps}-step DPM++ 34-view sweep, "
          f"{len(args.seeds)} seeds ==")
    t0 = time.perf_counter()
    validator = ValidationHandler(
        cfg, masks_root=os.environ.get("DTU_MASKS_DIR"),
        calibration_dir=str(cal_dir), lpips_fn=lpips_fn)
    results = validator.infer_dtu(
        coach, step=args.steps, num_steps=args.denoise_steps,
        return_instead_of_save=True, on_missing_ckpt="raise")
    eval_wall = time.perf_counter() - t0
    results["wall_s"] = {"train": train_wall, "eval": eval_wall}

    metrics = {k: float(v) for k, v in results.items()
               if k.endswith("_mean")}
    print("== results (masked, 300x400 protocol) ==")
    print(f"  {'metric':8s} {'train views':>12s} {'test views':>12s}")
    for m in METRICS:
        print(f"  {m:8s} {metrics[f'{m}_train_mean']:12.4f} "
              f"{metrics[f'{m}_test_mean']:12.4f}")

    verdict = None
    if args.reference_lpips is not None:
        verdict = lpips_verdict(metrics["lpips_test_mean"],
                                args.reference_lpips)
        print(f"== acceptance: lpips {verdict['lpips_test_mean']:.4f} vs "
              f"reference {args.reference_lpips:.4f} -> rel diff "
              f"{verdict['rel_diff']:.2%} "
              f"[{'PASS' if verdict['pass'] else 'FAIL'}]")

    args.out.mkdir(parents=True, exist_ok=True)
    payload = {"metrics": metrics, "assets": report,
               "manifest": manifest, "all_assets_real": all_real,
               "meaningful_for_quality": all_real,
               "train_wall_s": round(train_wall, 1),
               "eval_wall_s": round(eval_wall, 1),
               "steps": args.steps, "seeds": args.seeds,
               "denoise_steps": args.denoise_steps,
               "acceptance": verdict}
    (args.out / "acceptance.json").write_text(json.dumps(payload, indent=2))
    print("wrote", args.out / "acceptance.json")
    if verdict is not None and not verdict["pass"]:
        raise SystemExit(2)
    return payload, results


if __name__ == "__main__":
    main(sys.argv[1:])
