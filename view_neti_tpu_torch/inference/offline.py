"""Offline DTU novel-view inference from a saved run (scripts/inference.py
of the JAX package), run as a module through inference/__main__.py:

    python -m view_neti_tpu_torch.inference \
        --config_path input_configs/inference.yaml \
        [--input_dir results/exp --iteration 1500 --seeds "[0, 1]" ...]
    python -m view_neti_tpu_torch.inference --exp_dir results/exp \
        --iteration 1500 [--seeds 0 1 2 --save_dir DIR ...]

The second form is the JAX script's legacy flags (parse_args), whose
results go to --save_dir, else into the run directory itself.

It reads an InferenceConfig (YAML and dot-overrides), rebuilds the Coach
from the config embedded in the step's mapper checkpoint, runs the DTU
sweep over the 34 eval cameras (2 with --debug 1) on the card, reloading
the step's mapper files (it raises where they are missing), and writes each
seed's result sheet preds_iter_{it}_seed{i}.png and the bundle
results_all_iter_{it}.msgpack under inference_dir, which summarize_dtu
scores. A mode-3 run sweeps each token of eval_placeholder_object_tokens
(else the run's own list, else its first object token) against that token's
scan, and writes preds_iter_{it}-{token}_seed{i}.png and
results_all_iter_{it}-{token}.msgpack; its results are keyed by token. The
frozen SD stack is read from SD_WEIGHTS_DIR (a diffusers-layout directory)
when it is set, as the train CLI reads it, so that a run is rendered on the
weights it was trained on; unset, it is the seeded stack the config builds,
as in the JAX script (scripts/inference.py builds its Coach without
weights, a deviation ROADMAP.md records). VIEW_NETI_TINY=1 swaps in the
miniature stack;
`main(argv, device="cpu")` runs on the CPU. Under torchrun (or the
VIEW_NETI_* variables of parallel/dist.py) each sweep's cameras are split
over the dp groups and rank 0 writes everything; the other ranks return
None. --parallel.* options set the run config's parallel section (the
checkpoint's own otherwise): with --parallel.tp N
--parallel.tensor_parallel true each group of N ranks
renders its cameras together through the split UNet and CLIP
(parallel/tensor.py); a rank that fails inside them leaves its partners
waiting until the process group's timeout.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from view_neti_tpu_torch.config import (InferenceConfig, ParallelConfig,
                                        parse_cli)


def split_parallel_args(argv: List[str]) -> Tuple[List[str], List[str]]:
    """(the InferenceConfig's arguments, the --parallel.* ones as
    ParallelConfig arguments: --tp 2 ...)."""
    rest, parallel, i = [], [], 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--parallel."):
            rest.append(arg)
            i += 1
            continue
        key = "--" + arg[len("--parallel."):]
        if "=" in key:
            parallel.append(key)
            i += 1
        else:
            parallel += [key] + argv[i + 1:i + 2]
            i += 2
    return rest, parallel


def parse_args(argv: List[str]) -> InferenceConfig:
    """The InferenceConfig of the arguments (scripts/inference.py:29-51):
    YAML and dot-overrides, or, where an argument starts with --exp_dir or
    --save_dir, the legacy flags, whose results go to --save_dir, else to
    --exp_dir itself."""
    if not any(a.startswith(("--exp_dir", "--save_dir")) for a in argv):
        return parse_cli(argv, cls=InferenceConfig)
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp_dir", type=Path, required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--num_denoising_steps", type=int, default=30)
    ap.add_argument("--calibration_dir", type=str, default=None)
    ap.add_argument("--masks_root", type=str, default=None)
    ap.add_argument("--save_dir", type=Path, default=None)
    ap.add_argument("--lpips_weights", type=str, default=None)
    a = ap.parse_args(argv)
    return InferenceConfig(
        iteration=a.iteration, input_dir=a.exp_dir,
        inference_dir=a.save_dir or a.exp_dir, seeds=list(a.seeds),
        num_denoising_steps=a.num_denoising_steps,
        calibration_dir=a.calibration_dir, masks_root=a.masks_root,
        lpips_weights=a.lpips_weights)


def main(argv: Optional[List[str]] = None, device=None) -> Optional[Dict]:
    argv, parallel_argv = split_parallel_args(
        list(sys.argv[1:] if argv is None else argv))
    infer_cfg = parse_args(argv)
    if infer_cfg.input_dir is None or infer_cfg.iteration is None:
        raise SystemExit("input_dir and iteration are required (set them "
                         "in the YAML or pass --input_dir / --iteration)")
    from view_neti_tpu_torch.checkpoint import CheckpointHandler
    from view_neti_tpu_torch.parallel import dist
    from view_neti_tpu_torch.training import builder, inference_dtu
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.validate import ValidationHandler

    # the checkpoint's own config drives the rebuild
    input_dir = Path(infer_cfg.input_dir)
    it = infer_cfg.iteration
    ckpt = input_dir / f"mapper-steps-{it}_view.msgpack"
    if not ckpt.exists():
        ckpt = input_dir / f"mapper-steps-{it}_object.msgpack"
    cfg, _ = CheckpointHandler.load_mapper(ckpt)
    cfg.log.exp_dir = input_dir
    cfg.log.overwrite_ok = True
    cfg.log.resume_from = None   # the sweep reloads the step's mappers
    cfg.eval.validation_seeds = list(infer_cfg.seeds)
    cfg.eval.num_validation_images = len(infer_cfg.seeds)
    cfg.eval.num_denoising_steps = infer_cfg.num_denoising_steps
    cfg.debug = bool(infer_cfg.debug)
    if parallel_argv:
        given = parse_cli(parallel_argv, cls=ParallelConfig)
        keys = {a[2:].split("=")[0] for a in parallel_argv
                if a.startswith("--")}
        cfg.parallel = dataclasses.replace(
            cfg.parallel, **{k: getattr(given, k) for k in keys})
    if infer_cfg.eval_placeholder_object_tokens:
        cfg.eval.eval_placeholder_object_tokens = list(
            infer_cfg.eval_placeholder_object_tokens)
    if infer_cfg.torch_dtype in ("fp16", "bf16"):
        cfg.optim.mixed_precision = "bf16"   # fp16 runs bf16: the kernels
    elif infer_cfg.torch_dtype in ("fp32", "no"):
        cfg.optim.mixed_precision = "no"
    arch = None
    if os.environ.get("VIEW_NETI_TINY"):
        arch = builder.tiny_arch()
        cfg.model.word_embedding_dim = arch.text.hidden_size

    dp = dist.init_distributed(device)
    coach = Coach(cfg, arch=arch, calibration_dir=infer_cfg.calibration_dir,
                  weights_dir=os.environ.get("SD_WEIGHTS_DIR"), dist=dp)
    if dp.active and not dp.is_main:
        failed = inference_dtu.serve_sweeps(coach)
        coach.logger.close()
        dist.destroy(dp)
        if failed:
            raise RuntimeError("the offline sweep failed on rank 0")
        return None
    lpips_fn = None
    lpips_weights = (infer_cfg.lpips_weights
                     or os.environ.get("LPIPS_WEIGHTS"))
    if lpips_weights:
        from view_neti_tpu_torch.ops.metrics import make_lpips
        lpips_fn = make_lpips(lpips_weights, device=coach.device)
    validator = ValidationHandler(cfg, masks_root=infer_cfg.masks_root,
                                  calibration_dir=infer_cfg.calibration_dir,
                                  lpips_fn=lpips_fn)
    save_dir = Path(infer_cfg.inference_dir or input_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    try:
        if cfg.learnable_mode == 3:
            tokens = (cfg.eval.eval_placeholder_object_tokens
                      or coach.placeholder_object_tokens[:1])
            results = {tok: _sweep(validator, coach, infer_cfg, save_dir,
                                   tag=f"-{tok}", token=tok)
                       for tok in tokens}
        else:
            results = _sweep(validator, coach, infer_cfg, save_dir)
    except dist.CollectiveError:
        raise
    except Exception:
        if dp.active:   # the other ranks end with rank 0's failure
            inference_dtu.end_sweeps(coach, True)
        raise
    if dp.active:
        inference_dtu.end_sweeps(coach, False)
    coach.logger.close()
    dist.destroy(dp)
    return results


def _sweep(validator, coach, infer_cfg, save_dir: Path, tag: str = "",
           token: Optional[str] = None) -> Dict:
    """One sweep of the step's mappers (of `token`'s object in mode 3),
    its sheets and its bundle (names suffixed by `tag`)."""
    from view_neti_tpu_torch.training import inference_dtu
    from view_neti_tpu_torch.utils import msgpack_codec
    it = infer_cfg.iteration
    results = validator.infer_dtu(
        coach, step=it, num_steps=infer_cfg.num_denoising_steps,
        eval_placeholder_object_token=token, return_instead_of_save=True,
        on_missing_ckpt="raise")
    inference_dtu.save_figures(
        results, [save_dir / f"preds_iter_{it}{tag}_seed{i}.png"
                  for i in range(len(results["grids"]))],
        coach.logger.log_message)
    bundle = inference_dtu.result_bundle(results, infer_cfg.seeds)
    out = save_dir / f"results_all_iter_{it}{tag}.msgpack"
    out.write_bytes(msgpack_codec.packb(bundle))
    print(f"metrics{tag}:", bundle["metrics"])
    print("saved:", out)
    results["bundle"] = out
    return results

