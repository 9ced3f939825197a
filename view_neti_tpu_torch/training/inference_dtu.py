"""DTU novel-view evaluation (view_neti_tpu/training/inference_dtu.py).

The sweep rebuilds its conditioning from the step's checkpoint files (the
reference always reloads from disk, so that in-training validation
behaves as offline inference does), extends the view vocabulary to every
DTU camera without refitting the normalisation bounds, conditions every
(timestep, UNet layer) pair, denoises each camera with CFG and decodes it.
The metrics follow the reference's protocol: 300x400 images, object
masks, masked MSE / PSNR, SSIM and LPIPS, split into train and test
views.

Without PIL or matplotlib: images are read and resized through
data/image_io (PIL's bicubic resampling, bit for bit), and each seed's
result sheet is its grid, written as a PNG, with the sheet's title and
per-view labels in the log.

Under data parallelism (the counterpart of the JAX package's dp-sharded
denoise batch) rank 0 runs the validation round or the offline sweep; each
sweep's cameras are split over the dp groups (dist.split_items), every
group renders its own at the view batch it uses alone, so each image is
the one the one-process sweep computes, and the uint8 images come to rank
0 (dist.gather_to_main) from tp index 0 of each group. The other ranks
wait in serve_sweeps for each request until rank 0 ends the round
(end_sweeps). Under tensor parallelism the ranks of a tp group render
their cameras in lockstep, each through its piece of the split UNet and
CLIP, and rank 0's tp group renders its prompt sheets with it
(render_prompt_rows). A rank that fails between two of the UNet's
collectives leaves its partners waiting in the next one until the process
group's timeout (dist.TIMEOUT_S) ends them: the failure is not caught, as
no partner could go on without it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from view_neti_tpu_torch import weight_port
from view_neti_tpu_torch.checkpoint import CheckpointHandler
from view_neti_tpu_torch.constants import DTU_MASKS, DTU_SPLIT_IDXS
from view_neti_tpu_torch.data import dtu as dtu_mod
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.inference.pipeline import (encode_uncond, generate,
                                                    generate_batch)
from view_neti_tpu_torch.inference.prompt_manager import PromptManager
from view_neti_tpu_torch.ops import metrics as metrics_ops
from view_neti_tpu_torch.parallel import dist
from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
from view_neti_tpu_torch.utils.device import resolve_device
from view_neti_tpu_torch.utils.vis import make_grid_np, to_uint8

METRICS = ("mse", "psnr", "ssim", "lpips")


def get_cam_idxs(dtu_subset: int
                 ) -> Tuple[List[int], List[int], List[int]]:
    """(all 34 eval cameras, the train cameras, the test cameras)."""
    cam_idxs = sorted(DTU_SPLIT_IDXS["train"] + DTU_SPLIT_IDXS["test"])
    cam_idxs_train = dtu_mod.dtu_get_train_idxs(dtu_subset)
    cam_idxs_test = [i for i in cam_idxs if i not in cam_idxs_train]
    return cam_idxs, cam_idxs_train, cam_idxs_test


def dtu_get_gt_images(cam_idxs: Sequence[int], train_data_dir,
                      dtu_lighting: str, dtu_preprocess_key: int
                      ) -> Dict[int, np.ndarray]:
    """The ground-truth images at the evaluation resolution, (H, W, 3)
    uint8."""
    out = {}
    for idx in cam_idxs:
        img = image_io.read_rgb(Path(train_data_dir)
                                / dtu_mod.dtu_cam_and_lighting_to_fname(
                                    idx, dtu_lighting))
        if dtu_preprocess_key == -1:     # the tests' miniature protocol
            img = image_io.resize_pil(img, 64, 48)
        elif dtu_preprocess_key == 0:    # pad to 1600x1600, then 768x768
            if img.shape[:2] != (1200, 1600):
                raise ValueError(f"DTU image {img.shape} is not 1200x1600")
            img = np.concatenate([img, np.zeros((400, 1600, 3), np.uint8)])
            img = image_io.resize_pil(img, 768, 768)
        elif dtu_preprocess_key == 1:
            img = image_io.resize_pil(img, 768, 576)
        else:
            raise NotImplementedError(dtu_preprocess_key)
        out[idx] = img
    return out


def get_object_masks(cam_idxs: Sequence[int], scan_idx: int,
                     dtu_preprocess_key: int = 1,
                     masks_root: str = DTU_MASKS) -> Dict[int, np.ndarray]:
    """RegNeRF's IDR object masks (scan<N>/mask/<cam>.png, or
    scan<N>/<cam>.png), (H, W, 3) uint8; an all-white 1200x1600 mask
    where a file is missing."""
    out = {}
    for cam_idx in cam_idxs:
        dir_mask = Path(masks_root) / f"scan{scan_idx}" / "mask"
        f_mask = (dir_mask / f"{cam_idx:03d}.png" if dir_mask.exists()
                  else dir_mask.parent / f"{cam_idx:03d}.png")
        try:
            mask = image_io.read_rgb(f_mask)
        except FileNotFoundError:
            mask = np.full((1200, 1600, 3), 255, np.uint8)
        if dtu_preprocess_key == 1:
            mask = image_io.resize_pil(mask, 400, 300)
        out[cam_idx] = mask
    return out


def process_imgs(cam_idxs, cam_idxs_train, lookup_camidx_to_img_pred,
                 lookup_camidx_to_img_gt, lookup_camidx_to_mask):
    """The metric inputs, NHWC float32 in [0, 1] at 300x400:
      imgs_pred: (bs, n_seeds, 300, 400, 3)
      imgs_gt:   (bs, 300, 400, 3)
      masks:     (bs, 300, 400, 3), binarised at 0.01
      imgs_gt_plot: the ground truth under a 50-row header, yellow on the
        train views.
    Returns (imgs_pred, imgs_gt, masks, imgs_gt, imgs_gt_plot), as the JAX
    function does."""
    imgs_pred = np.stack([lookup_camidx_to_img_pred[i] for i in cam_idxs])
    if imgs_pred.ndim != 5:
        raise ValueError("expected predictions (bs, n_seeds, h, w, 3)")
    imgs_gt = np.stack([np.asarray(lookup_camidx_to_img_gt[i])
                        for i in cam_idxs])
    masks = np.stack([np.asarray(lookup_camidx_to_mask[i])
                      for i in cam_idxs])
    h_pred, w_pred = imgs_pred.shape[2:4]
    h_gt, w_gt = imgs_gt.shape[1:3]
    if not h_gt / w_gt == h_pred / w_pred == 0.75:
        raise ValueError("the DTU aspect ratio is 0.75")

    def resize_batch(arr, h_new=300, w_new=400):
        out = np.stack([image_io.resize_pil(a.astype(np.uint8), w_new, h_new)
                        for a in arr.reshape((-1,) + arr.shape[-3:])])
        return out.reshape(arr.shape[:-3] + (h_new, w_new, 3))

    imgs_pred = resize_batch(imgs_pred).astype(np.float32) / 255.0
    imgs_gt = resize_batch(imgs_gt).astype(np.float32) / 255.0
    masks = resize_batch(masks).astype(np.float32) / 255.0
    masks = (masks > 0.01).astype(np.float32)
    yellow = np.asarray([1.0, 1.0, 0.0], np.float32)
    headers = [np.ones((50, 400, 3), np.float32) * yellow
               if i in cam_idxs_train else np.zeros((50, 400, 3), np.float32)
               for i in cam_idxs]
    imgs_gt_plot = np.stack([np.concatenate([h, g], axis=0)
                             for h, g in zip(headers, imgs_gt)])
    return imgs_pred, imgs_gt, masks, imgs_gt, imgs_gt_plot


def score(imgs_pred, imgs_gt, masks, lpips_fn=None, device=None
          ) -> Dict[str, np.ndarray]:
    """Per-view masked MSE, PSNR, SSIM and LPIPS of one seed's
    predictions (bs, 300, 400, 3) on `device` (None: the card); LPIPS is 0
    without lpips_fn."""
    device = resolve_device(device)
    pred, gt, mask = (torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
                      for a in (imgs_pred, imgs_gt, masks))
    mse = metrics_ops.masked_mse(pred, gt, mask)
    out = {"mse": mse, "psnr": metrics_ops.psnr_from_mse(mse),
           "ssim": metrics_ops.ssim(pred * mask, gt * mask)}
    out["lpips"] = (lpips_fn(pred * mask * 2 - 1, gt * mask * 2 - 1)
                    if lpips_fn is not None else torch.zeros_like(mse))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def get_result_metrics_and_grids(cam_idxs, cam_idxs_train,
                                 imgs_pred_all_seeds, imgs_gt, masks,
                                 imgs_gt_plot, seeds, do_lpips=False,
                                 lpips_fn=None, title_prefix="",
                                 device=None) -> Dict:
    """The masked metric suite and each seed's result grid (ground truth,
    prediction, masked prediction, residual). The JAX function's keys;
    "figures" holds each seed's caption (its title and per-view labels)
    until save_figures writes the grids and puts their paths there.
    "per_view" adds the per-view values: {metric: [one (bs,) array per
    seed]}."""
    is_train = np.asarray([i in cam_idxs_train for i in cam_idxs])
    per_seed = {k: [] for k in METRICS}
    grids, captions, all_imgs_pred = [], [], []

    def _m(arr):   # a debug-truncated sweep may lack a split
        return float(arr.mean()) if arr.size else float("nan")

    for si, _ in enumerate(seeds):
        imgs_pred = imgs_pred_all_seeds[:, si]
        all_imgs_pred.append(imgs_pred)
        vals = score(imgs_pred, imgs_gt, masks,
                     lpips_fn if do_lpips else None, device)
        for k in METRICS:
            per_seed[k].append(vals[k])
        residual = ((imgs_pred - imgs_gt) + 1) / 2
        nrow = len(imgs_gt)
        grids.append(np.concatenate([
            make_grid_np(imgs_gt_plot, nrow),
            make_grid_np(imgs_pred, nrow),
            make_grid_np(imgs_pred * masks, nrow),
            make_grid_np(residual, nrow)], axis=0))
        psnr_b, mse_b, ssim_b, lpips_b = (vals[k] for k in
                                          ("psnr", "mse", "ssim", "lpips"))
        title = title_prefix + (
            f" PSNR: train {_m(psnr_b[is_train]):.3f}   "
            f"test {_m(psnr_b[~is_train]):.3f}  |  "
            f"MSE: train {_m(mse_b[is_train]):.3f}   "
            f"test {_m(mse_b[~is_train]):.3f}  |  "
            f"SSIM: train {_m(ssim_b[is_train]):.3f}   "
            f"test {_m(ssim_b[~is_train]):.3f}  |  "
            f"LPIPS: train {_m(lpips_b[is_train]):.3f}   "
            f"test {_m(lpips_b[~is_train]):.3f}")
        labels = [f"cam {c}: psnr {p:.1f} mse {m:.4f} ssim {s:.3f} "
                  f"lpips {lp:.3f}" + (" TRAIN" if t else "")
                  for c, t, p, m, s, lp in zip(cam_idxs, is_train, psnr_b,
                                               mse_b, ssim_b, lpips_b)]
        captions.append("\n".join([title] + labels))

    def agg(key, mask):
        if not mask.any():
            return float("nan")
        return float(np.concatenate([v[mask] for v in per_seed[key]]).mean())

    return dict(
        figures=captions, grids=grids, imgs_pred=all_imgs_pred,
        imgs_gt=imgs_gt, imgs_gt_plot=imgs_gt_plot, masks=masks,
        per_view=per_seed,
        **{f"{k}_{split}_mean": agg(k, is_train if split == "train"
                                    else ~is_train)
           for k in METRICS for split in ("train", "test")})


def save_figures(results: Dict, paths: Sequence[Path],
                 log: Callable[[str], None]) -> List[Path]:
    """Write each seed's grid as a PNG at paths[i], log its caption, and
    put the paths in results["figures"]."""
    written = []
    for grid, caption, path in zip(results["grids"], results["figures"],
                                   paths):
        image_io.write_png(path, to_uint8(grid))
        log(f"result sheet {path}:\n{caption}")
        written.append(Path(path))
    results["figures"] = written
    return written


def result_bundle(results: Dict, seeds: Sequence[int]) -> Dict:
    """The msgpack bundle of a sweep (the JAX package's keys), which
    summarize_dtu scores again."""
    return {
        "imgs_pred": np.stack(results["imgs_pred"]),   # (S, bs, h, w, 3)
        "imgs_gt": results["imgs_gt"],
        "masks": results["masks"],
        "metrics": {k: v for k, v in results.items() if k.endswith("_mean")},
        "seeds": np.asarray(list(seeds)),
    }


def _reloaded(live, entry):
    """A copy of a live mapper module with a checkpoint entry's
    parameters."""
    mapper = copy.deepcopy(live)
    mapper.load_state_dict(weight_port.from_jax_mapper(entry["params"],
                                                       entry["constants"]),
                           strict=True)
    return mapper.requires_grad_(False)


def dtu_generate_camidxs_to_preds(coach, cam_idxs: Sequence[int],
                                  step: int, **kwargs
                                  ) -> Optional[Dict[int, np.ndarray]]:
    """{camera: (n_seeds, H, W, 3) uint8} for every camera of cam_idxs
    (render_cameras' arguments). Under data parallelism it runs on rank 0
    and splits the cameras over the ranks, which serve_sweeps holds ready;
    the images come back to rank 0."""
    if not coach.dist.active:
        return render_cameras(coach, cam_idxs, step, **kwargs)
    request = dict(kwargs, cam_idxs=list(cam_idxs), step=step)
    dist.broadcast_from_main(coach.dist, request)
    return _render_share(coach, request)


def _render_share(coach, request: Dict) -> Optional[Dict[int, np.ndarray]]:
    """The rank's dp group's share of a split sweep, gathered on rank 0 in
    camera order (tp index 0 of each group sends the images). A failure to
    render outside the UNet's collectives travels with the gather and
    raises on rank 0, so that the ranks never part at a collective."""
    dp = coach.dist
    kwargs = dict(request)
    cams = kwargs.pop("cam_idxs")
    share = dist.split_items(cams, dp.dp_index, dp.dp_world)
    try:
        part, error = render_cameras(coach, share, **kwargs), None
    except Exception as e:   # sent to rank 0, which raises
        part, error = None, f"rank {dp.rank}: {e!r}\n{traceback.format_exc()}"
    parts = dist.gather_to_main(dp, (part if dp.tp_index == 0 else None,
                                     error))
    if parts is None:
        return None
    errors = [e for _, e in parts if e is not None]
    if errors:
        raise RuntimeError("split DTU sweep failed:\n" + "\n".join(errors))
    merged = {}
    for p, _ in parts:
        merged.update(p or {})
    return {c: merged[c] for c in cams}


def serve_sweeps(coach) -> bool:
    """A rank other than 0 during rank 0's validation round or offline
    run: render its share of each sweep that rank 0 requests, and under
    tensor parallelism in rank 0's tp group each prompt sheet with it,
    until rank 0 ends the round; returns rank 0's verdict, whether the
    round failed."""
    while True:
        request = dist.broadcast_from_main(coach.dist)
        if "failed" in request:
            return request["failed"]
        if "prompts" in request:
            if coach.dist.dp_index == 0:
                _prompt_rows(coach, **request)
            continue
        _render_share(coach, request)


def render_prompt_rows(coach, prompts: Sequence[str], num_steps: int,
                       res: int, seeds: Sequence[int]) -> np.ndarray:
    """Rank 0's (or one process's) prompt sheet: one row per prompt across
    the seeds, res x res, with the live mappers. Under tensor parallelism
    rank 0 first asks its tp group, waiting in serve_sweeps, to render the
    same rows with it."""
    request = dict(prompts=list(prompts), num_steps=num_steps, res=res,
                   seeds=list(seeds))
    if coach.dist.sharded:
        dist.broadcast_from_main(coach.dist, request)
    return _prompt_rows(coach, **request)


@torch.no_grad()
def _prompt_rows(coach, prompts: Sequence[str], num_steps: int, res: int,
                 seeds: Sequence[int]) -> np.ndarray:
    """Each prompt across the seeds, one row per prompt, stacked into a
    sheet. The object mapper of each prompt is the one whose token id it
    holds."""
    unet, vae = coach.infer_frozen()
    text = coach.built.text
    schedule = DPMSolverSchedule(
        prediction_type=coach.built.schedule.prediction_type)
    pm = PromptManager(
        coach.tokenizer, text, schedule.set_timesteps(num_steps),
        placeholder_view_token_ids=coach.built.placeholder_view_token_ids,
        placeholder_object_token_ids=coach.built.placeholder_object_token_ids,
        dtype=coach.compute_dtype)
    uncond = encode_uncond(text.clip, coach.tokenizer)
    denoise, decode = coach.sampling_fns(schedule, num_steps, 7.5)
    rows, pending = [], None
    for prompt in prompts:
        prompt_ids = set(int(x) for x in np.asarray(coach.tokenizer(
            prompt, padding="max_length", truncation=True,
            max_length=coach.tokenizer.model_max_length
        ).input_ids).reshape(-1).tolist())
        object_idx = next(
            (i for i, tok_id in enumerate(
                coach.built.placeholder_object_token_ids or ())
             if int(tok_id) in prompt_ids), 0)
        ctx, ctx_b = pm.embed_prompt(prompt, object_idx=object_idx)
        dev = generate(unet, vae, schedule, ctx, ctx_b, uncond, res, res,
                       seeds, num_steps, 7.5, coach.compute_dtype,
                       denoise_fn=denoise, as_numpy=False,
                       device=coach.device, decode_fn=decode)
        if pending is not None:
            rows.append(np.concatenate(list(pending.cpu().numpy()), axis=1))
        pending = dev
    if pending is not None:
        rows.append(np.concatenate(list(pending.cpu().numpy()), axis=1))
    return np.concatenate(rows, axis=0)


def end_sweeps(coach, failed: bool) -> None:
    """Rank 0 ends the round that serve_sweeps waits on."""
    dist.broadcast_from_main(coach.dist, {"failed": bool(failed)})


@torch.no_grad()
def render_cameras(
        coach, cam_idxs: Sequence[int], step: int,
        num_denoising_steps: int = 30, seeds: Sequence[int] = (0, 1),
        eval_placeholder_object_token: Optional[str] = None,
        guidance_scale: float = 7.5,
        calibration_dir: Optional[str] = None,
        on_missing_ckpt: str = "warn") -> Dict[int, np.ndarray]:
    """{camera: (n_seeds, H, W, 3) uint8} for every camera of cam_idxs, on
    this process.

    The mappers come from the step's checkpoint files
    (mapper-steps-{step}_{view,object}.msgpack), the view vocabulary is
    extended to every DTU camera without refitting its bounds, and the
    prompts are "{view token}. A photo of a {object}". Where a step file is
    missing, on_missing_ckpt "warn" logs a warning and uses the live
    mappers; "raise" (the offline CLI) raises FileNotFoundError. Cameras
    run VIEW_NETI_VIEW_BATCH at a time (default 1) through one denoise
    loop."""
    if on_missing_ckpt not in ("warn", "raise"):
        raise ValueError(f"on_missing_ckpt {on_missing_ckpt!r}")
    cfg = coach.cfg
    exp_dir = Path(cfg.log.exp_dir)
    text = coach.built.text
    device = coach.device

    # ---- the mappers of the step's checkpoint files --------------------
    view_mapper, obj_mappers = text.view_mapper, text.obj_mappers
    missing_ckpts = []
    if cfg.learnable_mode != 0:
        p = exp_dir / f"mapper-steps-{step}_view.msgpack"
        if p.exists():
            _, payload = CheckpointHandler.load_mapper(p)
            view_mapper = _reloaded(text.view_mapper,
                                    payload["mappers"]["view"])
        else:
            missing_ckpts.append(p.name)
    if cfg.learnable_mode != 1:
        p = exp_dir / f"mapper-steps-{step}_object.msgpack"
        if p.exists():
            _, payload = CheckpointHandler.load_mapper(p)
            obj_mappers = [_reloaded(m, payload["mappers"][t]) for m, t in
                           zip(text.obj_mappers,
                               coach.placeholder_object_tokens)]
        elif text.obj_mappers:
            missing_ckpts.append(p.name)
    if missing_ckpts:
        msg = (f"DTU eval at step {step}: mapper checkpoint(s) "
               f"{missing_ckpts} not found under {exp_dir}; the protocol "
               "reloads them from disk so that validation equals offline "
               "inference")
        if on_missing_ckpt == "raise":
            raise FileNotFoundError(msg)
        coach.logger.log_message(
            "WARNING: " + msg + " - falling back to LIVE trainable params")

    # ---- the view vocabulary over every DTU camera ---------------------
    kwargs = {}
    if calibration_dir is not None:
        kwargs["calibration_dir"] = calibration_dir
    lookup_tok, _ = dtu_mod.dtu_generate_dset_cam_tokens_params(**kwargs)
    table = coach.built.view_table
    new_tokens = [t for t in lookup_tok.values() if t not in table.tokens]
    coach.tokenizer.add_tokens(new_tokens)
    new_ids = [coach.tokenizer.convert_tokens_to_ids(t) for t in new_tokens]
    ext_table = table.extend(new_tokens, new_ids)
    text = dataclasses.replace(
        text, view_mapper=view_mapper, obj_mappers=obj_mappers,
        view_table_ids=torch.as_tensor(
            ext_table.token_ids.astype(np.int64), device=device),
        view_table_params=torch.as_tensor(ext_table.params_scaled(),
                                          device=device))

    # ---- conditioning and generation -----------------------------------
    schedule = DPMSolverSchedule(
        prediction_type=coach.built.schedule.prediction_type)
    pm = PromptManager(
        coach.tokenizer, text, schedule.set_timesteps(num_denoising_steps),
        placeholder_view_token_ids=list(ext_table.token_ids),
        placeholder_object_token_ids=coach.built.placeholder_object_token_ids,
        dtype=coach.compute_dtype)
    if eval_placeholder_object_token:
        object_token = eval_placeholder_object_token
    elif cfg.learnable_mode in (2, 3, 4, 5):
        object_token = coach.placeholder_object_tokens[0]
    else:
        object_token = cfg.data.fixed_object_token_or_path
    object_idx = (coach.placeholder_object_tokens.index(object_token)
                  if object_token in coach.placeholder_object_tokens else 0)
    if cfg.data.dtu_preprocess_key == -1:    # the tests' miniature protocol
        width, height = 64, 48
    elif cfg.data.dtu_preprocess_key == 1:
        width, height = 768, 576
    else:
        width, height = 768, 768

    unet, vae = coach.infer_frozen()
    uncond = encode_uncond(text.clip, coach.tokenizer)
    vb = int(os.environ.get("VIEW_NETI_VIEW_BATCH") or 1)
    # one graph per shape across the sweep's views and seeds (and the
    # Coach's later rounds); a ragged last chunk is captured apart, logged
    denoise, decode = coach.sampling_fns(schedule, num_denoising_steps,
                                         guidance_scale)
    out: Dict[int, np.ndarray] = {}
    camidx_to_token = dict(lookup_tok)
    # one chunk deep: the next chunk's conditioning and denoise are
    # launched before this chunk's images are copied to the host
    pending = None

    def drain(p):
        imgs = p[1].cpu().numpy()
        for ci, cam_idx in enumerate(p[0]):
            out[cam_idx] = imgs[ci]       # (n_seeds, H, W, 3) uint8

    for start in range(0, len(cam_idxs), vb):
        chunk = list(cam_idxs[start:start + vb])
        prompts = [f"{camidx_to_token[ci]}. A photo of a {object_token}"
                   for ci in chunk]
        contexts, contexts_b = pm.embed_prompts(prompts,
                                                object_idx=object_idx)
        imgs = generate_batch(
            unet, vae, schedule, contexts, contexts_b, uncond, height, width,
            seeds, num_denoising_steps, guidance_scale, coach.compute_dtype,
            denoise_fn=denoise, as_numpy=False, device=device,
            decode_fn=decode)
        if pending is not None:
            drain(pending)
        pending = (chunk, imgs)
    if pending is not None:
        drain(pending)
    return out
