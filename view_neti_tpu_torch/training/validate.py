"""ValidationHandler: evaluation during training
(view_neti_tpu/training/validate.py).

  * DTU runs (modes 2/4/5 on a DTU view vocabulary): the 34-view sweep,
    its masked metrics, result sheets and a result bundle (infer_dtu), and
    renders of the object tokens alone (infer_disentangled_objects_dtu);
  * mode 3: one sweep per evaluated object token against its own scan
    (infer_mode3), the renders of those tokens, and, with
    eval.do_t2i_generalization, free-text objects rendered from every eval
    camera (infer_t2i_generalization);
  * mode 0: the validation prompt bank (infer_mode0);
  * other runs of modes 1/2/4/5: a view-token prompt sheet
    (infer_prompt_sheet).

Sheets are PNGs written by data/image_io, their captions in the log; the
DTU sweeps reload the step's mapper files, the other renders use the live
mappers. Under data parallelism the handler runs on rank 0 alone: the DTU
sweeps of infer_dtu, infer_mode3 and infer_t2i_generalization split their
cameras over the dp groups (inference_dtu.dtu_generate_camidxs_to_preds),
under tensor parallelism rank 0's tp group renders the prompt sheets with
it (inference_dtu.render_prompt_rows), and the metrics, sheets and bundles
stay on rank 0.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from view_neti_tpu_torch.constants import T2I_GENERALIZATION_PROMPTS
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.training import inference_dtu
from view_neti_tpu_torch.utils import msgpack_codec
from view_neti_tpu_torch.utils.vis import make_grid_np, to_uint8

MAX_SHEET_ROWS = 14  # the reference's max_rows


def select_validation_view_tokens(placeholder_view_tokens,
                                  validation_view_tokens, is_dtu: bool,
                                  max_rows: int = MAX_SHEET_ROWS):
    """The view tokens of the validation prompt sheet: the configured ones,
    else all of them thinned (every 30th beyond 100 tokens, every 3rd
    beyond 15 on DTU), at most max_rows - 1."""
    if validation_view_tokens is not None:
        view_tokens = list(validation_view_tokens)
    else:
        view_tokens = list(placeholder_view_tokens)
    if len(view_tokens) > 100:
        view_tokens = view_tokens[::30]
    if is_dtu and len(view_tokens) > 15:
        view_tokens = view_tokens[::3]
    return view_tokens[:max_rows - 1]


class ValidationHandler:
    def __init__(self, cfg, masks_root: Optional[str] = None,
                 calibration_dir: Optional[str] = None, lpips_fn=None):
        self.cfg = cfg
        self.masks_root = masks_root
        self.calibration_dir = calibration_dir
        self.lpips_fn = lpips_fn

    # ------------------------------------------------------------------
    def infer(self, coach, step: int) -> Optional[Dict]:
        """One validation round of the Coach at `step`, by mode (2 denoising
        steps when cfg.debug)."""
        cfg = self.cfg
        num_steps = 2 if cfg.debug else cfg.eval.num_denoising_steps
        if cfg.learnable_mode == 3:
            return self.infer_mode3(coach, step, num_steps)
        if self._is_dtu(coach):
            results = self.infer_dtu(coach, step, num_steps)
            if coach.placeholder_object_tokens:
                self.infer_disentangled_objects_dtu(
                    coach, step, num_steps, coach.placeholder_object_tokens)
            return results
        if cfg.learnable_mode == 0:
            return self.infer_mode0(coach, step, num_steps)
        return self.infer_prompt_sheet(coach, step, num_steps)

    @staticmethod
    def _is_dtu(coach) -> bool:
        """A DTU run: its view vocabulary is DTU-coded."""
        toks = coach.placeholder_view_tokens
        return bool(toks) and "dtu" in toks[0]

    # ------------------------------------------------------------------
    def infer_prompt_sheet(self, coach, step: int, num_steps: int) -> Dict:
        """One row per (thinned) view token, and a row without a view for
        modes with a learnable object."""
        cfg = self.cfg
        view_tokens = select_validation_view_tokens(
            coach.placeholder_view_tokens, cfg.eval.validation_view_tokens,
            is_dtu=False)
        if cfg.learnable_mode == 1:
            obj = coach.train_dataset.fixed_object_token
            prompts = [f"{v}. A photo of a {obj}" for v in view_tokens]
        else:
            obj = coach.placeholder_object_tokens[0]
            prompts = [f"A photo of a {obj}"]
            prompts += [f"{v}. A photo of a {obj}" for v in view_tokens]
        out = Path(cfg.log.exp_dir) / f"val-image-{step}.png"
        sheet = self._render_prompts(coach, num_steps, prompts, out)
        coach.logger.log_images("validation", [sheet], step)
        return {"sheet": str(out), "prompts": prompts}

    # ------------------------------------------------------------------
    def infer_mode0(self, coach, step: int, num_steps: int) -> Dict:
        """Text-to-image over the validation prompt bank at the training
        resolution, one row per prompt."""
        cfg = self.cfg
        token = coach.placeholder_object_tokens[0]
        prompts = [p.format(token) for p in cfg.eval.validation_prompts]
        out = Path(cfg.log.exp_dir) / f"val-images-{step}.png"
        sheet = self._render_prompts(coach, num_steps, prompts, out,
                                     res=cfg.data.resolution)
        coach.logger.log_images("validation", [sheet], step)
        return {"sheet": str(out)}

    # ------------------------------------------------------------------
    def infer_dtu(self, coach, step: int, num_steps: int,
                  eval_placeholder_object_token: Optional[str] = None,
                  return_instead_of_save: bool = False,
                  on_missing_ckpt: str = "warn") -> Dict:
        """The DTU sweep over the 34 eval cameras (2 with cfg.debug), its
        metrics and, unless return_instead_of_save, the result bundle
        validation-iter_{step}-...msgpack, one sheet per seed and the
        metrics in the log."""
        cfg = self.cfg
        cam_idxs, cam_idxs_train, _ = inference_dtu.get_cam_idxs(
            cfg.data.dtu_subset)
        if cfg.debug:
            cam_idxs = cam_idxs[:2]
        preds = inference_dtu.dtu_generate_camidxs_to_preds(
            coach, cam_idxs, step, num_denoising_steps=num_steps,
            seeds=cfg.eval.validation_seeds,
            eval_placeholder_object_token=eval_placeholder_object_token,
            calibration_dir=self.calibration_dir,
            on_missing_ckpt=on_missing_ckpt)
        data_dir = Path(str(cfg.data.train_data_dir))
        if eval_placeholder_object_token and cfg.learnable_mode == 3:
            scans = {t: s for s, t in coach.train_dataset.
                     lookup_object_to_placeholder_object_token.items()}
            data_dir = data_dir / scans[eval_placeholder_object_token]
        gts = inference_dtu.dtu_get_gt_images(
            cam_idxs, data_dir, cfg.data.dtu_lighting,
            cfg.data.dtu_preprocess_key)
        masks = inference_dtu.get_object_masks(
            cam_idxs, self._scan_idx(data_dir), cfg.data.dtu_preprocess_key,
            masks_root=self.masks_root or inference_dtu.DTU_MASKS)
        (imgs_pred, imgs_gt, masks_arr, _, imgs_gt_plot
         ) = inference_dtu.process_imgs(cam_idxs, cam_idxs_train, preds,
                                        gts, masks)
        results = inference_dtu.get_result_metrics_and_grids(
            cam_idxs, cam_idxs_train, imgs_pred, imgs_gt, masks_arr,
            imgs_gt_plot, cfg.eval.validation_seeds,
            do_lpips=self.lpips_fn is not None, lpips_fn=self.lpips_fn,
            title_prefix=f"step {step} |", device=coach.device)
        results["cam_idxs"] = list(cam_idxs)
        if return_instead_of_save:
            return results
        out_dir = Path(cfg.log.exp_dir)
        tag = (f"-{eval_placeholder_object_token}"
               if eval_placeholder_object_token else "")
        bundle_path = out_dir / (
            f"validation-iter_{step}-denoisesteps_{num_steps}"
            f"_numseeds_{len(cfg.eval.validation_seeds)}{tag}.msgpack")
        bundle_path.write_bytes(msgpack_codec.packb(
            inference_dtu.result_bundle(results,
                                        cfg.eval.validation_seeds)))
        inference_dtu.save_figures(
            results, [out_dir / f"val-dtu-step{step}{tag}-seed{i}.png"
                      for i in range(len(results["grids"]))],
            coach.logger.log_message)
        metrics = {k: v for k, v in results.items() if k.endswith("_mean")}
        coach.logger.log_metrics(
            {f"val{tag}/{k}": v for k, v in metrics.items()}, step)
        coach.logger.log_images(
            f"val{tag}", [np.clip(g, 0, 1) for g in results["grids"]], step)
        coach.logger.log_message(f"DTU val step {step}{tag}: {metrics}")
        results["bundle"] = bundle_path
        return results

    def _scan_idx(self, data_dir=None) -> int:
        name = Path(str(data_dir or self.cfg.data.train_data_dir)).name
        digits = "".join(c for c in name if c.isdigit())
        return int(digits) if digits else 0

    # ------------------------------------------------------------------
    def infer_mode3(self, coach, step: int,
                    num_steps: int) -> Dict[str, Dict]:
        """Mode 3's round: a DTU sweep per token of
        eval.eval_placeholder_object_tokens (else the first object token),
        each against its own scan; the renders of those tokens alone; and
        with eval.do_t2i_generalization (off by default) the free-text
        sheet. Returns {token: its sweep's results}."""
        cfg = self.cfg
        tokens = (cfg.eval.eval_placeholder_object_tokens
                  or coach.placeholder_object_tokens[:1])
        results = {tok: self.infer_dtu(coach, step, num_steps,
                                       eval_placeholder_object_token=tok)
                   for tok in tokens}
        self.infer_disentangled_objects_dtu(coach, step, num_steps, tokens)
        if cfg.eval.do_t2i_generalization:
            self.infer_t2i_generalization(coach, step, num_steps)
        return results

    def infer_t2i_generalization(self, coach, step: int,
                                 num_steps: int) -> List[Path]:
        """View control on objects the run never saw: each free-text prompt
        ("a koala", ...) rendered from every eval camera with seed 0, the
        predictions over a strip of the first scan's ground truth at half
        resolution, one PNG sheet per prompt (the prompt in the log)."""
        cfg = self.cfg
        prompts = list(T2I_GENERALIZATION_PROMPTS)
        cam_idxs, _, _ = inference_dtu.get_cam_idxs(cfg.data.dtu_subset)
        if cfg.debug:
            cam_idxs = cam_idxs[:2]
            prompts = prompts[:1]
        data_dir = Path(str(cfg.data.train_data_dir))
        if cfg.data.train_data_subsets:
            data_dir = data_dir / str(cfg.data.train_data_subsets[0])
        gts = inference_dtu.dtu_get_gt_images(
            cam_idxs, data_dir, cfg.data.dtu_lighting,
            cfg.data.dtu_preprocess_key)
        gt_arr = np.stack([gts[i].astype(np.float32) / 255.0
                           for i in cam_idxs])
        nrow = len(cam_idxs)
        written = []
        for i, prompt in enumerate(prompts):
            preds = inference_dtu.dtu_generate_camidxs_to_preds(
                coach, cam_idxs, step, num_denoising_steps=num_steps,
                seeds=[0], eval_placeholder_object_token=prompt,
                calibration_dir=self.calibration_dir)
            pred_arr = np.concatenate([preds[c].astype(np.float32) / 255.0
                                       for c in cam_idxs])
            grid = np.concatenate([make_grid_np(pred_arr, nrow),
                                   make_grid_np(gt_arr, nrow)],
                                  axis=0)[::2, ::2]
            out = Path(cfg.log.exp_dir) / (
                f"validation-iter_{step}-denoisesteps_"
                f"{cfg.eval.num_denoising_steps}_upsample_"
                f"{cfg.eval.dtu_upsample_key}_imgs_t2i_{i}.png")
            image_io.write_png(out, to_uint8(grid))
            coach.logger.log_message(
                f"saved t2i-generalization sheet {out}: {prompt}")
            coach.logger.log_images(f"val_t2i_{i}", [np.clip(grid, 0, 1)],
                                    step)
            written.append(out)
        return written

    def infer_disentangled_objects_dtu(self, coach, step: int,
                                       num_steps: int,
                                       tokens: Sequence[str]) -> None:
        """Renders of the object tokens alone, without a view token (every
        3rd of more than 10 tokens, at most 10)."""
        tokens = list(tokens)
        if len(tokens) > 10:
            tokens = tokens[::3][:10]
        self._render_prompt_bank(coach, step, num_steps, tokens,
                                 tag="disentangled",
                                 templates=["A photo of a {}"])

    def _render_prompt_bank(self, coach, step: int, num_steps: int,
                            tokens: Sequence[str], tag: str,
                            templates=None) -> None:
        cfg = self.cfg
        templates = templates or cfg.eval.validation_prompts
        if cfg.debug:
            templates = templates[:1]
        prompts = [tmpl.format(tok) for tok in tokens for tmpl in templates]
        out = Path(cfg.log.exp_dir) / f"val-{tag}-step{step}.png"
        self._render_prompts(coach, num_steps, prompts, out, tag=tag)

    def _render_prompts(self, coach, num_steps: int, prompts: Sequence[str],
                        out_path: Path, tag: str = "validation",
                        res: Optional[int] = None) -> np.ndarray:
        """Each prompt across the validation seeds with the live mappers:
        one row per prompt, stacked into a sheet written at out_path
        (inference_dtu.render_prompt_rows, with rank 0's tp group under
        tensor parallelism). Square renders at 512 (32 on the tests'
        miniature protocol) unless res is given."""
        cfg = self.cfg
        if res is None:
            res = 512 if cfg.data.dtu_preprocess_key != -1 else 32
        sheet = inference_dtu.render_prompt_rows(
            coach, prompts, num_steps, res, cfg.eval.validation_seeds)
        image_io.write_png(out_path, sheet)
        coach.logger.log_message(f"saved {tag} sheet {out_path}")
        return sheet
