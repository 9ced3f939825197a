"""Coach: the textual-inversion trainer (view_neti_tpu/training/coach.py).

The per-step work is the train step (training/train_step.py); the Coach
owns the host side: the dataset and its loader, the vocabulary growth, the
optimizer and its learning-rate table, the caches on the card, the
per-step random numbers, checkpoint cadence and logging.

What it runs, as the JAX Coach runs it:
  * fuse_accumulation (the default) runs train_batch_size x
    gradient_accumulation_steps samples as one batch per optimizer step;
    off, it accumulates the gradients of k micro-batches and steps once
    (optax.MultiSteps in the JAX package);
  * mode 3 (one view mapper over several scans, one object mapper per
    scan): fused, the batch is k groups of train_batch_size samples, each
    group from its own scene draw and conditioned on that scene's object
    mapper (TrainBatch.object_idx (G,)); unfused, each micro-batch draws
    one scene. Mode 3 keeps no latent cache;
  * augmentation 0 without a flip: every image's VAE posterior moments are
    encoded once into a latent cache on the card, and the step samples from
    them;
  * an augmentation preset (the shipped mode-2 recipe is 7): the uint8
    bases are decoded once into a cache on the card (when they fit under
    VIEW_NETI_DEVICE_BASE_CACHE_MB) and the step augments them there;
    the host sends only indices;
  * with data.device_augment false, or on an llff folder (the images keep
    their own sizes), the dataset flips and augments on the host
    (data/augment.py) and the step encodes the float pixel batch through
    the VAE every step; an llff folder of several sizes needs a preset that
    crops to one, and the Coach refuses one without it at its start;
  * the random numbers of micro-step m come from a generator on the card
    seeded with a fixed mix of (seed, m), the counterpart of JAX's
    fold_in(base, m): they depend on the position alone;
  * optim.steps_per_dispatch (0: 4 with a cache on the card, else 1; the
    JAX Coach's rule) optimizer steps run as one dispatch window, shrunk
    to land on save, validation and end boundaries (`dispatch_window`,
    JAX's _dispatch_window), the counterpart of make_multi_step's W-step
    scan: on the card each optimizer step (its k micro-batches) is one
    replay of a CUDA graph captured once (utils/graphs.py), its batch
    and draws copied into the graph's buffers before the replay, and the
    window's W losses land in one device tensor read once. Under
    torch.distributed (the step all-reduces its gradients) and in mode 3
    (each group's object mapper is chosen on the host) the window's steps
    run eagerly, back to back, and the Coach says so once;
    steps_per_dispatch 1 makes every window one optimizer step, run
    eagerly;
  * losses are read one window behind, from a pinned copy, so the loop
    never waits for the work it has just launched;
  * a checkpoint every log.save_steps (pruned to
    log.checkpoints_total_limit) and a final one, in the JAX package's
    files (checkpoint.py); with log.checkpoint_backend "orbax" (the
    config's request for a resumable state) a train state beside each
    (train_state.py), and log.resume_from (a state file, or "latest")
    restores one and fast-forwards the stream to its step, so that the
    resumed run replays the uninterrupted one;
  * with a validator attached (training/validate.py), a validation round
    every eval.validation_steps, after that step's checkpoint is written
    (the DTU sweep reloads it); max_validation_failures consecutive
    failures abort the run;
  * the frozen SD stack from a diffusers-layout directory (weights_dir),
    loaded strictly unless VIEW_NETI_LAX_WEIGHTS is set, and a reference
    torch view mapper (.pt) for modes 4/5 through torch_interop;
  * data parallel over torch.distributed (`dist`, a parallel/dist.py
    record; the JAX Coach's mesh dp axis): every rank runs the same loader
    and draws the whole fused batch's numbers, keeps its rows of both
    before the copy to the card (the caches and resume keep global
    indices), and one all-reduce a step averages the gradients and the
    loss; only rank 0 logs and writes files, each write followed by a
    barrier; every rank enters the validation cadence, rank 0 runs the
    round and the others render their share of its DTU sweeps
    (inference_dtu.serve_sweeps), and rank 0's verdict keeps the
    consecutive-failure count equal on every rank;
  * the mesh's tp axis (parallel.tp): the ranks form a dp x tp layout
    (dist_lib.with_layout); the rows, the draws and the sweeps are cut by
    the dp index, so the ranks of a tp group compute the same rows, and
    the gradient all-reduce runs over the dp group. With
    parallel.tensor_parallel the frozen UNet's attention and feed-forward
    projections and CLIP's MLP are split over the tp group after the
    weights are loaded (parallel/tensor.py shard_frozen_, the JAX Coach's
    _place_frozen_on_mesh); the ranks of a group then render rank 0's
    prompt sheets together with it (inference_dtu.render_prompt_rows);
  * with VIEW_NETI_TRACE_DIR set, the train loop, from the first batch to
    the last window's metrics, runs under torch.profiler
    (utils/profiling.trace), which writes one trace file a process into
    that directory before the final checkpoint, or when the loop raises;
  * the loop records spans (utils/profiling.span): coach.loop around it,
    coach.window a dispatch window, coach.feed a step's batch copy and
    draws, coach.step its window_step call, coach.stage, coach.log,
    coach.save and coach.validate; setup.cache_fill the cache's fill.

Not ported: the XLA cost hook (TPU tooling) and the orbax format
(train_state.py writes the port's own).
"""
from __future__ import annotations

import functools
import math
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from view_neti_tpu_torch import train_state, weight_port
from view_neti_tpu_torch.checkpoint import CheckpointHandler
from view_neti_tpu_torch.config import RunConfig
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.dataset import (DataLoader,
                                              TextualInversionDataset)
from view_neti_tpu_torch.data.loader import PrefetchLoader
from view_neti_tpu_torch.inference.pipeline import (make_decode_fn,
                                                    make_denoise_fn)
from view_neti_tpu_torch.ops import device_augment
from view_neti_tpu_torch.parallel import dist as dist_lib
from view_neti_tpu_torch.parallel import tensor as tensor_lib
from view_neti_tpu_torch.tokenizer import FallbackTokenizer, load_tokenizer
from view_neti_tpu_torch.training import builder, inference_dtu
from view_neti_tpu_torch.training.logger import CoachLogger
from view_neti_tpu_torch.training.optim import (SlicedAdamW,
                                                make_lr_schedule,
                                                scaled_learning_rate,
                                                trainable_mask_keys)
from view_neti_tpu_torch.training.train_step import (TrainBatch,
                                                     make_train_step,
                                                     sample_step_draws)
from view_neti_tpu_torch.utils.device import resolve_device
from view_neti_tpu_torch.utils.graphs import Graphed
from view_neti_tpu_torch.utils.misc import fixseed
from view_neti_tpu_torch.utils.profiling import (SpanRecord, StepTimer,
                                                 span, trace)
from view_neti_tpu_torch.utils.vis import downsample_image, get_image_grid

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, micro_step: int) -> int:
    """The generator seed of a micro-step: splitmix64's finaliser over
    (seed, micro_step), so nearby positions get unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15
         + (micro_step + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def resolve_steps_per_dispatch(steps_per_dispatch: int,
                               use_pixel_cache: bool) -> int:
    """optim.steps_per_dispatch, with 0 resolved as the JAX Coach resolves
    it (view_neti_tpu/training/coach.py:180-183): 4 when the batch is
    indices into a cache on the card, else 1."""
    if steps_per_dispatch == 0:
        return 4 if use_pixel_cache else 1
    return steps_per_dispatch


def dispatch_window(cfg: RunConfig, steps_per_dispatch: int,
                    global_step: int, has_validator: bool,
                    accum_k: int) -> int:
    """The micro-steps of the next dispatch window, as the JAX Coach's
    _dispatch_window computes them: steps_per_dispatch optimizer steps,
    shrunk to land exactly on the save, validation and end boundaries,
    times the accumulation factor (a window holds whole k-micro-batch
    groups); 1 when steps_per_dispatch <= 1."""
    if steps_per_dispatch <= 1:
        return 1
    w_opt = min(steps_per_dispatch,
                cfg.optim.max_train_steps - global_step)
    s = cfg.log.save_steps
    w_opt = min(w_opt, s - (global_step % s))
    if has_validator and cfg.eval.validation_prompts is not None:
        v = cfg.eval.validation_steps
        w_opt = min(w_opt, v - (global_step % v))
    return max(1, w_opt) * accum_k


class Coach:
    def __init__(self, cfg: RunConfig,
                 arch: Optional[builder.SDArch] = None,
                 calibration_dir: Optional[str] = None,
                 weights_dir: Optional[str] = None, device=None,
                 dist: Optional[dist_lib.DataParallel] = None):
        # dist: the rank's record from dist_lib.init_distributed (its
        # device wins over `device`); None runs one process
        self.dist = (dist if dist is not None
                     else dist_lib.DataParallel(device=resolve_device(device)))
        self.device = self.dist.device
        self.cfg = cfg
        self.logger = CoachLogger(cfg, enabled=self.dist.is_main)
        if cfg.optim.seed is not None:
            fixseed(cfg.optim.seed)
        o = cfg.optim
        fused = o.fuse_accumulation and o.gradient_accumulation_steps > 1
        # mode 3 fused: the batch is k groups of train_batch_size, each
        # with its own scene (the reference's per-micro-batch scenes)
        self.mode3_group_size = (o.train_batch_size
                                 if fused and cfg.learnable_mode == 3
                                 else None)
        if fused:
            self.micro_batch_size = (o.train_batch_size
                                     * o.gradient_accumulation_steps)
            self.accum_k = 1
        else:
            self.micro_batch_size = o.train_batch_size
            self.accum_k = o.gradient_accumulation_steps
        n_dp = dist_lib.resolve(cfg.parallel, self.micro_batch_size,
                                self.dist.world)
        self.dist = dist_lib.with_layout(self.dist, self.dist.world // n_dp,
                                         cfg.parallel.tensor_parallel)
        if self.dist.active:
            self.logger.log_message(
                f"data parallel: {self.dist.world} ranks over "
                f"{self.dist.backend}"
                f"{' sharing one card' if self.dist.shared_card else ''}, "
                f"{self.micro_batch_size // n_dp} of the "
                f"{self.micro_batch_size} rows a step each")
            self.logger.log_message(
                f"device mesh: dp={n_dp} tp={self.dist.tp_world} "
                f"(tensor_parallel={cfg.parallel.tensor_parallel})")
        mp = cfg.optim.mixed_precision
        if mp is False:  # YAML 1.1 reads a bare `no` as False
            mp = "no"
        # fp16 runs bf16, as in the JAX package: the kernels are bf16
        self.compute_dtype = {"no": torch.float32, "fp16": torch.bfloat16,
                              "bf16": torch.bfloat16}[mp]
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = cfg.optim.allow_tf32

        # ---- architecture, tokenizer, dataset ----------------------------
        self.arch = arch or builder.resolve_arch(
            cfg.model.pretrained_model_name_or_path,
            cfg.model.word_embedding_dim)
        if cfg.optim.gradient_checkpointing:
            self.arch = builder.with_gradient_checkpointing(self.arch)
        self.tokenizer = load_tokenizer(cfg.data.tokenizer_path)
        if (isinstance(self.tokenizer, FallbackTokenizer)
                and self.arch.text.vocab_size
                != self.tokenizer.base_vocab_size):
            # keep the hashed ids inside the model's table
            self.tokenizer = FallbackTokenizer(
                base_vocab_size=self.arch.text.vocab_size)
        self.tokenizer.model_max_length = \
            self.arch.text.max_position_embeddings
        self.train_dataset = self._init_dataset(calibration_dir)
        if not self.train_dataset.uniform_base_shape:
            # the llff passthrough: host augmentation, stackable batches
            self.train_dataset.check_host_batches()
        self.placeholder_view_tokens = \
            self.train_dataset.placeholder_view_tokens
        self.placeholder_object_tokens = \
            self.train_dataset.placeholder_object_tokens
        if cfg.eval.validation_view_tokens is not None:
            assert all(v in self.placeholder_view_tokens
                       for v in cfg.eval.validation_view_tokens)

        # ---- models --------------------------------------------------------
        self.built = builder.build_models(
            cfg, self.tokenizer, self.placeholder_view_tokens,
            self.placeholder_object_tokens, arch=self.arch,
            compute_dtype=self.compute_dtype,
            calibration_dir=calibration_dir, device=self.device)
        if weights_dir is not None:
            self._load_pretrained_weights(weights_dir)
        tensor_lib.shard_frozen_(self.built.unet, self.built.text.clip,
                                 self.dist, log=self.logger.log_message)
        self._maybe_load_pretrained_mappers()
        fuse = cfg.optim.fuse_conv
        self.fuse_conv = (self.device.type == "cuda" if fuse is None
                          else bool(fuse))
        if self.fuse_conv:
            builder.fuse_vae_for_training(self.built.vae)

        # ---- optimizer ---------------------------------------------------
        lr = scaled_learning_rate(o.learning_rate, o.scale_lr,
                                  o.train_batch_size,
                                  o.gradient_accumulation_steps,
                                  num_processes=1)
        self.lr_schedule = make_lr_schedule(o.lr_scheduler, lr,
                                            o.lr_warmup_steps,
                                            o.max_train_steps)
        self._lr_host = np.asarray(
            [self.lr_schedule(s) for s in range(o.max_train_steps + 2)],
            np.float32)
        self.optimizer = SlicedAdamW(
            builder.trainable_groups(self.built), self.lr_schedule,
            o.adam_beta1, o.adam_beta2, o.adam_epsilon, o.adam_weight_decay,
            frozen_keys=trainable_mask_keys(cfg.learnable_mode)[1],
            schedule_steps=o.max_train_steps)

        # ---- caches on the card and the augmentation ---------------------
        ds = self.train_dataset
        self.cache_latents = (cfg.data.augmentation_key == 0
                              and ds.flip_p == 0.0
                              and cfg.learnable_mode != 3)
        self.augment_spec = None
        if (not self.cache_latents and cfg.data.device_augment
                and ds.uniform_base_shape):
            self.augment_spec = device_augment.from_augmentation_key(
                cfg.data.augmentation_key, ds.flip_p)
        if self.augment_spec is not None:
            self.logger.log_message(
                f"device augmentation active: {self.augment_spec}")
        self.use_pixel_cache = (self.cache_latents
                                or (self.augment_spec is not None
                                    and self._base_cache_fits()))
        self.train_step = make_train_step(
            self.optimizer, compute_dtype=self.compute_dtype,
            from_moments=self.cache_latents, augment=self.augment_spec,
            cache_pixels=self.use_pixel_cache,
            accumulation_steps=self.accum_k,
            reduce=(functools.partial(dist_lib.all_reduce_step_, self.dist,
                                      self.optimizer)
                    if self.dist.active else None))

        # ---- the dispatch window -----------------------------------------
        self.steps_per_dispatch = resolve_steps_per_dispatch(
            o.steps_per_dispatch, self.use_pixel_cache)
        eager = None
        if self.dist.active:
            eager = (f"the step all-reduces its gradients over "
                     f"torch.distributed ({self.dist.backend})")
        elif cfg.learnable_mode == 3:
            eager = ("mode 3 chooses each group's object mapper on the "
                     "host")
        if self.steps_per_dispatch > 1 and eager:
            self.logger.log_message(
                f"the {self.steps_per_dispatch}-step dispatch windows run "
                f"eagerly, back to back without a host read: {eager}")
        # one optimizer step (k micro-batches) of a window: a CUDA graph
        # replay on the card, the step itself on the CPU or where eager
        self.window_step = Graphed(
            self._optimizer_step, "train step",
            enabled=self.steps_per_dispatch > 1 and eager is None,
            log=self.logger.log_message)
        self._window_sizes = set()
        # the sweeps' and renders' denoise and decode functions, kept
        # across validation rounds so that each shape is captured once
        self._sampling = {}

        self.checkpoint_handler = CheckpointHandler(
            cfg=cfg,
            placeholder_view_tokens=self.placeholder_view_tokens,
            placeholder_view_token_ids=self.built.placeholder_view_token_ids,
            placeholder_object_tokens=self.placeholder_object_tokens,
            placeholder_object_token_ids=(
                self.built.placeholder_object_token_ids),
            save_root=cfg.log.exp_dir)
        self.validator = None  # attached by the caller (ValidationHandler)
        self.global_step = 0
        seed = cfg.optim.seed if cfg.optim.seed is not None else cfg.seed
        self._base_seed = int(seed)
        self._generator = torch.Generator(self.device)
        # what the loop recorded: the logged losses, and the spans of the
        # last train loop (its coach.step spans lie inside it) and of the
        # cache fill
        self.losses = []
        self.loop_span: Optional[SpanRecord] = None
        self.cache_fill_span: Optional[SpanRecord] = None
        self._maybe_resume()

    @property
    def loop_end_s(self) -> Optional[float]:
        """The end of the last train loop (after its last loss was read),
        on the perf_counter clock."""
        return self.loop_span and self.loop_span.end_ns * 1e-9

    @property
    def cache_fill_s(self) -> Optional[float]:
        return self.cache_fill_span and self.cache_fill_span.seconds

    # ------------------------------------------------------------------
    def _init_dataset(self, calibration_dir) -> TextualInversionDataset:
        cfg = self.cfg
        return TextualInversionDataset(
            learnable_mode=cfg.learnable_mode,
            train_data_subsets=cfg.data.train_data_subsets,
            placeholder_object_tokens=cfg.data.placeholder_object_tokens,
            fixed_object_token_or_path=cfg.data.fixed_object_token_or_path,
            data_root=cfg.data.train_data_dir,
            tokenizer=self.tokenizer,
            size=cfg.data.resolution,
            placeholder_object_token=cfg.data.placeholder_object_token,
            repeats=cfg.data.repeats,
            center_crop=cfg.data.center_crop,
            caption_strategy=cfg.data.caption_strategy,
            camera_representation=cfg.data.camera_representation,
            dtu_lighting=cfg.data.dtu_lighting,
            dtu_subset=cfg.data.dtu_subset,
            dtu_preprocess_key=cfg.data.dtu_preprocess_key,
            augmentation_key=cfg.data.augmentation_key,
            flip_p=cfg.data.flip_p,
            calibration_dir=calibration_dir,
            seed=cfg.seed,
            set_name="train")

    def _load_pretrained_weights(self, weights_dir: str) -> None:
        """The frozen UNet, VAE and CLIP from a diffusers-layout directory,
        copied into the built modules in their dtypes (the compute dtype;
        norms and tables fp32). Strict: a key missing or left over on
        either side raises; VIEW_NETI_LAX_WEIGHTS=1 logs each instead. The
        placeholders' token rows and target norms are then taken from the
        loaded super-category rows."""
        arch = self.arch
        strict = not os.environ.get("VIEW_NETI_LAX_WEIGHTS")
        log = self.logger.log_message
        sds = weight_port.load_sd_weights(
            weights_dir, text_layers=arch.text.num_layers,
            use_linear_projection=arch.unet.use_linear_projection,
            vocab_headroom=arch.text.vocab_headroom, strict=strict, log=log,
            unet_blocks=len(arch.unet.block_out_channels),
            vae_blocks=len(arch.vae.channel_mults))
        built = self.built
        for name, module in (("unet", built.unet), ("vae", built.vae),
                             ("clip", built.text.clip)):
            result = module.load_state_dict(sds[name], strict=strict)
            if result.missing_keys or result.unexpected_keys:
                log(f"WARNING: {name}: {len(result.missing_keys)} "
                    f"parameters KEPT FROM RANDOM INIT, e.g. "
                    f"{result.missing_keys[:5]}; "
                    f"{len(result.unexpected_keys)} file keys unused, e.g. "
                    f"{result.unexpected_keys[:5]}")
        del sds
        table = built.text.clip.text_model.embeddings.token_embedding.weight
        norms_obj, norm_view = builder.init_concept_rows_(
            self.cfg, self.tokenizer, built.placeholder_view_token_ids,
            built.placeholder_object_token_ids, table)
        built.target_norm_object = norms_obj or None
        built.target_norm_view = norm_view
        if built.text.obj_norm_scales is not None:
            built.text.obj_norm_scales = torch.tensor(norms_obj,
                                                      device=self.device)
        if built.text.view_norm_scale is not None and norm_view:
            built.text.view_norm_scale = torch.tensor(norm_view,
                                                      device=self.device)
        log(f"loaded pretrained weights: {weights_dir}")

    def _maybe_load_pretrained_mappers(self) -> None:
        """Modes 4/5: the pretrained view mapper; modes 1/2 with an object
        mapper checkpoint: that mapper (mode 3 refuses one: the dataset
        raises). Both from the msgpack files of checkpoint.py (the JAX
        package's or the port's)."""
        cfg = self.cfg
        text = self.built.text
        if cfg.learnable_mode in (4, 5) and cfg.model.pretrained_view_mapper:
            p = Path(cfg.model.pretrained_view_mapper)
            if p.exists() and p.suffix in (".pt", ".bin", ".pth"):
                from view_neti_tpu_torch.torch_interop import \
                    maybe_import_view_mapper
                p = maybe_import_view_mapper(p)
                self.logger.log_message(f"imported torch view mapper -> {p}")
            if p.exists():
                _, payload = CheckpointHandler.load_mapper(p)
                entry = payload["mappers"]["view"]
                text.view_mapper.load_state_dict(weight_port.from_jax_mapper(
                    entry["params"], entry["constants"]), strict=True)
                self.logger.log_message(f"loaded pretrained view mapper {p}")
            else:
                self.logger.log_message(
                    f"pretrained view mapper {p} not found; training from "
                    "fresh init")
        fot = cfg.data.fixed_object_token_or_path
        if (cfg.learnable_mode in (1, 2) and fot
                and str(fot).endswith(".msgpack") and Path(fot).exists()
                and text.obj_mappers):
            _, payload = CheckpointHandler.load_mapper(Path(fot))
            for tok, mapper in zip(self.placeholder_object_tokens,
                                   text.obj_mappers):
                if tok in payload["mappers"]:
                    entry = payload["mappers"][tok]
                    mapper.load_state_dict(weight_port.from_jax_mapper(
                        entry["params"], entry["constants"]), strict=True)
            self.logger.log_message(f"loaded pretrained object mapper {fot}")

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        ds = self.train_dataset
        self.logger.log_start_of_training(
            total_batch_size=(cfg.optim.train_batch_size
                              * cfg.optim.gradient_accumulation_steps),
            num_samples=len(ds))
        if cfg.log.save_dataset_images:
            if self.dist.is_main:
                self.save_dataset_images()
            dist_lib.barrier(self.dist)
        if len(ds) < self.micro_batch_size:
            raise ValueError(
                f"dataset yields {len(ds)} examples (num_images x repeats) "
                f"< batch {self.micro_batch_size}; raise data.repeats")
        if self.cache_latents:
            if self.built.pixel_cache is None:
                self._fill_latent_cache()
            ds.skip_pixels = True
        elif self.augment_spec is not None:
            if self.use_pixel_cache:
                self._fill_base_cache()
                ds.skip_pixels = True
            else:
                ds.emit_base_pixels = True
        k = self.accum_k
        # the data stream is a function of the batch position, the draws
        # of the micro-step: a later start replays the same stream
        micro_step = self.global_step * k
        if os.environ.get("VIEW_NETI_NO_PREFETCH"):
            loader = DataLoader(ds, batch_size=self.micro_batch_size,
                                seed=cfg.seed, start_batch=micro_step,
                                group_size=self.mode3_group_size)
            prepare = self._pack
        else:
            loader = PrefetchLoader(ds, batch_size=self.micro_batch_size,
                                    seed=cfg.seed, start_batch=micro_step,
                                    prepare=self._pack,
                                    group_size=self.mode3_group_size)
            prepare = None

        def stream():
            while True:
                for b in loader:
                    yield prepare(b) if prepare else b

        last_loss = float("nan")
        pending = None
        self._val_failures = 0
        timer = StepTimer()
        t0 = time.time()
        # the whole loop under torch.profiler where VIEW_NETI_TRACE_DIR is
        # set (utils/profiling.py). Unlike the JAX Coach's, the trace is
        # closed when the loop raises too: an open profiler would break
        # every later one in the process.
        with trace(os.environ.get("VIEW_NETI_TRACE_DIR")), \
                span("coach.loop") as loop:
            batches = stream()
            while self.global_step < cfg.optim.max_train_steps:
                # a window holds whole k-micro-batch groups: one optimizer
                # step with steps_per_dispatch 1
                w = max(self._dispatch_window(), k)
                with span("coach.window"):
                    losses = self._run_window(w, batches, micro_step)
                micro_step += w
                timer.tick()
                self.global_step += w // k
                # read the PREVIOUS window's losses: this one still runs
                prev = pending
                pending = (self.global_step, self._stage(losses),
                           self.micro_batch_size * w)
                if prev is not None:
                    with span("coach.log"):
                        last_loss = self._log_step_metrics(prev, timer)
                self.logger.update_step(self.global_step)
                if self.global_step % cfg.log.save_steps == 0:
                    with span("coach.save"):
                        self._save(
                            f"learned_embeds-steps-{self.global_step}"
                            ".msgpack",
                            f"mapper-steps-{self.global_step}.msgpack")
                if self._should_eval() and self.validator is not None:
                    with span("coach.validate"):
                        self._validate()
            if pending is not None:
                with span("coach.log"):
                    last_loss = self._log_step_metrics(pending, timer)
        self.loop_span = loop.record
        self.last_step_timer = timer
        if isinstance(loader, PrefetchLoader):
            loader.close()
        with span("coach.save"):
            self._save("learned_embeds-final.msgpack", "mapper-final.msgpack")
        wall = time.time() - t0
        self.logger.log_message(
            f"training done: {self.global_step} steps in {wall:.1f}s")
        self.logger.close()
        return {"steps": self.global_step, "wall_s": wall,
                "final_loss": last_loss}

    def _dispatch_window(self) -> int:
        return dispatch_window(self.cfg, self.steps_per_dispatch,
                               self.global_step, self.validator is not None,
                               self.accum_k)

    def _optimizer_step(self, batches, draws) -> torch.Tensor:
        """One optimizer step: the train step over its k micro-batches;
        the last one's loss (the loss the Coach logs for the step)."""
        for batch, d in zip(batches, draws):
            loss = self.train_step(self.built, batch, d)["total_loss"]
        return loss

    def _run_window(self, w: int, batches, micro_step: int) -> torch.Tensor:
        """w micro-steps from micro_step on, w // k optimizer steps back to
        back through window_step, with no host read: each step's batch is
        copied to the card and its draws made there first. Returns the
        steps' losses, one (w // k,) device tensor."""
        if w not in self._window_sizes:
            if self._window_sizes:
                # the JAX Coach's words; here every window replays the one
                # step's graph, so a new size captures nothing
                self.logger.log_message(
                    f"running an additional {w}-microbatch dispatch window "
                    f"(shrunk at a save/validation/end boundary); it "
                    f"replays the same one-step graph, so nothing new is "
                    f"captured for it")
            self._window_sizes.add(w)
        k, losses = self.accum_k, []
        for m in range(micro_step, micro_step + w, k):
            with span("coach.feed"):
                group = [self._to_device(next(batches)) for _ in range(k)]
                draws = [self._step_draws(m + i, b)
                         for i, b in enumerate(group)]
            with span("coach.step"):
                losses.append(self.window_step(group, draws))
        return torch.stack(losses)

    def _should_eval(self) -> bool:
        return (self.cfg.eval.validation_prompts is not None
                and self.global_step % self.cfg.eval.validation_steps == 0)

    def _validate(self) -> None:
        """One validation round. A failure is logged and training goes on
        (an I/O error late in a long run must not end it), but
        eval.max_validation_failures consecutive failures abort, so that a
        systematic error (a wrong masks directory, a missing calibration)
        does not reduce a run's evaluation to log lines. Under data
        parallelism rank 0 runs the round and the other ranks render their
        share of its sweeps until it ends the round with its verdict, so
        every rank counts the same failures; a failed collective is never
        a validation failure: it ends the run."""
        error = None
        if self.dist.active and not self.dist.is_main:
            failed = inference_dtu.serve_sweeps(self)
        else:
            try:
                self.validator.infer(coach=self, step=self.global_step)
            except dist_lib.CollectiveError:
                raise
            except Exception as e:
                error = e
                self.logger.log_message(traceback.format_exc())
            failed = error is not None
            if self.dist.active:
                inference_dtu.end_sweeps(self, failed)
        if not failed:
            self._val_failures = 0
            return
        self._val_failures += 1
        limit = self.cfg.eval.max_validation_failures
        self.logger.log_message(
            f"WARNING: validation at step {self.global_step} failed "
            f"({error!r}); {self._val_failures}/{limit} consecutive")
        if self._val_failures >= limit:
            raise RuntimeError(
                f"{limit} consecutive validation failures: aborting so "
                "that a systematic eval error is not swallowed (raise "
                "eval.max_validation_failures to allow more)") from error

    def infer_frozen(self):
        """(unet, vae) for the inference paths: the VAE's decoder sections
        through the fused conv when fuse_conv is on (the UNet stays
        unfused, as in the JAX package)."""
        vae = self.built.vae
        if self.fuse_conv:
            vae = builder.fuse_for_inference(vae)
        return self.built.unet, vae

    def sampling_fns(self, schedule, num_steps: int, guidance_scale: float):
        """(denoise_fn, decode_fn) of inference_dtu's sweeps and renders at
        these settings: kept on the Coach, so that a shape is captured once
        for every view, seed and round; eager under a process group (a tp
        split's collectives cross the host)."""
        key = (schedule.prediction_type, num_steps, guidance_scale)
        if key not in self._sampling:
            unet, vae = self.infer_frozen()
            graph, log = not self.dist.active, self.logger.log_message
            self._sampling[key] = (
                make_denoise_fn(unet, schedule, num_steps, guidance_scale,
                                self.compute_dtype, graph=graph, log=log),
                make_decode_fn(vae, graph=graph, log=log))
        return self._sampling[key]

    def save_dataset_images(self) -> None:
        """A contact sheet of the first (at most 100) training images,
        scaled by 0.2, at startup."""
        fnames = self.train_dataset.image_paths_flattened
        save_name = "dataset.png"
        if len(fnames) > 100:
            fnames = fnames[:100]
            save_name = "dataset_first_100.png"
        grid = downsample_image(
            get_image_grid([image_io.read_rgb(f) for f in fnames]), 0.2)
        out = Path(self.cfg.log.exp_dir) / save_name
        out.parent.mkdir(parents=True, exist_ok=True)
        image_io.write_png(out, grid)
        self.logger.log_message(f"saved dataset contact sheet {out}")

    def _stage(self, loss: torch.Tensor):
        """Start the losses' copy to the host without waiting for it: a
        pinned buffer and an event on the card, a plain tensor on the
        CPU."""
        if loss.device.type != "cuda":
            return loss, None
        with span("coach.stage"):
            host = torch.empty(loss.shape, dtype=loss.dtype,
                               pin_memory=True)
            host.copy_(loss, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _log_step_metrics(self, pending, timer) -> float:
        """Log a window's optimizer steps, each with its loss and learning
        rate, the window's rate beside the last; returns the last loss."""
        end_step, (losses, done), imgs_per_tick = pending
        if done is not None:
            done.synchronize()
        values = losses.tolist()
        ips = timer.imgs_per_sec(imgs_per_tick)
        for idx, value in enumerate(values):
            step = end_step - (len(values) - 1 - idx)
            self.losses.append(value)
            logs = {"total_loss": value,
                    "lr": float(self._lr_host[min(step,
                                                  len(self._lr_host) - 1)])}
            if ips and idx == len(values) - 1:
                logs["imgs_per_sec"] = ips
            self.logger.log_metrics(logs, step=step)
            if not math.isfinite(value):
                self.logger.log_message(f"step {step}: loss {value}")
        return values[-1]

    def _step_draws(self, micro_step: int, batch: TrainBatch):
        """The micro-step's draws: the whole fused batch's, of which a rank
        keeps its rows."""
        self._generator.manual_seed(step_seed(self._base_seed, micro_step))
        draws = sample_step_draws(self._generator, self.built, batch,
                                  from_moments=self.cache_latents,
                                  augment=self.augment_spec,
                                  batch_size=self.micro_batch_size)
        return dist_lib.shard_draws(draws, self.dist, self.micro_batch_size,
                                    self.mode3_group_size)

    def _pack(self, batch_np) -> Dict:
        """A collated host batch as torch tensors: the token ids, the two
        placeholder ids and the image indices in one int64 array (one copy
        to the card), and the pixels where there is no cache; pinned when
        the run is on the card. A grouped batch's (G,) object indices stay
        on the host: they choose the mapper of each group."""
        ids = np.asarray(batch_np["input_ids"], np.int64)
        ints = np.concatenate(
            [ids] + [np.asarray(batch_np[k], np.int64)[:, None]
                     for k in ("input_ids_placeholder_object",
                               "input_ids_placeholder_view", "image_idxs")],
            axis=1)
        obj = np.asarray(batch_np["object_idx"])
        pixels = (None if self.use_pixel_cache
                  else np.ascontiguousarray(batch_np["pixel_values"]))
        if self.dist.active:   # the rank's rows, before the copy
            ints = dist_lib.shard_rows(ints, self.dist)
            obj = dist_lib.shard_object_idx(obj, self.dist, len(ids))
            if pixels is not None:
                pixels = dist_lib.shard_rows(pixels, self.dist)
        host = {"ints": torch.from_numpy(ints), "pixels": None,
                "length": ids.shape[1],
                "object_idx": (int(obj) if obj.ndim == 0 else
                               torch.from_numpy(obj.astype(np.int64)))}
        if pixels is not None:
            host["pixels"] = torch.from_numpy(pixels)
        if self.device.type == "cuda":
            for key in ("ints", "pixels"):
                if host[key] is not None:
                    host[key] = host[key].pin_memory()
        return host

    def _to_device(self, host: Dict) -> TrainBatch:
        ints = host["ints"].to(self.device, non_blocking=True)
        L = host["length"]
        pixels = (ints[:, L + 2] if self.use_pixel_cache
                  else host["pixels"].to(self.device, non_blocking=True))
        return TrainBatch(pixel_values=pixels, input_ids=ints[:, :L],
                          input_ids_placeholder_object=ints[:, L],
                          input_ids_placeholder_view=ints[:, L + 1],
                          object_idx=host["object_idx"])

    def _build_batch(self, batch_np) -> TrainBatch:
        """The train batch on the card of a collated host batch: with a
        cache, pixel_values holds the image indices."""
        return self._to_device(self._pack(batch_np))

    # ---- caches ------------------------------------------------------
    def _base_cache_fits(self) -> bool:
        """Do all uint8 bases fit under VIEW_NETI_DEVICE_BASE_CACHE_MB
        (default 4096)?"""
        ds = self.train_dataset
        limit = int(os.environ.get("VIEW_NETI_DEVICE_BASE_CACHE_MB",
                                   "4096")) * 1_000_000
        first = ds._load_base(Path(ds.image_paths_flattened[0]))
        return first.nbytes * ds.num_images <= limit

    def _fill_base_cache(self) -> None:
        """Every uint8 base image on the card once; the step gathers rows
        by index."""
        if self.built.pixel_cache is not None:
            return
        ds = self.train_dataset
        with span("setup.cache_fill") as fill:
            bases = np.stack([ds._load_base(Path(p))
                              for p in ds.image_paths_flattened])
            self.built.pixel_cache = torch.from_numpy(bases).to(self.device)
        self.cache_fill_span = fill.record
        self.logger.log_message(
            f"device base-image cache: {bases.shape[0]} images "
            f"({bases.nbytes / 1e6:.0f} MB uint8) in "
            f"{self.cache_fill_s:.2f} s")

    @torch.no_grad()
    def _fill_latent_cache(self) -> None:
        """Every image's VAE posterior moments (fp32), encoded once."""
        ds = self.train_dataset
        chunks = []
        with span("setup.cache_fill") as fill:
            for start in range(0, ds.num_images, 8):
                pix = np.stack([ds[i]["pixel_values"]
                                for i in range(start, min(start + 8,
                                                          ds.num_images))])
                x = torch.from_numpy(pix).to(self.device, self.compute_dtype)
                chunks.append(self.built.vae.moments(x).float())
            self.built.pixel_cache = torch.cat(chunks)
        self.cache_fill_span = fill.record
        self.logger.log_message(
            f"latent cache: {self.built.pixel_cache.shape[0]} images -> "
            f"moments {tuple(self.built.pixel_cache.shape[1:])}")

    # ---- checkpoints -------------------------------------------------
    def jax_trainable(self):
        """(trainable, object constants, view constants) of the live
        mappers in the JAX tree layout."""
        text = self.built.text
        return weight_port.to_jax_trainable(
            [m.state_dict() for m in text.obj_mappers]
            if text.obj_mappers else None,
            text.view_mapper.state_dict()
            if text.view_mapper is not None else None)

    def _save(self, embeds_name: str, mapper_name: str) -> None:
        """Rank 0 writes the checkpoint (and the train state, and prunes);
        every rank then waits for it."""
        if self.dist.is_main:
            self._write_checkpoint(embeds_name, mapper_name)
        dist_lib.barrier(self.dist)

    def _write_checkpoint(self, embeds_name: str, mapper_name: str) -> None:
        trainable, obj_c, view_c = self.jax_trainable()
        table = self.built.text.clip.text_model.embeddings.token_embedding
        self.checkpoint_handler.save_model(
            trainable=trainable, obj_constants=obj_c, view_constants=view_c,
            view_table=self.built.view_table,
            token_table=table.weight.detach().float().cpu().numpy(),
            embeds_save_name=embeds_name, mapper_save_name=mapper_name)
        if self.cfg.log.checkpoint_backend == "orbax":
            out = train_state.save(train_state.state_path(
                self.cfg.log.exp_dir, self.global_step), self)
            self.logger.log_message(f"saved train state {out}")
        self.logger.log_message(f"saved checkpoint at step "
                                f"{self.global_step}")
        if "steps" in embeds_name:
            self._prune_old_checkpoints()

    def _maybe_resume(self) -> None:
        """log.resume_from: the mappers, the optimizer's moments and
        counts, and the global step from a train state (train_state.py): a
        path, or "latest" for the newest under <exp_dir>/train_state.
        train() then fast-forwards the stream to the step."""
        path = train_state.resolve(self.cfg.log.exp_dir,
                                   self.cfg.log.resume_from)
        if path is None:
            return
        self.global_step = train_state.restore(self, train_state.load(path))
        self.logger.log_message(
            f"resumed from {path} at global step {self.global_step}")

    def _prune_old_checkpoints(self) -> None:
        """Keep the newest log.checkpoints_total_limit step checkpoints and
        their train states; final checkpoints are never pruned."""
        limit = self.cfg.log.checkpoints_total_limit
        if not limit:
            return
        root = Path(self.cfg.log.exp_dir)
        steps = sorted({
            int(p.name.split("-steps-")[1].split(".")[0].split("_")[0])
            for p in root.glob("*-steps-*.msgpack")})
        for step in steps[:-limit]:
            for pattern in (f"*-steps-{step}.msgpack",
                            f"*-steps-{step}_*.msgpack"):
                for p in root.glob(pattern):
                    p.unlink()
            train_state.state_path(root, step).unlink(missing_ok=True)
