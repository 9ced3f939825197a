#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (view_neti_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--steps N] [--train-steps N] [--coach-steps N]

Phases; any failure ends the run with a non-zero exit:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds the eight kernel libraries from
                view_neti_tpu_torch/csrc/ (in parallel) and prints each
                kernel's registers and spills; the instantiations the
                paths run (K1's, K2's and K3's two designs at the head-dim
                buckets 48, 64, 80 and 160, and every instantiation of
                K4's two designs) must not spill, and
                ptxas must serialise no warpgroup product;
  3. kernels -- the flash-attention forward (K1: its Hopper design on
                wgmma and TMA at the buckets 48, 64, 80 and 160, its
                long-key kernel above 80 keys and its short-key kernel up
                to 80, at every path shape; the mma.sync design checked
                beside it at each of them), its backward (K2 dq, K3
                dk/dv: their Hopper design on wgmma and TMA at the
                buckets 48, 64, 80 and 160 at any key count, every shape
                of the train steps, with the mma.sync design checked
                beside it at each of them, but for each kernel the shapes
                where the card measured it slower, BWD_MMA_SYNC_SHAPES,
                which keep the mma.sync design with the Hopper one checked
                and timed beside it) and the
                fused GroupNorm+SiLU+conv3x3 (K4: its Hopper design on
                wgmma and TMA at every Cout > 16, the ResNet convs of the
                VAE and of the fused UNet, with the mma.sync design
                checked beside it; the mma.sync design at the two narrow
                convs) at every shape the SD-1.5 768x576 serving path
                (with the fused UNet, BENCH_FUSE_UNET=1, its 18 ResNet
                conv shapes at B = 6 too), the 384x512 B=9
                train step and the DTU sweep (B=4 at 768x576, its 512x512
                object renders) give them, the folders phase's 512x512
                B=9 train step (K1-K3 at 4096 x 4096 and 4096 x 77, K4's
                encoder at 512x512 down to 64x64), in SD-1.5 (head dims
                40, 80, 160) and in SD-2.1 (head dim 64, the mode3 phase),
                bf16, and at SD-1.5's tp-2 shapes (4 heads a rank) of the
                tp phase's render and train steps;
                inputs from a seed, held against their plain
                versions in fp32 with TF32 off, each limit with a control
                it must catch (K4 two: a lost input-channel chunk and the halo
                padded before the SiLU), and timed with CUDA events
                beside the plain version, one PyTorch library call and
                the card's bound (and the bound's share of the kernel's
                time); at the Hopper design's shapes, also its per-call
                time in a CUDA graph of 20 calls (K4: 10) and its host
                time a call, and the mma.sync design's three times beside
                it at each kernel's heaviest shape; every path's counted run
                below holds K1's to K4's launches by design
                (launch_counts' "K1 sm90", "K1 mma_sync", ...): all 32 of
                a UNet forward's K1 on the Hopper design, SD-1.5's and
                SD-2.1's (SD15_SM90, M3_SM90); of a train step's 30 K2
                and 31 K3 launches, 30 and 30 on SD-1.5 at 384x512, 29
                and 31 on SD-2.1, all at 512x512 (SD15_BWD_SM90,
                M3_BWD_SM90, FOLDERS_BWD_SM90, which bwd_design must give
                at attention_shapes); 20 of an encode's 21 K4 launches,
                28 of a decode's 29 (K4_SM90) and all 44 of a fused UNet
                forward's (K4_UNET_SM90), which conv_design must give at
                k4_shapes; a `backward pair` line sums K2 and K3 over
                each training path, as run (with each kernel's launches
                there by design, and with the mma.sync design at every
                shape where it was timed at each), beside SDPA's
                backward, and a `conv paths` line sums K4 over each path
                the same way, beside GroupNorm + SiLU + cuDNN;
  4. slice   -- the serving path at full SD-1.5 width with seeded random
                weights: mode-2 view + object mappers, FallbackTokenizer,
                PromptManager conditioning, DPM-Solver++ with CFG 7.5 for
                3 seeds at 768x576, fused VAE decode to uint8; checks the
                output and that every UNet attention went through K1 and
                every decoder conv section through K4; the second run
                captures the denoise loop and the decode as CUDA graphs
                (their launch records checked); times sec/image over three
                more rounds of generate as bench.py does, graphed and
                eager, which must give the same images bit for bit (a
                replay with stale inputs is the control), splits one run
                by stage, holds the fused decode against the same weights
                decoded unfused, and profiles one CFG denoise step graphed
                and eager and one decode (device time by kernel group,
                idle share); then the fused-UNet serving path
                (BENCH_FUSE_UNET=1: fuse_for_inference with a view of the
                same UNet, its ResNet convs through K4): its counted run
                (44 K4 launches a forward, all on the Hopper design),
                graphed serving with the switch off and on interleaved
                round by round (sec/image each), the fused graphed rounds
                bit-equal to an eager one (a stale replay the control),
                one UNet forward against the unfused one within
                FUSED_UNET_REL_LIMIT (the last block's residual dropped
                the control), the loop's images within FUSED_LEVELS of
                the unfused ones, and one fused CFG step profiled graphed
                and eagerly with the weights' relayout (conv3x3_hwio) a
                range of its own;
  5. train   -- the mode-2 train step of bench.py:main on the same stack:
                B = 9 (3 x 3 accumulation, fused), 384x512 pixels uniform in
                [-1, 1], the fused VAE encode, DDPM noise, nested dropout,
                the UNet through K1/K2/K3, fp32 MSE, the sliced AdamW; 2
                warm-up and --train-steps timed steps (imgs/sec, ms/step,
                peak memory), checks on the loss, the gradients, the moved
                parameters and every kernel's launch count, a check that
                the kernels' gradient descends (central difference along
                -g with the draws held fixed), a stage split and a profile;
  6. coach   -- the training Coach end to end on the shipped mode-2 recipe,
                as bench.py:_bench_e2e drives the JAX one: six synthetic
                1600x1200 DTU PNG scans written by the port's PNG writer,
                the config of the bench (mode 2, arch 15, SD-1.5, preset 7,
                DTU preprocess 1, fused batch 9, bf16), the uint8 base cache
                on the card and the preset-7 augmentation there, 2 warm-up
                and --coach-steps timed steps in its default 4-step
                dispatch windows (CUDA graph replays; a save at step 10
                shrinks one, train states on), the msgpack checkpoints;
                then the same run with optim.steps_per_dispatch 1 (eager)
                must give the same losses, mappers, counts and files; the
                `coach window` line has both runs' ms/step, imgs/sec and
                one step's idle share, the capture's seconds and pool;
                then the graphed run again with VIEW_NETI_TRACE_DIR set
                (torch.profiler around the train loop, the window graph
                captured under it): the same losses, mappers, counts and
                files, one trace file that parses and names K1-K4; the
                `coach trace` line has its ms/step beside the untraced
                run's, the trace's MB and the kernels it holds;
                prints imgs/sec and ms/step (the host clock from a
                synchronize after the warm-up to the loop's end, over the
                timed steps) beside the train phase's raw step, the cache fill, the
                decode and resize per image, peak memory, the augmentation's
                device time and launches, and one profiled Coach step;
                checks the losses, the launches of K1-K4 per step against
                the train phase's, the augmentation on the card against its
                CPU run, the cache against a fresh CPU decode and the saved
                mappers against the live ones;
  7. weights -- SD-1.5 read from disk: a seeded stack written in the
                diffusers layout by the port's safetensors writer under
                build/ (deleted afterwards), loaded by a Coach given
                weights_dir; every PortReport clean, every parameter equal
                to the written one, one UNet forward bit-equal; prints the
                GB read, the load seconds and the peak memory;
  8. acceptance -- python -m view_neti_tpu_torch.acceptance on that stack
                (deleted after this phase) and the validate phase's
                34-camera scan with IDR masks:
                the stack's sha256 manifest written and checked clean by
                the port's weight_port, a byte of a file added to it
                changed and named by the check, then restored; the run
                with SD_WEIGHTS_DIR and DTU_MASKS_DIR set, 4 steps of the
                mode-2 recipe at full width (preset 7, DTU preprocess 1,
                fused batch 9, bf16) and the 34-view sweep of its
                checkpoint (its default seeds 0 1 2, 5 steps, random-VGG
                LPIPS; B = 6 and 3-image decodes, the serving shapes):
                acceptance.json's key set, finite metrics, not labelled
                meaningful, K1-K4's launches; python -m
                view_neti_tpu_torch.inference on that run with
                SD_WEIGHTS_DIR set equals the sweep's first two cameras
                bit for bit, and unset (the control) differs; prints the
                train and eval wall seconds, the cache fill, the sweep's
                sec/image, the metrics, the manifest's GB/s and the
                launches;
  9. validate -- the shipped mode-2 recipe with validation on: 34
                synthetic 1600x1200 DTU scans with IDR masks from
                RandomState(0), the Coach (DTU preprocess 1, preset 7,
                bf16) trains 3 steps and validates once after its step-2
                checkpoint: the DTU sweep over the 34 eval cameras at
                768x576 (seeds [0, 1], VAL_DENOISE steps, CFG 7.5)
                reloading that
                checkpoint, masked PSNR / SSIM / LPIPS (random VGG) on the
                card, the object-token renders; prints the sweep's seconds
                and sec/image, the metric means, peak memory, and the
                launches and idle share of one CFG denoise step at the
                sweep's shapes (graphed and eager); checks K1-K4's
                launches; the sweep's first SWEEP_CHECK_CAMS (2) cameras
                again through its graphs and eagerly, bit for bit, for
                both sec/image;
 10. inference -- python -m view_neti_tpu_torch.inference on that run with
                --debug 1: its predictions equal the sweep's for the first
                two cameras bit for bit; then python -m
                view_neti_tpu_torch.summarize_dtu on the sweep's bundle:
                its per-seed means equal the sweep's per-view means to
                1e-6;
 11. mode3  -- mode-3 multi-scene pretraining on its shipped recipe
                (input_configs/train_m3.yaml): SD-2.1 at full width
                (v-prediction, the 23-layer 1024-wide GELU CLIP, linear
                projections, head dim 64) with seeded weights, four
                synthetic 1600x1200 DTU scans of the recipe's 34 cameras
                under build/ (deleted afterwards), one object mapper per
                scan and one view mapper, preset 5 on the card, fused
                B = 9 in 3 groups of 3, bf16: a Coach stopped after 2
                steps (its checkpoint writes the step-2 train state); a
                straight Coach of 2 warm-up and 8 timed steps;
                a Coach resumed from "latest" (a copy of the stopped run's
                state) must replay the straight one's losses and final
                mappers bit for bit, then runs the mode-3 validation round
                (a DTU
                sweep per eval token against its own scan, VAL_DENOISE
                steps, CFG
                7.5, seeds [0, 1], cut to the first 2 eval cameras, and the
                object renders); offline inference on that run (--debug 1)
                equals its sweeps, summarize_dtu reads one bundle per
                token; grouped conditioning equals per-group calls exactly;
                the step's v-prediction target equals the CPU's; prints
                imgs/sec beside the SD-1.5 Coach's, peak memory, K1-K4
                launches per step, each token's sweep, and the launches and
                idle share of one grouped step and of one CFG denoise step
                at SD-2.1;
 12. folders -- training on other datasets' folders at 512x512, SD-1.5 at
                full width with seeded bf16 weights and fp32 mappers: the
                mode-0 recipe (input_configs/train_mode0.yaml: fused B = 9,
                the flip on the card, arch 15, nested dropout, bypass 0.2)
                on a folder of fourteen 512x512 views: the five committed
                baseline JPEGs (tests/data/jpeg/teapot) and one per format
                of tests/data/formats/teapot (progressive 4:2:0 and
                progressive CMYK JPEG, YCCK JPEG, Adam7 8-bit RGB PNG,
                16-bit RGB PNG, arithmetic-coded sequential 4:2:0 and
                progressive 4:4:4 JPEG, lossless RGB and gray JPEG),
                decoded by the port's readers; first every committed
                image fixture decoded on the host and held to its
                manifest's sha256 of PIL's decode, with the decode ms per
                megapixel of each kind of 512x512 view, and the host
                crop's compiled resize against its plain numpy version;
                then spherical mode 2
                on an llff folder of 12 PNG views (6 at 1008x756, 6 at
                756x1008; deg_freedom "phi") with data.device_augment
                false, preset 7 cropping to 512x512 on the host; each run 2
                warm-up and FOLDERS_STEPS timed steps, one validation round
                after the warm-up (mode 0: the first 2 validation prompts;
                mode 2: a prompt sheet of 3 view tokens; 2 seeds,
                VAL_DENOISE steps)
                and a final checkpoint, exported through python -m
                view_neti_tpu_torch.export_torch and imported back through
                torch_interop.import_torch_artifacts bit for bit; checks
                K1-K4's launches per step and per render; prints imgs/sec,
                ms/step, peak memory, the idle share and launches of one
                profiled step per run, the decode ms per megapixel of each
                fixture and of the llff 8-bit PNGs, the host augmentation's
                ms per example and its
                share of a step, and the export and import seconds;
 13. ddp    -- data parallel over torch.distributed
                (view_neti_tpu_torch/parallel/dist.py): the coach phase's
                recipe (fused B = 9 at 384x512, preset 7 on the base
                cache, SD-1.5 at full width, bf16) for 2 warm-up and 4
                timed steps with a checkpoint at the last, in one process;
                through a process group of one rank over NCCL, bit for
                bit; then over 3 ranks spawned with a FileStore (gloo when
                they share this card, NCCL with a card each), 3 rows a
                rank: each step's loss within 1e-5 relative and the mappers
                within tests/test_parallel.py's tolerance (rtol 5e-3, atol
                1e-5) of one process computing the ranks' rows at their
                shapes (the fused batch and draws cut by plain indexing),
                the first loss within DDP_FUSED_STEP1_RTOL of the fused
                one-process run's, a limit that a planted fault (each
                row's dropout draws shifted by one row) must exceed, the
                same per-slice counts, every rank's K1-K4 launches a step
                equal to the coach phase's, one all-gather of one size a
                step, one set of checkpoint files; a debug validation
                round after the last step's checkpoint in the one-process
                run and in the ranks (the first 2 eval cameras, seeds
                [0, 1], 5 steps; its sweep split over the ranks): the
                ranks' predictions equal one process's round on their
                checkpoint bit for bit; the six scan cameras of
                the last checkpoint rendered split over the ranks (seeds
                [0, 1], 5 DPM-Solver++ steps, CFG 7.5) equal one process's
                render bit for bit; prints imgs/sec and ms/step of the ranks
                beside one process's, the all-reduce's ms a step and
                bytes, each rank's peak memory and the largest loss and
                mapper differences;
 14. tp     -- the mesh's tp axis over torch.distributed
                (view_neti_tpu_torch/parallel/tensor.py): the coach
                phase's recipe (fused B = 9 at 384x512, preset 7, SD-1.5 at
                full width, bf16) for 2 warm-up and 3 timed steps in one
                process; in one process computing the tp split by plain
                indexing (tp_emulate_: the pieces' partials and input
                gradients added in piece order in fp32), and the same with
                a planted fault (one attention's input gradients not
                summed over the pieces); then over 2 spawned ranks in a
                dp 1 x tp 2 layout with tensor_parallel (gloo when they
                share this card, NCCL with a card each): the ranks
                bit-equal to each other, each step's loss within 1e-5
                relative and the mappers within rtol 5e-3, atol 1e-5 of
                the split in one process, a loss limit the planted fault
                must exceed; each rank's K1-K4 launches a step those of
                one process; the all-gathers a step the count worked out
                from the table (one forward sum per row-parallel layer,
                one backward sum per split unit's input that needs a
                gradient); a render at the serving shapes (3 seeds,
                768x576, 5 DPM-Solver++ steps, CFG 7.5) on each rank
                against one process's, its mean uint8 difference within a
                limit that a planted fault (rank 1's partial of one
                row-parallel layer dropped) must exceed; one SD-2.1 UNet
                forward split over the ranks (its 5-head level whole, the
                rest split) against the same UNet whole; prints imgs/sec
                and ms/step beside one process's, the all-gathers' count,
                bytes and host ms a step, each rank's frozen-parameter
                bytes beside one process's, each rank's peak memory;
 15. bench  -- python -m view_neti_tpu_torch.bench in its five modes at
                full width, each in a process of its own: the raw train
                step (BENCH_STEPS 8), the mode-2 Coach (16 steps), the
                mode-3 Coach (8), serving (30 steps), serving with
                BENCH_FUSE_UNET=1 and the 34-view DTU sweep (3 steps); each
                must exit 0 with one JSON line, a finite positive value,
                0 < mfu <= 1 and this card as its device, and launch its
                path's kernels; the fused run serving's launches and 44
                K4 launches a UNet forward, its flops_per_image serving's
                within 0.1 %; serving's sec/image (switch off and on) and
                the mode-2 Coach's imgs/sec must lie within 0.67-1.5x of
                the slice and coach phases' graphed rates; BENCH_FLASH=0
                must be refused with the error line and a failed exit
                (bench.main in this process);
                prints a `bench [...]` line with the six records;
 16. report  -- one JSON line of per-kernel results, then the result line.
The bound is max(operations / 989 TFLOP/s, bytes / 3.35 TB/s,
exponentials / (16 a clock x the SMs x the card's clocks.max.sm)): the
published dense-bf16 and memory peaks of an H100 SXM at 700 W, and the
special-function units' rate for the attention kernels' one exponential
per score.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
EXP_PER_SM_CLOCK = 16    # ex2 on the special-function units, sm_90
# exponentials a second: main() sets it from the card (exp_rate); this is
# an H100 SXM's 132 SMs at its 1980 MHz clocks.max.sm
EXP_RATE = EXP_PER_SM_CLOCK * 132 * 1980e6
BATCH = 6                # 3 seeds x CFG
HEIGHT, WIDTH = 576, 768
TRAIN_BATCH = 9          # train_batch_size 3 x gradient_accumulation 3
TRAIN_HEIGHT, TRAIN_WIDTH = 384, 512
# the shipped recipe's validation (input_configs/train.yaml): seeds [0, 1],
# 30 denoising steps, cut for time to VAL_DENOISE (every sweep, render and
# offline inference of the validate, inference, mode3 and folders phases);
# the sweep denoises one camera at a time with CFG
VAL_SEEDS = [0, 1]
SWEEP_BATCH = 2 * len(VAL_SEEDS)
VAL_DENOISE = 20
VAL_TRAIN_STEPS = 3      # the validate phase's Coach steps ...
VAL_EVERY = 2            # ... with a checkpoint and a validation at step 2
EVAL_CAMS = 34           # the DTU eval cameras of inference_dtu.get_cam_idxs
SWEEP_CHECK_CAMS = 2     # the sweep graphed against eager on these cameras
INFER_CAMS = 2           # offline inference with --debug 1
# the acceptance phase: python -m view_neti_tpu_torch.acceptance on the eval
# scan and the weights phase's stack, cut for time to ACC_STEPS steps and
# ACC_DENOISE denoising steps; its default seeds, so that its sweep runs at
# the serving shapes (B = 6 at 72x96 latents, decodes of 3 images)
ACC_STEPS = 4
ACC_DENOISE = 5
ACC_SEEDS = [0, 1, 2]
ACC_KEYS = {"metrics", "assets", "manifest", "all_assets_real",
            "meaningful_for_quality", "train_wall_s", "eval_wall_s",
            "steps", "seeds", "denoise_steps", "acceptance"}
# the mode3 phase: input_configs/train_m3.yaml, its four scans and three
# eval tokens; cut for time: the sweeps to the first M3_SWEEP_CAMS eval
# cameras (2; INFER_CAMS of them are held to offline inference)
M3_CONFIG = os.path.join("input_configs", "train_m3.yaml")
M3_WARM = 2              # warm-up steps, then a checkpoint and train state
M3_STEPS = 4             # timed steps of the straight run after the warm-up
M3_TOKENS = 3            # eval.eval_placeholder_object_tokens of the recipe
M3_SWEEP_CAMS = 2
# the folders phase: input_configs/train_mode0.yaml on a folder of the
# committed image fixtures, then a spherical mode-2 run with host
# augmentation on an llff folder of two image sizes; both at 512x512, fused
# B = 9, a validation round at step FOLDERS_WARM and a final checkpoint
FOLDERS_CONFIG = os.path.join("input_configs", "train_mode0.yaml")
# the mode-0 folder: the five baseline JPEGs and one 512x512 view per
# format of tests/data/formats (progressive 4:2:0, progressive CMYK, YCCK,
# Adam7 8-bit RGB PNG, 16-bit RGB PNG, arithmetic-coded sequential 4:2:0
# and progressive 4:4:4, lossless RGB and gray)
FOLDERS_VIEW_DIRS = (os.path.join("tests", "data", "jpeg", "teapot"),
                     os.path.join("tests", "data", "formats", "teapot"))
# the committed image fixtures, each with a manifest of PIL's decode
FIXTURE_DIRS = (os.path.join("tests", "data", "jpeg"),
                os.path.join("tests", "data", "formats"))
DECODE_REPS = 5          # decodes of each fixture for its ms per megapixel
FOLDERS_WARM = 2         # warm-up steps, then the validation round
FOLDERS_STEPS = 3        # timed steps of each run after the warm-up
FOLDERS_SIZE = 512
FOLDERS_PROMPTS = 2      # eval.validation_prompts cut to the first 2
FOLDERS_SHEET_TOKENS = 3  # the prompt sheet's view tokens (and one without)
FOLDERS_VIEWS = 12       # the llff folder: 6 at 1008x756, 6 at 756x1008
FOLDERS_MODE0_VIEWS = 14
# the 512x512 views whose decode ms per megapixel the phase prints by kind
DECODE_KINDS = {
    "baseline_420": "tests/data/jpeg/teapot/view_0.jpg",
    "progressive_420": "tests/data/formats/teapot/view_5_progressive.jpg",
    "arith_seq_420": "tests/data/formats/teapot/view_10_arith.jpg",
    "arith_prog_444_rst": "tests/data/formats/teapot/view_11_arith_prog.jpg",
    "lossless_rgb_p1": "tests/data/formats/teapot/view_12_lossless_rgb.jpg",
    "lossless_gray_p7": "tests/data/formats/teapot/view_13_lossless_gray.jpg",
}
# the host crop's compiled resize (data/augment.py) against its plain numpy
# version, which fuses every multiply-add: within a level
RESIZE_PLAIN_MAX_LEVELS = 1
FOLDERS_RENDERS = FOLDERS_PROMPTS + 1 + FOLDERS_SHEET_TOKENS
# the fused-UNet serving path (UNetConfig.fuse_conv) against the unfused
# one on the same weights: one UNet forward at the loop's first CFG step,
# the relative RMS of the difference within FUSED_UNET_REL_LIMIT (K4 and
# GroupNorm + SiLU + cuDNN round differently in bf16: fp32 sums and one
# cast against a bf16 normalize, SiLU, conv and time-embedding add), a
# limit that a planted fault (the last ResNet block's conv2 without its
# residual) must exceed; the full loop's images within FUSED_LEVELS levels
# at FUSED_WITHIN_SHARE of their values
FUSED_UNET_REL_LIMIT = 2e-2
FUSED_LEVELS = 8
FUSED_WITHIN_SHARE = 0.99


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def exp_rate(sms: int, max_sm_mhz: float) -> float:
    """The card's exponentials a second: 16 a clock on each SM."""
    return EXP_PER_SM_CLOCK * sms * max_sm_mhz * 1e6


def bound(flops: float, nbytes: float, exps: float = 0.0):
    """(the least ms the card could take, what bounds it): the largest of
    the tensor-core operations over the bf16 peak, the bytes over the
    memory rate and the exponentials over EXP_RATE."""
    times = {"operations": flops / PEAK_FLOPS, "bytes": nbytes / PEAK_BYTES,
             "exponentials": exps / EXP_RATE}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def attention_tolerance(ref):
    """The attention kernels' limit on |got - ref| at each element, against
    the fp32 plain result ref: the bf16 rounding of the output (2^-8 |ref|)
    plus 2^-4 of the RMS of ref for the bf16 rounding of p (and, in the
    backward, of ds) before their products, whose error is a sum of
    independent roundings that scales with the result's spread, not with
    each element. At the 6912-key self-attention a 20 % error in o, or one
    64-key tile of 108 left out, exceeds it."""
    return 2 ** -8 * ref.abs() + 2 ** -4 * ref.square().mean().sqrt()


def of_limit(got, ref, tol) -> float:
    """The worst element's error as a share of its limit."""
    return ((got.float() - ref).abs() / tol).max().item()


def time_ms(torch, fn, budget_ms: float = 150.0) -> float:
    """Mean time of fn on the card, by CUDA events, after a warm-up call;
    the count of timed calls (2 to 20) is sized to fill about
    budget_ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(max(2, min(20, budget_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn, by CUDA events over `replays`
    replays of a CUDA graph that holds `calls` calls: the host's launch
    work, as on the graphed paths, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds of one eager call of fn: the calls are queued
    without a wait, timed on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "K1 flash_attention_fwd"
    if "flash_bwd_dq_kernel" in low:
        return "K2 flash_attention_bwd_dq"
    if "flash_bwd_dkv" in low:        # the kernel and its split reduction
        return "K3 flash_attention_bwd_dkv"
    if "fused_conv_kernel" in low:
        return "K4 fused_conv"
    if any(s in low for s in ("fprop", "dgrad", "conv", "nhwc", "nchw",
                              "cudnn")):
        return "cudnn conv"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cublas matmul"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce" in low or "norm" in low:
        return "reduction/norm"
    return "elementwise/other"


def ptxas_usage(logs):
    """{(library, function): (registers, spill bytes)} from the build's
    `-Xptxas -v` output: spill bytes are the stores plus the loads."""
    usage, spills = {}, {}
    for lib, log in logs.items():
        entry = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                spills[entry] = int(m.group(1)) + int(m.group(2))
                continue
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                usage[(lib, entry)] = int(m.group(1))
    return {key: (regs, spills.get(key[1])) for key, regs in usage.items()}


PATH_BUCKETS = (48, 64, 80, 160)   # SD-1.5's head dims 40/80/160, SD-2.1's 64
BWD_SM90_BUCKETS = PATH_BUCKETS    # K2's and K3's Hopper design
BWD_SM90_SHORT_BUCKETS = (48, 64)  # K2's short-key kernel (Lk <= 80)
K4_SM90_INSTANTIATIONS = 1         # K4's Hopper design: one tile


def check_path_spills(usage):
    """The instantiations of K1, K2 and K3 (each design) at the paths'
    head-dim buckets (PATH_BUCKETS) and every instantiation of K4's two
    designs must spill nothing; prints every instantiation of the
    kernels."""
    seen = 0
    for (lib, fn), (regs, spill) in sorted(usage.items()):
        m = re.search(r"(flash_fwd_kernel(?:_sm90(?:_short)?)?|"
                      r"flash_bwd_dq_kernel(?:_sm90(?:_short)?)?|"
                      r"flash_bwd_dkv_kernel(?:_sm90)?|"
                      r"fused_conv_kernel(?:_sm90)?)"
                      r"I((?:L[ib]\d+E)+)", fn)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"\d+", m.group(2))]
        print(f"build {lib}: {m.group(1)}<{', '.join(map(str, args))}>: "
              f"{regs} registers, {spill} bytes spill", flush=True)
        # K1-K3's first template argument is the head-dim bucket; every
        # instantiation of K4's two designs runs on a path
        if m.group(1).startswith("fused_conv_kernel") or (
                args[0] in PATH_BUCKETS):
            seen += 1
            check(spill == 0, f"{fn} (on the path) spills {spill} bytes")
    return seen


def check_wgmma_pipelined(logs):
    """No kernel's warpgroup products are serialised: ptxas says so (C7512
    where registers run short, C7520 in a path it cannot prove
    warp-uniform) and the products then wait for each other."""
    for lib, log in logs.items():
        bad = [line.strip() for line in log.splitlines()
               if "instructions are serialized" in line]
        check(not bad, f"{lib}: ptxas serialised wgmma: {bad[:2]}")


def launch_counts(reset: bool = False):
    """Each kernel wrapper's launch count, {"K1": n, ...}, and each one's by
    design ("K1 sm90", "K1 mma_sync", ..., "K4 mma_sync"), graph replays
    included (utils/graphs.py); reset sets them all to 0 first."""
    from view_neti_tpu_torch.utils.graphs import launch_counts as counts
    return counts(reset)


# K1's launches a UNet forward on its Hopper design (ops/flash_attention.py
# ::fwd_design: the head-dim buckets 48, 64, 80 and 160 at any key count):
# all 32 of SD-1.5's (d = 40, 80, 160) and of SD-2.1's (d = 64), whether
# train (384x512), sweep (768x576) or render (512x512)
SD15_SM90 = 32
M3_SM90 = {"train": 32, "sweep": 32, "render": 32}


def unet_k1(forwards: int, sm90: int = SD15_SM90):
    """K1's launches in `forwards` UNet forwards as launch_counts keys
    them: 32 a forward, `sm90` of them on the Hopper design."""
    return {"K1": 32 * forwards, "K1 sm90": sm90 * forwards,
            "K1 mma_sync": (32 - sm90) * forwards}


def capture_record(counts):
    """Launch counts as a CUDA graph's capture keeps them
    (utils/graphs.py): only the counts the capture moved, none at 0."""
    return {k: v for k, v in counts.items() if v}


def add_counts(*counts):
    """The key-wise sum of launch counts."""
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# K2's and K3's launches a train step on their Hopper design
# (ops/flash_attention.py::bwd_design: the head-dim buckets 48, 64, 80 and
# 160 at any key count, but the shapes of BWD_MMA_SYNC_SHAPES, where the
# card measured the Hopper design slower): SD-1.5's at 384x512 all 30 of
# K2's and 30 of K3's 31 (its 48 x 77 mid-block cross-attention at d = 160
# on mma.sync); SD-2.1's 29 of K2's (its 48 x 48 mid block at d = 64 on
# mma.sync) and all 31 of K3's; SD-1.5's at 512x512 (the folders path, 64
# x 64 and 64 x 77 mid blocks) all
SD15_BWD_SM90 = {"K2": 30, "K3": 30}
M3_BWD_SM90 = {"K2": 29, "K3": 31}
FOLDERS_BWD_SM90 = {"K2": 30, "K3": 31}


def unet_bwd(steps: int, sm90=SD15_BWD_SM90):
    """K2's and K3's launches in `steps` train steps as launch_counts keys
    them: 30 and 31 a step, sm90["K2"] and sm90["K3"] of them on the
    Hopper design."""
    return {"K2": 30 * steps, "K2 sm90": sm90["K2"] * steps,
            "K2 mma_sync": (30 - sm90["K2"]) * steps, "K3": 31 * steps,
            "K3 sm90": sm90["K3"] * steps,
            "K3 mma_sync": (31 - sm90["K3"]) * steps}


BWD_KERNELS = {"K2": "dq", "K3": "dkv"}  # bwd_design's names of K2 and K3


def bwd_split_by_path(shapes, design):
    """K2's and K3's launches on each path of attention_shapes' rows, by
    design as `design` (ops/flash_attention.py::bwd_design) names each
    shape's for each kernel: {path: launch_counts-style counts}. The launch
    checks' unet_bwd constants must agree with it (phase_kernels
    checks)."""
    out = {}
    for shape in shapes:
        for key in ("K2", "K3"):
            name = design(shape["d"], shape["Lk"], shape["Lq"],
                          BWD_KERNELS[key])
            for path, n in shape["per_run"].get(key, {}).items():
                counts = out.setdefault(path, {})
                for k in (key, f"{key} {name}"):
                    counts[k] = counts.get(k, 0) + n
    return out


def train_paths_bwd():
    """What bwd_split_by_path must give: each training path's steps in one
    run (attention_shapes' per_run), at its model's split."""
    return {"train": unet_bwd(1), "validate": unet_bwd(VAL_TRAIN_STEPS),
            "acceptance": unet_bwd(ACC_STEPS),
            "mode3": unet_bwd(2 * (M3_WARM + M3_STEPS), M3_BWD_SM90),
            "folders": unet_bwd(2 * (FOLDERS_WARM + FOLDERS_STEPS),
                                FOLDERS_BWD_SM90),
            "tp": unet_bwd(TP_WARM + TP_STEPS)}


# K4's launches an encode (the train step's VAE encoder, 21 sections) and a
# decode (29) on its Hopper design (ops/fused_conv.py::conv_design: every
# Cout > 16, the ResNet convs): all but the encoder's last conv (512 -> 8)
# and the decoder's conv_out (128 -> 3)
K4_SM90 = {"encode": 20, "decode": 28}
# K4's launches a UNet forward with UNetConfig.fuse_conv (the fused-UNet
# serving path, BENCH_FUSE_UNET=1): two sections in each of the 22 ResNet
# blocks, all on the Hopper design (Cout 320 to 1280)
K4_UNET_SM90 = 44
SERVE_STEPS = 30         # the serving path's DPM-Solver++ steps (--steps)


def k4(encodes: int = 0, decodes: int = 0):
    """K4's launches in `encodes` VAE encodes and `decodes` decodes as
    launch_counts keys them: 21 and 29 each, K4_SM90 of them on the
    Hopper design."""
    total = 21 * encodes + 29 * decodes
    sm90 = K4_SM90["encode"] * encodes + K4_SM90["decode"] * decodes
    return {"K4": total, "K4 sm90": sm90, "K4 mma_sync": total - sm90}


def k4_unet(forwards: int = 0):
    """K4's launches in `forwards` fused UNet forwards as launch_counts
    keys them: 44 each, all on the Hopper design."""
    n = K4_UNET_SM90 * forwards
    return {"K4": n, "K4 sm90": n, "K4 mma_sync": 0}


def path_codecs():
    """Each path's VAE encodes and decodes in one run (k4_shapes'
    per_run): {path: (encodes, decodes)}."""
    return {"serve": (0, 1), "serve_fused_unet": (0, 1), "train": (1, 0),
            "validate": (VAL_TRAIN_STEPS, EVAL_CAMS + 1),
            "acceptance": (ACC_STEPS, EVAL_CAMS), "inference": (0, INFER_CAMS),
            "mode3": (2 * (M3_WARM + M3_STEPS),
                      M3_TOKENS * (M3_SWEEP_CAMS + INFER_CAMS + 1)),
            "folders": (2 * (FOLDERS_WARM + FOLDERS_STEPS), FOLDERS_RENDERS),
            "tp": (TP_WARM + TP_STEPS, 1)}


def path_k4(serve_steps: int = SERVE_STEPS):
    """Each path's K4 launches in one run, as the launch checks hold its
    counted run to them: its encodes and decodes (path_codecs) and, on the
    fused-UNet serving path, its `serve_steps` fused UNet forwards."""
    forwards = {"serve_fused_unet": serve_steps}
    return {p: add_counts(k4(*c), k4_unet(forwards.get(p, 0)))
            for p, c in path_codecs().items()}


def conv_split_by_path(shapes, design):
    """K4's launches on each path of k4_shapes' rows, by design as `design`
    (ops/fused_conv.py::conv_design) names each shape's: {path:
    launch_counts-style counts}. Every path must give path_k4()[path]
    (phase_kernels checks)."""
    out = {}
    for _, _, _, ci, co, _, per_run in shapes:
        for path, n in per_run.items():
            counts = out.setdefault(path, {})
            for k in ("K4", f"K4 {design(ci, co)}"):
                counts[k] = counts.get(k, 0) + n
    return out


# an SD-1.5 train step's launches
SD15_STEP = {**unet_k1(1), **unet_bwd(1), **k4(encodes=1)}


def device_profile(torch, fn, ranges=()):
    """Where the device time of fn goes, from torch.profiler: the span from
    the first kernel's start to the last one's end, the union of kernel
    intervals in it (busy), the idle share, and kernel time by group and
    by name. A record_function range named in `ranges` leaves a span on
    the device's timeline; the kernels that start inside it form a group of
    that name, with their count under launches_by_range. None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e for e in events if e.name in ranges]
    events = [e for e in events if e.name not in ranges]
    if not events:
        return None

    def range_of(e):
        return next((m.name for m in marks
                     if m.time_range.start <= e.time_range.start
                     < m.time_range.end), None)

    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    span_us = max(e for _, e in spans) - spans[0][0]
    groups, names, in_range = {}, {}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        g = range_of(e)
        if g is not None:
            in_range[g] = in_range.get(g, 0) + 1
        else:
            g = kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + ms
        names[e.name[:70]] = names.get(e.name[:70], 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return dict(span_ms=span_us / 1e3, busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / span_us, kernels=len(events),
                by_group_ms=dict(sorted(groups.items(),
                                        key=lambda kv: -kv[1])),
                launches_by_range=in_range, top_ms=dict(top))


def augment_ranged(fn):
    """fn with the train step's augmentation inside a record_function range
    "device_augment", so that device_profile(..., ranges=("device_augment",))
    groups its kernels."""
    import torch
    from view_neti_tpu_torch.training import train_step
    inner = train_step.augment_batch

    def ranged(*args):
        with torch.profiler.record_function("device_augment"):
            return inner(*args)

    def run():
        train_step.augment_batch = ranged
        try:
            return fn()
        finally:
            train_step.augment_batch = inner
    return run


def attention_shapes(serve_steps: int):
    """Every attention shape of the paths, with its launches per run of
    each (K1, 30 UNet forwards per serving run; K1, K2, K3 per train step).

    SD-1.5 has 8 heads and 5 transformer blocks on each of its three
    attention levels (2 down, 3 up) plus 1 in the mid block; each block
    runs a self- and a cross-attention (Lk = 77). Serving: B = 6 (3 seeds x
    CFG) at 72x96 latents; the acceptance phase's sweep too (its default 3
    seeds, ACC_DENOISE steps a camera). The DTU sweep (validate,
    inference; and the weights phase's two UNet forwards): B = 4 (2 seeds
    x CFG) at 72x96, VAL_DENOISE steps a camera. The object-token renders
    of a validation round: B = 4 at 64x64 latents (512x512). Training (the
    train step and the validate and acceptance phases' Coach steps): B = 9
    at 48x64 latents; the first
    self-attention's inputs need no gradient (no backward) and the first
    cross-attention's q needs none (K3 only), so a step runs K2 30 times
    and K3 31 times. SD-2.1 (the mode3 phase) has the same blocks with a
    head dim of 64: 5, 10, 20 and 20 heads on the four levels; its path
    runs 2 (M3_WARM + M3_STEPS) train steps (the stopped, the straight
    and the resumed Coach), a sweep per eval token over M3_SWEEP_CAMS
    cameras and over the offline inference's INFER_CAMS, and the renders
    of the eval tokens. The folders phase trains at 512x512 (64x64
    latents, B = 9): 2 (FOLDERS_WARM + FOLDERS_STEPS) steps of its two
    Coaches, and FOLDERS_RENDERS renders at the render shapes. A rank of
    the tp phase runs SD-1.5's attentions over 8 / TP_WORLD heads: one
    render at the serving shapes (TP_DENOISE steps) and TP_WARM + TP_STEPS
    train steps."""
    shapes = []
    m3_steps = 2 * (M3_WARM + M3_STEPS)
    folders_steps = 2 * (FOLDERS_WARM + FOLDERS_STEPS)
    for kind, B, lengths, dims, heads in (
            ("serve", BATCH, (6912, 1728, 432, 108), (40, 80, 160, 160),
             (8,) * 4),
            ("sweep", SWEEP_BATCH, (6912, 1728, 432, 108),
             (40, 80, 160, 160), (8,) * 4),
            ("render", SWEEP_BATCH, (4096, 1024, 256, 64),
             (40, 80, 160, 160), (8,) * 4),
            ("train", TRAIN_BATCH, (3072, 768, 192, 48), (40, 80, 160, 160),
             (8,) * 4),
            ("m3 train", TRAIN_BATCH, (3072, 768, 192, 48), (64,) * 4,
             (5, 10, 20, 20)),
            ("m3 sweep", SWEEP_BATCH, (6912, 1728, 432, 108), (64,) * 4,
             (5, 10, 20, 20)),
            ("m3 render", SWEEP_BATCH, (4096, 1024, 256, 64), (64,) * 4,
             (5, 10, 20, 20)),
            ("folders train", TRAIN_BATCH, (4096, 1024, 256, 64),
             (40, 80, 160, 160), (8,) * 4),
            ("tp serve", BATCH, (6912, 1728, 432, 108), (40, 80, 160, 160),
             (8 // TP_WORLD,) * 4),
            ("tp train", TRAIN_BATCH, (3072, 768, 192, 48),
             (40, 80, 160, 160), (8 // TP_WORLD,) * 4)):
        for level, (L, d, H, n) in enumerate(zip(lengths, dims, heads,
                                                 (5, 5, 5, 1))):
            for Lk in (L, 77):
                first = kind.endswith("train") and level == 0
                if kind == "serve":
                    per_run = {"K1": {
                        "serve": n * serve_steps,
                        "acceptance": n * ACC_DENOISE * EVAL_CAMS}}
                elif kind == "sweep":
                    per_run = {"K1": {
                        "validate": n * VAL_DENOISE * EVAL_CAMS,
                        "inference": n * VAL_DENOISE * INFER_CAMS,
                        "weights": 2 * n}}
                elif kind == "render":
                    per_run = {"K1": {
                        "validate": n * VAL_DENOISE,
                        "folders": n * VAL_DENOISE * FOLDERS_RENDERS}}
                elif kind == "m3 sweep":
                    per_run = {"K1": {"mode3": n * VAL_DENOISE * M3_TOKENS
                                      * (M3_SWEEP_CAMS + INFER_CAMS)}}
                elif kind == "m3 render":
                    per_run = {"K1": {"mode3": n * VAL_DENOISE * M3_TOKENS}}
                elif kind == "tp serve":
                    per_run = {"K1": {"tp": n * TP_DENOISE}}
                else:
                    paths = ({"mode3": m3_steps} if kind == "m3 train" else
                             {"folders": folders_steps}
                             if kind == "folders train" else
                             {"tp": TP_WARM + TP_STEPS}
                             if kind == "tp train" else
                             {"train": 1, "validate": VAL_TRAIN_STEPS,
                              "acceptance": ACC_STEPS})
                    per_run = {
                        key: {p: m * k for p, k in paths.items()}
                        for key, m in (("K1", n), ("K2", n - first),
                                       ("K3", n - (first and Lk == L)))}
                shapes.append(dict(B=B, Lq=L, Lk=Lk, H=H, d=d,
                                   per_run=per_run))
    return shapes


def attention_bound(key, shape):
    """(the bound's ms, what bounds it) of K1, K2 or K3 at a row of
    attention_shapes: the products (4, 6 and 8 operations a score and head
    dimension), the bytes (each input read once and each output written
    once: q, k, v, o and the fp32 lse; K2 adds dO and writes dQ, K3 dK and
    dV, both read lse and delta) and one exponential a score (K2 and K3
    recompute P), the special-function units' share."""
    B, Lq, Lk, H, d = (shape[k] for k in ("B", "Lq", "Lk", "H", "d"))
    q, kv, rows = B * Lq * H * d, B * Lk * H * d, B * H * Lq
    per, nbytes = {"K1": (4, 2.0 * (2 * q + 2 * kv) + 4.0 * rows),
                   "K2": (6, 2.0 * (3 * q + 2 * kv) + 8.0 * rows),
                   "K3": (8, 2.0 * (2 * q + 4 * kv) + 8.0 * rows)}[key]
    return bound(per * B * H * Lq * Lk * d, nbytes, float(B * H * Lq * Lk))


def conv_bound(shape):
    """(the bound's ms, what bounds it) of K4 at a row of k4_shapes: 2 x 9
    x Cin x Cout operations an output pixel; x, the weights, the output
    and the residual in bf16, a and b (and the time embedding) in fp32,
    each once."""
    B, H, W, Ci, Co, epi, _ = shape
    px = B * H * W
    return bound(2.0 * 9 * px * Ci * Co,
                 2.0 * (px * Ci + px * Co + 9 * Ci * Co
                        + (px * Co if epi == " +res" else 0))
                 + 8.0 * B * Ci + (4.0 * B * Co if epi == " +t" else 0.0))


def dropped_keys(Lk: int) -> int:
    """The keys a control leaves out: the last 64-key tile, or half the
    keys where there is only one tile."""
    return 64 if Lk > 64 else Lk // 2


def attention_rows(torch, F, fa, shape, g, dev,
                   heaviest=("K1", "K2", "K3")):
    """K1 at one attention shape and, where the train step differentiates
    it, K2 and K3: each held against its plain version with a control its
    limit has to catch, and timed beside the plain version, a PyTorch
    library call and the bound. At the Hopper design's shapes the mma.sync
    design is held to the same limit at the same inputs; for the kernels
    in `heaviest` (this is their heaviest Hopper shape) both designs are
    also timed in a CUDA graph and on the host, and the mma.sync design
    eagerly."""
    B, Lq, Lk, H, d = (shape[k] for k in ("B", "Lq", "Lk", "H", "d"))
    label = f"B{B} Lq{Lq} Lk{Lk} H{H} d{d}"
    drop = dropped_keys(Lk)
    q = torch.randn(B, Lq, H, d, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Lk, H, d, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Lk, H, d, generator=g, device=dev).bfloat16()
    design = fa.fwd_design(d, Lk)
    o, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()

    def per_batch(fn):
        # one batch element at a time: the full fp32 logits at L = 6912
        # would be 9 GB
        outs = [fn(b) for b in range(B)]
        return [torch.cat(t) for t in zip(*outs)]

    def ref_fwd(keys=Lk):
        return per_batch(lambda b: fa.flash_attention_ref(
            q[b:b + 1].float(), k[b:b + 1, :keys].float(),
            v[b:b + 1, :keys].float()))

    ro, rlse = ref_fwd()
    tol = attention_tolerance(ro)
    ratio = of_limit(o, ro, tol)
    lse_err = (lse - rlse).abs().max().item()
    # the control: the plain version with the last key tile dropped, the
    # fault of a wrong key mask or a lost tile in the online softmax
    control = of_limit(ref_fwd(Lk - drop)[0], ro, tol)
    check(ratio <= 1 and lse_err <= 1e-3,
          f"K1 ({design}) disagrees at {label}: {ratio:.3g} of the limit, "
          f"lse {lse_err:.3g}")
    check(control > 1, f"K1's limit at {label} misses {drop} dropped keys "
                       f"({control:.3g} of the limit)")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bms, by = attention_bound("K1", shape)
    row = dict(
        shape=label, design=design, per_run=shape["per_run"]["K1"],
        max_abs_err=(o.float() - ro).abs().max().item(), lse_err=lse_err,
        err_of_limit=ratio, control_of_limit=control,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v)),
        plain_ms=time_ms(torch, ref_fwd, 50.0),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        bound_ms=bms, bound_by=by)
    if design == "sm90":
        # the mma.sync design at the same inputs, held to the same limit
        # and timed in the same call
        mo, mlse = fa._flash_attention_mma_sync(q, k, v)

        def mma():
            return fa._flash_attention_mma_sync(q, k, v)

        def sm90():
            return fa._launch_fwd(q, k, v, "sm90")

        row.update(mma_sync_err_of_limit=of_limit(mo, ro, tol),
                   mma_sync_max_abs_err=(mo.float() - ro).abs().max().item(),
                   mma_sync_lse_err=(mlse - rlse).abs().max().item())
        if "K1" in heaviest:
            row.update(graph_ms=graph_ms(torch, sm90),
                       host_us=host_us(torch, sm90),
                       mma_sync_ms=time_ms(torch, mma),
                       mma_sync_graph_ms=graph_ms(torch, mma),
                       mma_sync_host_us=host_us(torch, mma))
        check(row["mma_sync_err_of_limit"] <= 1
              and row["mma_sync_lse_err"] <= 1e-3,
              f"K1 (mma_sync) disagrees at {label}: "
              f"{row['mma_sync_err_of_limit']:.3g} of the limit")
        del mo, mlse
    rows = {"K1": row}
    del ro, rlse, tol
    if "K2" not in shape["per_run"]:
        return rows

    do = torch.randn(B, Lq, H, d, generator=g, device=dev).bfloat16()
    delta = fa.attention_delta(o, do)
    designs = {key: fa.bwd_design(d, Lk, Lq, kernel)
               for key, kernel in (("K2", "dq"), ("K3", "dkv"))}
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()

    def ref_bwd(keys=Lk, need_dq=True, need_dkv=True):
        # o, lse and delta stay those of all Lk keys: fewer keys is the
        # fault of a kernel that lost their tile
        return per_batch(lambda b: [t for t in fa.flash_attention_bwd_ref(
            q[b:b + 1].float(), k[b:b + 1, :keys].float(),
            v[b:b + 1, :keys].float(), o[b:b + 1].float(), lse[b:b + 1],
            do[b:b + 1].float(), need_dq, need_dkv) if t is not None])

    refs = ref_bwd()
    tols = [attention_tolerance(r) for r in refs]

    def errs_of(got):
        """(share of the limit, max abs error) of dq, dk, dv."""
        return ([of_limit(x, r, t) for x, r, t in zip(got, refs, tols)],
                [(x.float() - r).abs().max().item()
                 for x, r in zip(got, refs)])

    ratios, errs = errs_of((dq, dk, dv))
    # controls: dq without the last key tile's terms; dk and dv with that
    # tile's rows never written
    ctl_dq = of_limit(ref_bwd(Lk - drop, need_dkv=False)[0], refs[0],
                      tols[0])
    ctl_dkv = []
    for r, t in zip(refs[1:], tols[1:]):
        lost = r.clone()
        lost[:, Lk - drop:] = 0
        ctl_dkv.append(of_limit(lost, r, t))
    check(ratios[0] <= 1, f"K2 ({designs['K2']}) disagrees at {label}: "
                          f"{ratios[0]:.3g} of the limit")
    check(max(ratios[1:]) <= 1, f"K3 ({designs['K3']}) disagrees at "
                                f"{label}: dk {ratios[1]:.3g}, dv "
                                f"{ratios[2]:.3g} of the limit")
    check(ctl_dq > 1 and min(ctl_dkv) > 1,
          f"the backward's limit at {label} misses a lost key tile (dq "
          f"{ctl_dq:.3g}, dk {ctl_dkv[0]:.3g}, dv {ctl_dkv[1]:.3g})")
    if "sm90" in designs.values():
        # the mma.sync designs at the same inputs, held to the same limits
        m_ratios, m_errs = errs_of((
            fa._flash_attention_bwd_dq_mma_sync(q, k, v, do, lse, delta),
            *fa._flash_attention_bwd_dkv_mma_sync(q, k, v, do, lse,
                                                  delta)))
        check(max(m_ratios) <= 1,
              f"K2/K3 (mma_sync) disagree at {label}: dq, dk, dv "
              f"{[round(x, 3) for x in m_ratios]} of the limit")
    # a shape of a Hopper bucket that bwd_design keeps on the mma.sync
    # design for a kernel (BWD_MMA_SYNC_SHAPES): the Hopper design checked
    # and timed beside it at the same inputs
    held = [key for key, name in designs.items()
            if name == "mma_sync" and fa.fwd_design(d, Lk) == "sm90"]
    if held:
        h_ratios, h_errs = errs_of((
            fa._launch_bwd_dq(q, k, v, do, lse, delta, "sm90")[0],
            *fa._launch_bwd_dkv(q, k, v, do, lse, delta, "sm90")[:2]))
        check(max(h_ratios) <= 1,
              f"K2/K3 (sm90) disagree at {label}: dq, dk, dv "
              f"{[round(x, 3) for x in h_ratios]} of the limit")
    del refs, tols

    # SDPA's backward through autograd, the library yardstick: one call
    # computes dq, dk and dv, so its time stands beside both kernels
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv)
    ldo = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), ldo, retain_graph=True))
    del lo
    for key, ratio, control, err, fn, plain, launch in (
            ("K2", ratios[0], ctl_dq, errs[0],
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             lambda: ref_bwd(need_dkv=False), fa._launch_bwd_dq),
            ("K3", max(ratios[1:]), min(ctl_dkv), max(errs[1:]),
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             lambda: ref_bwd(need_dq=False), fa._launch_bwd_dkv)):
        bms, by = attention_bound(key, shape)
        design = designs[key]
        rows[key] = row = dict(
            shape=label, design=design, per_run=shape["per_run"][key],
            max_abs_err=err, err_of_limit=ratio, control_of_limit=control,
            ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain, 50.0),
            library_ms=library_ms, bound_ms=bms, bound_by=by)

        def sm90(launch=launch):
            return launch(q, k, v, do, lse, delta, "sm90")

        def mma(launch=launch):
            return launch(q, k, v, do, lse, delta, "mma_sync")

        sl = slice(0, 1) if key == "K2" else slice(1, 3)
        if key in held:
            row.update(sm90_err_of_limit=max(h_ratios[sl]),
                       sm90_max_abs_err=max(h_errs[sl]),
                       sm90_ms=time_ms(torch, sm90))
        if design == "sm90":
            # both designs eagerly, in a CUDA graph of 20 calls and on the
            # host at the kernel's heaviest shape, counting nothing
            row.update(mma_sync_err_of_limit=max(m_ratios[sl]),
                       mma_sync_max_abs_err=max(m_errs[sl]))
            if key in heaviest:
                row.update(graph_ms=graph_ms(torch, sm90),
                           host_us=host_us(torch, sm90),
                           mma_sync_ms=time_ms(torch, mma),
                           mma_sync_graph_ms=graph_ms(torch, mma),
                           mma_sync_host_us=host_us(torch, mma))
    return rows


def vae_k4_shapes():
    """Every norm->SiLU->conv3x3 section of the VAE decoder (29 per decode)
    and of its encoder (21 per train step): (B, H, W, Cin, Cout,
    epilogue, {path: launches per run}). conv1 of each ResNet block has no
    epilogue, conv2 adds the residual (" +res"). Decodes: serving B = 3
    from 72x96 latents (the fused-UNet serving path's too), and the
    acceptance phase's sweep (3 seeds) once a camera; the DTU sweep
    B = 2 (one camera's seeds) from 72x96, once a camera; the object
    renders B = 2 from 64x64. The encoder: B = 9 at 384x512, in the train
    step and in the validate and acceptance phases' Coach steps. SD-2.1's
    VAE is SD-1.5's, so the mode3 phase runs the same shapes: its train
    steps, a decode per camera of its sweeps and one per token's render. The folders phase
    encodes B = 9 at 512x512 every step and decodes its renders at the
    render shapes. A tp rank decodes its render at the serving shapes and
    encodes TP_WARM + TP_STEPS train steps."""
    def decoder(D, h, w, per):
        return [(D, h * s, w * s, ci, co, epi, per(n))
                for s, ci, co, epi, n
                in ((1, 512, 512, "", 5), (1, 512, 512, " +res", 5),
                    (2, 512, 512, "", 3), (2, 512, 512, " +res", 3),
                    (4, 512, 256, "", 1), (4, 256, 256, "", 2),
                    (4, 256, 256, " +res", 3), (8, 256, 128, "", 1),
                    (8, 128, 128, "", 2), (8, 128, 128, " +res", 3),
                    (8, 128, 3, "", 1))]

    E = TRAIN_BATCH
    m3_steps = 2 * (M3_WARM + M3_STEPS)
    folders_steps = 2 * (FOLDERS_WARM + FOLDERS_STEPS)

    def train(n):
        return {"train": n, "validate": n * VAL_TRAIN_STEPS,
                "mode3": n * m3_steps, "acceptance": n * ACC_STEPS,
                "tp": n * (TP_WARM + TP_STEPS)}

    def folders(n):
        return {"folders": n * folders_steps}

    def encoder(h, w, per):
        return [(E, h // s, w // s, ci, co, epi, per(n))
                for s, ci, co, epi, n
                in ((1, 128, 128, "", 2), (1, 128, 128, " +res", 2),
                    (2, 128, 256, "", 1), (2, 256, 256, "", 1),
                    (2, 256, 256, " +res", 2), (4, 256, 512, "", 1),
                    (4, 512, 512, "", 1), (4, 512, 512, " +res", 2),
                    (8, 512, 512, "", 4), (8, 512, 512, " +res", 4),
                    (8, 512, 8, "", 1))]

    return (decoder(BATCH // 2, 72, 96, lambda n: {
                "serve": n, "serve_fused_unet": n,
                "acceptance": n * EVAL_CAMS, "tp": n})
            + decoder(len(VAL_SEEDS), 72, 96, lambda n: {
                "validate": n * EVAL_CAMS, "inference": n * INFER_CAMS,
                "mode3": n * M3_TOKENS * (M3_SWEEP_CAMS + INFER_CAMS)})
            + decoder(len(VAL_SEEDS), 64, 64, lambda n: {
                "validate": n, "mode3": n * M3_TOKENS,
                "folders": n * FOLDERS_RENDERS})
            + encoder(TRAIN_HEIGHT, TRAIN_WIDTH, train)
            + encoder(FOLDERS_SIZE, FOLDERS_SIZE, folders))


def unet_k4_shapes(serve_steps: int = SERVE_STEPS):
    """Every ResNet conv section of an SD-1.5 UNet forward with
    UNetConfig.fuse_conv (44), on the fused-UNet serving path: B = 6 (3
    seeds x CFG) at the 72x96 latents and the three levels below,
    `serve_steps` forwards a run. conv1 adds the time embedding (" +t",
    add_bc), conv2 the block's input or its 1x1 shortcut (" +res"); the
    up blocks' conv1 read the skip concatenations (Cin up to 2560)."""
    return [(BATCH, h, w, ci, co, epi, {"serve_fused_unet": n * serve_steps})
            for h, w, ci, co, epi, n in (
                (72, 96, 320, 320, " +t", 2), (72, 96, 320, 320, " +res", 5),
                (72, 96, 640, 320, " +t", 2), (72, 96, 960, 320, " +t", 1),
                (36, 48, 320, 640, " +t", 1), (36, 48, 640, 640, " +t", 1),
                (36, 48, 640, 640, " +res", 5), (36, 48, 960, 640, " +t", 1),
                (36, 48, 1280, 640, " +t", 1),
                (36, 48, 1920, 640, " +t", 1),
                (18, 24, 640, 1280, " +t", 1),
                (18, 24, 1280, 1280, " +t", 1),
                (18, 24, 1280, 1280, " +res", 5),
                (18, 24, 1920, 1280, " +t", 1),
                (18, 24, 2560, 1280, " +t", 2),
                (9, 12, 1280, 1280, " +t", 4),
                (9, 12, 1280, 1280, " +res", 7),
                (9, 12, 2560, 1280, " +t", 3))]


def k4_shapes(serve_steps: int = SERVE_STEPS):
    """K4's shapes on every path: the VAE's (vae_k4_shapes), then the
    fused UNet's (unet_k4_shapes)."""
    return vae_k4_shapes() + unet_k4_shapes(serve_steps)


def k4_row(torch, F, fc, shape, g, dev, time_mma=True):
    """K4 at one shape of the paths, on the design conv_design names: held
    against its plain version with two controls its limit has to catch,
    timed eagerly, in a CUDA graph of 10 calls and on the host, beside the
    plain version, GroupNorm + SiLU + cuDNN and the bound; at the Hopper
    design's shapes the mma.sync design is held to the same limit at the
    same inputs and, with time_mma, timed the same way."""
    B, H, W, Ci, Co, epi, per_run = shape
    label = f"B{B} {H}x{W} {Ci}->{Co}{epi}"
    use_res, use_t = epi == " +res", epi == " +t"
    design = fc.conv_design(Ci, Co)
    x = torch.randn(B, H, W, Ci, generator=g, device=dev).bfloat16()
    a = 1 + 0.1 * torch.randn(B, Ci, generator=g, device=dev)
    b = 0.1 * torch.randn(B, Ci, generator=g, device=dev)
    w = (torch.randn(3, 3, Ci, Co, generator=g, device=dev)
         * (9 * Ci) ** -0.5).bfloat16()
    bias = (0.1 * torch.randn(Co, generator=g, device=dev)).bfloat16()
    res = (torch.randn(B, H, W, Co, generator=g, device=dev).bfloat16()
           if use_res else None)
    # the UNet's time embedding, fp32 as the wrapper takes it
    t = torch.randn(B, Co, generator=g, device=dev) if use_t else None
    out = fc.fused_affine_silu_conv3x3(x, a, b, w, bias, add_bc=t,
                                       residual=res)
    torch.cuda.synchronize()

    def ref(cin=Ci):
        return fc.fused_affine_silu_conv3x3_ref(
            x[..., :cin], a[:, :cin], b[:, :cin], w[:, :, :cin], bias,
            add_bc=t, residual=res, out_dtype=torch.float32)

    def padded_before_silu():
        # the zero padding applied to x, not to silu(a x + b): the border
        # taps read silu(b) instead of 0, the fault of a halo tile staged
        # without its out-of-image mask
        pad = (0, 0, 1, 1, 1, 1)
        return fc.fused_affine_silu_conv3x3_ref(
            F.pad(x, pad), a, b, w, bias, add_bc=t,
            residual=F.pad(res, pad) if use_res else None,
            out_dtype=torch.float32)[:, 1:-1, 1:-1]

    want = ref()
    # bf16 output rounding plus 2e-2 for summation order
    tol = 2e-2 + 2 ** -8 * want.abs()
    ratio = of_limit(out, want, tol)
    # the controls: the last chunk of input channels left out (a lost
    # chunk of the kernel's channel loop), and the halo fault above
    controls = dict(chunk=of_limit(ref(Ci - fc.CIN_CHUNK), want, tol),
                    halo=of_limit(padded_before_silu(), want, tol))
    check(ratio <= 1, f"K4 ({design}) disagrees at {label}: {ratio:.3g} of "
                      f"the limit")
    check(min(controls.values()) > 1,
          f"K4's limit at {label} misses a control's fault: {controls}")
    gn_w = torch.ones(Ci, device=dev, dtype=torch.bfloat16)
    gn_b = torch.zeros(Ci, device=dev, dtype=torch.bfloat16)
    x_cl = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    res_cl = res.permute(0, 3, 1, 2) if use_res else None
    # the unfused UNet adds the time embedding in bf16
    t_cl = t.bfloat16()[:, :, None, None] if use_t else None

    def library():
        y = F.conv2d(F.silu(F.group_norm(x_cl, 32, gn_w, gn_b)), w_oihw,
                     bias, padding=1)
        if use_t:
            y = y + t_cl
        return y + res_cl if use_res else y

    bms, by = conv_bound(shape)

    def run(d=design):
        # counts nothing: the launch checks read the paths' runs only
        return fc._fused_affine_silu_conv3x3_design(d, x, a, b, w, bias,
                                                    add_bc=t, residual=res)

    row = dict(shape=label, design=design, per_run=per_run,
               max_abs_err=(out.float() - want).abs().max().item(),
               err_of_limit=ratio,
               control_of_limit=min(controls.values()), controls=controls,
               ms=time_ms(torch, lambda: fc.fused_affine_silu_conv3x3(
                   x, a, b, w, bias, add_bc=t, residual=res)),
               graph_ms=graph_ms(torch, run, calls=10, replays=3),
               host_us=host_us(torch, run, calls=20),
               plain_ms=time_ms(torch, lambda:
                                fc.fused_affine_silu_conv3x3_ref(
                                    x, a, b, w, bias, add_bc=t,
                                    residual=res), 50.0),
               library_ms=time_ms(torch, library), bound_ms=bms,
               bound_by=by)
    if design == "sm90":
        # the mma.sync design at the same inputs, held to the same limit
        # and timed the same way in the same call
        mo = run("mma_sync")
        mma_ratio = of_limit(mo, want, tol)
        check(mma_ratio <= 1, f"K4 (mma_sync) disagrees at {label}: "
                              f"{mma_ratio:.3g} of the limit")
        row.update(mma_sync_err_of_limit=mma_ratio,
                   mma_sync_max_abs_err=(mo.float() - want).abs().max()
                   .item())
        del mo
        if time_mma:
            row.update(
                mma_sync_ms=time_ms(torch, lambda: run("mma_sync")),
                mma_sync_graph_ms=graph_ms(torch, lambda: run("mma_sync"),
                                           calls=10, replays=3),
                mma_sync_host_us=host_us(torch, lambda: run("mma_sync"),
                                         calls=20))
    return row


def print_row(key, row, card):
    extra = (f", lse {row['lse_err']:.3g}" if "lse_err" in row else "")
    if "design" in row:
        key = f"{key} {row['design']}"
    if "mma_sync_ms" in row:
        extra += (f", mma_sync {row['mma_sync_ms']:.4f} ms "
                  f"({row['mma_sync_err_of_limit']:.3g} of the limit); "
                  f"graphed {row['graph_ms']:.4f} ms, mma_sync "
                  f"{row['mma_sync_graph_ms']:.4f}; host "
                  f"{row['host_us']:.1f} us a call, mma_sync "
                  f"{row['mma_sync_host_us']:.1f}")
    elif "graph_ms" in row:
        extra += (f"; graphed {row['graph_ms']:.4f} ms; host "
                  f"{row['host_us']:.1f} us a call")
    if "mma_sync_err_of_limit" in row and "mma_sync_ms" not in row:
        extra += (f"; mma_sync {row['mma_sync_err_of_limit']:.3g} of the "
                  f"limit, not timed")
    if "sm90_ms" in row:
        extra += (f"; sm90 {row['sm90_ms']:.4f} ms "
                  f"({row['sm90_err_of_limit']:.3g} of the limit)")
    if "controls" in row:
        extra += ", controls " + ", ".join(
            f"{k} {v:.3g}" for k, v in row["controls"].items())
    print(f"{key} {row['shape']}: err {row['max_abs_err']:.3g} "
          f"({row['err_of_limit']:.3g} of the limit; control "
          f"{row['control_of_limit']:.3g}){extra} | kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {row['share_of_bound']:.4f} of the kernel's "
          f"time) [{card}]", flush=True)


def bwd_pair(results):
    """K2 and K3 summed over one run of each training path, each shape's
    launches there times its time: as run (each shape on the design
    bwd_design names), with the mma.sync design at every shape (its time
    beside the Hopper design's at the same inputs; None where that time
    was not taken, mma_sync_total), SDPA's backward (one
    call computes dq, dk and dv: K3's launches, which include the one
    cross-attention whose q needs no gradient) and the bound; `designs`
    holds each kernel's launches there by design."""
    out = {}
    for p in ("train", "validate", "acceptance", "mode3", "folders", "tp"):
        def total(key, field):
            return sum(r[field] * r["per_run"].get(p, 0)
                       for r in results[key])

        designs = {key: {"sm90": 0, "mma_sync": 0} for key in ("K2", "K3")}
        for key, by_design in designs.items():
            for r in results[key]:
                by_design[r["design"]] += r["per_run"].get(p, 0)
        out[p] = dict(
            designs=designs,
            k2_ms=total("K2", "ms"), k3_ms=total("K3", "ms"),
            k2_mma_sync_ms=mma_sync_total(results["K2"], p),
            k3_mma_sync_ms=mma_sync_total(results["K3"], p),
            sdpa_backward_ms=total("K3", "library_ms"),
            bound_ms=total("K2", "bound_ms") + total("K3", "bound_ms"))
        out[p]["pair_ms"] = out[p]["k2_ms"] + out[p]["k3_ms"]
        both = (out[p]["k2_mma_sync_ms"], out[p]["k3_mma_sync_ms"])
        out[p]["pair_mma_sync_ms"] = (None if None in both else sum(both))
    return out


def mma_sync_total(rows, path, field="mma_sync_ms", fallback="ms"):
    """A path's sum with every shape on the mma.sync design: a Hopper row
    adds the mma.sync design's `field`, timed beside it, an mma.sync row
    its own `fallback`; None where a Hopper row of the path was not timed
    on the mma.sync design (phase_kernels times that design beside the
    Hopper one at each kernel's heaviest shape only)."""
    total = 0.0
    for r in rows:
        n = r["per_run"].get(path, 0)
        if not n:
            continue
        if r["design"] == "sm90":
            if field not in r:
                return None
            total += r[field] * n
        else:
            total += r[fallback] * n
    return total


def conv_paths(rows):
    """K4 summed over one run of each path, each shape's launches there
    times its time: as run (each shape on the design conv_design names),
    eagerly and in a CUDA graph; with the mma.sync design at every shape
    (its time beside the Hopper design's at the same inputs; None where
    that time was not taken, mma_sync_total), eagerly and in a graph;
    GroupNorm + SiLU + cuDNN; the bound."""
    out = {}
    for p in path_codecs():
        def total(field):
            return sum(r[field] * r["per_run"].get(p, 0) for r in rows)
        out[p] = dict(k4_ms=total("ms"), k4_graph_ms=total("graph_ms"),
                      k4_mma_sync_ms=mma_sync_total(rows, p),
                      k4_mma_sync_graph_ms=mma_sync_total(
                          rows, p, "mma_sync_graph_ms", "graph_ms"),
                      library_ms=total("library_ms"),
                      bound_ms=total("bound_ms"))
    return out


def phase_kernels(torch, dev, card, serve_steps):
    import torch.nn.functional as F
    from view_neti_tpu_torch.ops import flash_attention as fa
    from view_neti_tpu_torch.ops import fused_conv as fc

    # the plain versions in full fp32: no TF32 in matmuls or convolutions
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(0)
    results = {"K1": [], "K2": [], "K3": [], "K4": []}
    shapes = attention_shapes(serve_steps)
    # the launch checks' split of K2 and K3 by design is bwd_design's
    split = bwd_split_by_path(shapes, fa.bwd_design)
    for path, want in train_paths_bwd().items():
        check(split[path] == capture_record(want),
              f"K2/K3 by design on the {path} path: bwd_design gives "
              f"{split[path]}, the launch checks {want}")
    # the superseded mma.sync designs: checked beside the Hopper designs at
    # every shape, timed beside them at each kernel's heaviest shape
    def design(key, s):
        if key == "K1":
            return fa.fwd_design(s["d"], s["Lk"])
        return fa.bwd_design(s["d"], s["Lk"], s["Lq"], BWD_KERNELS[key])

    heaviest = {key: max((s for s in shapes if key in s["per_run"]
                          and design(key, s) == "sm90"),
                         key=lambda s: attention_bound(key, s)[0])
                for key in ("K1", "K2", "K3")}
    for shape in shapes:
        t0 = time.perf_counter()
        rows = attention_rows(torch, F, fa, shape, g, dev,
                              [k for k, s in heaviest.items() if s is shape])
        for key, row in rows.items():
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["row_s"] = time.perf_counter() - t0
            results[key].append(row)
            print_row(key, row, card)
    print(f"backward pair [{card}]: {json.dumps(bwd_pair(results))}",
          flush=True)
    shapes = k4_shapes(serve_steps)
    # every path's K4 launches in k4_shapes, split by conv_design, are what
    # the launch checks hold the path's counted run to
    split = conv_split_by_path(shapes, fc.conv_design)
    want = path_k4(serve_steps)
    check(sorted(split) == sorted(want) and all(
        split[p] == capture_record(want[p]) for p in split),
        f"K4 by design in k4_shapes: {split}, the launch checks {want}")
    heaviest = max((s for s in shapes
                    if fc.conv_design(s[3], s[4]) == "sm90"),
                   key=lambda s: conv_bound(s)[0])
    for shape in shapes:
        t0 = time.perf_counter()
        row = k4_row(torch, F, fc, shape, g, dev, shape is heaviest)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["row_s"] = time.perf_counter() - t0
        results["K4"].append(row)
        print_row("K4", row, card)
    print(f"conv paths [{card}]: {json.dumps(conv_paths(results['K4']))}",
          flush=True)
    # the phase's seconds: the attention shapes' rows (K1 with K2 and K3
    # where the shape has them) and K4's
    print("kernels seconds: " + json.dumps({
        key: sum(r["row_s"] for r in results[key]) for key in ("K1", "K4")}),
        flush=True)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return results


def phase_slice(torch, dev, card, steps):
    import numpy as np
    from view_neti_tpu_torch.config import ModelConfig, RunConfig
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder

    t0 = time.perf_counter()
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
                                     compute_dtype=torch.bfloat16,
                                     calibration_dir=caldir, device=dev)
    vae = builder.fuse_for_inference(built.vae)
    sched = DPMSolverSchedule()
    torch.cuda.synchronize()
    print(f"slice: built SD-1.5 stack in {time.perf_counter() - t0:.1f} s",
          flush=True)
    seeds = [0, 1, 2]
    prompt = f"{view_tokens[0]}. A photo of a <skull>"

    def condition():
        pm = PromptManager(tok, built.text, sched.set_timesteps(steps),
                           built.placeholder_view_token_ids,
                           built.placeholder_object_token_ids)
        ctx, ctx_b = pm.embed_prompt(prompt)
        return ctx, ctx_b, pipeline.encode_uncond(built.text.clip, tok)

    # the counted run: the user's entry points, counts from 0. The denoise
    # loop and the decode are kept across runs, so that the second run of
    # their shapes captures each in a CUDA graph and later runs replay it
    launch_counts(reset=True)
    t0 = time.perf_counter()
    ctx, ctx_b, uncond = condition()

    def sampler(graph):
        return (pipeline.make_denoise_fn(built.unet, sched, steps, 7.5,
                                         torch.bfloat16, graph=graph),
                pipeline.make_decode_fn(vae, graph=graph))

    graphed, eager = sampler(True), sampler(False)

    def run(seed_offset, fns=graphed):
        return pipeline.generate(built.unet, vae, sched, ctx, ctx_b, uncond,
                                 HEIGHT, WIDTH,
                                 [s + seed_offset for s in seeds],
                                 num_inference_steps=steps,
                                 guidance_scale=7.5,
                                 compute_dtype=torch.bfloat16, device=dev,
                                 denoise_fn=fns[0], decode_fn=fns[1])

    imgs = run(0)
    first_s = time.perf_counter() - t0
    # the second run captures the loop and the decode, then replays them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(1)
    capture_run_s = time.perf_counter() - t0
    launches = launch_counts()
    check(imgs.shape == (3, HEIGHT, WIDTH, 3) and imgs.dtype == np.uint8,
          f"images {imgs.shape} {imgs.dtype}")
    check(imgs.min() != imgs.max(), "images are constant")
    want = {**unet_k1(2 * steps), **unet_bwd(0), **k4(decodes=2)}
    check(launches == want, f"serving launches in 2 runs {launches}, want "
                            f"{want} (no backward)")
    (loop_cap,), (dec_cap,) = (list(f.captures.values()) for f in graphed)
    check(loop_cap.launches == capture_record(unet_k1(steps))
          and loop_cap.replays == 1,
          f"the denoise graph's launches {loop_cap.launches}, replays "
          f"{loop_cap.replays}")
    check(dec_cap.launches == capture_record(k4(decodes=1))
          and dec_cap.replays == 1,
          f"the decode graph's launches {dec_cap.launches}")
    print(f"slice: first run {first_s:.2f} s, capture run "
          f"{capture_run_s:.2f} s, launches {launches}", flush=True)

    # sec/image as bench.py:_bench_infer counts it: three more rounds of
    # generate (new seeds, uint8 images copied to the host), over the
    # rounds times the seeds; the conditioning is outside the rounds. The
    # graphed rounds replay the two graphs; the eager ones launch every
    # kernel from the host (the kernels' libraries loaded in the graphed
    # warm-up above), and must give the same images bit for bit
    rounds = 3
    per_image, outs = {}, {}
    for name, fns in (("graphed", graphed), ("eager", eager)):
        outs[name] = []
        t0 = time.perf_counter()
        for r in range(2, rounds + 2):
            outs[name].append(run(r, fns))
        per_image[name] = (time.perf_counter() - t0) / (rounds * len(seeds))
    sec_per_image = per_image["graphed"]
    equal = all(np.array_equal(a, b)
                for a, b in zip(outs["graphed"], outs["eager"]))
    check(equal, "the graphed sampling runs differ from the eager ones")
    # the control: a replay whose inputs were not copied into the graph's
    # buffers gives an earlier call's images (here the last graphed
    # round's), which the check must tell from the first round's
    graphed[0].replay(loop_cap)
    stale = pipeline.decode_to_uint8(
        vae, loop_cap.out_tensors[0].to(torch.bfloat16)).cpu().numpy()
    stale_levels = float(np.abs(stale.astype(np.int32)
                                - outs["eager"][0].astype(np.int32)).mean())
    check(stale_levels > 1.0, f"a stale-buffer replay is within "
                              f"{stale_levels} mean levels of the eager run")
    graph_stats = dict(
        sec_per_image_graphed=per_image["graphed"],
        sec_per_image_eager=per_image["eager"],
        graphed_equals_eager=equal, stale_replay_mean_levels=stale_levels,
        loop_capture_s=loop_cap.capture_s,
        loop_pool_gib=loop_cap.pool_bytes / 2 ** 30,
        decode_capture_s=dec_cap.capture_s,
        decode_pool_gib=dec_cap.pool_bytes / 2 ** 30)
    print(f"slice graphs [{card}]: {json.dumps(graph_stats)}", flush=True)

    # one more run split by stage (the graphs' replays), with the final
    # latents checked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx, ctx_b, uncond = condition()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    denoise, decode = graphed
    lat0 = pipeline.initial_latents(seeds, HEIGHT // 8, WIDTH // 8, dev)
    lat = denoise(lat0, ctx, ctx_b, uncond)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    imgs2 = decode(lat.to(torch.bfloat16))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(bool(torch.isfinite(lat).all()), "final latents are not finite")
    check(tuple(imgs2.shape) == (3, HEIGHT, WIDTH, 3), "decode shape")
    stages = dict(steps=steps, conditioning_s=t1 - t0, denoise_s=t2 - t1,
                  decode_s=t3 - t2, sec_per_image=sec_per_image,
                  first_run_s=first_s, capture_run_s=capture_run_s,
                  latents_abs_max=lat.abs().max().item(), **graph_stats)
    print(f"slice [{card}]: {json.dumps(stages)}", flush=True)

    # the decode against the same weights built unfused (GroupNorm, SiLU
    # and cuDNN's conv, no K4): the two round differently, so the limit is
    # on the share of uint8 values within 2 levels of each other
    unfused = copy.deepcopy(vae)
    unfused.config = dataclasses.replace(vae.config, fuse_conv=False)
    imgs3 = pipeline.decode_to_uint8(unfused, lat.to(torch.bfloat16))
    within2 = ((imgs2.int() - imgs3.int()).abs() <= 2).float().mean().item()
    print(f"slice: fused decode within 2 levels of the unfused one: "
          f"{within2}", flush=True)
    check(within2 >= 0.999, f"the K4 decode disagrees with the unfused "
                            f"decode: {within2} within 2 levels")
    del unfused, imgs3
    stages["decode_within_2_of_unfused"] = within2

    # where the device time goes: one CFG denoise step (one UNet forward
    # at B = 6 and the solver update) as a graph replay and eagerly, and
    # one decode, under the profiler
    step1 = pipeline.make_denoise_fn(built.unet, sched, 1, 7.5,
                                     torch.bfloat16)
    step1_eager = pipeline.make_denoise_fn(built.unet, sched, 1, 7.5,
                                           torch.bfloat16, graph=False)
    for _ in range(2):      # the warm-up, then the capture
        step1(lat0, ctx, ctx_b, uncond)
    for what, fn in (
            ("denoise step graphed", lambda: step1(lat0, ctx, ctx_b, uncond)),
            ("denoise step", lambda: step1_eager(lat0, ctx, ctx_b, uncond)),
            ("decode", lambda: pipeline.decode_to_uint8(
                vae, lat.to(torch.bfloat16)))):
        prof = device_profile(torch, fn)
        stages[f"{what.replace(' ', '_')}_idle_share"] = (
            prof["idle_share"] if prof else None)
        print(f"profile {what} [{card}]: "
              f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    stages["fused_unet"] = slice_fused_unet(
        torch, dev, card, built, vae, sched, steps, seeds,
        (ctx, ctx_b, uncond), lat0, outs["graphed"], run)
    return launches, stages, built, tok


def cfg_unet_inputs(torch, lat0, ctx, ctx_b, uncond, t):
    """The UNet's inputs at one CFG step of pipeline.make_denoise_fn's
    loop: the latents twice (B = 2 N), the timestep t, and the
    unconditional contexts beside the prompt's, in bf16."""
    N, n_layers = lat0.shape[0], ctx.shape[1]
    reps = N // ctx.shape[2]
    u = uncond[None, :1].to(torch.bfloat16).expand(
        (n_layers, N) + tuple(uncond.shape[1:]))
    c, cb = (x[0].repeat_interleave(reps, dim=1).to(torch.bfloat16)
             for x in (ctx, ctx_b))
    return (torch.cat([lat0, lat0]).to(torch.bfloat16),
            torch.full((2 * N,), float(t), device=lat0.device),
            torch.cat([u, c], 1), torch.cat([u, cb], 1))


def slice_fused_unet(torch, dev, card, built, vae, sched, steps, seeds,
                     cond, lat0, unfused_imgs, run_unfused):
    """The fused-UNet serving path (BENCH_FUSE_UNET=1; builder.
    fuse_for_inference with the UNet) on the slice's weights: a view of
    the UNet that shares its parameters, fused. Its counted run (the eager
    warm-up and the capture, as the slice's) holds K4's launches by design
    (44 a forward, all on the Hopper design, and the decode's); graphed
    serving with the switch off and on, interleaved round by round; the
    graphed rounds bit-equal to an eager one, a stale-buffer replay the
    control; one UNet forward against the unfused one within
    FUSED_UNET_REL_LIMIT, which a planted fault must exceed; the loop's
    images against the unfused ones; one fused CFG step profiled graphed
    and eagerly, the weights' relayout (ops/conv.py conv3x3_hwio) a range
    of its own. Returns the stats, the counted launches under
    "launches"."""
    import numpy as np
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.models import unet as unet_mod
    from view_neti_tpu_torch.ops import conv as conv_ops
    from view_neti_tpu_torch.training import builder

    ctx, ctx_b, uncond = cond
    unet = copy.copy(built.unet)
    builder.fuse_for_inference(vae, unet=unet)
    check(unet.config.fuse_conv and not built.unet.config.fuse_conv,
          "fuse_for_inference did not fuse the UNet's view alone")

    def sampler(graph):
        return (pipeline.make_denoise_fn(unet, sched, steps, 7.5,
                                         torch.bfloat16, graph=graph),
                pipeline.make_decode_fn(vae, graph=graph))

    graphed, eager = sampler(True), sampler(False)

    def run(seed_offset, fns=graphed):
        return pipeline.generate(unet, vae, sched, ctx, ctx_b, uncond,
                                 HEIGHT, WIDTH,
                                 [s + seed_offset for s in seeds],
                                 num_inference_steps=steps,
                                 guidance_scale=7.5,
                                 compute_dtype=torch.bfloat16, device=dev,
                                 denoise_fn=fns[0], decode_fn=fns[1])

    launch_counts(reset=True)
    t0 = time.perf_counter()
    run(0)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(1)
    capture_run_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {**unet_k1(2 * steps), **unet_bwd(0),
            **add_counts(k4(decodes=2), k4_unet(2 * steps))}
    check(launches == want, f"fused serving launches in 2 runs {launches}, "
                            f"want {want}")
    (loop_cap,), (dec_cap,) = (list(f.captures.values()) for f in graphed)
    check(loop_cap.launches == capture_record(
        add_counts(unet_k1(steps), k4_unet(steps))),
        f"the fused denoise graph's launches {loop_cap.launches}")
    check(dec_cap.launches == capture_record(k4(decodes=1)),
          f"the fused decode graph's launches {dec_cap.launches}")

    # sec/image with the switch off and on, their graphed rounds
    # interleaved (off, on) so that both see the same card
    rounds = 3
    secs = {"off": 0.0, "on": 0.0}
    imgs = []
    for r in range(2, rounds + 2):
        for name, fn in (("off", run_unfused), ("on", run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(r)
            secs[name] += time.perf_counter() - t0
            if name == "on":
                imgs.append(out)
    per_image = {k: v / (rounds * len(seeds)) for k, v in secs.items()}
    eager_imgs = run(2, eager)
    equal = np.array_equal(imgs[0], eager_imgs)
    check(equal, "the fused graphed sampling run differs from the eager one")
    graphed[0].replay(loop_cap)
    stale = pipeline.decode_to_uint8(
        vae, loop_cap.out_tensors[0].to(torch.bfloat16)).cpu().numpy()
    stale_levels = float(np.abs(stale.astype(np.int32)
                                - eager_imgs.astype(np.int32)).mean())
    check(stale_levels > 1.0, f"a stale fused replay is within "
                              f"{stale_levels} mean levels of the eager run")

    # the loop's images, fused against unfused, the same seeds
    diff = np.abs(np.stack(imgs).astype(np.int32)
                  - np.stack(unfused_imgs).astype(np.int32))
    within = float((diff <= FUSED_LEVELS).mean())
    images = dict(mean_levels=float(diff.mean()), max_levels=int(diff.max()),
                  within_2=float((diff <= 2).mean()),
                  within_limit=within)
    check(within >= FUSED_WITHIN_SHARE,
          f"the fused loop's images: {within} within {FUSED_LEVELS} levels "
          f"of the unfused ones, want {FUSED_WITHIN_SHARE}")

    # one UNet forward, fused against unfused, and the planted fault
    inputs = cfg_unet_inputs(torch, lat0, ctx, ctx_b, uncond,
                             sched.set_timesteps(steps)[0])
    fused_conv3x3 = unet_mod.fused_affine_silu_conv3x3

    def dropped_last_residual(*args, **kwargs):
        # the 22nd section with a residual is the last block's conv2
        if kwargs.get("residual") is not None:
            seen[0] += 1
            if seen[0] == 22:
                kwargs["residual"] = None
        return fused_conv3x3(*args, **kwargs)

    with torch.no_grad():
        want_eps = built.unet(*inputs).float()
        got = unet(*inputs).float()
        seen = [0]
        unet_mod.fused_affine_silu_conv3x3 = dropped_last_residual
        try:
            fault = unet(*inputs).float()
        finally:
            unet_mod.fused_affine_silu_conv3x3 = fused_conv3x3
    check(seen[0] == 22, f"{seen[0]} fused sections with a residual in a "
                         f"forward, want 22")

    def rel(x):
        return ((x - want_eps).square().mean().sqrt()
                / want_eps.square().mean().sqrt()).item()

    forward = dict(rel_rms=rel(got), fault_rel_rms=rel(fault),
                   max_abs=(got - want_eps).abs().max().item(),
                   limit=FUSED_UNET_REL_LIMIT,
                   finite=bool(torch.isfinite(got).all()))
    check(forward["finite"] and forward["rel_rms"] <= FUSED_UNET_REL_LIMIT,
          f"the fused UNet's forward against the unfused one: {forward}")
    check(forward["fault_rel_rms"] > FUSED_UNET_REL_LIMIT,
          f"the limit misses the dropped residual: {forward}")
    del want_eps, got, fault

    # one fused CFG step: graphed, by kernel group; eagerly, with the
    # weights' relayout under a range of its own
    step1 = pipeline.make_denoise_fn(unet, sched, 1, 7.5, torch.bfloat16)
    step1_eager = pipeline.make_denoise_fn(unet, sched, 1, 7.5,
                                           torch.bfloat16, graph=False)
    for _ in range(2):      # the warm-up, then the capture
        step1(lat0, ctx, ctx_b, uncond)

    def hwio(conv):
        with torch.profiler.record_function("conv3x3_hwio"):
            return conv_ops.conv3x3_hwio(conv)

    prof = {"graphed": device_profile(
        torch, lambda: step1(lat0, ctx, ctx_b, uncond))}
    unet_mod.conv3x3_hwio = hwio
    try:
        prof["eager"] = device_profile(
            torch, lambda: step1_eager(lat0, ctx, ctx_b, uncond),
            ranges=("conv3x3_hwio",))
    finally:
        unet_mod.conv3x3_hwio = conv_ops.conv3x3_hwio
    for what, p in prof.items():
        print(f"profile fused denoise step {what} [{card}]: "
              f"{json.dumps(p) if p else 'not measured'}", flush=True)
    relayout = None
    if prof["graphed"] and prof["eager"]:
        ms = prof["eager"]["by_group_ms"].get("conv3x3_hwio", 0.0)
        relayout = dict(ms=ms, launches=prof["eager"]["launches_by_range"]
                        .get("conv3x3_hwio", 0),
                        share_of_graphed_busy=ms / prof["graphed"]["busy_ms"])
    stats = dict(sec_per_image_off=per_image["off"],
                 sec_per_image_on=per_image["on"],
                 on_over_off=per_image["on"] / per_image["off"],
                 first_run_s=first_s, capture_run_s=capture_run_s,
                 graphed_equals_eager=equal,
                 stale_replay_mean_levels=stale_levels,
                 loop_capture_s=loop_cap.capture_s,
                 loop_pool_gib=loop_cap.pool_bytes / 2 ** 30,
                 forward=forward, images=images, relayout=relayout,
                 step_idle_share=(prof["graphed"]["idle_share"]
                                  if prof["graphed"] else None))
    print(f"slice fused unet [{card}]: {json.dumps(stats)}", flush=True)
    stats["launches"] = launches
    return stats


def phase_train(torch, dev, card, built, tok, steps):
    """The mode-2 train step of bench.py:main at full width: B = 9, 384x512
    pixels uniform in [-1, 1], bf16 frozen weights, fp32 mappers, the
    sliced AdamW at scaled_learning_rate(1e-3, True, 9, 3, 1), constant."""
    from view_neti_tpu_torch.training import builder, optim
    from view_neti_tpu_torch.training import train_step as ts
    from view_neti_tpu_torch.training.text_forward import \
        neti_text_conditioning

    B, cd = TRAIN_BATCH, torch.bfloat16
    builder.fuse_vae_for_training(built.vae)
    groups = builder.trainable_groups(built)
    mappers = {"object": built.text.obj_mappers[0],
               "view": built.text.view_mapper}
    lr = optim.scaled_learning_rate(1e-3, True, B, 3, 1)
    opt = optim.SlicedAdamW(groups, optim.make_lr_schedule("constant", lr,
                                                           0, 3000))
    step = ts.make_train_step(opt, compute_dtype=cd)

    # the batch of bench.py: BOS, view token, filler, object token, EOS
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
        pixel_values=torch.rand(B, TRAIN_HEIGHT, TRAIN_WIDTH, 3,
                                generator=g, device=dev) * 2 - 1,
        input_ids=ids.to(dev),
        input_ids_placeholder_object=torch.full((B,), obj_id, device=dev),
        input_ids_placeholder_view=torch.full((B,), view_id, device=dev))

    def run_step():
        return step(built, batch, ts.sample_step_draws(g, built, batch))

    # the counted run: 2 warm-up steps and the timed steps, counts from 0
    start = {key: [p.detach().clone() for p in m.parameters()]
             for key, m in mappers.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    losses = [run_step()["total_loss"] for _ in range(2)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses += [run_step()["total_loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n = 2 + steps
    want = {k: v * n for k, v in SD15_STEP.items()}
    check(launches == want, f"train launches {launches}, want {want}")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    moved = {}
    for key, m in mappers.items():
        grads = [p.grad for p in m.parameters()]
        check(all(gr is not None and bool(torch.isfinite(gr).all())
                  for gr in grads), f"{key} mapper gradient missing or "
                                    f"not finite")
        check(sum(gr.abs().sum().item() for gr in grads) > 0,
              f"{key} mapper gradient is zero")
        delta = torch.cat([(p.detach() - p0).abs().flatten()
                           for p, p0 in zip(m.parameters(), start[key])])
        check(delta.max().item() > 0, f"{key} mapper did not move")
        moved[key] = delta.median().item() / (lr * n)
    ms_step = (t2 - t1) * 1e3 / steps
    result = dict(batch=B, height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
                  timed_steps=steps, ms_per_step=ms_step,
                  imgs_per_sec=B * 1e3 / ms_step,
                  warmup_s=t1 - t0, peak_memory_gib=peak_gb,
                  losses=losses, median_move_of_lr_per_step=moved,
                  launches=launches)
    print(f"train [{card}]: {json.dumps(result)}", flush=True)

    # the kernels' gradient descends: with the draws held fixed, the loss
    # along -g changes by eps |g|^2 (central difference, eps sized for a
    # change of 1e-3 of the loss: smaller steps drown in the bf16 rounding
    # of the forward, larger ones leave its linear range); the limit is a
    # factor of 2 on the slope
    params = [p for m in mappers.values() for p in m.parameters()]
    draws = ts.sample_step_draws(g, built, batch)
    latents = ts.encode_latents(built, batch, draws, cd)
    opt.zero_grad()
    loss = ts.diffusion_loss(built, batch, draws, latents, cd)
    loss.backward()
    grad = [p.grad.detach().clone() for p in params]
    theta = [p.detach().clone() for p in params]
    loss = loss.detach().item()
    gg = sum(float(x.double().square().sum()) for x in grad)
    eps = 1e-3 * loss / gg

    @torch.no_grad()
    def loss_at(sign):
        for p, t, gr in zip(params, theta, grad):
            p.copy_(t + sign * eps * gr)
        return float(ts.diffusion_loss(built, batch, draws, latents, cd))

    lower, upper = loss_at(-1), loss_at(+1)
    with torch.no_grad():
        for p, t in zip(params, theta):
            p.copy_(t)
    slope = (upper - lower) / (2 * eps)
    descent = dict(loss=loss, eps=eps, grad_sq=gg,
                   loss_minus=lower, loss_plus=upper,
                   slope_of_grad_sq=slope / gg)
    print(f"train descent [{card}]: {json.dumps(descent)}", flush=True)
    check(lower < loss < upper and 0.5 <= slope / gg <= 2,
          f"the kernels' gradient does not match the loss's slope: "
          f"{descent}")
    result["descent"] = descent

    # one step split by stage
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = ts.sample_step_draws(g, built, batch)
    latents = ts.encode_latents(built, batch, draws, cd)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx, ctx_b = neti_text_conditioning(
        built.text, batch.input_ids, batch.input_ids_placeholder_object,
        batch.input_ids_placeholder_view, draws.timesteps, train=True,
        draws=draws.dropout)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sched = built.schedule
    noisy = sched.add_noise(latents, draws.noise, draws.timesteps)
    target = sched.target(latents, draws.noise, draws.timesteps)
    pred = built.unet(noisy.to(cd), draws.timesteps, ctx.to(cd),
                      ctx_b.to(cd))
    loss = torch.mean((pred.float() - target) ** 2)
    opt.zero_grad()
    loss.backward()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    stages = dict(encode_ms=(t1 - t0) * 1e3, conditioning_ms=(t2 - t1) * 1e3,
                  unet_fwd_and_backward_ms=(t3 - t2) * 1e3,
                  optimizer_ms=(t4 - t3) * 1e3)
    print(f"train stages [{card}]: {json.dumps(stages)}", flush=True)
    result["stages"] = stages
    del ctx, ctx_b, pred, loss

    prof = device_profile(torch, run_step)
    print(f"profile train step [{card}]: "
          f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    result["profile"] = prof
    return launches, result


def write_scan(root, image_io, dtu, np, cams=None, masks=False):
    """bench.py:_bench_e2e's synthetic DTU scan: 64 random cal18 matrices
    and the six dtu_subset-6 cameras (or `cams`) at 1600x1200, pixels from
    RandomState(0) in the bench's order, written by the port's PNG writer
    with the rows' filters cycling through all five types, in 8 threads.
    masks: an IDR object mask per camera too (idrmasks/scan114/mask/, an
    ellipse of seeded centre and radii). Returns (scan, calibration, masks
    root, image paths)."""
    from concurrent.futures import ThreadPoolExecutor
    rect = os.path.join(root, "dtu", "Rectified", "scan114")
    cal = os.path.join(root, "dtu", "Calibration", "cal18")
    mask_dir = os.path.join(root, "dtu", "idrmasks", "scan114", "mask")
    os.makedirs(rect)
    os.makedirs(cal)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        with open(os.path.join(cal, f"pos_{i:03d}.txt"), "w") as f:
            f.write("\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    jobs = []
    for i in (dtu.dtu_get_train_idxs(6) if cams is None else cams):
        jobs.append((os.path.join(rect, f"rect_{i + 1:03d}_3_r5000.png"),
                     rng.randint(0, 255, (1200, 1600, 3), np.uint8)))
    if masks:
        os.makedirs(mask_dir)
        yy, xx = np.mgrid[0:1200, 0:1600]
        for i in cams:
            cy, cx, ry, rx = rng.uniform((400, 500, 200, 300),
                                         (800, 1100, 500, 700))
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            jobs.append((os.path.join(mask_dir, f"{i:03d}.png"),
                         (inside * 255).astype(np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(image_io.write_png, path, img)
                  for path, img in jobs]:
            f.result()
    paths = [p for p, _ in jobs if p.startswith(rect)]
    return rect, cal, os.path.dirname(os.path.dirname(mask_dir)), paths


def mode2_config(rect, exp_dir, **changes):
    """bench.py:_bench_e2e's mode-2 recipe at full SD-1.5 width (coach
    phase), DTU preprocess 1: 512x384 training, 768x576 evaluation."""
    from view_neti_tpu_torch.config import RunConfig, decode
    data = {
        "learnable_mode": 2,
        "model": {"arch_view_net": 15, "arch_view_disable_tl": False,
                  "word_embedding_dim": 768,
                  "pretrained_model_name_or_path":
                      "runwayml/stable-diffusion-v1-5",
                  "normalize_view_mapper_output": True,
                  "output_bypass_alpha_view": 5.0, "pe_sigma_exp_key": 2},
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6,
                 "dtu_preprocess_key": 1, "repeats": 100,
                 "train_data_dir": rect, "augmentation_key": 7},
        "log": {"exp_dir": exp_dir, "save_dataset_images": False,
                "save_steps": 10 ** 9, "report_to": "none"},
        "eval": {"validation_prompts": None},
        "optim": {"mixed_precision": "bf16", "fuse_accumulation": True}}
    for section, values in changes.items():
        data[section].update(values)
    return decode(RunConfig, data)


COACH_SAVE_STEPS = 10    # a save boundary that cuts the third 4-step window
COACH_WINDOW = 4         # optim.steps_per_dispatch 0 with the base cache


def coach_files(run_dir):
    """{relative path: bytes} of a run's checkpoints and train states; a
    mapper file's bytes without its saved config, which names the run's
    directory and its dispatch window."""
    from view_neti_tpu_torch.utils import msgpack_codec
    out = {}
    for base, _, names in os.walk(run_dir):
        for name in names:
            if name.endswith(".msgpack"):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    data = f.read()
                payload = msgpack_codec.unpackb(data)
                if isinstance(payload, dict) and "cfg" in payload:
                    data = msgpack_codec.packb(
                        {k: v for k, v in payload.items() if k != "cfg"})
                out[os.path.relpath(path, run_dir)] = data
    return out


def coach_trace(torch, dev, card, cfg, cal, trace_dir, warm, steps,
                untraced):
    """The coach phase's graphed run again, under the Coach's
    VIEW_NETI_TRACE_DIR (utils/profiling.trace: torch.profiler around the
    train loop, the window's graph captured under it): the losses,
    optimizer counts, mappers, launches and checkpoint files must equal the
    untraced run's bit for bit, and the one trace file must parse and hold
    kernels of K1, K2, K3 and K4. Returns the `coach trace` line's stats:
    ms a step beside the untraced run's (the loop up to its last metrics;
    the trace's write after it is write_s), the file's MB, and the kernels
    of each group in the trace against the run's launches (a graph replay
    whose kernels the profiler records one by one adds its whole record)."""
    import contextlib
    import glob
    from view_neti_tpu_torch.bench import SyncAfter
    from view_neti_tpu_torch.training import coach as coach_lib

    t_run = time.perf_counter()
    coach = coach_lib.Coach(cfg, calibration_dir=cal, device=dev)
    timed = SyncAfter(coach, warm)
    marks, real_trace = {}, coach_lib.trace

    @contextlib.contextmanager
    def marked(logdir):
        check(logdir == trace_dir, f"the Coach traced into {logdir}")
        with real_trace(logdir):
            yield
            marks["loop_end"] = time.perf_counter()
        marks["written"] = time.perf_counter()

    launch_counts(reset=True)
    coach_lib.trace = marked
    os.environ["VIEW_NETI_TRACE_DIR"] = trace_dir
    try:
        coach.train()
    finally:
        del os.environ["VIEW_NETI_TRACE_DIR"]
        coach_lib.trace = real_trace
    launches = launch_counts()
    check(not torch.autograd.profiler._is_profiler_enabled,
          "the Coach left its profiler open")
    traced_ms = (marks["loop_end"] - timed.at) * 1e3 / steps
    del timed
    check(launches == untraced["launches"],
          f"traced launches {launches} != {untraced['launches']}")
    check(coach.losses == untraced["losses"],
          f"traced losses {coach.losses} != {untraced['losses']}")
    check(coach.optimizer.counts == untraced["counts"],
          f"traced counts {coach.optimizer.counts}")
    mappers = mapper_state(coach)
    mapper_diff = max((mappers[k].float() - v.float()).abs().max().item()
                      for k, v in untraced["mappers"].items())
    check(mappers.keys() == untraced["mappers"].keys() and mapper_diff == 0,
          f"traced mappers differ by {mapper_diff}")
    files = coach_files(cfg.log.exp_dir)
    check(sorted(files) == sorted(untraced["files"]) and all(
        files[k] == v for k, v in untraced["files"].items()),
        "the traced run's checkpoint files differ")
    del coach
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(paths) == 1 and os.listdir(trace_dir) == [
        os.path.basename(p) for p in paths],
        f"trace files {os.listdir(trace_dir)}")
    t0 = time.perf_counter()
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    parse_s = time.perf_counter() - t0
    # the Hopper designs' kernels of K1-K4, by name
    sm90_names = {"K1": "flash_fwd_kernel_sm90",
                  "K2": "flash_bwd_dq_kernel_sm90",
                  "K3": "flash_bwd_dkv_kernel_sm90",
                  "K4": "fused_conv_kernel_sm90"}
    kernels, graph_launches, sm90 = {}, 0, dict.fromkeys(sm90_names, 0)
    for e in events:
        if e.get("cat") == "kernel":
            g = kernel_group(e.get("name", ""))
            kernels[g] = kernels.get(g, 0) + 1
            for key, name in sm90_names.items():
                sm90[key] += name in e.get("name", "")
        elif e.get("name") == "cudaGraphLaunch":
            graph_launches += 1
    in_trace = {k: kernels.get(kernel_group(name), 0) for k, name in (
        ("K1", "flash_fwd_kernel"), ("K2", "flash_bwd_dq_kernel"),
        ("K3", "flash_bwd_dkv"), ("K4", "fused_conv_kernel"))}
    for key, n_sm90 in sm90.items():
        in_trace.update({f"{key} sm90": n_sm90,
                         f"{key} mma_sync": in_trace[key] - n_sm90})
    n = len(untraced["losses"])
    per_step = {k: v // n for k, v in launches.items()}
    # the warm-up step runs eagerly under the trace: at least its kernels.
    # K3's group holds its split reduction's launches too
    check(all(in_trace[k] >= per_step[k] for k in per_step),
          f"the trace holds {in_trace} kernels of K1-K4, want at least one "
          f"step's {per_step}")
    stats = dict(
        steps=n, timed_steps=steps,
        traced_ms_per_step=traced_ms, untraced_ms_per_step=untraced["ms"],
        traced_over_untraced=traced_ms / untraced["ms"],
        write_s=marks["written"] - marks["loop_end"], parse_s=parse_s,
        trace_mb=os.path.getsize(paths[0]) / 2 ** 20, events=len(events),
        kernels_in_trace=sum(kernels.values()), k1_k4_in_trace=in_trace,
        launches=launches, graph_launches_in_trace=graph_launches,
        replays_traced_kernel_by_kernel=all(
            in_trace[k] >= launches[k] for k in ("K1", "K2", "K4")),
        losses_equal=True, mapper_max_abs_diff=mapper_diff,
        run_s=time.perf_counter() - t_run)
    print(f"coach trace [{card}]: {json.dumps(stats)}", flush=True)
    return stats


def phase_coach(torch, dev, card, train_result, steps):
    """The Coach of view_neti_tpu_torch.train on the recipe of
    bench.py:_bench_e2e (bench.py:394-432), at full width: its default
    dispatch windows (4 optimizer steps, each a CUDA graph replay) with a
    save boundary inside a window and the train state requested, then the
    same run with optim.steps_per_dispatch 1 (every step eager), which must
    give the same losses, mappers, optimizer counts and checkpoint bytes."""
    import numpy as np
    from view_neti_tpu_torch import weight_port
    from view_neti_tpu_torch.bench import SyncAfter
    from view_neti_tpu_torch.checkpoint import CheckpointHandler
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.data.dataset import DataLoader
    from view_neti_tpu_torch.ops import device_augment as da
    from view_neti_tpu_torch.training.coach import Coach

    warm, B = 2, TRAIN_BATCH
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rect, cal, _, paths = write_scan(root, image_io, dtu, np)
        write_s = time.perf_counter() - t0
        log = {"save_steps": COACH_SAVE_STEPS,
               "checkpoint_backend": "orbax"}
        cfg = mode2_config(rect, os.path.join(root, "run"), log=log,
                           optim={"max_train_steps": warm + steps})
        t0 = time.perf_counter()
        coach = Coach(cfg, calibration_dir=cal, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(coach.micro_batch_size == B and coach.use_pixel_cache
              and coach.augment_spec == da.from_augmentation_key(7),
              "the Coach did not take the fused, cached, preset-7 path")
        check(coach.steps_per_dispatch == COACH_WINDOW
              and coach.window_step.enabled,
              f"the Coach's window is {coach.steps_per_dispatch} steps, "
              f"graphed: {coach.window_step.enabled}")

        # the counted run: the user's entry point, counts from 0
        timed = SyncAfter(coach, warm)
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        result = coach.train()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # the graphs' private pools are reserved, not allocated
        reserved_gb = torch.cuda.max_memory_reserved() / 2 ** 30
        n = coach.global_step
        per_step = SD15_STEP
        check(n == warm + steps, f"the Coach ran {n} steps")
        check(launches == {k: v * n for k, v in per_step.items()},
              f"coach launches {launches} over {n} steps, want "
              f"{per_step} a step as the train phase")
        check(train_result["launches"] == {
            k: v * (2 + train_result["timed_steps"])
            for k, v in per_step.items()}, "train launches")
        losses = coach.losses
        check(len(losses) == n and all(math.isfinite(x) for x in losses),
              f"coach losses {losses}")
        (cap,) = coach.window_step.captures.values()
        check(cap.launches == capture_record(per_step)
              and cap.replays == n - 1,
              f"the train step's graph launches {cap.launches} over "
              f"{cap.replays} replays, want {per_step} over {n - 1}")
        ms_step = (coach.loop_end_s - timed.at) * 1e3 / steps
        del timed   # it holds the Coach, which is freed below
        raw_ms = train_result["ms_per_step"]
        graphed = dict(losses=list(losses), counts=coach.optimizer.counts,
                       mappers=mapper_state(coach),
                       files=coach_files(cfg.log.exp_dir))

        # the bases on the card against a fresh decode and resize on the CPU
        ds = coach.train_dataset
        cache = coach.built.pixel_cache.cpu().numpy()
        decode_ms, resize_ms, fresh = [], [], []
        for p in ds.image_paths_flattened:
            t0 = time.perf_counter()
            img = image_io.read_rgb(p)
            t1 = time.perf_counter()
            fresh.append(ds._base_image(img))
            t2 = time.perf_counter()
            decode_ms.append((t1 - t0) * 1e3)
            resize_ms.append((t2 - t1) * 1e3)
        check(cache.shape == (6, TRAIN_HEIGHT, TRAIN_WIDTH, 3)
              and np.array_equal(cache, np.stack(fresh)),
              "the base cache on the card differs from the CPU decode")

        # the saved mappers reload bit for bit
        run_dir = cfg.log.exp_dir
        for key, module in (("view", coach.built.text.view_mapper),
                            ("object", coach.built.text.obj_mappers[0])):
            _, payload = CheckpointHandler.load_mapper(
                os.path.join(run_dir, f"mapper-final_{key}.msgpack"))
            entry = payload["mappers"][
                "view" if key == "view" else coach.placeholder_object_tokens[0]]
            saved = weight_port.from_jax_mapper(entry["params"],
                                                entry["constants"])
            live = module.state_dict()
            check(saved.keys() == live.keys() and all(
                torch.equal(saved[k], live[k].cpu()) for k in live),
                f"mapper-final_{key}.msgpack differs from the live mapper")

        # the augmentation on the card against its CPU run: draws sampled
        # on the card, the same bases
        spec = coach.augment_spec
        idx = torch.arange(B, device=dev) % cache.shape[0]
        bases = coach.built.pixel_cache[idx]
        g = torch.Generator(dev).manual_seed(1)
        draws = da.sample_augment_draws(g, spec, B, TRAIN_HEIGHT,
                                       TRAIN_WIDTH)
        got = da.augment_batch(spec, draws, bases)
        want = da.augment_batch(spec, draws.to("cpu"), bases.cpu())
        aug_err = (got.cpu() - want).abs().max().item()
        check(aug_err <= 1e-4, f"the augmentation on the card differs from "
                               f"its CPU run by {aug_err}")
        aug_ms = time_ms(torch, lambda: da.augment_batch(spec, draws, bases))
        aug_prof = device_profile(torch, lambda: da.augment_batch(
            spec, draws, bases))

        # one more Coach step under the profiler, the augmentation's
        # kernels in a group of their own
        batch = coach._build_batch(next(iter(DataLoader(ds, B))))

        def one_step():
            coach.train_step(coach.built, batch,
                             coach._step_draws(10 ** 6, batch))

        def one_replay():
            coach.window_step([batch], [coach._step_draws(10 ** 6, batch)])

        prof = device_profile(torch, augment_ranged(one_step),
                              ranges=("device_augment",))
        prof_graphed = device_profile(torch, one_replay)
        capture = dict(capture_s=cap.capture_s,
                       pool_gib=cap.pool_bytes / 2 ** 30)
        cache_fill_s = coach.cache_fill_s
        timer_rejected = coach.last_step_timer.rejected_total
        del coach, batch, cap
        import gc
        gc.collect()
        torch.cuda.empty_cache()

        # the same run with every step eager: the same losses, mappers,
        # counts and files, bit for bit
        cfg_eager = mode2_config(
            rect, os.path.join(root, "run_eager"), log=log,
            optim={"max_train_steps": warm + steps, "steps_per_dispatch": 1})
        eager = Coach(cfg_eager, calibration_dir=cal, device=dev)
        check(eager.steps_per_dispatch == 1 and not eager.window_step.enabled,
              "the eager Coach took a window")
        etimed = SyncAfter(eager, warm)
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        eager.train()
        eager_launches = launch_counts()
        eager_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        eager_reserved_gb = torch.cuda.max_memory_reserved() / 2 ** 30
        check(eager_launches == launches, f"eager launches {eager_launches}")
        eager_ms = (eager.loop_end_s - etimed.at) * 1e3 / steps
        del etimed
        efiles = coach_files(cfg_eager.log.exp_dir)
        emappers = mapper_state(eager)
        check(eager.losses == graphed["losses"],
              f"graphed losses {graphed['losses']} != eager {eager.losses}")
        check(eager.optimizer.counts == graphed["counts"],
              f"counts {graphed['counts']} != {eager.optimizer.counts}")
        mapper_diff = max((emappers[k].float() - v.float()).abs().max().item()
                          for k, v in graphed["mappers"].items())
        check(emappers.keys() == graphed["mappers"].keys()
              and mapper_diff == 0, f"mappers differ by {mapper_diff}")
        check(sorted(efiles) == sorted(graphed["files"])
              and all(efiles[k] == v for k, v in graphed["files"].items()),
              f"checkpoint files differ: {sorted(graphed['files'])} / "
              f"{[k for k in efiles if efiles[k] != graphed['files'].get(k)]}")
        ebatch = eager._build_batch(next(iter(DataLoader(
            eager.train_dataset, B))))
        prof_eager = device_profile(torch, lambda: eager.train_step(
            eager.built, ebatch, eager._step_draws(10 ** 6, ebatch)))
        del eager, ebatch
        gc.collect()
        torch.cuda.empty_cache()
        cfg_traced = mode2_config(
            rect, os.path.join(root, "run_traced"), log=log,
            optim={"max_train_steps": warm + steps})
        trace_stats = coach_trace(
            torch, dev, card, cfg_traced, cal, os.path.join(root, "trace"),
            warm, steps, dict(graphed, launches=launches, ms=ms_step))
        gc.collect()
        torch.cuda.empty_cache()
        window = dict(
            steps_per_dispatch=COACH_WINDOW, save_steps=COACH_SAVE_STEPS,
            graphed_ms_per_step=ms_step, eager_ms_per_step=eager_ms,
            graphed_imgs_per_sec=B * 1e3 / ms_step,
            eager_imgs_per_sec=B * 1e3 / eager_ms,
            graphed_idle_share=(prof_graphed["idle_share"]
                                if prof_graphed else None),
            eager_idle_share=prof_eager["idle_share"] if prof_eager else None,
            graphed_step_kernels=(prof_graphed["kernels"]
                                  if prof_graphed else None),
            graphed_peak_memory_gib=peak_gb,
            eager_peak_memory_gib=eager_peak_gb,
            graphed_peak_reserved_gib=reserved_gb,
            eager_peak_reserved_gib=eager_reserved_gb,
            checkpoint_files=sorted(efiles), losses_equal=True,
            mapper_max_abs_diff=mapper_diff, **capture)
        print(f"coach window [{card}]: {json.dumps(window)}", flush=True)
    stats = dict(
        batch=B, height=TRAIN_HEIGHT, width=TRAIN_WIDTH, warmup_steps=warm, timed_steps=steps,
        imgs_per_sec=B * 1e3 / ms_step, ms_per_step=ms_step,
        raw_step_ms_per_step=raw_ms, ms_ratio_to_raw_step=ms_step / raw_ms,
        peak_memory_gib=peak_gb,
        write_scan_s=write_s, build_s=build_s, train_s=train_s,
        cache_fill_s=cache_fill_s,
        decode_ms_per_image=float(np.median(decode_ms)),
        resize_ms_per_image=float(np.median(resize_ms)),
        augment_ms=aug_ms,
        augment_launches=aug_prof["kernels"] if aug_prof else None,
        augment_busy_ms=aug_prof["busy_ms"] if aug_prof else None,
        augment_max_abs_err_card_vs_cpu=aug_err,
        launches_per_step={k: v / n for k, v in launches.items()},
        losses=losses, final_loss=result["final_loss"],
        timer_rejected=timer_rejected, window=window, trace=trace_stats)
    print(f"coach [{card}]: {json.dumps(stats)}", flush=True)
    print(f"profile coach step [{card}]: "
          f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    stats["profile"] = prof
    return launches, stats


def phase_weights(torch, dev, card, rect, cal):
    """SD-1.5 read from disk: a seeded stack (seed 1) written in the
    diffusers layout (unet/, vae/, text_encoder/; the CLIP table without
    its headroom rows) by the port's safetensors writer, in the dtypes the
    stack holds, under build/ (returned; main deletes it after the
    acceptance phase); a Coach (seed 0) given weights_dir. Every
    PortReport clean, every loaded parameter equal to the written one,
    the placeholders' rows the loaded super-category rows, and one UNet
    forward of the loaded stack bit-equal to the written stack's."""
    from view_neti_tpu_torch.config import ModelConfig, RunConfig
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.utils import safetensors_io

    arch = builder.resolve_arch("sd-1.5", 768)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_sd_weights")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    mem = builder.build_models(
        RunConfig(seed=1, model=ModelConfig(word_embedding_dim=768)),
        FallbackTokenizer(base_vocab_size=arch.text.vocab_size), [],
        ["<skull>"], arch=arch,
        compute_dtype=torch.bfloat16, device=dev)
    files = {"unet": (mem.unet, "unet/diffusion_pytorch_model.safetensors"),
             "vae": (mem.vae, "vae/diffusion_pytorch_model.safetensors"),
             "clip": (mem.text.clip, "text_encoder/model.safetensors")}
    table_key = "text_model.embeddings.token_embedding.weight"
    written = {}
    for name, (module, rel) in files.items():
        sd = dict(module.state_dict())
        if name == "clip":
            sd[table_key] = sd[table_key][:arch.text.vocab_size]
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        safetensors_io.save_file(sd, path)
        written[name] = sd
    nbytes = sum(os.path.getsize(os.path.join(root, rel))
                 for _, rel in files.values())
    write_s = time.perf_counter() - t0
    dtypes = sorted({str(v.dtype) for sd in written.values()
                     for v in sd.values()})

    with tempfile.TemporaryDirectory() as exp:
        # the counted run: the user's entry point and one UNet forward of
        # each stack, counts from 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        coach = Coach(mode2_config(rect, exp), calibration_dir=cal,
                      weights_dir=root, device=dev)
        torch.cuda.synchronize()
        coach_s = time.perf_counter() - t0
        log = open(os.path.join(exp, "logs", "log.txt")).read()
        g = torch.Generator(dev).manual_seed(0)
        lat = torch.randn(SWEEP_BATCH, HEIGHT // 8, WIDTH // 8, 4,
                          generator=g, device=dev).bfloat16()
        t = torch.tensor([999.0, 999.0, 500.0, 500.0], device=dev)
        ctx = torch.randn(16, SWEEP_BATCH, 77, 768, generator=g,
                          device=dev).bfloat16()
        with torch.no_grad():
            out_loaded = coach.built.unet(lat, t, ctx, ctx)
            out_mem = mem.unet(lat, t, ctx, ctx)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # the load alone, again on the same Coach (the files are in the
        # page cache either way)
        t0 = time.perf_counter()
        coach._load_pretrained_weights(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for name in ("unet", "vae", "clip"):
        check(re.search(rf"{name}: ported \d+ tensors \(\d+ optional "
                        rf"absent\)\n", log) is not None,
              f"the {name} PortReport is not clean: {log[-2000:]}")
    built = coach.built
    worst = 0.0
    for name, module in (("unet", built.unet), ("vae", built.vae),
                         ("clip", built.text.clip)):
        got = module.state_dict()
        check(got.keys() == written[name].keys(), f"{name} keys differ")
        for k, v in written[name].items():
            mine = got[k][:v.shape[0]] if k == table_key else got[k]
            check(mine.dtype == v.dtype, f"{name}.{k}: {mine.dtype}")
            worst = max(worst, (mine.float() - v.float()).abs().max().item())
    check(worst == 0, f"a loaded parameter differs by {worst}")
    table = built.text.clip.text_model.embeddings.token_embedding.weight
    sup = coach.tokenizer.encode("view", add_special_tokens=False)[0]
    check(all(torch.equal(table[i], table[sup])
              for i in built.placeholder_view_token_ids),
          "the view placeholders' rows are not the loaded 'view' row")
    check(torch.equal(out_loaded, out_mem),
          f"the loaded UNet's forward differs from the written stack's by "
          f"{(out_loaded.float() - out_mem.float()).abs().max().item()}")
    check(launches == {**unet_k1(2), **unet_bwd(0), **k4()},
          f"weights launches {launches}")
    stats = dict(gb_read=nbytes / 1e9, dtypes=dtypes, write_s=write_s,
                 coach_build_s=coach_s, load_s=load_s,
                 read_gb_per_s=nbytes / 1e9 / load_s,
                 peak_memory_gib=peak_gb, max_abs_diff=worst,
                 unet_forward_bit_equal=True, launches=launches)
    print(f"weights [{card}]: {json.dumps(stats)}", flush=True)
    del coach, built, mem, out_loaded, out_mem
    return launches, root


def phase_acceptance(torch, dev, card, root, weights, cal, masks_root):
    """python -m view_neti_tpu_torch.acceptance on the eval scan under root
    (34 cameras, IDR masks) and the weights phase's seeded SD-1.5 stack:
    first the stack's sha256 manifest (weight_port.write_manifest), clean
    on a check, and a small file added to the stack and to the manifest,
    one byte of it changed, named by check_manifest, and restored; then the
    run with SD_WEIGHTS_DIR and DTU_MASKS_DIR set (its manifest checked
    before training), --steps ACC_STEPS --denoise_steps ACC_DENOISE and
    the default seeds (ACC_SEEDS): the mode-2 recipe at full width (preset
    7, DTU preprocess 1, fused batch 9, bf16) and the 34-view sweep of its
    checkpoint with a random-VGG LPIPS; acceptance.json's keys, finite
    metrics, the launches of K1-K4. Then python -m
    view_neti_tpu_torch.inference on that run (--debug 1, the same seeds
    and steps) with SD_WEIGHTS_DIR set: bit-equal to the sweep's first two
    cameras; and unset (the control): it renders the seeded stack and must
    differ."""
    import numpy as np
    from view_neti_tpu_torch import acceptance
    from view_neti_tpu_torch.inference import offline
    from view_neti_tpu_torch.weight_port import check_manifest, write_manifest

    manifest = os.path.join(weights, "MANIFEST.sha256")
    t0 = time.perf_counter()
    n_files = write_manifest(weights, manifest)
    write_s = time.perf_counter() - t0
    with open(manifest) as f:
        nbytes = sum(int(line.split()[1]) for line in f if line.strip())
    t0 = time.perf_counter()
    problems = check_manifest(weights, manifest)
    check_s = time.perf_counter() - t0
    check(problems == [], f"the fresh manifest does not check: {problems}")
    probe = os.path.join(weights, "probe.bin")
    with open(probe, "wb") as f:
        f.write(bytes(range(256)) * 16)
    write_manifest(weights, manifest)
    with open(probe, "r+b") as f:
        f.seek(1000)
        byte = f.read(1)
        f.seek(1000)
        f.write(bytes([byte[0] ^ 0xFF]))
    tampered = check_manifest(weights, manifest)
    with open(probe, "r+b") as f:   # restored: the run checks it clean
        f.seek(1000)
        f.write(byte)
    check(tampered == ["sha256 mismatch: probe.bin"],
          f"check_manifest on a changed byte of probe.bin: {tampered}")

    out = os.path.join(root, "acceptance")
    env = {"SD_WEIGHTS_DIR": weights, "DTU_MASKS_DIR": masks_root,
           "WEIGHTS_MANIFEST": None, "TOKENIZER_PATH": None,
           "LPIPS_WEIGHTS": None}
    saved = {k: os.environ.get(k) for k in env}

    def set_env(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    set_env(env)
    try:
        # the counted run: the user's entry point, counts from 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        payload, res = acceptance.main([
            "--dtu_root", os.path.join(root, "dtu"), "--out", out,
            "--steps", str(ACC_STEPS), "--denoise_steps", str(ACC_DENOISE)])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

        infer_argv = [
            "--input_dir", os.path.join(out, "run"), "--iteration",
            str(ACC_STEPS), "--seeds", json.dumps(ACC_SEEDS),
            "--num_denoising_steps",
            str(ACC_DENOISE), "--debug", "1", "--torch_dtype", "bf16",
            "--calibration_dir", cal, "--masks_root", masks_root]
        t0 = time.perf_counter()
        loaded = offline.main(infer_argv + [
            "--inference_dir", os.path.join(out, "inference")])
        offline_s = time.perf_counter() - t0
        os.environ.pop("SD_WEIGHTS_DIR")
        seeded = offline.main(infer_argv + [
            "--inference_dir", os.path.join(out, "inference_seeded")])
    finally:
        set_env(saved)
    with open(os.path.join(out, "acceptance.json")) as f:
        written = json.load(f)
    with open(os.path.join(out, "run", "logs", "log.txt")) as f:
        log = f.read()
    fill = re.search(r"device base-image cache: \d+ images \(\d+ MB uint8\) "
                     r"in ([\d.]+) s", log)
    loop = re.search(r"training done: \d+ steps in ([\d.]+)s", log)
    ref = np.stack(res["imgs_pred"])[:, :INFER_CAMS]
    got = np.stack(loaded["imgs_pred"])
    control = np.stack(seeded["imgs_pred"])
    diff = float(np.abs(got - ref).max()) * 255
    control_diff = float(np.abs(control - ref).max()) * 255
    cams = len(res["cam_idxs"])
    stats = dict(
        steps=ACC_STEPS, seeds=payload["seeds"], denoising_steps=ACC_DENOISE,
        cams=cams, wall_s=wall_s, train_wall_s=res["wall_s"]["train"],
        eval_wall_s=res["wall_s"]["eval"],
        cache_fill_s=float(fill.group(1)) if fill else None,
        train_loop_s=float(loop.group(1)) if loop else None,
        sweep_sec_per_image=res["wall_s"]["eval"] / (
            cams * len(payload["seeds"])),
        metrics=payload["metrics"],
        meaningful_for_quality=payload["meaningful_for_quality"],
        manifest_files=n_files, manifest_gb=nbytes / 1e9,
        manifest_write_s=write_s, manifest_check_s=check_s,
        manifest_gb_per_s=nbytes / 1e9 / check_s,
        manifest_clean=problems == [], tampered_named=tampered,
        peak_memory_gib=peak_gb, launches=launches,
        offline_s=offline_s, offline_max_diff_levels_vs_sweep=diff,
        offline_bit_equal=bool(np.array_equal(got, ref)),
        control_unset_max_diff_levels=control_diff)
    print(f"acceptance [{card}]: {json.dumps(stats)}", flush=True)
    check(written == json.loads(json.dumps(payload)),
          "acceptance.json differs from the payload returned")
    check(set(payload) == ACC_KEYS, f"acceptance.json keys {set(payload)}")
    check(len(payload["metrics"]) == 8 and all(
        math.isfinite(v) for v in payload["metrics"].values()),
          f"acceptance metrics {payload['metrics']}")
    check(payload["manifest"] == manifest, f"manifest {payload['manifest']}")
    check(payload["assets"]["SD_WEIGHTS_DIR"]["present"]
          and payload["assets"]["DTU_MASKS_DIR"]["present"],
          f"assets {payload['assets']}")
    check(payload["meaningful_for_quality"] is False
          and payload["acceptance"] is None,
          "a run without a tokenizer or LPIPS weights is labelled "
          "meaningful")
    check(cams == EVAL_CAMS, f"{cams} cameras swept")
    check(payload["seeds"] == ACC_SEEDS and 2 * len(ACC_SEEDS) == BATCH,
          f"seeds {payload['seeds']}: the sweep would leave the serving "
          f"shapes that the kernels phase checks")
    check(fill is not None and loop is not None,
          "no cache fill or training line in the run's log")
    want = {**unet_k1(ACC_STEPS + ACC_DENOISE * EVAL_CAMS),
            **unet_bwd(ACC_STEPS), **k4(ACC_STEPS, EVAL_CAMS)}
    check(launches == want, f"acceptance launches {launches}, want {want}")
    check(loaded["cam_idxs"] == res["cam_idxs"][:INFER_CAMS],
          f"offline cameras {loaded['cam_idxs']}")
    check(np.array_equal(got, ref),
          f"offline inference with SD_WEIGHTS_DIR differs from the "
          f"acceptance sweep by up to {diff} levels")
    check(not np.array_equal(control, ref),
          "offline inference without SD_WEIGHTS_DIR equals the sweep on "
          "the loaded stack: the check could not catch a stack left unread")
    return launches, stats


def phase_validate(torch, dev, card, rect, cal, masks_root, run_dir):
    """The shipped mode-2 recipe with validation on: the Coach at full
    width (DTU preprocess 1, preset 7, fused batch 9, bf16) trains
    VAL_TRAIN_STEPS steps, writes the step-VAL_EVERY checkpoint and runs
    one validation round after it: the DTU sweep over the 34 eval
    cameras at 768x576 (seeds [0, 1], 30 DPM-Solver++ steps, CFG 7.5,
    reloading the step's mapper files), its metrics with a random-VGG
    LPIPS on the card, the result bundle and sheets, and the object-token
    renders at 512x512."""
    import numpy as np
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.ops.metrics import make_lpips
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.validate import ValidationHandler

    class TimedValidation(ValidationHandler):
        """The sweep's wall time and results, read from outside."""
        def infer_dtu(self, coach, step, num_steps, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.results = super().infer_dtu(coach, step, num_steps, **kw)
            torch.cuda.synchronize()
            self.sweep_s = time.perf_counter() - t0
            return self.results

    cfg = mode2_config(
        rect, run_dir,
        log={"save_steps": VAL_EVERY},
        eval={"validation_prompts": ["A photo of a {}"],
              "validation_steps": VAL_EVERY, "validation_seeds": VAL_SEEDS,
              "num_validation_images": len(VAL_SEEDS),
              "num_denoising_steps": VAL_DENOISE},
        optim={"max_train_steps": VAL_TRAIN_STEPS})
    coach = Coach(cfg, calibration_dir=cal, device=dev)
    coach.validator = TimedValidation(
        cfg, masks_root=masks_root, calibration_dir=cal,
        lpips_fn=make_lpips(seed=0, device=dev))
    # the counted run: the user's entry point, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    coach.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    res = coach.validator.results
    log = open(os.path.join(run_dir, "logs", "log.txt")).read()
    check("falling back to LIVE" not in log,
          "the sweep did not reload the step's mapper files")
    check(len(res["cam_idxs"]) == EVAL_CAMS, f"{len(res['cam_idxs'])} cams")
    means = {k: v for k, v in res.items() if k.endswith("_mean")}
    check(all(math.isfinite(v) for v in means.values()),
          f"validation metrics {means}")
    preds = np.stack(res["imgs_pred"])
    check(preds.shape == (len(VAL_SEEDS), EVAL_CAMS, 300, 400, 3)
          and preds.min() != preds.max(), f"predictions {preds.shape}")
    bundle = os.path.join(
        run_dir, f"validation-iter_{VAL_EVERY}-denoisesteps_{VAL_DENOISE}"
                 f"_numseeds_{len(VAL_SEEDS)}.msgpack")
    check(os.path.exists(bundle), "no validation bundle")
    n = VAL_TRAIN_STEPS
    want = {**unet_k1(n + VAL_DENOISE * (EVAL_CAMS + 1)), **unet_bwd(n),
            **k4(n, EVAL_CAMS + 1)}
    check(launches == want, f"validate launches {launches}, want {want}")
    (loop_cap,) = [c for f, _ in coach._sampling.values()
                   for c in f.captures.values()
                   if c.static_args[0].shape[1:3] == (HEIGHT // 8,
                                                      WIDTH // 8)]
    check(loop_cap.replays == EVAL_CAMS - 1,
          f"the sweep's denoise graph replayed {loop_cap.replays} times, "
          f"want {EVAL_CAMS - 1}")

    # the sweep graphed (the round captured its shapes: replays only) and
    # eager on its first cameras: the same images bit for bit
    from view_neti_tpu_torch.training import inference_dtu
    check_cams = res["cam_idxs"][:SWEEP_CHECK_CAMS]

    def eager_sampling(schedule, num_steps, guidance_scale):
        unet, vae = coach.infer_frozen()
        return (pipeline.make_denoise_fn(unet, schedule, num_steps,
                                         guidance_scale, coach.compute_dtype,
                                         graph=False),
                pipeline.make_decode_fn(vae, graph=False))

    sweeps = {}
    for name, fns in (("graphed", None), ("eager", eager_sampling)):
        if fns is not None:     # the Coach's own, or eager ones
            coach.sampling_fns = fns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference_dtu.render_cameras(
            coach, check_cams, VAL_EVERY, VAL_DENOISE, VAL_SEEDS,
            calibration_dir=cal)
        sweeps[name] = (out, (time.perf_counter() - t0)
                        / (len(check_cams) * len(VAL_SEEDS)))
    del coach.sampling_fns
    check(all(np.array_equal(sweeps["graphed"][0][c], sweeps["eager"][0][c])
              for c in check_cams),
          "the graphed sweep differs from the eager one")

    # one CFG denoise step at the sweep's shapes (B = 4, 72x96 latents)
    # under the profiler
    unet, _ = coach.infer_frozen()
    sched = DPMSolverSchedule()
    pm = PromptManager(coach.tokenizer, coach.built.text,
                       sched.set_timesteps(1),
                       coach.built.placeholder_view_token_ids,
                       coach.built.placeholder_object_token_ids,
                       dtype=torch.bfloat16)
    with torch.no_grad():
        ctx, ctx_b = pm.embed_prompt(
            f"{coach.placeholder_view_tokens[0]}. A photo of a "
            f"{coach.placeholder_object_tokens[0]}")
        uncond = pipeline.encode_uncond(coach.built.text.clip,
                                        coach.tokenizer)
    lat0 = pipeline.initial_latents(VAL_SEEDS, HEIGHT // 8, WIDTH // 8, dev)
    step1 = pipeline.make_denoise_fn(unet, sched, 1, 7.5, torch.bfloat16)
    step1_eager = pipeline.make_denoise_fn(unet, sched, 1, 7.5,
                                           torch.bfloat16, graph=False)
    for _ in range(2):      # the warm-up, then the capture
        step1(lat0, ctx, ctx_b, uncond)
    prof = device_profile(torch, lambda: step1(lat0, ctx, ctx_b, uncond))
    prof_eager = device_profile(torch, lambda: step1_eager(lat0, ctx, ctx_b,
                                                           uncond))
    sweep_s = coach.validator.sweep_s
    stats = dict(
        cams=EVAL_CAMS, seeds=VAL_SEEDS, denoising_steps=VAL_DENOISE,
        train_steps=n, coach_train_s=train_s, sweep_s=sweep_s,
        sec_per_image=sweep_s / (EVAL_CAMS * len(VAL_SEEDS)),
        check_cams=len(check_cams),
        sec_per_image_graphed=sweeps["graphed"][1],
        sec_per_image_eager=sweeps["eager"][1], graphed_equals_eager=True,
        sweep_capture_s=loop_cap.capture_s,
        sweep_pool_gib=loop_cap.pool_bytes / 2 ** 30,
        metrics=means, peak_memory_gib=peak_gb, launches=launches,
        denoise_step_launches=prof["kernels"] if prof else None,
        denoise_step_idle_share=prof["idle_share"] if prof else None,
        eager_denoise_step_idle_share=(prof_eager["idle_share"]
                                       if prof_eager else None))
    print(f"validate [{card}]: {json.dumps(stats)}", flush=True)
    print(f"profile sweep denoise step [{card}]: "
          f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    stats["per_view"] = res["per_view"]
    stats["imgs_pred"] = preds
    stats["cam_idxs"] = res["cam_idxs"]
    stats["bundle"] = bundle
    return launches, stats


def phase_inference(torch, dev, card, cal, masks_root, run_dir, val):
    """python -m view_neti_tpu_torch.inference on the validate phase's run
    at its checkpoint step, --debug 1 (its first two cameras), the same
    seeds and VAL_DENOISE steps: the predictions equal the sweep's bit for
    bit.
    Then python -m view_neti_tpu_torch.summarize_dtu on the sweep's bundle
    with LPIPS: each seed's CSV means equal the means of the sweep's
    per-view metrics to 1e-6."""
    import csv
    import numpy as np
    from view_neti_tpu_torch import summarize_dtu
    from view_neti_tpu_torch.inference import offline

    out_dir = os.path.join(run_dir, "inference")
    argv = ["--input_dir", run_dir, "--iteration", str(VAL_EVERY),
            "--seeds", json.dumps(VAL_SEEDS), "--num_denoising_steps",
            str(VAL_DENOISE), "--debug", "1", "--torch_dtype", "bf16",
            "--calibration_dir", cal, "--masks_root", masks_root,
            "--inference_dir", out_dir]
    # the counted run: the user's entry point, counts from 0
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    res = offline.main(argv)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {**unet_k1(VAL_DENOISE * INFER_CAMS), **unet_bwd(0),
            **k4(decodes=INFER_CAMS)}
    check(launches == want, f"inference launches {launches}, want {want}")
    check(res["cam_idxs"] == val["cam_idxs"][:INFER_CAMS],
          f"cameras {res['cam_idxs']}")
    got = np.stack(res["imgs_pred"])
    ref = val["imgs_pred"][:, :INFER_CAMS]
    diff = float(np.abs(got - ref).max()) * 255
    stats = dict(seconds=infer_s, launches=launches,
                 max_diff_levels_vs_sweep=diff)
    print(f"inference [{card}]: {json.dumps(stats)}", flush=True)
    check(np.array_equal(got, ref),
          f"offline inference differs from the in-training sweep by up to "
          f"{diff} levels")
    check(os.path.exists(os.path.join(
        out_dir, f"results_all_iter_{VAL_EVERY}.msgpack")), "no bundle")

    csv_path = os.path.join(run_dir, "summary.csv")
    rows = summarize_dtu.main(["--results_dirs", run_dir, "--iteration",
                               str(VAL_EVERY), "--do_lpips", "--out",
                               csv_path])
    with open(csv_path) as f:
        table = list(csv.DictReader(f))
    check(len(rows) == len(table) == len(VAL_SEEDS)
          and all(r["bundle"].startswith("validation-iter") for r in table),
          f"summary rows {table}")
    worst = 0.0
    for row in table:
        for k in ("mse", "psnr", "ssim", "lpips"):
            want_v = float(val["per_view"][k][int(row["seed"])].mean())
            worst = max(worst, abs(float(row[k]) - want_v)
                        / max(abs(want_v), 1e-12))
    summary = dict(rows=table, max_rel_diff_vs_sweep=worst)
    print(f"summarize [{card}]: {json.dumps(summary)}", flush=True)
    check(worst <= 1e-6, f"summarize_dtu differs from the sweep by {worst}")
    stats["summary_max_rel_diff"] = worst
    return launches, stats


def write_mode3_scans(root, image_io, dtu, np, scans):
    """The recipe's scans (dtu_subset 0: 34 cameras, lighting "3") at
    1600x1200 from RandomState(0) and 64 random cal18 matrices, written by
    the port's PNG writer in 8 threads. Returns (Rectified, calibration)."""
    from concurrent.futures import ThreadPoolExecutor
    rect = os.path.join(root, "dtu", "Rectified")
    cal = os.path.join(root, "dtu", "Calibration", "cal18")
    os.makedirs(cal)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        with open(os.path.join(cal, f"pos_{i:03d}.txt"), "w") as f:
            f.write("\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    jobs = []
    for scan in scans:
        os.makedirs(os.path.join(rect, scan))
        for i in dtu.dtu_get_train_idxs(0):
            jobs.append((os.path.join(rect, scan,
                                      f"rect_{i + 1:03d}_3_r5000.png"),
                         rng.randint(0, 255, (1200, 1600, 3), np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(image_io.write_png, path, img)
                  for path, img in jobs]:
            f.result()
    return rect, cal, len(jobs)


def mode3_config(rect, exp_dir, steps, save_steps, **log):
    """input_configs/train_m3.yaml as the train CLI reads it, with this
    run's data and experiment directories, a checkpoint and a train state
    every save_steps, no reports, and its validation at VAL_DENOISE
    steps."""
    from view_neti_tpu_torch.config import parse_cli
    args = ["--config_path", M3_CONFIG, "--data.train_data_dir", rect,
            "--log.exp_dir", exp_dir, "--log.save_steps", str(save_steps),
            "--log.checkpoint_backend", "orbax", "--log.report_to", "none",
            "--log.save_dataset_images", "false",
            "--optim.max_train_steps", str(steps),
            "--eval.num_denoising_steps", str(VAL_DENOISE)]
    for key, value in log.items():
        args += [f"--log.{key}", str(value)]
    return parse_cli(args)


def mapper_state(coach):
    """Every mapper's parameters, copied to the host."""
    text = coach.built.text
    return {f"{name}.{k}": v.detach().cpu().clone()
            for name, m in ([(f"object{i}", m) for i, m in
                             enumerate(text.obj_mappers)]
                            + [("view", text.view_mapper)])
            for k, v in m.state_dict().items()}


def phase_mode3(torch, dev, card, coach_stats):
    """Mode 3 on its shipped recipe at full SD-2.1 width: a run stopped
    after M3_WARM steps (its final checkpoint writes the train state), a
    straight run of M3_WARM + M3_STEPS steps with no checkpoint before its
    end (timed), a run resumed from the stopped one's state that must
    replay the straight one bit for bit and then validates, offline
    inference and the summary of that run."""
    import gc
    import numpy as np
    from view_neti_tpu_torch import summarize_dtu
    from view_neti_tpu_torch.bench import SyncAfter
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.data.dataset import DataLoader
    from view_neti_tpu_torch.inference import offline, pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.ops import device_augment as da
    from view_neti_tpu_torch.ops.metrics import make_lpips
    from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
    from view_neti_tpu_torch.schedulers.ddpm import DDPMSchedule
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    from view_neti_tpu_torch.training import inference_dtu
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.text_forward import (
        _object_pass, neti_text_conditioning)
    from view_neti_tpu_torch.training.validate import ValidationHandler

    B, n = TRAIN_BATCH, M3_WARM + M3_STEPS
    per_step = {**unet_k1(1, M3_SM90["train"]), **unet_bwd(1, M3_BWD_SM90),
                **k4(encodes=1)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_mode3")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        probe = mode3_config("x", "x", 1, 1)
        rect, cal, n_images = write_mode3_scans(
            root, image_io, dtu, np, [str(x) for x in
                                      probe.data.train_data_subsets])
        write_s = time.perf_counter() - t0

        # ---- the stopped run: M3_WARM steps; its final checkpoint writes
        # the step-M3_WARM train state
        run_p = os.path.join(root, "stopped")
        coach = Coach(mode3_config(rect, run_p, M3_WARM, M3_WARM),
                      calibration_dir=cal, device=dev)
        launch_counts(reset=True)
        coach.train()
        launches_p = launch_counts()
        check(os.path.exists(os.path.join(run_p, "train_state",
                                          f"state-{M3_WARM}.msgpack")),
              f"no train state at step {M3_WARM}")
        del coach
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the straight run: M3_WARM warm-up and M3_STEPS timed steps,
        # no checkpoint before the final one
        run_a = os.path.join(root, "straight")
        cfg = mode3_config(rect, run_a, n, 10 ** 9)
        check(cfg.learnable_mode == 3 and cfg.data.augmentation_key == 5
              and "stable-diffusion-2-1"
              in cfg.model.pretrained_model_name_or_path
              and len(cfg.eval.eval_placeholder_object_tokens) == M3_TOKENS,
              "the mode-3 recipe changed")
        t0 = time.perf_counter()
        coach = Coach(cfg, calibration_dir=cal, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        arch = coach.arch
        check(coach.mode3_group_size == 3 and coach.micro_batch_size == B
              and coach.use_pixel_cache and not coach.cache_latents
              and coach.augment_spec == da.from_augmentation_key(5)
              and coach.compute_dtype == torch.bfloat16
              and coach.built.schedule.prediction_type == "v_prediction"
              and arch.text.num_layers == 23 and arch.text.hidden_size == 1024
              and arch.unet.use_linear_projection
              and arch.unet.attention_head_dim == 64
              and len(coach.built.text.obj_mappers) == 4,
              "the Coach did not take SD-2.1's fused, grouped, preset-5 "
              "mode-3 path")
        timed = SyncAfter(coach, M3_WARM)
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        coach.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_a = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(coach.global_step == n, f"the mode-3 Coach ran "
                                      f"{coach.global_step} steps")
        check(launches_a == {k: v * n for k, v in per_step.items()},
              f"mode-3 launches {launches_a} over {n} steps, want "
              f"{per_step} a step (the SD-1.5 step's)")
        losses_a = coach.losses
        check(len(losses_a) == n and all(math.isfinite(x)
                                         for x in losses_a),
              f"mode-3 losses {losses_a}")
        ms_step = (coach.loop_end_s - timed.at) * 1e3 / M3_STEPS
        del timed
        final_a = mapper_state(coach)

        # grouped conditioning against one call per group on its own
        # prompts, on a batch whose groups hold two scenes or more: the
        # object mapper's rows (gathered, mapped, scattered back) exactly,
        # and the whole conditioning (its CLIP pass then runs on B / G of
        # the rows); checked at the phase's end
        ds = coach.train_dataset
        loader = iter(DataLoader(ds, B, seed=cfg.seed, group_size=3))
        batch = None
        for _ in range(50):
            cand = coach._build_batch(next(loader))
            if len(set(cand.object_idx.tolist())) > 1:
                batch = cand
                break
        check(batch is not None, "no batch with two scenes in 50")
        g = torch.Generator(dev).manual_seed(3)
        ts = torch.randint(0, 1000, (B,), generator=g, device=dev)
        text = coach.built.text
        K = NUM_UNET_LAYERS
        t_k = ts.float().repeat(K)
        l_k = torch.arange(K, dtype=torch.float32,
                           device=dev).repeat_interleave(B)
        with torch.no_grad():
            ctx, ctx_b = neti_text_conditioning(
                text, batch.input_ids, batch.input_ids_placeholder_object,
                batch.input_ids_placeholder_view, ts,
                object_idx=batch.object_idx)
            _, rows_g, bypass_g = _object_pass(text, batch.object_idx, t_k,
                                               l_k, K, B, None, None)
            group_diff = mapper_rows_diff = 0.0
            for gi, idx in enumerate(batch.object_idx.tolist()):
                rows = slice(3 * gi, 3 * gi + 3)
                want, want_b = neti_text_conditioning(
                    text, batch.input_ids[rows],
                    batch.input_ids_placeholder_object[rows],
                    batch.input_ids_placeholder_view[rows], ts[rows],
                    object_idx=idx)
                group_diff = max(
                    group_diff,
                    (ctx[:, rows] - want).abs().max().item(),
                    (ctx_b[:, rows] - want_b).abs().max().item())

                def take(x):
                    return x.reshape(K, 3, 3)[:, gi].reshape(-1)

                _, w1, b1 = _object_pass(text, idx, take(t_k), take(l_k), K,
                                         3, None, None)
                mapper_rows_diff = max(
                    mapper_rows_diff,
                    (rows_g.reshape(K, B, -1)[:, rows] - w1.reshape(K, 3, -1)
                     ).abs().max().item(),
                    (bypass_g.reshape(K, B, -1)[:, rows]
                     - b1.reshape(K, 3, -1)).abs().max().item())
        grouped = dict(object_idx=batch.object_idx.tolist(),
                       mapper_rows_max_abs_diff=mapper_rows_diff,
                       conditioning_max_abs_diff=group_diff)
        print(f"mode3 grouped conditioning [{card}]: {json.dumps(grouped)}",
              flush=True)

        # one more grouped step under the profiler (after the straight
        # run's mappers were copied), the augmentation's kernels in a group
        # of their own
        def one_step():
            coach.train_step(coach.built, batch,
                             coach._step_draws(10 ** 6, batch))

        step_prof = device_profile(torch, augment_ranged(one_step),
                                   ranges=("device_augment",))

        # the step's v-prediction target on the card against the CPU's
        sched = coach.built.schedule
        lat = torch.randn(B, 48, 64, 4, generator=g, device=dev)
        eps = torch.randn(B, 48, 64, 4, generator=g, device=dev)
        target = sched.target(lat, eps, ts)
        cpu = DDPMSchedule(prediction_type="v_prediction").target(
            lat.cpu(), eps.cpu(), ts.cpu())
        v_err = (target.cpu() - cpu).abs().max().item()
        check(v_err <= 1e-5 and not torch.allclose(target, eps),
              f"the v-prediction target differs from the CPU's by {v_err}")
        del (coach, text, ds, loader, cand, batch, ctx, ctx_b, want, want_b,
             rows_g, bypass_g, w1, b1)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the resumed run: "latest" in a fresh directory holding the
        # stopped run's state, to n steps, then the validation round on
        # the step-n checkpoint
        run_b = os.path.join(root, "resumed")
        os.makedirs(os.path.join(run_b, "train_state"))
        shutil.copy(os.path.join(run_p, "train_state",
                                 f"state-{M3_WARM}.msgpack"),
                    os.path.join(run_b, "train_state"))
        cfg_b = mode3_config(rect, run_b, n, n, resume_from="latest")
        cfg_b.eval.validation_steps = n
        coach = Coach(cfg_b, calibration_dir=cal, device=dev)
        check(coach.global_step == M3_WARM,
              f"resumed at step {coach.global_step}")

        class TimedValidation(ValidationHandler):
            """Each token's sweep time and results, read from outside."""
            sweeps = {}

            def infer_dtu(self, coach, step, num_steps, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = super().infer_dtu(coach, step, num_steps, **kw)
                torch.cuda.synchronize()
                self.sweeps[kw["eval_placeholder_object_token"]] = (
                    time.perf_counter() - t0, res)
                return res

        coach.validator = TimedValidation(
            cfg_b, calibration_dir=cal,
            masks_root=os.path.join(root, "no_masks"),
            lpips_fn=make_lpips(seed=0, device=dev))
        cams_all = inference_dtu.get_cam_idxs
        # the cut: the sweeps cover the first M3_SWEEP_CAMS eval cameras
        inference_dtu.get_cam_idxs = lambda subset: (
            cams_all(subset)[0][:M3_SWEEP_CAMS],) + cams_all(subset)[1:]
        try:
            launch_counts(reset=True)
            t0 = time.perf_counter()
            coach.train()
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
            launches_b = launch_counts()
        finally:
            inference_dtu.get_cam_idxs = cams_all
        losses_b = coach.losses
        final_b = mapper_state(coach)
        mapper_diff = max((final_a[k] - final_b[k]).abs().max().item()
                          for k in final_a)
        resume = dict(losses_straight=losses_a[M3_WARM:],
                      losses_resumed=losses_b,
                      losses_equal=losses_b == losses_a[M3_WARM:],
                      mappers_max_abs_diff=mapper_diff,
                      mappers_equal=final_a.keys() == final_b.keys() and all(
                          torch.equal(final_a[k], final_b[k])
                          for k in final_a))
        print(f"mode3 resume [{card}]: {json.dumps(resume)}", flush=True)
        check(resume["losses_equal"] and resume["mappers_equal"],
              f"the resumed run does not replay the straight one: {resume}")
        sweeps = coach.validator.sweeps
        tokens = list(cfg_b.eval.eval_placeholder_object_tokens)
        check(sorted(sweeps) == sorted(tokens), f"swept {sorted(sweeps)}")
        per_token = {}
        for tok in tokens:
            secs, res = sweeps[tok]
            preds = np.stack(res["imgs_pred"])
            # dtu_subset 0 trains on every eval camera: no test split
            check(preds.shape == (len(VAL_SEEDS), M3_SWEEP_CAMS, 300, 400, 3)
                  and preds.min() != preds.max()
                  and all(math.isfinite(v) for k, v in res.items()
                          if k.endswith("_train_mean")),
                  f"{tok}: predictions {preds.shape}")
            bundle = os.path.join(
                run_b, f"validation-iter_{n}-denoisesteps_{VAL_DENOISE}"
                       f"_numseeds_{len(VAL_SEEDS)}-{tok}.msgpack")
            check(os.path.exists(bundle), f"no bundle for {tok}")
            per_token[tok] = dict(
                sweep_s=secs,
                sec_per_image=secs / (M3_SWEEP_CAMS * len(VAL_SEEDS)),
                psnr_train_mean=res["psnr_train_mean"])
        check(os.path.exists(os.path.join(
            run_b, f"val-disentangled-step{n}.png")), "no object renders")
        # each eval token's sweep (768x576) and render (512x512)
        want_b = add_counts(
            {k: v * M3_STEPS for k, v in per_step.items()},
            unet_k1(VAL_DENOISE * M3_TOKENS * M3_SWEEP_CAMS,
                    M3_SM90["sweep"]),
            unet_k1(VAL_DENOISE * M3_TOKENS, M3_SM90["render"]),
            k4(decodes=M3_TOKENS * (M3_SWEEP_CAMS + 1)))
        check(launches_b == want_b, f"resumed run launches {launches_b}, "
                                    f"want {want_b}")

        # one CFG denoise step at the sweep's shapes (B = 4 at 72x96) under
        # the profiler, and a whole denoise of one camera: finite latents
        unet, vae = coach.infer_frozen()
        with torch.no_grad():
            uncond = pipeline.encode_uncond(coach.built.text.clip,
                                            coach.tokenizer)

        def denoiser(steps):
            dpm = DPMSolverSchedule(prediction_type="v_prediction")
            pm = PromptManager(coach.tokenizer, coach.built.text,
                               dpm.set_timesteps(steps),
                               coach.built.placeholder_view_token_ids,
                               coach.built.placeholder_object_token_ids,
                               dtype=torch.bfloat16)
            with torch.no_grad():
                ctx, ctx_b = pm.embed_prompt(
                    f"{coach.placeholder_view_tokens[0]}. A photo of a "
                    f"{tokens[0]}")
            return (pipeline.make_denoise_fn(unet, dpm, steps, 7.5,
                                             torch.bfloat16), ctx, ctx_b)

        lat0 = pipeline.initial_latents(VAL_SEEDS, HEIGHT // 8, WIDTH // 8,
                                        dev)
        full, ctx, ctx_b = denoiser(VAL_DENOISE)
        lat = full(lat0, ctx, ctx_b, uncond)
        imgs = pipeline.decode_to_uint8(vae, lat.to(torch.bfloat16))
        check(bool(torch.isfinite(lat).all()) and imgs.min() != imgs.max(),
              "the v-prediction denoise is not finite or its decode is "
              "constant")
        step1, ctx1, ctx1_b = denoiser(1)
        for _ in range(2):      # the warm-up, then the capture
            step1(lat0, ctx1, ctx1_b, uncond)
        prof = device_profile(torch, lambda: step1(lat0, ctx1, ctx1_b,
                                                   uncond))
        del coach, unet, vae, ctx, ctx_b, lat
        gc.collect()
        torch.cuda.empty_cache()

        # ---- offline inference on the resumed run: its sweeps' first
        # INFER_CAMS cameras, bit for bit; the summary of its bundles
        out_dir = os.path.join(run_b, "inference")
        launch_counts(reset=True)
        t0 = time.perf_counter()
        offline_res = offline.main([
            "--input_dir", run_b, "--iteration", str(n), "--seeds",
            json.dumps(VAL_SEEDS), "--num_denoising_steps",
            str(VAL_DENOISE), "--debug", "1", "--torch_dtype", "bf16",
            "--calibration_dir", cal, "--masks_root",
            os.path.join(root, "no_masks"), "--inference_dir", out_dir])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        launches_c = launch_counts()
        want_c = {**unet_k1(VAL_DENOISE * INFER_CAMS * M3_TOKENS,
                            M3_SM90["sweep"]), **unet_bwd(0),
                  **k4(decodes=INFER_CAMS * M3_TOKENS)}
        check(launches_c == want_c, f"mode-3 inference launches "
                                    f"{launches_c}, want {want_c}")
        check(sorted(offline_res) == sorted(tokens),
              f"offline results keyed {sorted(offline_res)}")
        infer_diff = 0.0
        for tok in tokens:
            got = np.stack(offline_res[tok]["imgs_pred"])
            ref = np.stack(sweeps[tok][1]["imgs_pred"])[:, :INFER_CAMS]
            infer_diff = max(infer_diff, float(np.abs(got - ref).max()) * 255)
            check(os.path.exists(os.path.join(
                out_dir, f"results_all_iter_{n}-{tok}.msgpack")),
                f"no offline bundle for {tok}")
        check(infer_diff == 0, f"mode-3 offline inference differs from the "
                               f"sweeps by up to {infer_diff} levels")
        rows = summarize_dtu.main(["--results_dirs", run_b, "--iteration",
                                   str(n), "--out",
                                   os.path.join(root, "summary.csv")])
        check(len(rows) == M3_TOKENS * len(VAL_SEEDS)
              and all(any(r["bundle"].endswith(f"-{t}") for t in tokens)
                      for r in rows), f"mode-3 summary rows {rows}")
        check(mapper_rows_diff == 0 and group_diff == 0,
              f"grouped conditioning differs from the per-group calls: "
              f"{grouped}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: launches_p[k] + launches_a[k] + launches_b[k]
                + launches_c[k] for k in launches_a}
    stats = dict(
        model="SD-2.1 (stabilityai/stable-diffusion-2-1, seeded weights)",
        scans=n_images // 34, images=n_images, batch=B, groups=3,
        height=TRAIN_HEIGHT, width=TRAIN_WIDTH, warmup_steps=M3_WARM,
        timed_steps=M3_STEPS, imgs_per_sec=B * 1e3 / ms_step,
        ms_per_step=ms_step,
        sd15_coach_imgs_per_sec=coach_stats["imgs_per_sec"],
        sd15_coach_ms_per_step=coach_stats["ms_per_step"],
        sd15_raw_step_ms_per_step=coach_stats["raw_step_ms_per_step"],
        peak_memory_gib=peak_gb, write_scans_s=write_s,
        build_s=build_s, train_s=train_s, resumed_run_s=resumed_s,
        offline_s=infer_s,
        launches_per_step={k: v / n for k, v in launches_a.items()},
        losses=losses_a, resume_exact=True,
        grouped_conditioning=grouped,
        v_target_max_abs_err_card_vs_cpu=v_err,
        sweep_cams=M3_SWEEP_CAMS, per_token=per_token,
        offline_max_diff_levels=infer_diff,
        step_launches=step_prof["kernels"] if step_prof else None,
        step_idle_share=step_prof["idle_share"] if step_prof else None,
        denoise_step_launches=prof["kernels"] if prof else None,
        denoise_step_idle_share=prof["idle_share"] if prof else None,
        launches=launches)
    print(f"mode3 [{card}]: {json.dumps(stats)}", flush=True)
    print(f"profile mode3 step [{card}]: "
          f"{json.dumps(step_prof) if step_prof else 'not measured'}",
          flush=True)
    print(f"profile mode3 denoise step [{card}]: "
          f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    return launches, stats


def write_llff_views(root, image_io, np):
    """FOLDERS_VIEWS views obj___0_{phi}_1.png of a smooth synthetic
    object (phi 0, 30, ..., 330: deg_freedom "phi"), alternately 1008x756
    and 756x1008 (width x height), written by the port's PNG writer in 8
    threads."""
    from concurrent.futures import ThreadPoolExecutor
    os.makedirs(root)
    rng = np.random.RandomState(0)
    jobs = []
    for i in range(FOLDERS_VIEWS):
        h, w = (756, 1008) if i % 2 == 0 else (1008, 756)
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([60 + 120 * x / w, 80 + 100 * y / h,
                        200 - 80 * (x + y) / (w + h)], -1)
        cx, cy = w * (0.3 + 0.03 * i), h * 0.55
        disk = ((x - cx) ** 2 + (y - cy) ** 2) < (0.2 * min(h, w)) ** 2
        img[disk] = [220, 90, 40]
        img += rng.randn(h, w, 3).astype(np.float32) * 6
        jobs.append((os.path.join(root, f"obj___0_{30 * i}_1.png"),
                     np.clip(img, 0, 255).astype(np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(image_io.write_png, path, img)
                  for path, img in jobs]:
            f.result()
    return [path for path, _ in jobs]


def folders_mode0_config(folder, exp_dir):
    """input_configs/train_mode0.yaml as the train CLI reads it, on this
    folder, FOLDERS_WARM + FOLDERS_STEPS steps, a validation round every
    FOLDERS_WARM steps on two seeds (the phase's validator runs one), the
    first FOLDERS_PROMPTS validation prompts, no reports."""
    from view_neti_tpu_torch.config import parse_cli
    cfg = parse_cli([
        "--config_path", FOLDERS_CONFIG, "--data.train_data_dir", folder,
        "--log.exp_dir", exp_dir, "--log.save_steps", str(10 ** 9),
        "--log.report_to", "none", "--log.save_dataset_images", "false",
        "--optim.max_train_steps", str(FOLDERS_WARM + FOLDERS_STEPS),
        "--eval.validation_steps", str(FOLDERS_WARM),
        "--eval.num_validation_images", str(len(VAL_SEEDS)),
        "--eval.validation_seeds", json.dumps(VAL_SEEDS),
        "--eval.num_denoising_steps", str(VAL_DENOISE)])
    cfg.eval.validation_prompts = cfg.eval.validation_prompts[
        :FOLDERS_PROMPTS]
    return cfg


def decode_fixtures(image_io, np):
    """Every committed image fixture (FIXTURE_DIRS) decoded by the port's
    readers: its shape and the sha256 of its RGB bytes against its
    manifest (PIL's decode when it was written), and its decode ms per
    megapixel (the median of DECODE_REPS decodes). Fails on a mismatch."""
    import hashlib
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for d in FIXTURE_DIRS:
        with open(os.path.join(here, d, "manifest.json")) as f:
            manifest = json.load(f)
        for rel, want in sorted(manifest.items()):
            path = os.path.join(here, d, rel)
            times = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                rgb = image_io.read_rgb(path)
                times.append(time.perf_counter() - t0)
            digest = hashlib.sha256(rgb.tobytes()).hexdigest()
            check(list(rgb.shape) == want["shape"]
                  and digest == want["sha256_rgb"],
                  f"{d}/{rel}: decode {rgb.shape} {digest} differs from "
                  f"PIL's {want}")
            mp = rgb.shape[0] * rgb.shape[1] / 1e6
            out[f"{d}/{rel}"] = float(np.median(times)) * 1e3 / mp
    return out


def crop_resize_check(np):
    """The host crop's resize (data/augment.py: native_bilinear_resize,
    csrc/bilinear_resize.cpp built with -march=native on this host) against
    its plain numpy version on the llff crops' shapes (a 1008x756 view's
    crop boxes to 512x512), within RESIZE_PLAIN_MAX_LEVELS; the ms of
    each."""
    from view_neti_tpu_torch.data import augment
    from view_neti_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.host_library("bilinear_resize")
    rng = np.random.default_rng(0)
    out = dict(max_levels=0, build_or_load_s=time.perf_counter() - t0,
               compiled_ms=[], plain_ms=[])
    for h, w in ((700, 900), (756, 640), (512, 1008)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        got = augment.native_bilinear_resize(img, FOLDERS_SIZE, FOLDERS_SIZE)
        t1 = time.perf_counter()
        want = augment.native_bilinear_resize_plain(img, FOLDERS_SIZE,
                                                    FOLDERS_SIZE)
        t2 = time.perf_counter()
        levels = int(np.abs(got.astype(int) - want.astype(int)).max())
        check(levels <= RESIZE_PLAIN_MAX_LEVELS,
              f"the crop resize at {h}x{w} is {levels} levels from its "
              f"plain version")
        out["max_levels"] = max(out["max_levels"], levels)
        out["compiled_ms"].append((t1 - t0) * 1e3)
        out["plain_ms"].append((t2 - t1) * 1e3)
    return out


def phase_folders(torch, dev, card):
    """Training on other datasets' folders and the export of its mappers:
    every committed image fixture held to its manifest, the mode-0 recipe
    on a folder of the five baseline JPEGs and one view per other format
    (the flip on the card), then a spherical mode-2 run on an llff folder
    of two image sizes with preset 7 on the host (data.device_augment
    false), each with a
    validation round after its warm-up and a final checkpoint; both runs'
    checkpoints exported through python -m view_neti_tpu_torch.export_torch
    and imported back through torch_interop.import_torch_artifacts."""
    import gc
    import numpy as np
    from view_neti_tpu_torch import export_torch, torch_interop, weight_port
    from view_neti_tpu_torch.checkpoint import CheckpointHandler
    from view_neti_tpu_torch.data import image_io
    from view_neti_tpu_torch.data.dataset import DataLoader
    from view_neti_tpu_torch.ops import device_augment as da
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.training.validate import ValidationHandler

    B, n = TRAIN_BATCH, FOLDERS_WARM + FOLDERS_STEPS
    per_step = {**unet_k1(1), **unet_bwd(1, FOLDERS_BWD_SM90),
                **k4(encodes=1)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_folders")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    class OnceValidation(ValidationHandler):
        """The round at step FOLDERS_WARM, timed; no later one."""
        rounds = []

        def infer(self, coach, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().infer(coach, step)
            torch.cuda.synchronize()
            end = time.perf_counter()
            self.rounds.append(dict(step=step, s=end - t0, end=end, res=res))
            self.cfg.eval.validation_steps = 10 ** 9
            return res

    def run(cfg, name, expect):
        """Build, train (counted) and profile one Coach; its stats."""
        t0 = time.perf_counter()
        coach = Coach(cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(coach.micro_batch_size == B and expect(coach),
              f"the {name} Coach did not take its path")
        coach.validator = OnceValidation(cfg)
        OnceValidation.rounds = []
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        coach.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(coach.global_step == n, f"the {name} Coach ran "
                                      f"{coach.global_step} steps")
        rounds = OnceValidation.rounds
        check(len(rounds) == 1 and rounds[0]["step"] == FOLDERS_WARM,
              f"{name}: validation rounds {[r['step'] for r in rounds]}")
        renders = FOLDERS_PROMPTS if name == "mode0" else (
            1 + FOLDERS_SHEET_TOKENS)
        want = add_counts({k: v * n for k, v in per_step.items()},
                          unet_k1(VAL_DENOISE * renders),
                          k4(decodes=renders))
        check(launches == want, f"{name} launches {launches}, want {want}")
        # the mappers as the final checkpoint saved them (the profiled
        # step below moves them)
        text = coach.built.text
        live = {tok: {k: v.detach().cpu().clone()
                      for k, v in m.state_dict().items()}
                for tok, m in zip(coach.placeholder_object_tokens,
                                  text.obj_mappers)}
        if text.view_mapper is not None:
            live["view"] = {k: v.detach().cpu().clone()
                            for k, v in text.view_mapper.state_dict().items()}
        losses = coach.losses
        check(len(losses) == n and all(math.isfinite(x) for x in losses),
              f"{name} losses {losses}")
        # the timed steps start after the validation round
        ms_step = ((coach.loop_end_s - rounds[0]["end"]) * 1e3
                   / FOLDERS_STEPS)
        batch = coach._build_batch(next(iter(DataLoader(
            coach.train_dataset, B))))

        def one_step():
            coach.train_step(coach.built, batch,
                             coach._step_draws(10 ** 6, batch))

        prof = device_profile(torch, augment_ranged(one_step),
                              ranges=("device_augment",))
        # the step's device time by CUDA events beside the profile's busy
        # time (the batch is on the card: no loader in it)
        step_ms = time_ms(torch, one_step, 1500.0)
        stats = dict(
            imgs_per_sec=B * 1e3 / ms_step, ms_per_step=ms_step,
            peak_memory_gib=peak_gb, build_s=build_s,
            train_s=train_s, validation_s=rounds[0]["s"], renders=renders,
            losses=losses,
            launches_per_step={
                k: (launches[k] - want[k] + per_step[k] * n) / n
                for k in per_step},
            step_ms=step_ms,
            step_busy_ms=prof["busy_ms"] if prof else None,
            step_launches=prof["kernels"] if prof else None,
            step_idle_share=prof["idle_share"] if prof else None)
        return coach, live, launches, stats, prof

    def export_and_reimport(coach, live, name, keys):
        """The final checkpoint through the export CLI and back through
        import_torch_artifacts: every mapper tree and the embeddings bit
        for bit, and each mapper equal to the live module."""
        run_dir = str(coach.cfg.log.exp_dir)
        src = {k: os.path.join(run_dir, f"mapper-final_{k}.msgpack")
               for k in keys}
        embeds = os.path.join(run_dir, "learned_embeds-final.msgpack")
        out = os.path.join(root, f"{name}_torch")
        args = ["--out", out, "--embeds", embeds, "--iteration", str(n)]
        for k in keys:
            args += [f"--{k}", src[k]]
        t0 = time.perf_counter()
        written = export_torch.main(args)
        export_s = time.perf_counter() - t0
        back_dir = os.path.join(root, f"{name}_back")
        t0 = time.perf_counter()
        back = torch_interop.import_torch_artifacts(
            back_dir, iteration=n, embeds_path=written[-1],
            **{f"{k}_path": os.path.join(out, f"mapper-steps-{n}_{k}.pt")
               for k in keys})
        import_s = time.perf_counter() - t0
        check(len(written) == len(keys) + 1 and len(back) == len(keys) + 1,
              f"{name}: exported {written}, imported {back}")

        def same_tree(a, b):
            if isinstance(a, dict):
                return a.keys() == b.keys() and all(same_tree(a[k], b[k])
                                                    for k in a)
            return np.array_equal(np.asarray(a), np.asarray(b))

        for k in keys:
            orig = CheckpointHandler.load_raw(src[k])["mappers"]
            again = CheckpointHandler.load_raw(os.path.join(
                back_dir, f"mapper-steps-{n}_{k}.msgpack"))["mappers"]
            check(orig.keys() == again.keys(), f"{name} {k}: mappers "
                                               f"{list(again)}")
            for tok, entry in orig.items():
                check(same_tree(entry["params"], again[tok]["params"])
                      and same_tree(entry["constants"] or {},
                                    again[tok]["constants"] or {}),
                      f"{name} {k} {tok!r}: the re-imported mapper differs")
                saved = weight_port.from_jax_mapper(again[tok]["params"],
                                                    again[tok]["constants"])
                check(saved.keys() == live[tok].keys() and all(
                    torch.equal(saved[x], live[tok][x]) for x in saved),
                    f"{name} {k} {tok!r}: differs from the trained mapper")
        rows = CheckpointHandler.load_learned_embeds(embeds)
        rows_back = CheckpointHandler.load_learned_embeds(os.path.join(
            back_dir, f"learned_embeds-steps-{n}.msgpack"))
        check(rows.keys() == rows_back.keys() and all(
            np.array_equal(rows[t], rows_back[t]) for t in rows),
            f"{name}: the re-imported embeddings differ")
        return dict(export_s=export_s, import_s=import_s,
                    files=[os.path.basename(p) for p in written],
                    bit_equal=True)

    try:
        # ---- every fixture's decode against PIL's ------------------------
        fixtures_ms_per_mp = decode_fixtures(image_io, np)
        print(f"decode fixtures [{card}]: "
              f"{json.dumps(fixtures_ms_per_mp)}", flush=True)
        kinds_ms_per_mp = {k: fixtures_ms_per_mp[v]
                           for k, v in DECODE_KINDS.items()}
        print(f"decode kinds 512x512 ms/MP [{card}]: "
              f"{json.dumps(kinds_ms_per_mp)}", flush=True)
        resize_check = crop_resize_check(np)
        print(f"crop resize [{card}]: {json.dumps(resize_check)}",
              flush=True)

        # ---- (a) the mode-0 recipe on the mixed-format folder ------------
        folder = os.path.join(root, "teapot")
        os.makedirs(folder)
        here = os.path.dirname(os.path.abspath(__file__))
        for d in FOLDERS_VIEW_DIRS:
            for f in sorted(os.listdir(os.path.join(here, d))):
                shutil.copy(os.path.join(here, d, f), folder)
        views = sorted(os.listdir(folder))
        cfg = folders_mode0_config(folder, os.path.join(root, "mode0"))
        m = cfg.model
        check(cfg.learnable_mode == 0 and cfg.data.resolution == FOLDERS_SIZE
              and cfg.data.flip_p == 0.5 and cfg.data.augmentation_key == 0
              and m.arch_view_net == 15 and m.use_nested_dropout
              and m.output_bypass_object
              and m.output_bypass_alpha_object == 0.2
              and "stable-diffusion-v1-5" in m.pretrained_model_name_or_path
              and cfg.optim.train_batch_size == 3
              and cfg.optim.gradient_accumulation_steps == 3,
              "the mode-0 recipe changed")
        coach, live, launches_a, stats_a, prof_a = run(
            cfg, "mode0", lambda c: (
                c.augment_spec == da.from_augmentation_key(0, 0.5)
                and c.use_pixel_cache and not c.cache_latents
                and c.compute_dtype == torch.bfloat16
                and c.train_dataset.num_images == len(views)
              == FOLDERS_MODE0_VIEWS))
        check(os.path.exists(os.path.join(
            root, "mode0", f"val-images-{FOLDERS_WARM}.png")),
            "no mode-0 validation sheet")
        stats_a["export"] = export_and_reimport(coach, live, "mode0",
                                                ["object"])
        del coach
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) a spherical llff folder with preset 7 on the host -------
        t0 = time.perf_counter()
        pngs = write_llff_views(os.path.join(root, "llff", "obj"), image_io,
                                np)
        write_s = time.perf_counter() - t0
        tokens = [f"<view_0_{30 * i}_1>" for i in range(FOLDERS_VIEWS)]
        cfg_b = mode2_config(
            os.path.join(root, "llff", "obj"), os.path.join(root, "llff_run"),
            data={"camera_representation": "spherical",
                  "device_augment": False, "dtu_preprocess_key": 0,
                  "augmentation_key": 7},
            eval={"validation_prompts": ["A photo of a {}"],
                  "validation_steps": FOLDERS_WARM,
                  "validation_view_tokens": tokens[:FOLDERS_SHEET_TOKENS],
                  "validation_seeds": VAL_SEEDS,
                  "num_validation_images": len(VAL_SEEDS),
                  "num_denoising_steps": VAL_DENOISE},
            optim={"max_train_steps": n})
        coach, live, launches_b, stats_b, prof_b = run(
            cfg_b, "llff", lambda c: (
                c.augment_spec is None and not c.use_pixel_cache
                and not c.cache_latents
                and not c.train_dataset.uniform_base_shape
                and c.train_dataset.augmentations is not None
                and c.built.view_table.deg_freedom == "phi"
                and c.placeholder_view_tokens == tokens))
        check(os.path.exists(os.path.join(
            root, "llff_run", f"val-image-{FOLDERS_WARM}.png")),
            "no prompt sheet")
        # the host augmentation per example on cached bases, and the
        # pixels it gives
        ds = coach.train_dataset
        for p in pngs:
            ds._load_base(p)
        t0 = time.perf_counter()
        pix = [ds._load_pixels(pngs[i % len(pngs)],
                               np.random.default_rng((7, i)))
               for i in range(B)]
        aug_ms = (time.perf_counter() - t0) * 1e3 / B
        check(all(x.shape == (FOLDERS_SIZE, FOLDERS_SIZE, 3)
                  and x.min() >= -1 and x.max() <= 1 for x in pix),
              "host-augmented pixels")
        # the same examples with the crop's plain numpy resize, for the
        # compiled resize's share of the host path
        from view_neti_tpu_torch.data import augment
        compiled = augment.native_bilinear_resize
        augment.native_bilinear_resize = augment.native_bilinear_resize_plain
        try:
            t0 = time.perf_counter()
            for i in range(B):
                ds._load_pixels(pngs[i % len(pngs)],
                                np.random.default_rng((7, i)))
            aug_plain_ms = (time.perf_counter() - t0) * 1e3 / B
        finally:
            augment.native_bilinear_resize = compiled
        print(f"llff host path [{card}]: {aug_ms:.3f} ms per example "
              f"(preset 7 on cached bases, crop to {FOLDERS_SIZE}x"
              f"{FOLDERS_SIZE}, B = {B}); {aug_plain_ms:.3f} with the "
              f"crop's plain numpy resize", flush=True)
        stats_b.update(host_augment_ms_per_example=aug_ms,
                       host_augment_plain_crop_ms_per_example=aug_plain_ms,
                       host_augment_share_of_step=(
                           aug_ms * B / stats_b["ms_per_step"]),
                       write_views_s=write_s)
        stats_b["export"] = export_and_reimport(coach, live, "llff",
                                                ["view", "object"])
        del coach, ds, pix
        gc.collect()
        torch.cuda.empty_cache()

        # ---- decode speed: the llff 8-bit PNGs beside the fixtures --------
        mp = sum(np.prod(image_io.image_size(p)) for p in pngs) / 1e6
        t0 = time.perf_counter()
        for p in pngs:
            image_io.read_rgb(p)
        decode = dict(llff_png8_ms_per_mp=(time.perf_counter() - t0) * 1e3
                      / mp, fixtures_equal_to_pil=len(fixtures_ms_per_mp),
                      kinds_ms_per_mp=kinds_ms_per_mp,
                      crop_resize=resize_check)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    stats = dict(model="SD-1.5 (runwayml/stable-diffusion-v1-5, seeded "
                       "weights)", batch=B, height=FOLDERS_SIZE,
                 width=FOLDERS_SIZE, warmup_steps=FOLDERS_WARM,
                 timed_steps=FOLDERS_STEPS, mode0=stats_a, llff=stats_b,
                 decode=decode, launches=launches)
    print(f"folders [{card}]: {json.dumps(stats)}", flush=True)
    print(f"profile folders mode0 step [{card}]: "
          f"{json.dumps(prof_a) if prof_a else 'not measured'}", flush=True)
    print(f"profile folders llff step [{card}]: "
          f"{json.dumps(prof_b) if prof_b else 'not measured'}", flush=True)
    return launches, stats


# the ddp phase: the coach phase's recipe over DDP_WORLD ranks of
# torch.distributed (gloo when they share the card, NCCL with a card each),
# B = 9 as 3 rows a rank, against one process; then the split DTU sweep of
# its last checkpoint: the six scan cameras cut to DDP_DENOISE steps
DDP_WORLD = 3
DDP_WARM = 2             # warm-up steps, then DDP_STEPS timed ones
DDP_STEPS = 2
DDP_DENOISE = 5
DDP_VAL_CAMS = 2         # the validation round's cameras (cfg.debug) ...
DDP_VAL_DENOISE = 2      # ... and its denoising steps (ValidationHandler)
DDP_LOSS_RTOL = 1e-5
DDP_MAPPER_RTOL, DDP_MAPPER_ATOL = 5e-3, 1e-5   # tests/test_parallel.py
# the ranks' first loss against the fused one-process run's (relative):
# the limit lies between the sound reading and the planted control's
# (the dropout draws of each rank's rows shifted by one row), which it
# must catch
DDP_FUSED_STEP1_RTOL = 3e-4
DDP_TIMEOUT_S = 300      # a rank waiting longer on a collective ends it


def ddp_config(rect, exp_dir):
    """The coach phase's mode-2 recipe, DDP_WARM + DDP_STEPS steps, one
    checkpoint at the last one and, where a validator is attached
    (ddp_validator), one debug validation round after it: the first
    DDP_VAL_CAMS eval cameras, seeds [0, 1]."""
    steps = DDP_WARM + DDP_STEPS
    cfg = mode2_config(rect, exp_dir, log={"save_steps": steps},
                       eval={"validation_prompts": ["A photo of a {}"],
                             "validation_steps": steps,
                             "validation_seeds": VAL_SEEDS,
                             "num_validation_images": len(VAL_SEEDS)},
                       optim={"max_train_steps": steps})
    cfg.debug = True
    return cfg


def ddp_validator(torch, coach, cal):
    """Attach the ddp phase's validation round to a Coach (every rank needs
    one to enter the round): ValidationHandler's round under cfg.debug, the
    DTU sweep of DDP_VAL_CAMS cameras (its result bundle in the run's
    directory) and one object render, at DDP_VAL_DENOISE steps. Each
    round's seconds, after the card finishes the step before it, go to
    coach.validate_s and its kernel launches to coach.validate_launches,
    so that the step times and the training's launches leave them out."""
    from view_neti_tpu_torch.training.validate import ValidationHandler

    coach.validator = ValidationHandler(coach.cfg, calibration_dir=cal)
    coach.validate_s = []
    coach.validate_launches = dict.fromkeys(launch_counts(), 0)
    validate = coach._validate

    def timed():
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        validate()
        coach.validate_s.append(time.perf_counter() - t0)
        for k, v in launch_counts().items():
            coach.validate_launches[k] += v - before[k]
    coach._validate = timed


def ddp_run_stats(coach, warm=DDP_WARM, steps=DDP_STEPS):
    """A finished Coach's losses, host copies of its mappers, counts, and
    the timed steps' ms a step on the host's clock (the steps after warm),
    its validation rounds left out."""
    from view_neti_tpu_torch.utils import profiling
    ends = [sp.end_ns * 1e-9
            for sp in profiling.within(coach.loop_span, "coach.step")]
    return dict(
        losses=coach.losses,
        mappers={k: v.numpy() for k, v in mapper_state(coach).items()},
        counts=coach.optimizer.counts,
        ms_per_step=(coach.loop_end_s - ends[(warm - 1) // coach.accum_k]
                     - sum(getattr(coach, "validate_s", ()))) * 1e3
        / steps)


def ddp_rank(rank, world, root, rect, cal, cams):
    """One spawned rank of the ddp phase: the recipe's Coach on its rows of
    the fused batch, the kernels' launches and the peak memory of its
    training, then its share of the split sweep of the last checkpoint
    (rank 0 requests it and gathers the images). Writes what it measured
    to root/rank<r>.pkl."""
    import pickle
    import torch
    from view_neti_tpu_torch.parallel import dist
    from view_neti_tpu_torch.training import inference_dtu
    from view_neti_tpu_torch.training.coach import Coach
    steps = DDP_WARM + DDP_STEPS
    dp = dist.init_distributed(
        store=torch.distributed.FileStore(os.path.join(root, "store"),
                                          world),
        rank=rank, world_size=world, timeout_s=DDP_TIMEOUT_S)
    # time the gradient all-reduce (dist.all_reduce_mean_'s all-gather)
    # on the host's clock: the collective with its wait for the slowest
    # rank, or on NCCL its enqueue; and the bytes a rank sends
    gather, reduce_s, reduce_bytes = torch.distributed.all_gather, [], []

    def timed_gather(parts, tensor, *args, **kwargs):
        t0 = time.perf_counter()
        out = gather(parts, tensor, *args, **kwargs)
        reduce_s.append(time.perf_counter() - t0)
        reduce_bytes.append(tensor.numel() * tensor.element_size())
        return out
    torch.distributed.all_gather = timed_gather
    coach = Coach(ddp_config(rect, os.path.join(root, "ranks")),
                  calibration_dir=cal, dist=dp)
    ddp_validator(torch, coach, cal)
    # the counted run: the user's entry point, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    coach.train()
    torch.cuda.synchronize()
    launches = {k: v - coach.validate_launches[k]
                for k, v in launch_counts().items()}
    out = ddp_run_stats(coach)
    out.update(rank=rank, backend=dp.backend, shared_card=dp.shared_card,
               device=str(dp.device), launches=launches,
               validate_s=coach.validate_s,
               validate_launches=coach.validate_launches,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               reduce_ms=[x * 1e3 for x in reduce_s[DDP_WARM:]],
               reduce_bytes=sorted(set(reduce_bytes)))
    dist.barrier(dp)
    t0 = time.perf_counter()
    if dp.is_main:
        preds = inference_dtu.dtu_generate_camidxs_to_preds(
            coach, cams, steps, num_denoising_steps=DDP_DENOISE,
            seeds=VAL_SEEDS, calibration_dir=cal, on_missing_ckpt="raise")
        inference_dtu.end_sweeps(coach, False)
    else:
        check(not inference_dtu.serve_sweeps(coach),
              "rank 0 failed the split sweep")
        preds = None
    torch.cuda.synchronize()
    out.update(sweep_s=time.perf_counter() - t0, preds=preds)
    dist.barrier(dp)
    dist.destroy(dp)
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ddp_chunk(batch, draws, lo, hi, shift_dropout=False):
    """Rows lo:hi of a fused mode-2 batch and of its StepDraws, by plain
    indexing, independent of parallel/dist.py: every per-row tensor's rows,
    and the nested-dropout draws' columns of their (K, B) layer-major
    layout. shift_dropout plants a sharding fault, the control of
    DDP_FUSED_STEP1_RTOL: each row takes the dropout draws of the row
    before it."""
    from view_neti_tpu_torch.training.train_step import StepDraws, TrainBatch
    B = len(batch.input_ids)
    check(isinstance(batch.object_idx, int),
          f"a mode-2 batch has one object, not {batch.object_idx}")

    def layer_major(x):
        x = x.reshape(-1, B)
        if shift_dropout:
            x = x.roll(1, dims=1)
        return x[:, lo:hi].reshape(-1)

    part = TrainBatch(
        pixel_values=batch.pixel_values[lo:hi],
        input_ids=batch.input_ids[lo:hi],
        input_ids_placeholder_object=batch.input_ids_placeholder_object[lo:hi],
        input_ids_placeholder_view=batch.input_ids_placeholder_view[lo:hi],
        object_idx=batch.object_idx)
    augment = draws.augment and dataclasses.replace(draws.augment, **{
        f.name: getattr(draws.augment, f.name)[lo:hi]
        for f in dataclasses.fields(draws.augment)})
    dropout = draws.dropout and {
        key: tuple(layer_major(t) for t in d)
        for key, d in draws.dropout.items()}
    return part, StepDraws(vae_eps=draws.vae_eps[lo:hi],
                           noise=draws.noise[lo:hi],
                           timesteps=draws.timesteps[lo:hi],
                           dropout=dropout, augment=augment)


def ddp_chunked_reference(torch, coach, world):
    """One process computing each fused step as the ranks compute it: the
    one-process Coach's fused batch and draws, cut into world chunks of
    rows (ddp_chunk), each chunk's forward and backward alone, so at a
    rank's shapes and roundings, the chunks' gradients and losses added in
    rank order in fp32 and divided by world, one optimizer step. Also the
    first step's loss with the planted fault (ddp_chunk's shift_dropout).
    Returns ddp_run_stats's losses, mappers and counts, and
    control_loss."""
    from view_neti_tpu_torch.data.dataset import DataLoader
    from view_neti_tpu_torch.training import train_step as tts
    check(not coach.dist.active, "the reference is one process")
    ds = coach.train_dataset
    coach._fill_base_cache()
    ds.skip_pixels = True
    stream = iter(DataLoader(ds, coach.micro_batch_size, seed=coach.cfg.seed))
    opt = coach.optimizer
    params = [p for g in opt.optimizer.param_groups for p in g["params"]]
    n = coach.micro_batch_size // world

    def chunk_loss(batch, draws, r, shift_dropout=False):
        part, part_draws = ddp_chunk(batch, draws, r * n, (r + 1) * n,
                                     shift_dropout)
        latents = tts.encode_latents(
            coach.built, part, part_draws, coach.compute_dtype,
            coach.cache_latents, coach.augment_spec)
        return tts.diffusion_loss(coach.built, part, part_draws, latents,
                                  coach.compute_dtype)

    def rank_mean(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return float(total / world)

    losses, control = [], None
    for step in range(DDP_WARM + DDP_STEPS):
        batch = coach._build_batch(next(stream))
        draws = coach._step_draws(step, batch)
        if step == 0:
            with torch.no_grad():
                control = rank_mean([chunk_loss(batch, draws, r, True)
                                     for r in range(world)])
        sums = [torch.zeros_like(p) for p in params]
        parts = []
        opt.zero_grad()
        for r in range(world):
            loss = chunk_loss(batch, draws, r)
            loss.backward()
            for total, p in zip(sums, params):
                if p.grad is not None:
                    total += p.grad
                    p.grad = None
            parts.append(loss.detach())
        for total, p in zip(sums, params):
            p.grad = total / world
        opt.step()
        losses.append(rank_mean(parts))
    return dict(losses=losses,
                mappers={k: v.numpy() for k, v in mapper_state(coach).items()},
                counts=opt.counts, control_loss=control)


def ddp_diff(got, want):
    """(largest relative loss difference, largest mapper difference, the
    mapper elements outside DDP_MAPPER_RTOL / DDP_MAPPER_ATOL)."""
    import numpy as np
    losses = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                      want["losses"]))
    worst, outside = 0.0, 0
    for k, w in want["mappers"].items():
        d = np.abs(got["mappers"][k] - w)
        worst = max(worst, float(d.max()))
        outside += int((d > DDP_MAPPER_ATOL
                        + DDP_MAPPER_RTOL * np.abs(w)).sum())
    return float(losses), worst, outside


def phase_ddp(torch, dev, card):
    """Data-parallel training and the split DTU sweep over
    torch.distributed (view_neti_tpu_torch/parallel/dist.py): the coach
    phase's recipe (mode 2, SD-1.5 at full width, preset 7 on the base
    cache, fused B = 9 at 384x512, bf16) in one process; the same through
    a process group of one rank over NCCL, bit for bit; over DDP_WORLD
    spawned ranks (gloo when they share this card, NCCL with a card each),
    3 rows a rank, each step's loss within DDP_LOSS_RTOL and the mappers
    within tests/test_parallel.py's tolerance of one process at the ranks'
    shapes (ddp_chunked_reference), the first loss within
    DDP_FUSED_STEP1_RTOL of the fused one-process run's (and the planted
    fault beyond it), the same per-slice counts and one set of checkpoint
    files; the validation round after the last step (ddp_validator), its
    sweep split over the ranks, equal to one process's round on the ranks'
    checkpoint bit for bit; then the six scan cameras of the last
    checkpoint rendered split over the ranks (seeds [0, 1], DDP_DENOISE
    DPM-Solver++ steps, CFG 7.5) equal to one process's render bit for
    bit."""
    import gc
    import pickle
    import numpy as np
    import torch.multiprocessing as mp
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.parallel import dist
    from view_neti_tpu_torch.training import inference_dtu
    from view_neti_tpu_torch.training.coach import Coach
    from view_neti_tpu_torch.utils import msgpack_codec

    steps = DDP_WARM + DDP_STEPS
    per_step = SD15_STEP
    want_launches = {k: v * steps for k, v in per_step.items()}
    cams = dtu.dtu_get_train_idxs(6)
    val_cams = inference_dtu.get_cam_idxs(6)[0][:DDP_VAL_CAMS]
    with tempfile.TemporaryDirectory() as root:
        # the train cameras first: their pixels are drawn as before
        rect, cal, _, _ = write_scan(
            root, image_io, dtu, np,
            cams=list(cams) + [c for c in val_cams if c not in cams])
        single = Coach(ddp_config(rect, os.path.join(root, "single")),
                       calibration_dir=cal, device=dev)
        ddp_validator(torch, single, cal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        single.train()
        torch.cuda.synchronize()
        ref = ddp_run_stats(single)
        ref["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        # NCCL at world size 1, through the same code
        dp = dist.init_distributed(
            store=torch.distributed.FileStore(os.path.join(root, "store1"),
                                              1),
            rank=0, world_size=1, timeout_s=DDP_TIMEOUT_S)
        check(dp.backend == "nccl" and dp.active,
              f"one rank with a card took {dp.backend}")
        coach = Coach(ddp_config(rect, os.path.join(root, "nccl")),
                      calibration_dir=cal, dist=dp)
        launch_counts(reset=True)
        coach.train()
        torch.cuda.synchronize()
        nccl_launches = launch_counts()
        nccl = ddp_run_stats(coach)
        dist.destroy(dp)
        nccl_equal = (nccl["losses"] == ref["losses"] and all(
            np.array_equal(v, ref["mappers"][k])
            for k, v in nccl["mappers"].items())
            and nccl["counts"] == ref["counts"])
        del coach, dp
        gc.collect()
        torch.cuda.empty_cache()

        # one process at the ranks' shapes: the reference they are held to
        coach = Coach(ddp_config(rect, os.path.join(root, "chunked")),
                      calibration_dir=cal, device=dev)
        chunked = ddp_chunked_reference(torch, coach, DDP_WORLD)
        del coach
        gc.collect()
        torch.cuda.empty_cache()

        # DDP_WORLD ranks on the card(s)
        t0 = time.perf_counter()
        mp.start_processes(ddp_rank, args=(DDP_WORLD, root, rect, cal, cams),
                           nprocs=DDP_WORLD, join=True,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(DDP_WORLD):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        files = {name: sorted(os.listdir(os.path.join(root, name)))
                 for name in ("single", "ranks")}
        with open(os.path.join(root, "ranks", "logs", "log.txt")) as f:
            log = f.read()

        # one process renders the same checkpoint, and runs the ranks'
        # validation round on it
        single.cfg.log.exp_dir = os.path.join(root, "ranks")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = inference_dtu.render_cameras(
            single, cams, steps, num_denoising_steps=DDP_DENOISE,
            seeds=VAL_SEEDS, calibration_dir=cal, on_missing_ckpt="raise")
        torch.cuda.synchronize()
        single_sweep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        val_want = single.validator.infer_dtu(
            single, steps, DDP_VAL_DENOISE, return_instead_of_save=True,
            on_missing_ckpt="raise")
        single_val_s = time.perf_counter() - t0
        # the ranks' round, as rank 0 wrote its bundle
        with open(os.path.join(
                root, "ranks", f"validation-iter_{steps}-denoisesteps_"
                f"{DDP_VAL_DENOISE}_numseeds_{len(VAL_SEEDS)}.msgpack"),
                "rb") as f:
            val_got = msgpack_codec.unpackb(f.read())["imgs_pred"]
    single_val_train_s = single.validate_s
    del single
    gc.collect()
    torch.cuda.empty_cache()

    main = ranks[0]
    loss_rel, mapper_abs, outside = ddp_diff(main, chunked)
    fused_loss_rel, fused_mapper_abs, fused_outside = ddp_diff(main, ref)
    fused_step1 = abs(main["losses"][0] - ref["losses"][0]) / abs(
        ref["losses"][0])
    control_step1 = abs(chunked["control_loss"] - ref["losses"][0]) / abs(
        ref["losses"][0])
    preds = main["preds"]
    sweep_equal = (preds is not None and list(preds) == list(cams) and all(
        np.array_equal(preds[c], want[c]) for c in cams))
    sweep_levels = (max(int(np.abs(preds[c].astype(int) - want[c]).max())
                        for c in cams) if preds is not None else None)
    shared = torch.cuda.device_count() < DDP_WORLD
    reduce_ms = [x for r in ranks for x in r["reduce_ms"]]
    val_ref = np.stack(val_want["imgs_pred"])
    val_equal = (val_want["cam_idxs"] == val_cams
                 and np.array_equal(val_got, val_ref))
    val_levels = (float(np.abs(val_got - val_ref).max()) * 255
                  if val_got.shape == val_ref.shape else None)
    # a rank's share of the sweep's cameras, and on rank 0 the render
    val_launches = [{k: n * (len(dist.split_items(val_cams, r["rank"],
                                                  DDP_WORLD))
                             + (r["rank"] == 0))
                     for k, n in {**unet_k1(DDP_VAL_DENOISE), **unet_bwd(0),
                                  **k4(decodes=1)}.items()}
                    for r in ranks]
    stats = dict(
        backend=main["backend"], world=DDP_WORLD,
        ranks_share_one_card=main["shared_card"],
        note=("the ranks share one card: the rate is not a scaling figure"
              if main["shared_card"] else "one rank per card"),
        batch=TRAIN_BATCH, rows_per_rank=TRAIN_BATCH // DDP_WORLD,
        height=TRAIN_HEIGHT, width=TRAIN_WIDTH, warmup_steps=DDP_WARM,
        timed_steps=DDP_STEPS,
        imgs_per_sec=TRAIN_BATCH * 1e3 / main["ms_per_step"],
        ms_per_step=main["ms_per_step"],
        ms_per_step_by_rank=[r["ms_per_step"] for r in ranks],
        one_process_ms_per_step=ref["ms_per_step"],
        one_process_imgs_per_sec=TRAIN_BATCH * 1e3 / ref["ms_per_step"],
        allreduce_ms_per_step=float(np.mean(reduce_ms)),
        allreduce_ms_max=float(np.max(reduce_ms)),
        allreduce_bytes=main["reduce_bytes"][0],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in ranks],
        one_process_peak_memory_gib=ref["peak_memory_gib"],
        launches_per_step_by_rank=[{k: v / steps for k, v in
                                    r["launches"].items()} for r in ranks],
        max_loss_rel_diff=loss_rel, max_mapper_abs_diff=mapper_abs,
        mapper_elements_outside_tolerance=outside,
        mapper_elements=sum(v.size for v in ref["mappers"].values()),
        fused_step1_loss_rel_diff=fused_step1,
        fused_step1_limit=DDP_FUSED_STEP1_RTOL,
        control_step1_loss_rel_diff=control_step1,
        fused_max_loss_rel_diff=fused_loss_rel,
        fused_max_mapper_abs_diff=fused_mapper_abs,
        fused_mapper_elements_outside_tolerance=fused_outside,
        losses=main["losses"], one_process_chunked_losses=chunked["losses"],
        one_process_fused_losses=ref["losses"],
        counts_equal=all(r["counts"] == chunked["counts"] == ref["counts"]
                         for r in ranks),
        nccl_world1_bit_equal=nccl_equal,
        nccl_world1_ms_per_step=nccl["ms_per_step"],
        sweep_cams=len(cams), sweep_denoising_steps=DDP_DENOISE,
        sweep_s_split=main["sweep_s"], sweep_s_one_process=single_sweep_s,
        sweep_bit_equal=sweep_equal, sweep_max_diff_levels=sweep_levels,
        val_round_cams=val_cams, val_round_denoising_steps=DDP_VAL_DENOISE,
        val_round_s_by_rank=[r["validate_s"] for r in ranks],
        val_round_s_one_process_training=single_val_train_s,
        val_round_s_one_process=single_val_s,
        val_round_launches_by_rank=[r["validate_launches"] for r in ranks],
        val_round_bit_equal=val_equal,
        val_round_max_diff_levels=val_levels,
        ranks_wall_s=ranks_s, checkpoint_files=files["ranks"])
    print(f"ddp [{card}]: {json.dumps(stats)}", flush=True)
    check(all(r["backend"] == ("gloo" if shared else "nccl")
              and r["shared_card"] == shared for r in ranks),
          f"ranks took {[r['backend'] for r in ranks]}")
    check(nccl_launches == want_launches,
          f"NCCL world-1 launches {nccl_launches}, want {want_launches}")
    check(nccl_equal, "NCCL at world size 1 differs from one process")
    for r in ranks:
        check(r["launches"] == want_launches,
              f"rank {r['rank']} launches {r['launches']}, want "
              f"{want_launches}")
        check(r["losses"] == main["losses"] and all(
            np.array_equal(v, main["mappers"][k])
            for k, v in r["mappers"].items()),
              f"rank {r['rank']} ended with other losses or mappers")
    check(len(main["losses"]) == steps
          and all(math.isfinite(x) for x in main["losses"]),
          f"ddp losses {main['losses']}")
    check(loss_rel <= DDP_LOSS_RTOL,
          f"ddp losses differ from one process at the ranks' shapes by "
          f"{loss_rel} relative")
    check(outside == 0, f"{outside} mapper elements differ from one process "
                        f"at the ranks' shapes beyond rtol "
                        f"{DDP_MAPPER_RTOL}, atol {DDP_MAPPER_ATOL} "
                        f"(largest {mapper_abs})")
    check(fused_step1 <= DDP_FUSED_STEP1_RTOL,
          f"the ranks' first loss differs from the fused one-process run's "
          f"by {fused_step1} relative, limit {DDP_FUSED_STEP1_RTOL}")
    check(control_step1 > DDP_FUSED_STEP1_RTOL,
          f"the planted fault (dropout rows shifted by one) moved the first "
          f"loss by {control_step1} relative only: the limit "
          f"{DDP_FUSED_STEP1_RTOL} would not catch it")
    check(all(r["reduce_bytes"] == main["reduce_bytes"]
              and len(r["reduce_bytes"]) == 1 for r in ranks),
          f"the ranks sent {[r['reduce_bytes'] for r in ranks]} bytes")
    check(stats["counts_equal"], "per-slice counts differ")
    check(files["ranks"] == files["single"],
          f"checkpoint files {files['ranks']}, one process "
          f"{files['single']}")
    check(log.count("***** Running training *****") == 1,
          "more than rank 0 logged")
    check(sweep_equal, f"the split sweep differs from one process by up to "
                       f"{sweep_levels} levels")
    check(all(len(r["validate_s"]) == 1 for r in ranks)
          and len(single_val_train_s) == 1,
          "a run did not validate once")
    check([r["validate_launches"] for r in ranks] == val_launches,
          f"validation launches {[r['validate_launches'] for r in ranks]}, "
          f"want {val_launches}")
    check(val_equal, f"the ranks' validation round differs from one "
                     f"process's by up to {val_levels} levels")
    return stats


# the tp phase: the coach phase's recipe over TP_WORLD ranks in a dp 1 x
# tp TP_WORLD layout with the frozen UNet and CLIP split over them
# (parallel/tensor.py), against one process; a render at the serving
# shapes cut to TP_DENOISE steps; one SD-2.1 UNet forward
TP_WORLD = 2
TP_WARM = 2              # warm-up steps, then TP_STEPS timed ones
TP_STEPS = 2
TP_DENOISE = 5
# the ranks against one process computing the split (tp_emulate_): each
# step's loss (relative) and the mappers (tests/test_parallel.py); the
# loss limit must catch the planted fault (TP_FAULT_INPUTS)
TP_LOSS_RTOL = 1e-5
TP_MAPPER_RTOL, TP_MAPPER_ATOL = 5e-3, 1e-5
# the planted faults: the backward sum over the tp group of this
# attention's inputs left out (the train step), and rank 1's partial of
# this row-parallel layer dropped (the render)
TP_FAULT_INPUTS = "mid_block.attentions.0.transformer_blocks.0.attn2"
TP_FAULT_ROW = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.2"
# the render against one process's: the mean uint8 difference, a limit
# that the planted fault must exceed
TP_RENDER_MEAN_LIMIT = 5.0
# SD-2.1's UNet forward at tp against one process: rms(diff) / rms(out)
TP_SD21_RTOL = 2e-2
TP_TIMEOUT_S = 300


def tp_config(rect, exp_dir, parallel=None):
    """The coach phase's mode-2 recipe for TP_WARM + TP_STEPS steps, with
    the parallel section of the ranks (one process ignores it)."""
    cfg = mode2_config(rect, exp_dir,
                       optim={"max_train_steps": TP_WARM + TP_STEPS})
    cfg.parallel = dataclasses.replace(cfg.parallel, **(parallel or {}))
    return cfg


def tp_render(torch, coach):
    """The serving slice's render on a Coach's stack: the first view token
    and the object, seeds 0 1 2 at HEIGHT x WIDTH, TP_DENOISE DPM-Solver++
    steps, CFG 7.5, the fused decode: (3, H, W, 3) uint8 on the host."""
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    built = coach.built
    sched = DPMSolverSchedule()
    unet, vae = coach.infer_frozen()
    pm = PromptManager(coach.tokenizer, built.text,
                       sched.set_timesteps(TP_DENOISE),
                       built.placeholder_view_token_ids,
                       built.placeholder_object_token_ids,
                       dtype=coach.compute_dtype)
    prompt = (f"{coach.placeholder_view_tokens[0]}. A photo of a "
              f"{coach.placeholder_object_tokens[0]}")
    with torch.no_grad():
        ctx, ctx_b = pm.embed_prompt(prompt)
        uncond = pipeline.encode_uncond(built.text.clip, coach.tokenizer)
    return pipeline.generate(unet, vae, sched, ctx, ctx_b, uncond, HEIGHT,
                             WIDTH, [0, 1, 2], TP_DENOISE, 7.5,
                             coach.compute_dtype, device=coach.device)


def frozen_bytes(built):
    """The bytes of the frozen UNet's, CLIP's and VAE's parameters."""
    return {name: sum(p.numel() * p.element_size()
                      for p in module.parameters())
            for name, module in (("unet", built.unet),
                                 ("clip", built.text.clip),
                                 ("vae", built.vae))}


def tp_emulate_(torch, built, tp, fault=None):
    """One process computing what the tp ranks compute, the reference they
    are held to, by plain indexing of the whole weights, independent of
    parallel/tensor.py: every attention whose heads tp divides and every
    feed-forward and CLIP MLP whose hidden width it divides runs as tp
    pieces (the r-th piece of the output features of q/k/v, fc1 and
    GEGLU's value and gate halves, of the input features of to_out.0,
    ff.net.2 and fc2, each a contiguous copy as a rank holds it), the
    pieces' partial outputs added in piece order in fp32 with the bias
    after, and each unit's input gradients added over the pieces in piece
    order in fp32. fault (a unit's path in the UNet) keeps only the first
    piece's input gradients there: the planted fault of the tp phase."""
    import torch.nn.functional as F
    from view_neti_tpu_torch.models.clip_text import CLIPMLP
    from view_neti_tpu_torch.models.unet import CrossAttention, FeedForward
    from view_neti_tpu_torch.ops.attention import multi_head_attention

    class Fan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, keep):
            ctx.keep = keep
            return tuple(x.view_as(x) for _ in range(tp))

        @staticmethod
        def backward(ctx, *grads):
            total = grads[0].float()
            for g in grads[1:ctx.keep]:
                total = total + g.float()
            return total.to(grads[0].dtype), None

    def fan(x, keep):
        return None if x is None else Fan.apply(x, keep)

    def total(parts, bias, dtype):
        out = parts[0].float()
        for part in parts[1:]:
            out = out + part.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(dtype)

    def rows(w, r):
        n = w.shape[0] // tp
        return w[r * n:(r + 1) * n].clone(memory_format=torch.contiguous_format)

    def cols(w, r):
        n = w.shape[1] // tp
        return w[:, r * n:(r + 1) * n].clone(
            memory_format=torch.contiguous_format)

    def attention(m, keep):
        H = m.heads // tp
        pieces = [[rows(m.to_q.weight, r), rows(m.to_k.weight, r),
                   rows(m.to_v.weight, r), cols(m.to_out[0].weight, r)]
                  for r in range(tp)]
        bias = m.to_out[0].bias

        def forward(x, ctx_k=None, ctx_v=None):
            B, L, _ = x.shape
            xs = fan(x, keep)
            ks = xs if ctx_k is None else fan(ctx_k.to(x.dtype), keep)
            vs = ks if ctx_v is None else fan(ctx_v.to(x.dtype), keep)
            parts = []
            for r, (wq, wk, wv, wo) in enumerate(pieces):
                q = F.linear(xs[r], wq)
                hd = q.shape[-1] // H
                k = F.linear(ks[r], wk).reshape(B, ks[r].shape[1], H, hd)
                v = F.linear(vs[r], wv).reshape(B, vs[r].shape[1], H, hd)
                o = multi_head_attention(q.reshape(B, L, H, hd), k, v)
                parts.append(F.linear(o.reshape(B, L, H * hd), wo))
            return total(parts, bias, x.dtype)
        return forward

    def feed_forward(m, keep):
        proj, out = m.net[0].proj, m.net[2]
        value, gate = proj.weight.chunk(2, dim=0)
        bv, bg = proj.bias.chunk(2, dim=0)
        pieces = [(torch.cat([rows(value, r), rows(gate, r)]),
                   torch.cat([rows(bv, r), rows(bg, r)]),
                   cols(out.weight, r)) for r in range(tp)]

        def forward(x):
            xs = fan(x, keep)
            parts = []
            for r, (w, b, wo) in enumerate(pieces):
                h, g = F.linear(xs[r], w, b).chunk(2, dim=-1)
                parts.append(F.linear(h * F.gelu(g), wo))
            return total(parts, out.bias, x.dtype)
        return forward

    def mlp(m):
        pieces = [(rows(m.fc1.weight, r), rows(m.fc1.bias, r),
                   cols(m.fc2.weight, r)) for r in range(tp)]

        def forward(x):
            xs = fan(x, tp)
            parts = []
            for r, (w, b, wo) in enumerate(pieces):
                h = F.linear(xs[r], w, b)
                if m.act == "quick_gelu":
                    h = h * torch.sigmoid(1.702 * h)
                else:
                    h = F.gelu(h)
                parts.append(F.linear(h, wo))
            return total(parts, m.fc2.bias, x.dtype)
        return forward

    split = 0
    for path, m in built.unet.named_modules():
        keep = 1 if path == fault else tp
        if isinstance(m, CrossAttention) and m.heads % tp == 0:
            m.forward = attention(m, keep)
            split += 1
        elif isinstance(m, FeedForward):
            m.forward = feed_forward(m, keep)
            split += 1
    for m in built.text.clip.modules():
        if isinstance(m, CLIPMLP):
            m.forward = mlp(m)
            split += 1
    check(fault is None or isinstance(built.unet.get_submodule(fault),
                                      CrossAttention),
          f"{fault} is not an attention")
    return split


def tp_collectives_per_step(unet_blocks, clip_layers):
    """The tp all-gathers of one train step at dp 1, from the table: one
    forward sum per row-parallel layer (an attention's to_out.0, a
    feed-forward's ff.net.2, a CLIP MLP's fc2); one backward sum per input
    of a split unit whose gradient the step needs: a self-attention's x,
    a cross-attention's x and its two contexts (the regular and the bypass
    stack), a feed-forward's and an MLP's x; the first transformer block's
    two attentions see x from the latents alone, which needs none."""
    forward = 3 * unet_blocks + clip_layers
    backward = unet_blocks * (1 + 3 + 1) - 2 + clip_layers
    return forward + backward


def tp_rank(rank, world, root, rect, cal):
    """One spawned rank of the tp phase: the recipe's Coach in a dp 1 x tp
    world layout (tensor_parallel true); the render (its launches counted)
    and the render with TP_FAULT_ROW's rank-1 partial dropped; then the
    counted training (launches, peak memory, the all-gathers' count, bytes
    and host ms); then one SD-2.1 UNet forward, whole and split. Writes
    what it measured to root/tp<r>.pkl."""
    import pickle
    import torch
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 sd21_unet_config)
    from view_neti_tpu_torch.parallel import dist, tensor
    from view_neti_tpu_torch.training import builder
    from view_neti_tpu_torch.training.coach import Coach
    steps = TP_WARM + TP_STEPS
    dp = dist.init_distributed(
        store=torch.distributed.FileStore(os.path.join(root, "store_tp"),
                                          world),
        rank=rank, world_size=world, timeout_s=TP_TIMEOUT_S)
    gather, calls = torch.distributed.all_gather, []

    def timed_gather(parts, tensor, *args, **kwargs):
        t0 = time.perf_counter()
        out = gather(parts, tensor, *args, **kwargs)
        calls.append((time.perf_counter() - t0,
                      tensor.numel() * tensor.element_size()))
        return out
    torch.distributed.all_gather = timed_gather
    coach = Coach(tp_config(rect, os.path.join(root, "tp_ranks"),
                            {"tp": world, "tensor_parallel": True}),
                  calibration_dir=cal, dist=dp)
    out = dict(rank=rank, backend=dp.backend, shared_card=dp.shared_card,
               frozen_bytes=frozen_bytes(coach.built),
               layout=(coach.dist.dp_index, coach.dist.tp_index,
                       coach.dist.dp_world, coach.dist.tp_world))
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out["render"] = tp_render(torch, coach)
    torch.cuda.synchronize()
    out.update(render_s=time.perf_counter() - t0,
               render_launches=launch_counts(), render_gathers=len(calls))
    row = coach.built.unet.get_submodule(TP_FAULT_ROW)
    check(isinstance(row, tensor.RowParallelLinear),
          f"{TP_FAULT_ROW} is not split")
    kept = row.weight.detach().clone()
    if rank == 1:
        row.weight.data.zero_()
    out["fault_render"] = tp_render(torch, coach)
    row.weight.data.copy_(kept)
    del calls[:]
    # the counted run: the user's entry point, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    coach.train()
    torch.cuda.synchronize()
    out.update(ddp_run_stats(coach, TP_WARM, TP_STEPS),
               launches=launch_counts(),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               gathers=len(calls),
               gather_bytes=sum(b for _, b in calls),
               gather_ms_timed=sum(t for t, _ in calls[
                   len(calls) * TP_WARM // steps:]) * 1e3)
    # SD-2.1: one forward of a seeded UNet, whole, then split over the
    # same group
    torch.manual_seed(0)
    with torch.device(dp.device):
        unet = UNet2DCondition(sd21_unet_config())
    builder.cast_compute_dtype_(unet, torch.bfloat16)
    unet.requires_grad_(False)
    g = torch.Generator(dp.device).manual_seed(1)
    lat = torch.randn(2, 64, 64, 4, generator=g, device=dp.device)
    ctx = torch.randn(16, 2, 77, 1024, generator=g,
                      device=dp.device).bfloat16()
    ts = torch.tensor([500, 100], device=dp.device)
    with torch.no_grad():
        whole = unet(lat, ts, ctx).float()
        logged = []
        plan = tensor.shard_frozen_(unet, torch.nn.Module(), coach.dist,
                                    log=logged.append)
        split = unet(lat, ts, ctx).float()
    out["sd21"] = dict(
        rel_rms=float((split - whole).pow(2).mean().sqrt()
                      / whole.pow(2).mean().sqrt()),
        max_abs=float((split - whole).abs().max()),
        finite=bool(torch.isfinite(split).all()),
        kept_whole=logged,
        split_units=sorted({k.rsplit(".", 2)[0] for k, v in plan.items()
                            if v in ("column", "geglu")}))
    dist.barrier(dp)
    dist.destroy(dp)
    with open(os.path.join(root, f"tp{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def phase_tp(torch, dev, card):
    """The mesh's tp axis over torch.distributed
    (view_neti_tpu_torch/parallel/tensor.py): the coach phase's recipe
    (mode 2, SD-1.5 at full width, preset 7 on the base cache, fused B = 9
    at 384x512, bf16) for TP_WARM + TP_STEPS steps in one process, in one
    process computing the tp split (tp_emulate_), the same with the
    planted fault, and over TP_WORLD spawned ranks (dp 1 x tp TP_WORLD,
    tensor_parallel; gloo when they share this card, NCCL with a card
    each). The ranks must be bit-equal to each other; each step's loss
    within TP_LOSS_RTOL and the mappers within tests/test_parallel.py's
    tolerance of the split computed in one process, a loss limit that the
    planted fault must exceed; each rank's K1-K4 launches a step those of
    one process; the all-gathers a step the count worked out from the
    table. The render (3 seeds, 768x576, TP_DENOISE steps, CFG 7.5)
    against one process's within TP_RENDER_MEAN_LIMIT mean levels, which
    the planted dropped partial must exceed. SD-2.1: the 5-head level
    whole, the rest split, the forward within TP_SD21_RTOL."""
    import gc
    import pickle
    import numpy as np
    import torch.multiprocessing as mp
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.training.coach import Coach

    steps = TP_WARM + TP_STEPS
    per_step = SD15_STEP
    want_launches = {k: v * steps for k, v in per_step.items()}
    want_render = {**unet_k1(TP_DENOISE), **unet_bwd(0), **k4(decodes=1)}
    unet_blocks, clip_layers = 16, 12
    want_gathers = tp_collectives_per_step(unet_blocks, clip_layers) * steps
    with tempfile.TemporaryDirectory() as root:
        rect, cal, _, _ = write_scan(root, image_io, dtu, np)
        single = Coach(tp_config(rect, os.path.join(root, "single")),
                       calibration_dir=cal, device=dev)
        single_bytes = frozen_bytes(single.built)
        want = tp_render(torch, single)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        single.train()
        torch.cuda.synchronize()
        single_launches = launch_counts()
        ref = ddp_run_stats(single, TP_WARM, TP_STEPS)
        ref["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del single
        gc.collect()
        torch.cuda.empty_cache()

        emulated = {}
        for name, fault in (("split", None), ("fault", TP_FAULT_INPUTS)):
            coach = Coach(tp_config(rect, os.path.join(root, name)),
                          calibration_dir=cal, device=dev)
            units = tp_emulate_(torch, coach.built, TP_WORLD, fault)
            coach.train()
            torch.cuda.synchronize()
            emulated[name] = ddp_run_stats(coach, TP_WARM, TP_STEPS)
            del coach
            gc.collect()
            torch.cuda.empty_cache()
        check(units == 2 * unet_blocks + unet_blocks + clip_layers,
              f"the split computed in one process has {units} units")

        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(TP_WORLD, root, rect, cal),
                           nprocs=TP_WORLD, join=True, start_method="spawn")
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(root, f"tp{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    gc.collect()
    torch.cuda.empty_cache()

    main = ranks[0]
    split = emulated["split"]
    loss_rel, mapper_abs, outside = ddp_diff(main, split)
    control_rel = max(abs(a - b) / abs(b) for a, b in zip(
        emulated["fault"]["losses"], split["losses"]))
    _, control_mapper_abs, control_outside = ddp_diff(emulated["fault"],
                                                      split)
    plain_rel, plain_mapper_abs, plain_outside = ddp_diff(main, ref)
    diff = np.abs(main["render"].astype(int) - want)
    fault = np.abs(main["fault_render"].astype(int) - want)
    shared = torch.cuda.device_count() < TP_WORLD
    unet_share = [r["frozen_bytes"]["unet"] / single_bytes["unet"]
                  for r in ranks]
    stats = dict(
        backend=main["backend"], world=TP_WORLD, dp=1, tp=TP_WORLD,
        ranks_share_one_card=main["shared_card"],
        note=("the ranks share one card: the rate is not a scaling figure"
              if main["shared_card"] else "one rank per card"),
        batch=TRAIN_BATCH, height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
        warmup_steps=TP_WARM, timed_steps=TP_STEPS,
        imgs_per_sec=TRAIN_BATCH * 1e3 / main["ms_per_step"],
        ms_per_step=main["ms_per_step"],
        ms_per_step_by_rank=[r["ms_per_step"] for r in ranks],
        one_process_imgs_per_sec=TRAIN_BATCH * 1e3 / ref["ms_per_step"],
        one_process_ms_per_step=ref["ms_per_step"],
        split_in_one_process_ms_per_step=split["ms_per_step"],
        gathers_per_step=main["gathers"] / steps,
        gathers_per_step_from_table=want_gathers / steps,
        gather_bytes_per_step=main["gather_bytes"] / steps,
        gather_ms_per_step=main["gather_ms_timed"] / TP_STEPS,
        frozen_bytes_by_rank=[r["frozen_bytes"] for r in ranks],
        one_process_frozen_bytes=single_bytes,
        unet_bytes_share_by_rank=unet_share,
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in ranks],
        one_process_peak_memory_gib=ref["peak_memory_gib"],
        launches_per_step_by_rank=[{k: v / steps for k, v in
                                    r["launches"].items()} for r in ranks],
        one_process_launches_per_step={k: v / steps for k, v in
                                       single_launches.items()},
        render_launches_by_rank=[r["render_launches"] for r in ranks],
        losses=main["losses"], split_losses=split["losses"],
        one_process_losses=ref["losses"],
        max_loss_rel_diff=loss_rel, loss_limit=TP_LOSS_RTOL,
        control_max_loss_rel_diff=control_rel,
        control_mapper_elements_outside_tolerance=control_outside,
        control_max_mapper_abs_diff=control_mapper_abs,
        max_mapper_abs_diff=mapper_abs,
        mapper_elements_outside_tolerance=outside,
        mapper_elements=sum(v.size for v in split["mappers"].values()),
        one_process_max_loss_rel_diff=plain_rel,
        one_process_max_mapper_abs_diff=plain_mapper_abs,
        one_process_mapper_elements_outside_tolerance=plain_outside,
        counts_equal=all(r["counts"] == split["counts"] == ref["counts"]
                         for r in ranks),
        render_seeds=3, render_height=HEIGHT, render_width=WIDTH,
        render_denoising_steps=TP_DENOISE,
        render_s_by_rank=[r["render_s"] for r in ranks],
        render_max_diff_levels=int(diff.max()),
        render_mean_diff_levels=float(diff.mean()),
        render_mean_limit=TP_RENDER_MEAN_LIMIT,
        control_render_max_diff_levels=int(fault.max()),
        control_render_mean_diff_levels=float(fault.mean()),
        sd21=main["sd21"], sd21_limit=TP_SD21_RTOL, ranks_wall_s=ranks_s)
    print(f"tp [{card}]: {json.dumps(stats)}", flush=True)
    check(all(r["backend"] == ("gloo" if shared else "nccl")
              and r["shared_card"] == shared for r in ranks),
          f"ranks took {[r['backend'] for r in ranks]}")
    check([r["layout"] for r in ranks]
          == [(0, r, 1, TP_WORLD) for r in range(TP_WORLD)],
          f"rank layout {[r['layout'] for r in ranks]}")
    check(single_launches == want_launches,
          f"one process launches {single_launches}, want {want_launches}")
    for r in ranks:
        check(r["launches"] == want_launches,
              f"rank {r['rank']} launches {r['launches']}, want "
              f"{want_launches}")
        check(r["render_launches"] == want_render,
              f"rank {r['rank']} render launches {r['render_launches']}, "
              f"want {want_render}")
        check(r["gathers"] == want_gathers,
              f"rank {r['rank']}: {r['gathers']} all-gathers in "
              f"{steps} steps, want {want_gathers} from the table")
        check(r["losses"] == main["losses"] and all(
            np.array_equal(v, main["mappers"][k])
            for k, v in r["mappers"].items())
            and np.array_equal(r["render"], main["render"])
            and np.array_equal(r["fault_render"], main["fault_render"]),
              f"rank {r['rank']} ended with other losses, mappers or "
              "images than rank 0")
    check(len(main["losses"]) == steps
          and all(math.isfinite(x) for x in main["losses"]),
          f"tp losses {main['losses']}")
    check(loss_rel <= TP_LOSS_RTOL,
          f"the ranks' losses differ from the split in one process by "
          f"{loss_rel} relative, limit {TP_LOSS_RTOL}")
    check(control_rel > TP_LOSS_RTOL,
          f"the planted fault ({TP_FAULT_INPUTS}'s input gradients not "
          f"summed) moved the losses by {control_rel} relative only: the "
          f"limit {TP_LOSS_RTOL} would not catch it")
    check(outside == 0, f"{outside} mapper elements differ from the split "
                        f"in one process beyond rtol {TP_MAPPER_RTOL}, atol "
                        f"{TP_MAPPER_ATOL} (largest {mapper_abs})")
    check(stats["counts_equal"], "per-slice counts differ")
    check(diff.mean() <= TP_RENDER_MEAN_LIMIT,
          f"the ranks' render differs from one process's by "
          f"{diff.mean()} levels on average, limit {TP_RENDER_MEAN_LIMIT}")
    check(fault.mean() > TP_RENDER_MEAN_LIMIT,
          f"the planted fault (rank 1's partial of {TP_FAULT_ROW} dropped) "
          f"moved the render by {fault.mean()} levels on average only: "
          f"the limit {TP_RENDER_MEAN_LIMIT} would not catch it")
    sd21 = main["sd21"]
    whole_level = [k for k in sd21["kept_whole"] if "attn" in k]
    check(sd21["finite"] and sd21["rel_rms"] <= TP_SD21_RTOL,
          f"SD-2.1 split forward: rel rms {sd21['rel_rms']}, limit "
          f"{TP_SD21_RTOL}")
    check(len(sd21["kept_whole"]) == len(whole_level) == 10
          and all(" unet.down_blocks.0." in k or " unet.up_blocks.3." in k
                  for k in sd21["kept_whole"])
          and len(sd21["split_units"]) == 16 + 22,
          f"SD-2.1 plan: kept whole {sd21['kept_whole']}, split "
          f"{len(sd21['split_units'])}")
    return dict(stats, launches={k: main["render_launches"][k] + v
                                 for k, v in main["launches"].items()})


# the bench phase: python -m view_neti_tpu_torch.bench in each mode, with
# its depth cut (BENCH_STEPS, BENCH_INFER_STEPS), and the kernels each
# mode's path launches
BENCH_RUNS = (
    ("raw", {"BENCH_E2E": "0", "BENCH_STEPS": "8"}, "K1 K2 K3 K4"),
    ("coach_mode2", {"BENCH_STEPS": "16"}, "K1 K2 K3 K4"),
    ("coach_mode3", {"BENCH_MODE": "3", "BENCH_STEPS": "8"}, "K1 K2 K3 K4"),
    ("serving", {"BENCH_INFER": "1"}, "K1 K4"),
    ("serving_fused_unet", {"BENCH_INFER": "1", "BENCH_FUSE_UNET": "1"},
     "K1 K4"),
    ("sweep", {"BENCH_VAL": "1", "BENCH_INFER_STEPS": "3"}, "K1 K4"),
)
BENCH_RATIO = (0.67, 1.5)   # a bench rate over the same rate of a phase
BENCH_TIMEOUT_S = 300


def run_bench(env):
    """python -m view_neti_tpu_torch.bench from this checkout with the
    BENCH_* variables env: (exit code, stdout lines, stderr, seconds)."""
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(env)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "view_neti_tpu_torch.bench"], env=full,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    return (proc.returncode, proc.stdout.splitlines(), proc.stderr,
            time.perf_counter() - t0)


def phase_bench(card, slice_stats, coach_stats):
    """python -m view_neti_tpu_torch.bench in its five modes at full width,
    and serving again with BENCH_FUSE_UNET=1, each in a process of its own
    (the kernels built above): exit 0 and one line each, a finite positive
    value, 0 < mfu <= 1, the device this card; the launches of each mode's
    kernels; the fused-UNet run's launches serving's and K4's 44 a UNet
    forward, its flops_per_image serving's within 0.1 %; serving's
    sec/image (switch off and on) and the mode-2 Coach's imgs/sec within
    BENCH_RATIO of the slice and coach phases' graphed rates in this run.
    The control: BENCH_FLASH=0 is refused with the error line and a failed
    exit (bench.main, in this process)."""
    records, launches = {}, {}
    for name, env, kernels in BENCH_RUNS:
        rc, lines, err, secs = run_bench(env)
        tail = "\n".join(err.splitlines()[-15:])
        check(rc == 0 and len(lines) == 1,
              f"bench {name}: exit {rc}, stdout {lines}, stderr:\n{tail}")
        rec = json.loads(lines[0])
        check(rec.get("unit") != "error" and math.isfinite(rec["value"])
              and rec["value"] > 0, f"bench {name}: {rec}")
        check(0 < rec.get("mfu", 0) <= 1, f"bench {name}: mfu {rec}")
        check(rec["device"] == card, f"bench {name}: device "
                                     f"{rec['device']!r}, not {card!r}")
        notes = {key: [json.loads(line[len(f"# {key} "):])
                       for line in err.splitlines()
                       if line.startswith(f"# {key} ")]
                 for key in ("launches", "flops per image by source")}
        counts, flops = (notes[k][0] if len(notes[k]) == 1 else {}
                         for k in notes)
        # the kernels of the mode, and K1-K4's launches split by design
        check(all(counts.get(k, 0) > 0 for k in kernels.split())
              and all(v == 0 for k, v in counts.items()
                      if k.split()[0] not in kernels.split())
              and all(counts.get(f"{k} sm90", 0)
                      + counts.get(f"{k} mma_sync", 0) == counts.get(k, 0)
                      for k in ("K1", "K2", "K3", "K4")),
              f"bench {name}: launches {counts}, want {kernels} only")
        # each launching kernel's wrapper added its FLOPs to the count
        check(sorted(flops) == sorted(["aten"] + kernels.split())
              and all(v > 0 for v in flops.values()),
              f"bench {name}: FLOPs by source {flops}")
        launches[name] = counts
        records[name] = dict(rec, launches=counts, flops_by_source=flops,
                             process_s=secs)
    # the fused UNet adds K4's 44 launches to each of the serving run's UNet
    # forwards (32 K1 launches each) and no FLOP
    plain, fused = records["serving"], records["serving_fused_unet"]
    forwards = plain["launches"]["K1"] // 32
    want = add_counts(plain["launches"], k4_unet(forwards))
    check(fused["launches"] == want,
          f"bench serving_fused_unet: launches {fused['launches']}, want "
          f"{want}")
    flops_ratio = fused["flops_per_image"] / plain["flops_per_image"]
    check(abs(flops_ratio - 1) <= 1e-3,
          f"bench serving_fused_unet: flops_per_image {flops_ratio} of "
          f"serving's")
    serve = records["serving"]["value"] / slice_stats["sec_per_image_graphed"]
    serve_fused = (fused["value"]
                   / slice_stats["fused_unet"]["sec_per_image_on"])
    coach = records["coach_mode2"]["value"] / coach_stats["imgs_per_sec"]
    for what, ratio in (("serving sec/image over the slice phase's", serve),
                        ("fused-UNet serving sec/image over the slice "
                         "phase's", serve_fused),
                        ("Coach mode 2 imgs/sec over the coach phase's",
                         coach)):
        check(BENCH_RATIO[0] <= ratio <= BENCH_RATIO[1],
              f"bench {what}: {ratio}, outside {BENCH_RATIO}")
    # the control, in this process (the CLI's exit code is main's): the
    # switch is refused before the card is touched
    from view_neti_tpu_torch import bench
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench.main([], env={"BENCH_FLASH": "0", "BENCH_INFER": "1"})
    secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    control = json.loads(lines[0]) if len(lines) == 1 else None
    check(rc != 0 and control is not None and control["unit"] == "error"
          and "BENCH_FLASH" in control["error"],
          f"bench control BENCH_FLASH=0: exit {rc}, stdout {lines}")
    summary = dict(records=records,
                   serving_over_slice_sec_per_image=serve,
                   serving_fused_unet_over_slice_sec_per_image=serve_fused,
                   fused_over_plain_flops_per_image=flops_ratio,
                   coach_mode2_over_coach_imgs_per_sec=coach,
                   control=dict(exit=rc, line=control, process_s=secs))
    print(f"bench [{card}]: {json.dumps(summary)}", flush=True)
    return add_counts(*launches.values())


def mma_sync_rows(rows):
    """A kernel's mma.sync design (K1's to K4's) at the Hopper design's
    shapes where it was timed beside it (the heaviest), from the check and
    the time attention_rows or k4_row took of it at the same inputs: the
    plain version, the library call, the bound and the control are the
    inputs', its error and times its own."""
    out = []
    for r in rows:
        if "mma_sync_ms" not in r:
            continue
        row = {k: v for k, v in r.items() if not k.startswith("mma_sync_")}
        row.update(design="mma_sync", ms=r["mma_sync_ms"],
                   max_abs_err=r["mma_sync_max_abs_err"],
                   err_of_limit=r["mma_sync_err_of_limit"],
                   graph_ms=r["mma_sync_graph_ms"],
                   host_us=r["mma_sync_host_us"],
                   share_of_bound=r["bound_ms"] / r["mma_sync_ms"])
        if "mma_sync_lse_err" in r:
            row["lse_err"] = r["mma_sync_lse_err"]
        out.append(row)
    return out


def kernel_report(kernels, launches, card):
    """The {"kernels": [...]} line: per kernel (the two designs of K1, K2,
    K3 and K4 apart),
    ms / plain_ms / bound_ms / library_ms and share_of_bound (bound_ms /
    ms) at its heaviest main-path shape, and the same summed over one run
    of each path that launches it (<path>_path_*: a serving run, a
    fused-UNet serving run, a train step, the weights phase, the
    acceptance phase, the validate phase, the inference phase, the mode3
    phase, the folders phase, a tp rank's render and training), each shape
    the design runs there weighted by its launches there; the Hopper
    designs' entries carry the mma.sync design's ms at their shape. An
    mma.sync design's entry takes its heaviest shape from the shapes it
    runs and from its time beside the Hopper design at the same inputs
    (mma_sync_rows), so it keeps its numbers when no path launches it, and
    its error from every shape it was checked at.
    Each entry carries its heaviest shape's time in a CUDA graph and on
    the host where the rows have them.
    `launches` holds each path's counted run (launch_counts' keys): a
    kernel's launches, by path, are those of its key there."""
    report = []
    for key, name, source, replaces, tol, design in (
            ("K1", "flash_attention_fwd_sm90",
             "view_neti_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
             "view_neti_tpu/ops/flash_attention.py:83",
             "o: 2^-8|o| + 2^-4 rms(o), lse: 1e-3", "sm90"),
            ("K1", "flash_attention_fwd",
             "view_neti_tpu_torch/csrc/flash_attention_fwd.cu",
             "view_neti_tpu/ops/flash_attention.py:83",
             "o: 2^-8|o| + 2^-4 rms(o), lse: 1e-3", "mma_sync"),
            ("K2", "flash_attention_bwd_dq_sm90",
             "view_neti_tpu_torch/csrc/flash_attention_bwd_dq_sm90.cu",
             "view_neti_tpu/ops/flash_attention.py:160",
             "dq: 2^-8|dq| + 2^-4 rms(dq)", "sm90"),
            ("K2", "flash_attention_bwd_dq",
             "view_neti_tpu_torch/csrc/flash_attention_bwd_dq.cu",
             "view_neti_tpu/ops/flash_attention.py:160",
             "dq: 2^-8|dq| + 2^-4 rms(dq)", "mma_sync"),
            ("K3", "flash_attention_bwd_dkv_sm90",
             "view_neti_tpu_torch/csrc/flash_attention_bwd_dkv_sm90.cu",
             "view_neti_tpu/ops/flash_attention.py:190",
             "dk, dv: 2^-8|x| + 2^-4 rms(x)", "sm90"),
            ("K3", "flash_attention_bwd_dkv",
             "view_neti_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
             "view_neti_tpu/ops/flash_attention.py:190",
             "dk, dv: 2^-8|x| + 2^-4 rms(x)", "mma_sync"),
            ("K4", "fused_affine_silu_conv3x3_sm90",
             "view_neti_tpu_torch/csrc/fused_conv_sm90.cu",
             "view_neti_tpu/ops/fused_conv.py:176", "2e-2 + 2^-8|out|",
             "sm90"),
            ("K4", "fused_affine_silu_conv3x3",
             "view_neti_tpu_torch/csrc/fused_conv.cu",
             "view_neti_tpu/ops/fused_conv.py:176", "2e-2 + 2^-8|out|",
             "mma_sync")):
        own = [r for r in kernels[key]
                if design is None or r["design"] == design]
        rows, errs = list(own), [(r["max_abs_err"], r["err_of_limit"],
                                  r["control_of_limit"]) for r in own]
        if design == "mma_sync":
            # beside the Hopper design: timed at its heaviest shape, checked
            # at every one
            rows += mma_sync_rows(kernels[key])
            errs += [(r["mma_sync_max_abs_err"], r["mma_sync_err_of_limit"],
                      r["control_of_limit"]) for r in kernels[key]
                     if "mma_sync_err_of_limit" in r]
        top = max(rows, key=lambda r: r["bound_ms"] * bool(r["per_run"]))
        paths = ("serve", "serve_fused_unet", "train", "weights",
                 "acceptance", "validate", "inference", "mode3", "folders",
                 "tp")
        # a path's sums over the shapes the design runs there
        path = {f"{p}_path_{k}": sum(r[k] * r["per_run"].get(p, 0)
                                     for r in own)
                for p in paths
                if any(p in r["per_run"] for r in own)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        for p in paths:
            if f"{p}_path_ms" in path:
                path[f"{p}_path_share_of_bound"] = (
                    path[f"{p}_path_bound_ms"] / path[f"{p}_path_ms"])
        count = f"{key} {design}" if design else key
        by_path = {p: n.get(count, 0) for p, n in launches.items()}
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            checked=True, tolerance=tol,
            max_abs_err=max(e[0] for e in errs),
            err_of_limit=max(e[1] for e in errs),
            control_of_limit=min(e[2] for e in errs),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            share_of_bound=top["share_of_bound"],
            library_ms=top["library_ms"], shape=top["shape"], **path,
            card=card)
        if "mma_sync_ms" in top:
            # the mma.sync design at the same shape, in the same call
            entry["mma_sync_ms"] = top["mma_sync_ms"]
        for k in ("graph_ms", "host_us"):
            if k in top:
                entry[k] = top[k]
        report.append(entry)
    return report


PHASE_S = {}


def timed(name, fn, *args):
    """fn(*args), its seconds printed and kept in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30,
                        help="DPM-Solver++ steps of the slice (default 30)")
    parser.add_argument("--train-steps", type=int, default=5,
                        help="timed train steps after 2 warm-up steps "
                             "(default 5)")
    parser.add_argument("--coach-steps", type=int, default=12,
                        help="timed Coach steps after 2 warm-up steps "
                             "(default 12)")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    max_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    global EXP_RATE
    EXP_RATE = exp_rate(torch.cuda.get_device_properties(0)
                        .multi_processor_count, float(max_mhz))
    print(f"exponentials: {EXP_RATE:.6g} a second (16 a clock x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
          f"x {max_mhz} MHz clocks.max.sm) [{card}]", flush=True)

    from view_neti_tpu_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    # the logs of libraries built earlier come from beside them, so every
    # run reads the four path buckets of K1's mma.sync design (in two
    # key-tile widths, 64 and 80), of K2's and K3's two designs and of K1's
    # Hopper design (its long-key and its short-key kernel), the two
    # buckets of K2's Hopper short-key kernel, K4's mma.sync
    # design's two output-channel tiles and its Hopper design's
    # instantiations
    n = check_path_spills(ptxas_usage(logs))
    check_wgmma_pipelined(logs)
    want = (6 * len(PATH_BUCKETS) + 2 * len(BWD_SM90_BUCKETS)
            + len(BWD_SM90_SHORT_BUCKETS) + 2 + K4_SM90_INSTANTIATIONS)
    check(n == want, f"found {n} path instantiations of K1-K4 in the build "
                     f"logs, want {want}")

    kernels = timed("kernels", phase_kernels, torch, dev, card, args.steps)
    serve_launches, slice_stats, built, tok = timed(
        "slice", phase_slice, torch, dev, card, args.steps)
    train_launches, train_result = timed("train", phase_train, torch, dev,
                                         card, built, tok, args.train_steps)
    # the Coach builds its own stack: free the slice's and train phase's
    del built, tok
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    coach_launches, coach_stats = timed("coach", phase_coach, torch, dev,
                                        card, train_result, args.coach_steps)
    gc.collect()
    torch.cuda.empty_cache()
    import numpy as np
    from view_neti_tpu_torch.data import dtu, image_io
    from view_neti_tpu_torch.training.inference_dtu import get_cam_idxs
    cams = get_cam_idxs(6)[0]
    check(len(cams) == EVAL_CAMS, f"{len(cams)} eval cameras")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rect, cal, masks_root, _ = write_scan(root, image_io, dtu, np,
                                              cams=cams, masks=True)
        print(f"eval scan: {len(cams)} images and masks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        weights_launches, weights = timed("weights", phase_weights, torch,
                                          dev, card, rect, cal)
        gc.collect()
        torch.cuda.empty_cache()
        try:
            acceptance_launches, _ = timed(
                "acceptance", phase_acceptance, torch, dev, card, root,
                weights, cal, masks_root)
        finally:
            shutil.rmtree(weights)
        gc.collect()
        torch.cuda.empty_cache()
        run_dir = os.path.join(root, "run")
        validate_launches, val = timed("validate", phase_validate, torch,
                                       dev, card, rect, cal, masks_root,
                                       run_dir)
        gc.collect()
        torch.cuda.empty_cache()
        inference_launches, _ = timed("inference", phase_inference, torch,
                                      dev, card, cal, masks_root, run_dir,
                                      val)
    del val
    gc.collect()
    torch.cuda.empty_cache()
    mode3_launches, _ = timed("mode3", phase_mode3, torch, dev, card,
                              coach_stats)
    gc.collect()
    torch.cuda.empty_cache()
    folders_launches, _ = timed("folders", phase_folders, torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("ddp", phase_ddp, torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = timed("tp", phase_tp, torch, dev, card)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    bench_launches = timed("bench", phase_bench, card, slice_stats,
                           coach_stats)
    report = kernel_report(kernels, {"serve": serve_launches,
                                     "serve_fused_unet":
                                         slice_stats["fused_unet"]
                                         ["launches"],
                                     "train": train_launches,
                                     "coach": coach_launches,
                                     "coach_trace":
                                         coach_stats["trace"]["launches"],
                                     "weights": weights_launches,
                                     "acceptance": acceptance_launches,
                                     "validate": validate_launches,
                                     "inference": inference_launches,
                                     "mode3": mode3_launches,
                                     "folders": folders_launches,
                                     "tp": tp_launches,
                                     "bench": bench_launches}, card)
    print(f"phases [{card}]: {json.dumps(PHASE_S)}", flush=True)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
