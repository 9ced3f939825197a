#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (view_neti_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--steps N]

Phases; any failure ends the run with a non-zero exit:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds both hand-written kernels from
                view_neti_tpu_torch/csrc/ (in parallel);
  3. kernels -- the flash-attention forward (K1) and the fused
                GroupNorm+SiLU+conv3x3 (K4) at every shape the SD-1.5
                768x576 serving path gives them (plus one SD-2.1 d=64 K1
                shape), bf16 inputs from a seed, held against their plain
                versions in fp32 with TF32 off, and timed with CUDA events
                beside the plain version, one PyTorch library call and the
                card's bound;
  4. slice   -- the serving path at full SD-1.5 width with seeded random
                weights: mode-2 view + object mappers, FallbackTokenizer,
                PromptManager conditioning, DPM-Solver++ with CFG 7.5 for
                3 seeds at 768x576, fused VAE decode to uint8; checks the
                output and that every UNet attention went through K1 and
                every decoder conv section through K4; times sec/image
                over three more rounds of generate as bench.py does, splits
                one run by stage, holds the fused decode against the same
                weights decoded unfused, and profiles one CFG denoise step
                and one decode (device time by kernel group, idle share);
  5. report  -- one JSON line of per-kernel results, then the result line.
The bound is max(operations / 989 TFLOP/s, bytes / 3.35 TB/s), the
published dense-bf16 and memory peaks of an H100 SXM at 700 W.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

PEAK_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
BATCH = 6                # 3 seeds x CFG
HEIGHT, WIDTH = 576, 768


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_tolerance(ro):
    """K1's limit on |o - ro| at each element, against the fp32 plain
    output ro: the bf16 rounding of o (2^-8 |ro|) plus 2^-4 of the RMS of
    ro for the bf16 rounding of p before the p.v product, whose error is a
    sum of independent roundings that scales with the output's spread, not
    with each element. At the 6912-key self-attention a 20 % error in o, or
    one 64-key tile of 108 left out, exceeds it."""
    return 2 ** -8 * ro.abs() + 2 ** -4 * ro.square().mean().sqrt()


def time_ms(torch, fn, budget_ms: float = 300.0) -> float:
    """Mean time of fn on the card, by CUDA events, after a warm-up call;
    the count of timed calls is sized to fill about budget_ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(max(2, min(50, budget_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "K1 flash_attention_fwd"
    if "fused_conv_kernel" in low:
        return "K4 fused_conv"
    if any(s in low for s in ("fprop", "conv", "nhwc", "nchw", "cudnn")):
        return "cudnn conv"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cublas matmul"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce" in low or "norm" in low:
        return "reduction/norm"
    return "elementwise/other"


def device_profile(torch, fn):
    """Where the device time of fn goes, from torch.profiler: the span from
    the first kernel's start to the last one's end, the union of kernel
    intervals in it (busy), the idle share, and kernel time by group and
    by name. None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
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
    groups, names = {}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        g = kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + ms
        names[e.name[:70]] = names.get(e.name[:70], 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return dict(span_ms=span_us / 1e3, busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / span_us, kernels=len(events),
                by_group_ms=dict(sorted(groups.items(),
                                        key=lambda kv: -kv[1])),
                top_ms=dict(top))


def phase_kernels(torch, dev, card):
    import torch.nn.functional as F
    from view_neti_tpu_torch.ops import flash_attention as fa
    from view_neti_tpu_torch.ops import fused_conv as fc

    # the plain versions in full fp32: no TF32 in matmuls or convolutions
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(0)
    results = {}

    # ---- K1: every UNet attention shape at 768x576, B = 3 seeds x CFG --
    # (Lq, Lk, heads, d, launches per UNet forward): self and cross
    # (Lk = 77) per level; SD-1.5 has 8 heads and 5 transformer blocks on
    # each of its three attention levels (2 down, 3 up) plus 1 in the mid
    # block. The last row is SD-2.1's level 0 (head dim 64), off the path.
    k1_shapes = []
    for L, d, n in ((6912, 40, 5), (1728, 80, 5), (432, 160, 5),
                    (108, 160, 1)):
        k1_shapes += [(L, L, 8, d, n), (L, 77, 8, d, n)]
    k1_shapes.append((6912, 6912, 5, 64, 0))
    rows = []
    for Lq, Lk, H, d, per_forward in k1_shapes:
        q = torch.randn(BATCH, Lq, H, d, generator=g, device=dev).bfloat16()
        k = torch.randn(BATCH, Lk, H, d, generator=g, device=dev).bfloat16()
        v = torch.randn(BATCH, Lk, H, d, generator=g, device=dev).bfloat16()
        o, lse = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()

        def ref(keys=Lk):
            # over batch chunks: the full fp32 logits at L=6912 would be
            # 9 GB
            outs, lses = [], []
            for b in range(BATCH):
                ro, rl = fa.flash_attention_ref(q[b:b + 1].float(),
                                                k[b:b + 1, :keys].float(),
                                                v[b:b + 1, :keys].float())
                outs.append(ro)
                lses.append(rl)
            return torch.cat(outs), torch.cat(lses)

        ro, rlse = ref()
        tol = k1_tolerance(ro)
        err = (o.float() - ro).abs()
        ratio = (err / tol).max().item()
        lse_err = (lse - rlse).abs().max().item()
        # the control: the plain version with the last 64-key tile dropped,
        # the fault of a wrong key mask or a lost tile in the online softmax;
        # the limit has to catch it
        control = ((ref(Lk - 64)[0] - ro).abs() / tol).max().item()
        check(ratio <= 1 and lse_err <= 1e-3,
              f"K1 disagrees at {(Lq, Lk, H, d)}: o {err.max().item():.3g} "
              f"({ratio:.3g} of the limit), lse {lse_err:.3g}")
        check(control > 1, f"K1's limit at {(Lq, Lk, H, d)} misses a "
                           f"dropped key tile ({control:.3g} of the limit)")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * BATCH * H * Lq * Lk * d
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4.0 * lse.numel()
        bms, by = bound(flops, nbytes)
        row = dict(shape=f"B{BATCH} Lq{Lq} Lk{Lk} H{H} d{d}",
                   per_forward=per_forward,
                   max_abs_err=err.max().item(), lse_err=lse_err,
                   err_of_limit=ratio, control_of_limit=control,
                   ms=time_ms(torch, lambda: fa.flash_attention(q, k, v)),
                   plain_ms=time_ms(torch, ref, 100.0),
                   library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
        print(f"K1 {row['shape']}: err {row['max_abs_err']:.3g} "
              f"({ratio:.3g} of the limit; dropped-tile control "
              f"{control:.3g}), lse {lse_err:.3g} | kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {bms:.4f} ms ({by}) [{card}]", flush=True)
        del q, k, v, o, lse, ro, rlse, err, tol
    results["K1"] = rows

    # ---- K4: every decoder norm->SiLU->conv3x3 shape, B = 3 -------------
    # (H, W, Cin, Cout, residual, launches per decode): conv1 of each ResNet
    # block has no residual, conv2 adds it; 29 sections in all.
    k4_shapes = [(72, 96, 512, 512, False, 5), (72, 96, 512, 512, True, 5),
                 (144, 192, 512, 512, False, 3),
                 (144, 192, 512, 512, True, 3),
                 (288, 384, 512, 256, False, 1),
                 (288, 384, 256, 256, False, 2),
                 (288, 384, 256, 256, True, 3),
                 (576, 768, 256, 128, False, 1),
                 (576, 768, 128, 128, False, 2),
                 (576, 768, 128, 128, True, 3),
                 (576, 768, 128, 3, False, 1)]
    check(sum(s[-1] for s in k4_shapes) == 29, "K4 shape table")
    B = BATCH // 2
    rows = []
    for H, W, Ci, Co, use_res, per_decode in k4_shapes:
        x = torch.randn(B, H, W, Ci, generator=g, device=dev).bfloat16()
        a = 1 + 0.1 * torch.randn(B, Ci, generator=g, device=dev)
        b = 0.1 * torch.randn(B, Ci, generator=g, device=dev)
        w = (torch.randn(3, 3, Ci, Co, generator=g, device=dev)
             * (9 * Ci) ** -0.5).bfloat16()
        bias = (0.1 * torch.randn(Co, generator=g, device=dev)).bfloat16()
        res = (torch.randn(B, H, W, Co, generator=g, device=dev).bfloat16()
               if use_res else None)
        out = fc.fused_affine_silu_conv3x3(x, a, b, w, bias, residual=res)
        torch.cuda.synchronize()
        want = fc.fused_affine_silu_conv3x3_ref(x, a, b, w, bias,
                                                residual=res,
                                                out_dtype=torch.float32)
        err = (out.float() - want).abs()
        # bf16 output rounding plus 2e-2 for summation order
        ok = bool((err <= 2e-2 + 2 ** -8 * want.abs()).all())
        check(ok, f"K4 disagrees at {(H, W, Ci, Co, use_res)}: "
                  f"{err.max().item():.3g}")
        gn_w = torch.ones(Ci, device=dev, dtype=torch.bfloat16)
        gn_b = torch.zeros(Ci, device=dev, dtype=torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        res_cl = res.permute(0, 3, 1, 2) if use_res else None

        def library():
            y = F.conv2d(F.silu(F.group_norm(x_cl, 32, gn_w, gn_b)), w_oihw,
                         bias, padding=1)
            return y + res_cl if use_res else y

        flops = 2.0 * 9 * B * H * W * Ci * Co
        nbytes = 2.0 * (x.numel() + out.numel() + w.numel()
                        + (res.numel() if use_res else 0)) + 8.0 * B * Ci
        bms, by = bound(flops, nbytes)
        row = dict(shape=f"B{B} {H}x{W} {Ci}->{Co}" + (" +res" if use_res
                                                       else ""),
                   per_decode=per_decode,
                   max_abs_err=err.max().item(),
                   ms=time_ms(torch, lambda: fc.fused_affine_silu_conv3x3(
                       x, a, b, w, bias, residual=res)),
                   plain_ms=time_ms(torch, lambda: fc.fused_affine_silu_conv3x3_ref(
                       x, a, b, w, bias, residual=res), 100.0),
                   library_ms=time_ms(torch, library),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
        print(f"K4 {row['shape']}: err {row['max_abs_err']:.3g} | kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"gn+silu+cudnn {row['library_ms']:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]", flush=True)
        del x, out, want, err, res
    results["K4"] = rows
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return results


def phase_slice(torch, dev, card, steps):
    import numpy as np
    from view_neti_tpu_torch.config import ModelConfig, RunConfig
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.ops.flash_attention import flash_attention
    from view_neti_tpu_torch.ops.fused_conv import fused_affine_silu_conv3x3
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

    # the counted run: the user's entry points, counts from 0
    flash_attention.launches = 0
    fused_affine_silu_conv3x3.launches = 0
    t0 = time.perf_counter()
    ctx, ctx_b, uncond = condition()

    def run(seed_offset):
        return pipeline.generate(built.unet, vae, sched, ctx, ctx_b, uncond,
                                 HEIGHT, WIDTH,
                                 [s + seed_offset for s in seeds],
                                 num_inference_steps=steps,
                                 guidance_scale=7.5,
                                 compute_dtype=torch.bfloat16, device=dev)

    imgs = run(0)
    first_s = time.perf_counter() - t0
    launches = {"K1": flash_attention.launches,
                "K4": fused_affine_silu_conv3x3.launches}
    check(imgs.shape == (3, HEIGHT, WIDTH, 3) and imgs.dtype == np.uint8,
          f"images {imgs.shape} {imgs.dtype}")
    check(imgs.min() != imgs.max(), "images are constant")
    check(launches["K1"] == 32 * steps,
          f"K1 launched {launches['K1']} times, want {32 * steps}")
    check(launches["K4"] == 29,
          f"K4 launched {launches['K4']} times, want 29")
    print(f"slice: first run {first_s:.2f} s, launches {launches}",
          flush=True)

    # sec/image as bench.py:_bench_infer counts it: three more rounds of
    # generate (new seeds, uint8 images copied to the host), over the
    # rounds times the seeds; the conditioning is outside the rounds
    rounds = 3
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        run(r)
    sec_per_image = (time.perf_counter() - t0) / (rounds * len(seeds))

    # one more run split by stage, with the final latents checked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx, ctx_b, uncond = condition()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    denoise = pipeline.make_denoise_fn(built.unet, sched, steps, 7.5,
                                       torch.bfloat16)
    lat0 = pipeline.initial_latents(seeds, HEIGHT // 8, WIDTH // 8, dev)
    lat = denoise(lat0, ctx, ctx_b, uncond)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    imgs2 = pipeline.decode_to_uint8(vae, lat.to(torch.bfloat16))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(bool(torch.isfinite(lat).all()), "final latents are not finite")
    check(tuple(imgs2.shape) == (3, HEIGHT, WIDTH, 3), "decode shape")
    stages = dict(steps=steps, conditioning_s=t1 - t0, denoise_s=t2 - t1,
                  decode_s=t3 - t2, sec_per_image=sec_per_image,
                  first_run_s=first_s,
                  latents_abs_max=lat.abs().max().item())
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
    # at B = 6 and the solver update) and one decode, under the profiler
    step1 = pipeline.make_denoise_fn(built.unet, sched, 1, 7.5,
                                     torch.bfloat16)
    for what, fn in (
            ("denoise step", lambda: step1(lat0, ctx, ctx_b, uncond)),
            ("decode", lambda: pipeline.decode_to_uint8(
                vae, lat.to(torch.bfloat16)))):
        prof = device_profile(torch, fn)
        print(f"profile {what} [{card}]: "
              f"{json.dumps(prof) if prof else 'not measured'}", flush=True)
    return launches, stages


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30,
                        help="DPM-Solver++ steps of the slice (default 30)")
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

    from view_neti_tpu_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"build {name}: {line.strip()}")

    kernels = phase_kernels(torch, dev, card)
    launches, stages = phase_slice(torch, dev, card, args.steps)

    # ms / plain_ms / bound_ms / library_ms are at the heaviest main-path
    # shape; path_* are the same summed over one serving run (K1's shapes
    # weighted by their launches per UNet forward times the steps, K4's by
    # their launches per decode).
    report = []
    for key, name, source, replaces, weight, tol in (
            ("K1", "flash_attention_fwd",
             "view_neti_tpu_torch/csrc/flash_attention_fwd.cu",
             "view_neti_tpu/ops/flash_attention.py:83",
             lambda r: r["per_forward"] * args.steps,
             "o: 2^-8|o| + 2^-4 rms(o), lse: 1e-3"),
            ("K4", "fused_affine_silu_conv3x3",
             "view_neti_tpu_torch/csrc/fused_conv.cu",
             "view_neti_tpu/ops/fused_conv.py:176",
             lambda r: r["per_decode"], "2e-2 + 2^-8|out|")):
        rows = kernels[key]
        top = max(rows, key=lambda r: r["bound_ms"] * (weight(r) > 0))
        path = {f"path_{k}": sum(r[k] * weight(r) for r in rows)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        if "err_of_limit" in rows[0]:
            path["err_of_limit"] = max(r["err_of_limit"] for r in rows)
            path["control_of_limit"] = min(r["control_of_limit"]
                                           for r in rows)
        report.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[key], checked=True, tolerance=tol,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=top["library_ms"], shape=top["shape"], **path,
            card=card))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
