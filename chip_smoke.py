#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (view_neti_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--steps N] [--train-steps N]

Phases; any failure ends the run with a non-zero exit:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds the four kernel libraries from
                view_neti_tpu_torch/csrc/ (in parallel) and prints each
                kernel's registers and spills; the instantiations the two
                paths run (K1 and K3 at head dims 40, 80, 160) must not
                spill;
  3. kernels -- the flash-attention forward (K1), its backward (K2 dq, K3
                dk/dv) and the fused GroupNorm+SiLU+conv3x3 (K4) at every
                shape the SD-1.5 768x576 serving path and the 384x512 B=9
                train step give them (plus one SD-2.1 d=64 K1 shape), bf16
                inputs from a seed, held against their plain versions in
                fp32 with TF32 off, each limit with a control it must
                catch, and timed with CUDA events beside the plain version,
                one PyTorch library call and the card's bound (and the
                bound's share of the kernel's time);
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
  5. train   -- the mode-2 train step of bench.py:main on the same stack:
                B = 9 (3 x 3 accumulation, fused), 384x512 pixels uniform in
                [-1, 1], the fused VAE encode, DDPM noise, nested dropout,
                the UNet through K1/K2/K3, fp32 MSE, the sliced AdamW; 2
                warm-up and --train-steps timed steps (imgs/sec, ms/step,
                peak memory), checks on the loss, the gradients, the moved
                parameters and every kernel's launch count, a check that
                the kernels' gradient descends (central difference along
                -g with the draws held fixed), a stage split and a profile;
  6. report  -- one JSON line of per-kernel results, then the result line.
The bound is max(operations / 989 TFLOP/s, bytes / 3.35 TB/s), the
published dense-bf16 and memory peaks of an H100 SXM at 700 W.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

PEAK_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
BATCH = 6                # 3 seeds x CFG
HEIGHT, WIDTH = 576, 768
TRAIN_BATCH = 9          # train_batch_size 3 x gradient_accumulation 3
TRAIN_HEIGHT, TRAIN_WIDTH = 384, 512


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def check_path_spills(usage):
    """The instantiations of K1 and K3 at the paths' head-dim buckets (48,
    80, 160) must spill nothing; prints every K1/K3 instantiation."""
    seen = 0
    for (lib, fn), (regs, spill) in sorted(usage.items()):
        m = re.search(r"(flash_fwd_kernel|flash_bwd_dkv_kernel)I((?:Li\d+E)+)",
                      fn)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"\d+", m.group(2))]
        dp = args[0]
        print(f"build {lib}: {m.group(1)}<{', '.join(map(str, args))}>: "
              f"{regs} registers, {spill} bytes spill", flush=True)
        if dp in (48, 80, 160):
            seen += 1
            check(spill == 0, f"{fn} (on the path) spills {spill} bytes")
    return seen


def launch_counts(reset: bool = False):
    """Each kernel wrapper's launch count, {"K1": n, ...}; reset sets them
    all to 0 first."""
    from view_neti_tpu_torch.ops import flash_attention as fa
    from view_neti_tpu_torch.ops import fused_conv as fc
    wrappers = {"K1": fa.flash_attention, "K2": fa.flash_attention_bwd_dq,
                "K3": fa.flash_attention_bwd_dkv,
                "K4": fc.fused_affine_silu_conv3x3}
    if reset:
        for fn in wrappers.values():
            fn.launches = 0
    return {key: fn.launches for key, fn in wrappers.items()}


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


def attention_shapes(serve_steps: int):
    """Every attention shape of the two paths, with its launches per
    serving run (K1, 30 UNet forwards) and per train step (K1, K2, K3).

    SD-1.5 has 8 heads and 5 transformer blocks on each of its three
    attention levels (2 down, 3 up) plus 1 in the mid block; each block
    runs a self- and a cross-attention (Lk = 77). Serving: B = 6 (3 seeds x
    CFG) at 72x96 latents. Training: B = 9 at 48x64 latents; the first
    self-attention's inputs need no gradient (no backward) and the first
    cross-attention's q needs none (K3 only), so a step runs K2 30 times
    and K3 31 times. The last row is SD-2.1's level 0 (head dim 64), off
    both paths."""
    shapes = []
    for path, B, lengths in (("serve", BATCH, (6912, 1728, 432, 108)),
                             ("train", TRAIN_BATCH, (3072, 768, 192, 48))):
        for level, (L, d, n) in enumerate(zip(lengths, (40, 80, 160, 160),
                                              (5, 5, 5, 1))):
            for Lk in (L, 77):
                first = path == "train" and level == 0
                if path == "serve":
                    per_run = {"K1": {"serve": n * serve_steps}}
                else:
                    per_run = {"K1": {"train": n},
                               "K2": {"train": n - first},
                               "K3": {"train": n - (first and Lk == L)}}
                shapes.append(dict(B=B, Lq=L, Lk=Lk, H=8, d=d,
                                   per_run=per_run))
    shapes.append(dict(B=BATCH, Lq=6912, Lk=6912, H=5, d=64,
                       per_run={"K1": {}}))
    return shapes


def dropped_keys(Lk: int) -> int:
    """The keys a control leaves out: the last 64-key tile, or half the
    keys where there is only one tile."""
    return 64 if Lk > 64 else Lk // 2


def attention_rows(torch, F, fa, shape, g, dev):
    """K1 at one attention shape and, where the train step differentiates
    it, K2 and K3: each held against its plain version with a control its
    limit has to catch, and timed beside the plain version, a PyTorch
    library call and the bound."""
    B, Lq, Lk, H, d = (shape[k] for k in ("B", "Lq", "Lk", "H", "d"))
    label = f"B{B} Lq{Lq} Lk{Lk} H{H} d{d}"
    drop = dropped_keys(Lk)
    q = torch.randn(B, Lq, H, d, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Lk, H, d, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Lk, H, d, generator=g, device=dev).bfloat16()
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
          f"K1 disagrees at {label}: {ratio:.3g} of the limit, "
          f"lse {lse_err:.3g}")
    check(control > 1, f"K1's limit at {label} misses {drop} dropped keys "
                       f"({control:.3g} of the limit)")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bms, by = bound(4.0 * B * H * Lq * Lk * d,
                    2.0 * (2 * q.numel() + k.numel() + v.numel())
                    + 4.0 * lse.numel())
    rows = {"K1": dict(
        shape=label, per_run=shape["per_run"]["K1"],
        max_abs_err=(o.float() - ro).abs().max().item(), lse_err=lse_err,
        err_of_limit=ratio, control_of_limit=control,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v)),
        plain_ms=time_ms(torch, ref_fwd, 100.0),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        bound_ms=bms, bound_by=by)}
    del ro, rlse, tol
    if "K2" not in shape["per_run"]:
        return rows

    do = torch.randn(B, Lq, H, d, generator=g, device=dev).bfloat16()
    delta = fa.attention_delta(o, do)
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

    rdq, rdk, rdv = ref_bwd()
    tols = [attention_tolerance(r) for r in (rdq, rdk, rdv)]
    ratios = [of_limit(x, r, t) for x, r, t in zip((dq, dk, dv),
                                                   (rdq, rdk, rdv), tols)]
    errs = [(x.float() - r).abs().max().item()
            for x, r in zip((dq, dk, dv), (rdq, rdk, rdv))]
    # controls: dq without the last key tile's terms; dk and dv with that
    # tile's rows never written
    ctl_dq = of_limit(ref_bwd(Lk - drop, need_dkv=False)[0], rdq, tols[0])
    ctl_dkv = []
    for r, t in zip((rdk, rdv), tols[1:]):
        lost = r.clone()
        lost[:, Lk - drop:] = 0
        ctl_dkv.append(of_limit(lost, r, t))
    check(ratios[0] <= 1, f"K2 disagrees at {label}: {ratios[0]:.3g} of "
                          f"the limit")
    check(max(ratios[1:]) <= 1, f"K3 disagrees at {label}: dk "
                                f"{ratios[1]:.3g}, dv {ratios[2]:.3g} of "
                                f"the limit")
    check(ctl_dq > 1 and min(ctl_dkv) > 1,
          f"the backward's limit at {label} misses a lost key tile (dq "
          f"{ctl_dq:.3g}, dk {ctl_dkv[0]:.3g}, dv {ctl_dkv[1]:.3g})")
    del rdq, rdk, rdv, tols

    # SDPA's backward through autograd, the library yardstick: one call
    # computes dq, dk and dv, so its time stands beside both kernels
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv)
    ldo = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), ldo, retain_graph=True))
    del lo
    io_bytes = 8.0 * lse.numel()                 # lse and delta, fp32
    for key, flops, nbytes, ratio, control, err, fn, plain in (
            ("K2", 6.0 * B * H * Lq * Lk * d,
             2.0 * (3 * q.numel() + k.numel() + v.numel()) + io_bytes,
             ratios[0], ctl_dq, errs[0],
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             lambda: ref_bwd(need_dkv=False)),
            ("K3", 8.0 * B * H * Lq * Lk * d,
             2.0 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel())
             + io_bytes, max(ratios[1:]), min(ctl_dkv), max(errs[1:]),
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             lambda: ref_bwd(need_dq=False))):
        bms, by = bound(flops, nbytes)
        rows[key] = dict(shape=label, per_run=shape["per_run"][key],
                         max_abs_err=err, err_of_limit=ratio,
                         control_of_limit=control, ms=time_ms(torch, fn),
                         plain_ms=time_ms(torch, plain, 100.0),
                         library_ms=library_ms, bound_ms=bms, bound_by=by)
    return rows


def k4_shapes():
    """Every norm->SiLU->conv3x3 section of the VAE decoder (serving, B = 3,
    29 per decode) and of its encoder (training, B = 9, 21 per step):
    (B, H, W, Cin, Cout, residual, {path: launches per run}). conv1 of each
    ResNet block has no residual, conv2 adds it."""
    D, E = BATCH // 2, TRAIN_BATCH

    def serve(n):
        return {"serve": n}

    def train(n):
        return {"train": n}

    return [(D, 72, 96, 512, 512, False, serve(5)),
            (D, 72, 96, 512, 512, True, serve(5)),
            (D, 144, 192, 512, 512, False, serve(3)),
            (D, 144, 192, 512, 512, True, serve(3)),
            (D, 288, 384, 512, 256, False, serve(1)),
            (D, 288, 384, 256, 256, False, serve(2)),
            (D, 288, 384, 256, 256, True, serve(3)),
            (D, 576, 768, 256, 128, False, serve(1)),
            (D, 576, 768, 128, 128, False, serve(2)),
            (D, 576, 768, 128, 128, True, serve(3)),
            (D, 576, 768, 128, 3, False, serve(1)),
            (E, 384, 512, 128, 128, False, train(2)),
            (E, 384, 512, 128, 128, True, train(2)),
            (E, 192, 256, 128, 256, False, train(1)),
            (E, 192, 256, 256, 256, False, train(1)),
            (E, 192, 256, 256, 256, True, train(2)),
            (E, 96, 128, 256, 512, False, train(1)),
            (E, 96, 128, 512, 512, False, train(1)),
            (E, 96, 128, 512, 512, True, train(2)),
            (E, 48, 64, 512, 512, False, train(4)),
            (E, 48, 64, 512, 512, True, train(4)),
            (E, 48, 64, 512, 8, False, train(1))]


def k4_row(torch, F, fc, shape, g, dev):
    B, H, W, Ci, Co, use_res, per_run = shape
    label = f"B{B} {H}x{W} {Ci}->{Co}" + (" +res" if use_res else "")
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

    def ref(cin=Ci):
        return fc.fused_affine_silu_conv3x3_ref(
            x[..., :cin], a[:, :cin], b[:, :cin], w[:, :, :cin], bias,
            residual=res, out_dtype=torch.float32)

    want = ref()
    # bf16 output rounding plus 2e-2 for summation order
    tol = 2e-2 + 2 ** -8 * want.abs()
    ratio = of_limit(out, want, tol)
    # the control: the last 32 input channels left out, the fault of a
    # lost k-step of the kernel's 32-channel loop
    control = of_limit(ref(Ci - 32), want, tol)
    check(ratio <= 1, f"K4 disagrees at {label}: {ratio:.3g} of the limit")
    check(control > 1, f"K4's limit at {label} misses a lost k-step "
                       f"({control:.3g} of the limit)")
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

    bms, by = bound(2.0 * 9 * B * H * W * Ci * Co,
                    2.0 * (x.numel() + out.numel() + w.numel()
                           + (res.numel() if use_res else 0))
                    + 8.0 * B * Ci)
    return dict(shape=label, per_run=per_run,
                max_abs_err=(out.float() - want).abs().max().item(),
                err_of_limit=ratio, control_of_limit=control,
                ms=time_ms(torch, lambda: fc.fused_affine_silu_conv3x3(
                    x, a, b, w, bias, residual=res)),
                plain_ms=time_ms(torch, lambda:
                                 fc.fused_affine_silu_conv3x3_ref(
                                     x, a, b, w, bias, residual=res), 100.0),
                library_ms=time_ms(torch, library), bound_ms=bms,
                bound_by=by)


def print_row(key, row, card):
    extra = (f", lse {row['lse_err']:.3g}" if "lse_err" in row else "")
    print(f"{key} {row['shape']}: err {row['max_abs_err']:.3g} "
          f"({row['err_of_limit']:.3g} of the limit; control "
          f"{row['control_of_limit']:.3g}){extra} | kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {row['share_of_bound']:.4f} of the kernel's "
          f"time) [{card}]", flush=True)


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
    for shape in attention_shapes(serve_steps):
        for key, row in attention_rows(torch, F, fa, shape, g,
                                       dev).items():
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            results[key].append(row)
            print_row(key, row, card)
    shapes = k4_shapes()
    check(sum(s[-1].get("serve", 0) for s in shapes) == 29
          and sum(s[-1].get("train", 0) for s in shapes) == 21,
          "K4 shape table")
    for shape in shapes:
        row = k4_row(torch, F, fc, shape, g, dev)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        results["K4"].append(row)
        print_row("K4", row, card)
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

    # the counted run: the user's entry points, counts from 0
    launch_counts(reset=True)
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
    launches = launch_counts()
    check(imgs.shape == (3, HEIGHT, WIDTH, 3) and imgs.dtype == np.uint8,
          f"images {imgs.shape} {imgs.dtype}")
    check(imgs.min() != imgs.max(), "images are constant")
    check(launches["K1"] == 32 * steps,
          f"K1 launched {launches['K1']} times, want {32 * steps}")
    check(launches["K4"] == 29,
          f"K4 launched {launches['K4']} times, want 29")
    check(launches["K2"] == launches["K3"] == 0,
          f"the serving path ran the backward: {launches}")
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
    return launches, stages, built, tok


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
    want = {"K1": 32 * n, "K2": 30 * n, "K3": 31 * n, "K4": 21 * n}
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


def kernel_report(kernels, launches, card):
    """The {"kernels": [...]} line: per kernel, ms / plain_ms / bound_ms /
    library_ms and share_of_bound (bound_ms / ms) at its heaviest main-path
    shape, and the same summed over one serving run (serve_path_*) and one
    train step (train_path_*), each shape weighted by its launches
    there."""
    report = []
    for key, name, source, replaces, tol in (
            ("K1", "flash_attention_fwd",
             "view_neti_tpu_torch/csrc/flash_attention_fwd.cu",
             "view_neti_tpu/ops/flash_attention.py:83",
             "o: 2^-8|o| + 2^-4 rms(o), lse: 1e-3"),
            ("K2", "flash_attention_bwd_dq",
             "view_neti_tpu_torch/csrc/flash_attention_bwd.cu",
             "view_neti_tpu/ops/flash_attention.py:160",
             "dq: 2^-8|dq| + 2^-4 rms(dq)"),
            ("K3", "flash_attention_bwd_dkv",
             "view_neti_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
             "view_neti_tpu/ops/flash_attention.py:190",
             "dk, dv: 2^-8|x| + 2^-4 rms(x)"),
            ("K4", "fused_affine_silu_conv3x3",
             "view_neti_tpu_torch/csrc/fused_conv.cu",
             "view_neti_tpu/ops/fused_conv.py:176", "2e-2 + 2^-8|out|")):
        rows = kernels[key]
        top = max(rows, key=lambda r: r["bound_ms"] * bool(r["per_run"]))
        path = {f"{p}_path_{k}": sum(r[k] * r["per_run"].get(p, 0)
                                     for r in rows)
                for p in ("serve", "train")
                if any(p in r["per_run"] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        for p in ("serve", "train"):
            if f"{p}_path_ms" in path:
                path[f"{p}_path_share_of_bound"] = (
                    path[f"{p}_path_bound_ms"] / path[f"{p}_path_ms"])
        report.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(n.get(key, 0) for n in launches.values()),
            launches_by_path={p: n.get(key, 0) for p, n in launches.items()},
            checked=True, tolerance=tol,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            err_of_limit=max(r["err_of_limit"] for r in rows),
            control_of_limit=min(r["control_of_limit"] for r in rows),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            share_of_bound=top["share_of_bound"],
            library_ms=top["library_ms"], shape=top["shape"], **path,
            card=card))
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30,
                        help="DPM-Solver++ steps of the slice (default 30)")
    parser.add_argument("--train-steps", type=int, default=5,
                        help="timed train steps after 2 warm-up steps "
                             "(default 5)")
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
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    # the logs of libraries built earlier come from beside them, so every
    # run reads the three path buckets of K1 (in two key-tile widths, 64
    # and 80) and of K3
    n = check_path_spills(ptxas_usage(logs))
    check(n == 9, f"found {n} path instantiations of K1/K3 in the build "
                  f"logs, want 9")

    kernels = phase_kernels(torch, dev, card, args.steps)
    serve_launches, _, built, tok = phase_slice(torch, dev, card,
                                                args.steps)
    train_launches, _ = phase_train(torch, dev, card, built, tok,
                                    args.train_steps)
    report = kernel_report(kernels, {"serve": serve_launches,
                                     "train": train_launches}, card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
