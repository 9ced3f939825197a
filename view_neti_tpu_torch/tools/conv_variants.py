#!/usr/bin/env python3
"""Time K4 (csrc/fused_conv.cu) against variants of its tiling on the card,
all in one process, so the instantiations it keeps rest on measured times.

    python3 view_neti_tpu_torch/tools/conv_variants.py [--rounds N]

Prints the card's name and power limit, then one JSON line:

  n_tile   -- the Cout <= 16 shapes of the two paths (the decoder's conv_out,
              the encoder's last conv) with each output-channel tile the
              library has (16 and 128), by swapping the wrapper's choice
              (ops/fused_conv.py conv_n_tile);
  variants -- csrc/fused_conv.cu as it is ("kept") and rebuilt with another
              launch configuration (pixel rows per block, output channels
              per block, warps along pixels and channels, blocks per SM) at
              heavy shapes of both paths.

Each time is the median over --rounds rounds of the mean of a burst of
launches (CUDA events), the variants taken in turns within each round.
Each result is also held against the plain version (worst element's share
of chip_smoke.py's limit, 2e-2 + 2^-8 |out|).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

WIDE = "launch_conv<4, 128, 2, 4, 2>(p, s)"
NARROW = "launch_conv<8, 16, 8, 1, 2>(p, s)"
# name: (the launch line replaced, its replacement)
VARIANTS = {
    "wide 8x32 px, 16 warps of 64x32":
        (WIDE, "launch_conv<8, 128, 4, 4, 1>(p, s)"),
    "wide 4x32 px, 4 warps of 64x64":
        (WIDE, "launch_conv<4, 128, 2, 2, 2>(p, s)"),
    "narrow 4x32 px": (NARROW, "launch_conv<4, 16, 8, 1, 2>(p, s)"),
}
SHAPES = (  # (B, H, W, Cin, Cout)
    (3, 576, 768, 256, 128), (3, 576, 768, 128, 128), (9, 384, 512, 128, 128),
    (3, 144, 192, 512, 512), (9, 48, 64, 512, 512), (3, 576, 768, 128, 3),
    (9, 48, 64, 512, 8))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_variants(build, out_dir):
    """{name: ctypes library} for every variant, built in parallel."""
    src = (build.CSRC / "fused_conv.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, sub in VARIANTS.items():
        if src.count(sub[0]) != 1:
            raise RuntimeError(f"variant {name}: {sub[0]!r} not in the source")
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu = os.path.join(out_dir, f"{tag}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(*sub))
        so = os.path.join(out_dir, f"lib{tag}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"kept": build.load("fused_conv")}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_variants: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    from view_neti_tpu_torch.ops import build
    from view_neti_tpu_torch.ops import fused_conv as fc
    libs = build_variants(build, str(build.BUILD_DIR / "variants"))
    symbol = "fused_affine_silu_conv3x3_bf16"

    def use(name):
        fn = getattr(libs[name], symbol)
        fn.argtypes = list(fc._ARGTYPES)
        fn.restype = ctypes.c_int
        build._libs["fused_conv"] = libs[name]
        build._entries[("fused_conv", symbol)] = fn

    def burst_ms(fn, n=20):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    g = torch.Generator("cuda").manual_seed(0)
    n_tile_choice = fc.conv_n_tile
    rows = []
    for B, H, W, Ci, Co in SHAPES:
        x = torch.randn(B, H, W, Ci, generator=g, device="cuda").bfloat16()
        a = 1 + 0.1 * torch.randn(B, Ci, generator=g, device="cuda")
        b = 0.1 * torch.randn(B, Ci, generator=g, device="cuda")
        w = (torch.randn(3, 3, Ci, Co, generator=g, device="cuda")
             * (9 * Ci) ** -0.5).bfloat16()
        want = fc.fused_affine_silu_conv3x3_ref(x, a, b, w,
                                                out_dtype=torch.float32)
        tol = 2e-2 + 2 ** -8 * want.abs()
        # (label, library, output-channel tile or None for the wrapper's):
        # the kept source, and the variants that change the instantiation
        # this Cout runs
        narrow = Co <= 16
        cands = ([(f"kept, n_tile {t}", "kept", t) for t in (16, 128)]
                 if narrow else [("kept", "kept", None)])
        cands += [(name, name, None) for name, sub in VARIANTS.items()
                  if (sub[0] == NARROW) == narrow]
        times = {c[0]: [] for c in cands}
        errs = {}
        for _ in range(args.rounds):
            for label, lib, tile in cands:
                use(lib)
                fc.conv_n_tile = ((lambda cout, t=tile: t) if tile
                                  else n_tile_choice)
                run = (lambda: fc.fused_affine_silu_conv3x3(x, a, b, w))
                out = run()
                errs[label] = ((out.float() - want).abs() / tol).max().item()
                times[label].append(burst_ms(run))
        fc.conv_n_tile = n_tile_choice
        rows.append(dict(shape=[B, H, W, Ci, Co],
                         ms={k: statistics.median(v) for k, v in
                             times.items()},
                         err_of_limit=errs))
        del x, want
    use("kept")
    print(json.dumps(dict(rounds=args.rounds, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
