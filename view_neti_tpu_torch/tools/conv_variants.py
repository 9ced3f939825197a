#!/usr/bin/env python3
"""Time K4's two designs against variants of each on the card, all in one
process, so the instantiations kept rest on measured times.

    python3 view_neti_tpu_torch/tools/conv_variants.py [--rounds N]

Prints the card's name and power limit, then one JSON line:

  n_tile   -- the Cout <= 16 shapes of the two paths (the decoder's conv_out,
              the encoder's last conv) with each output-channel tile the
              mma.sync library has (16 and 128), by swapping the wrapper's
              choice (ops/fused_conv.py conv_n_tile);
  variants -- at heavy wide shapes of both paths, csrc/fused_conv_sm90.cu as
              it is ("sm90 kept") and rebuilt with another launch line (the
              pixel tile TH x 32, the output channels BN, the weight ring's
              stages, the SiLU of the next chunk under the products or after
              them, a cluster of two blocks sharing each weight tile by
              multicast) or the first tap that SiLUs the next chunk, beside
              csrc/fused_conv.cu as it is ("mma_sync kept") and its
              launch-configuration variants. A "diagnostic" variant
              replaces the SiLU's arithmetic by a copy of x: wrong results
              (its error is printed, not gated), the time of the loop
              without the SiLU's work. ptxas's register and spill lines
              of every variant are printed first.

Each time is the median over --rounds rounds of the mean of a burst of
launches (CUDA events), the variants taken in turns within each round.
Each result is also held against the plain version (worst element's share
of chip_smoke.py's limit, 2e-2 + 2^-8 |out|); every variant but the
diagnostic one must stay within it.
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

SM90_LAUNCH = "launch_conv<8, 128, 4, true, 1>(p, x, w, w_cols, B, s)"
SM90_SILU = """        packed.x = affine_silu2(rv.x, av[0], av[1], bv[0], bv[1]);
        packed.y = affine_silu2(rv.y, av[2], av[3], bv[2], bv[3]);
        packed.z = affine_silu2(rv.z, av[4], av[5], bv[4], bv[5]);
        packed.w = affine_silu2(rv.w, av[6], av[7], bv[6], bv[7]);"""
SM90_SILU_TAP = "constexpr int kSiluTap0 = 3;"
WIDE = "launch_conv<4, 128, 2, 4, 2>(p, s)"
NARROW = "launch_conv<8, 16, 8, 1, 2>(p, s)"
DIAGNOSTIC = "sm90 diagnostic: SiLU arithmetic replaced by a copy"


def sm90_launch(th, bn, stages, overlap, cluster=1):
    return (f"launch_conv<{th}, {bn}, {stages}, "
            f"{'true' if overlap else 'false'}, {cluster}>"
            f"(p, x, w, w_cols, B, s)")


# name: (library, the text replaced, its replacement)
VARIANTS = {
    "sm90 5 stages": ("fused_conv_sm90", SM90_LAUNCH,
                      sm90_launch(8, 128, 5, True)),
    "sm90 3 stages": ("fused_conv_sm90", SM90_LAUNCH,
                      sm90_launch(8, 128, 3, True)),
    "sm90 SiLU after the products": ("fused_conv_sm90", SM90_LAUNCH,
                                     sm90_launch(8, 128, 4, False)),
    "sm90 4x32 px, BN 256": ("fused_conv_sm90", SM90_LAUNCH,
                             sm90_launch(4, 256, 4, True)),
    "sm90 4x32 px, BN 128": ("fused_conv_sm90", SM90_LAUNCH,
                             sm90_launch(4, 128, 4, True)),
    "sm90 2-block cluster, weights multicast": (
        "fused_conv_sm90", SM90_LAUNCH, sm90_launch(8, 128, 4, True, 2)),
    "sm90 SiLU from tap 1": ("fused_conv_sm90", SM90_SILU_TAP,
                             "constexpr int kSiluTap0 = 1;"),
    "sm90 SiLU from tap 5": ("fused_conv_sm90", SM90_SILU_TAP,
                             "constexpr int kSiluTap0 = 5;"),
    DIAGNOSTIC: ("fused_conv_sm90", SM90_SILU, "        packed = rv;"),
    "mma_sync wide 8x32 px, 16 warps of 64x32":
        ("fused_conv", WIDE, "launch_conv<8, 128, 4, 4, 1>(p, s)"),
    "mma_sync narrow 4x32 px":
        ("fused_conv", NARROW, "launch_conv<4, 16, 8, 1, 2>(p, s)"),
}
SHAPES = (  # (B, H, W, Cin, Cout)
    (3, 288, 384, 512, 256), (3, 576, 768, 128, 128), (9, 384, 512, 128, 128),
    (9, 128, 128, 512, 512), (9, 48, 64, 512, 512), (3, 72, 96, 512, 512),
    (3, 576, 768, 128, 3), (9, 48, 64, 512, 8))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_variants(build, out_dir):
    """{name: ctypes library} for every variant and the two kept sources,
    built in parallel."""
    sources = {lib: (build.CSRC / f"{lib}.cu").read_text()
               for lib in ("fused_conv_sm90", "fused_conv")}
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (lib, old, new) in VARIANTS.items():
        if sources[lib].count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not once in "
                               f"{lib}.cu")
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu = os.path.join(out_dir, f"{tag}.cu")
        with open(cu, "w") as f:
            f.write(sources[lib].replace(old, new))
        so = os.path.join(out_dir, f"lib{tag}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.build(["fused_conv_sm90", "fused_conv"])
    libs = {"sm90 kept": build.load("fused_conv_sm90"),
            "mma_sync kept": build.load("fused_conv")}
    regs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line
                      or "C75" in line]
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, regs


def library_of(name: str) -> str:
    return "fused_conv_sm90" if name.startswith("sm90") else "fused_conv"


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
    libs, regs = build_variants(build, str(build.BUILD_DIR / "variants"))
    print(json.dumps({"ptxas": regs}), flush=True)

    def use(name):
        lib = library_of(name)
        _, symbol, _ = fc.CONV_ENTRIES[
            "sm90" if lib == "fused_conv_sm90" else "mma_sync"]
        fn = getattr(libs[name], symbol)
        fn.argtypes = list(fc._ARGTYPES)
        fn.restype = ctypes.c_int
        build._libs[lib] = libs[name]
        build._entries[(lib, symbol)] = fn

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
        # (label, library, design, output-channel tile or None for the
        # wrapper's): the kept sources, and the variants of the design
        # this Cout runs on its path (both designs at a wide Cout)
        narrow = Co <= 16
        if narrow:
            cands = [(f"mma_sync kept, n_tile {t}", "mma_sync kept",
                      "mma_sync", t) for t in (16, 128)]
            cands += [(name, name, "mma_sync", None) for name, v in
                      VARIANTS.items() if v[1] == NARROW]
        else:
            cands = [("sm90 kept", "sm90 kept", "sm90", None),
                     ("mma_sync kept", "mma_sync kept", "mma_sync", None)]
            cands += [(name, name, "sm90" if v[0] == "fused_conv_sm90"
                       else "mma_sync", None)
                      for name, v in VARIANTS.items() if v[1] != NARROW]
        times = {c[0]: [] for c in cands}
        errs = {}
        for _ in range(args.rounds):
            for label, lib, design, tile in cands:
                use(lib)
                fc.conv_n_tile = ((lambda cout, t=tile: t) if tile
                                  else n_tile_choice)

                def run(design=design):
                    return fc._fused_affine_silu_conv3x3_design(
                        design, x, a, b, w)

                out = run()
                errs[label] = ((out.float() - want).abs() / tol).max().item()
                times[label].append(burst_ms(run))
        fc.conv_n_tile = n_tile_choice
        bad = {k: v for k, v in errs.items() if v > 1 and k != DIAGNOSTIC}
        if bad:
            raise RuntimeError(f"variants disagree at {(B, H, W, Ci, Co)}: "
                               f"{bad}")
        rows.append(dict(shape=[B, H, W, Ci, Co],
                         bound_ms=2.0 * 9 * B * H * W * Ci * Co / 989e12
                         * 1e3,
                         ms={k: statistics.median(v) for k, v in
                             times.items()},
                         err_of_limit=errs))
        del x, want
    use("sm90 kept")
    use("mma_sync kept")
    print(json.dumps(dict(rounds=args.rounds, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
