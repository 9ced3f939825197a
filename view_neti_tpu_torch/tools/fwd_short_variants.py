#!/usr/bin/env python3
"""Time K1's short-key kernel (csrc/flash_attention_fwd_sm90.cu,
flash_fwd_kernel_sm90_short: Lk <= 80) against variants of it on the card,
all in one process, and split one block's time by the steps of a tile.

    python3 view_neti_tpu_torch/tools/fwd_short_variants.py [--rounds N]

Prints the card's name and power limit, then one JSON line:

  rows  -- at the paths' cross-attention shapes (and SD-2.1's 48-key mid
           block), each variant's device time of one call (a CUDA graph of
           20 calls, as chip_smoke.py's graph_ms), the median over --rounds
           rounds with the variants in turns, and for the variants that
           compute the same function the worst element's share of
           chip_smoke.py's limit against the plain version. "kept" is the
           source as it is; the others rebuild it with text replaced:
             two Q stages, double-buffered output, head-major order, no L2
             promotion -- other designs of the same function;
             no exponentials, no output store -- ablations, wrong on
             purpose: what the time is without the special-function units'
             work or without the TMA stores of O;
  split -- the cycles (clock64) that consumer warpgroup 0 of block 0
           spends on each step of its tiles, summed over the block's
           tiles, with the tile count: the loop's top (the tile's
           coordinates, a new (batch, head)'s K and V), the wait for the Q
           stage, S = Q K^T, the softmax and P's packing, O = P V, the
           epilogue (the wait for the previous tile's stores, o into shared
           memory, lse, the stores).
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

SOURCE = "flash_attention_fwd_sm90"
_OLD_ORDER = """__device__ __forceinline__ Tile short_tile(int i, int H, int q_tiles) {
  const int bh = i / q_tiles;
  const int b = bh / H;
  return Tile{b, bh - b * H, bh, (i - bh * q_tiles) * kBQ};
}"""
_HEAD_MAJOR = """__device__ __forceinline__ Tile short_tile(int i, int H, int q_tiles) {
  const int h = i % H;
  const int bq = i / H;
  const int b = bq / q_tiles;
  return Tile{b, h, b * H + h, (bq - b * q_tiles) * kBQ};
}"""
_STAGES = "  static constexpr int kQStages = DP <= 64 ? 6 : DP <= 80 ? 3 : 2;"
_STORE = """      if (tid == 0 && row0 < Lq)
        tma_store_chunks<T::kChunks>(&omap, o_wg, kOChunkBytes, row0, h, b);"""
_EPILOGUE_WAIT = """      if (tid == 0) tma_store_wait_read();
      named_bar_sync(kEpilogueBar + c, 128);"""
# name: [(text replaced, its replacement), ...]
VARIANTS = {
    "two Q stages": [(_STAGES, "  static constexpr int kQStages = 2;")],
    "double-buffered output": [
        (_STAGES, "  static constexpr int kQStages = DP <= 64 ? 6 : 2;\n"
                  "  static constexpr int kOBufs = DP <= 80 ? 2 : 1;"),
        ("kQStages * kQBytes + 2 * kOBytes +",
         "kQStages * kQBytes + 2 * kOBufs * kOBytes +"),
        ("  const uint32_t bars = o_s + 2 * T::kOBytes;",
         "  const uint32_t bars = o_s + 2 * T::kOBufs * T::kOBytes;"),
        ("    const uint32_t o_wg = o_s + c * T::kOBytes;",
         "    int obuf = 0;"),
        (_EPILOGUE_WAIT,
         "      const uint32_t o_wg = o_s + (T::kOBufs * c + obuf) * "
         "T::kOBytes;\n"
         "      if (++obuf == T::kOBufs) obuf = 0;\n"
         "      if (tid == 0) {\n"
         "        if constexpr (T::kOBufs == 2)\n"
         "          asm volatile(\"cp.async.bulk.wait_group.read 1;\\n\" ::: "
         "\"memory\");\n"
         "        else\n"
         "          tma_store_wait_read();\n"
         "      }\n"
         "      named_bar_sync(kEpilogueBar + c, 128);")],
    "head-major order": [
        (_OLD_ORDER, _HEAD_MAJOR),
        ("  static constexpr int kKvSlots = DP <= 80 ? 2 : 1;",
         "  static constexpr int kKvSlots = DP <= 64 ? 4 : DP <= 80 ? 2 : 1;")],
    "no L2 promotion": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                         "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "no exponentials": [(
        "      exponentiate<kKeys>(sc, scale_log2, m0, m1, l0, l1);",
        "      l0 = l1 = 1.f;\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < kKeys / 2; ++i)\n"
        "        sc[i] = fmaf(sc[i], scale_log2, -m0);")],
    "no output store": [(_STORE, "")],
}
ABLATIONS = ("no exponentials", "no output store")
SPLIT_STEPS = ("loop top", "wait Q", "S", "softmax", "P V", "epilogue")


def _split_variant():
    """The kept source with clock64 marks between the steps of consumer
    warpgroup 0's tiles in block 0, read back by short_split_read."""
    mark = ("      if (split) {{ const long long t1 = clock64(); "
            "acc[{k}] += t1 - t0; t0 = t1; }}\n")
    subs = [
        ("struct Tile {", "__device__ long long g_split[8];\n\nstruct Tile {"),
        ("    int cur = -1, gen = -1, s = 0, round = 0;\n"
         "    for (int i = first; i < last; ++i) {\n"
         "      const Tile tile = short_tile(i, H, q_tiles);",
         "    int cur = -1, gen = -1, s = 0, round = 0;\n"
         "    const bool split = blockIdx.x == 0 && c == 0 && tid == 0;\n"
         "    long long t0 = clock64(), acc[6] = {0, 0, 0, 0, 0, 0};\n"
         "    for (int i = first; i < last; ++i) {\n"
         "      const Tile tile = short_tile(i, H, q_tiles);"),
        ("      mbar_wait(q_full + 8 * s, round & 1);\n"
         "      wgmma_fence();\n      pin_regs(sc);",
         mark.format(k=0) + "      mbar_wait(q_full + 8 * s, round & 1);\n"
         + mark.format(k=1) + "      wgmma_fence();\n      pin_regs(sc);"),
        ("      pin_regs(sc);\n      // the Q stage is read: it goes back",
         "      pin_regs(sc);\n" + mark.format(k=2)
         + "      // the Q stage is read: it goes back"),
        ("      pack_p<kKeys>(sc, p);\n",
         "      pack_p<kKeys>(sc, p);\n" + mark.format(k=3)),
        ("      pin_regs(o);\n      pin_regs(p);\n\n      // o = O / l",
         "      pin_regs(o);\n      pin_regs(p);\n" + mark.format(k=4)
         + "\n      // o = O / l"),
        (_STORE, _STORE + "\n" + mark.format(k=5)),
        ("    // the shared memory stays until the last store has read it\n",
         "    if (split) {\n"
         "      for (int k = 0; k < 6; ++k) g_split[k] = acc[k];\n"
         "      g_split[6] = last - first;\n"
         "    }\n"
         "    // the shared memory stays until the last store has read it\n"),
        ('extern "C" {\n',
         'extern "C" {\n\n'
         "int short_split_read(void* dst) {\n"
         "  return static_cast<int>(\n"
         "      cudaMemcpyFromSymbol(dst, g_split, sizeof(g_split)));\n"
         "}\n"),
    ]
    return subs


SHAPES = (  # (B, Lq, Lk, H, d): the cross-attentions, SD-2.1's mid block
    (6, 6912, 77, 8, 40), (9, 4096, 77, 8, 40), (9, 3072, 77, 5, 64),
    (6, 1728, 77, 8, 80), (6, 432, 77, 8, 160), (9, 48, 48, 20, 64))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def patched(src, subs, name):
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:60]!r} is not in the "
                               f"source once")
        src = src.replace(old, new)
    return src


def build_variants(build, fa, out_dir):
    """{name: C entry} for the kept source and every variant, and the
    split build's entry and library, all built in parallel."""
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in [*VARIANTS.items(), ("split", _split_variant())]:
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu = os.path.join(out_dir, f"{tag}.cu")
        with open(cu, "w") as f:
            f.write(patched(src, subs, name))
        so = os.path.join(out_dir, f"lib{tag}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"kept": build.load(SOURCE)}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    entries = {}
    for name, lib in libs.items():
        fn = lib.flash_attention_fwd_sm90_bf16
        fn.argtypes = list(fa._FWD_ARGTYPES)
        fn.restype = ctypes.c_int
        entries[name] = fn
    split = entries.pop("split")
    return entries, split, libs["split"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fwd_short_variants: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    import chip_smoke as cs
    from view_neti_tpu_torch.ops import build
    from view_neti_tpu_torch.ops import flash_attention as fa
    entries, split_fn, split_lib = build_variants(
        build, fa, str(build.BUILD_DIR / "short_variants"))
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    rows, splits = [], []
    for B, Lq, Lk, H, d in SHAPES:
        q = torch.randn(B, Lq, H, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, Lk, H, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, Lk, H, d, generator=g, device="cuda").bfloat16()
        o = torch.empty_like(q)
        lse = torch.empty(B, H, Lq, device="cuda")
        ro = torch.cat([fa.flash_attention_ref(q[b:b + 1].float(),
                                               k[b:b + 1].float(),
                                               v[b:b + 1].float())[0]
                        for b in range(B)])
        tol = cs.attention_tolerance(ro)

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), B, H, Lq, Lk, d,
                     *fa._strides(q, k, v, o), d ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        times = {name: [] for name in entries}
        errs = {}
        for _ in range(args.rounds):
            for name, fn in entries.items():
                times[name].append(cs.graph_ms(torch, lambda: call(fn)))
                if name not in ABLATIONS:
                    call(fn)
                    errs[name] = cs.of_limit(o, ro, tol)
        # one eager call of the split build: its marks, block 0's tiles
        buf = (ctypes.c_longlong * 8)()
        call(split_fn)
        torch.cuda.synchronize()
        if split_lib.short_split_read(buf):
            raise RuntimeError("short_split_read failed")
        tiles = buf[6]
        splits.append(dict(shape=[B, Lq, Lk, H, d], tiles=tiles,
                           cycles_a_tile={s: buf[i] / tiles for i, s in
                                          enumerate(SPLIT_STEPS)}))
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * (
            lse.numel())
        rows.append(dict(shape=[B, Lq, Lk, H, d],
                         bytes_bound_ms=nbytes / 3.35e9,
                         graph_ms={n: statistics.median(t)
                                   for n, t in times.items()},
                         err_of_limit=errs))
        del q, k, v, o, ro, tol
    print(json.dumps(dict(rounds=args.rounds, rows=rows, split=splits)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
