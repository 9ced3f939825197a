"""The readings that the correctness limits are set from, for one cell.

    python3 -m benchmark.control --workload <cell> --seconds <s>
                                 --seeds <n> [<n> ...] [--control 1]

runs the cell once for each seed in one process, with a short window,
and prints one JSON line a seed on standard output: "program", the
numbers the run compares (the program against the float32 reference),
and with --control 1 "control", the same numbers with the reference
computed on float8 operands put in the program's place; with --faults 1
(training traffic) the numbers of each fault planted in the reference
put in the program's place. The benchmark's
own runs never run this. Runs on the card; the tests drive it on the CPU
at a tiny size through `main(..., device="cpu")`.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path


def main(argv=None, root=None, device=None, out_stream=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=JSON",
                   help="change the traffic's recipe for a witness run, "
                        "e.g. optim.fuse_conv=false")
    p.add_argument("--witness", default=None, choices=("bf16",),
                   help="also the readings of the reference on operands "
                        "rounded to this precision, in the program's place")
    p.add_argument("--faults", type=int, choices=(0, 1), default=0,
                   help="train kinds: also the readings of each fault "
                        "planted in the reference put in the program's "
                        "place")
    args = p.parse_args(argv)
    root = Path(root or os.getcwd()).resolve()
    out_stream = out_stream or sys.stdout
    from benchmark import run as bench_run
    bench_run.cache_dirs(root)
    import torch
    dev = device or torch.device("cuda", 0)
    for seed in args.seeds:
        ns = bench_run.parse(["--workload", args.workload, "--seed",
                              str(seed), "--seconds", str(args.seconds)])
        _, _, ctx, _ = bench_run.prepare(ns, root, dev)
        for item in args.set:
            key, value = item.split("=", 1)
            *path, last = key.split(".")
            node = ctx.traffic["recipe"]
            for k in path:
                node = node.setdefault(k, {})
            node[last] = json.loads(value)
        driver = importlib.import_module(
            f"benchmark.drivers.{ctx.traffic['kind']}")
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp, \
                contextlib.redirect_stdout(sys.stderr):
            ctx.tmpdir = tmp
            out = driver.run(ctx)
            ref = driver.reference(ctx, out)
            line = {"seed": seed,
                    "program": driver.readings(ctx, out, ref)}
            if args.control:
                low = driver.reference(ctx, out, mode="fp8")
                out8 = driver.as_program(ctx, out, low)
                ref8 = (driver.reference(ctx, out8, reuse=ref)
                        if ctx.traffic["kind"] == "render" else ref)
                line["control"] = driver.readings(ctx, out8, ref8)
            if args.witness:
                wit = driver.as_program(
                    ctx, out, driver.reference(ctx, out, mode=args.witness))
                refw = (driver.reference(ctx, wit, reuse=ref)
                        if ctx.traffic["kind"] == "render" else ref)
                line[args.witness] = driver.readings(ctx, wit, refw)
            if args.faults and ctx.traffic["kind"] == "coach":
                for fault in ("half_batch", "token_altered"):
                    bad = driver.as_program(
                        ctx, out, driver.reference(ctx, out, fault=fault))
                    line[fault] = driver.readings(ctx, bad, ref)
        print(json.dumps(line), file=out_stream, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
