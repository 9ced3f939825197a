"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration file, its traffic mix
(benchmark/traffic/<traffic>.json, whose "kind" names the driver in
benchmark/drivers/), its metrics (benchmark/metrics/<metric>.py) and its
correctness limits (benchmark/limits/<cell>.json) are found by name. With
--trace 0 the line carries the cell's end-to-end metrics, with --trace 1
its per-layer metrics, read from a profile of a short window.

The run needs as many CUDA devices as the cell asks for, and exits 1
without a result line when they are not there. It measures the port
(view_neti_tpu_torch) only: it exits 1 without a result line when the
process holds jax, jaxlib, flax or the JAX package once the window has
closed. After the window it checks the outputs against the plain
reference (benchmark/reference/) and prints each number compared beside
its limit, last on standard error and last in the line, under "check".
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "view_neti_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc: its
    start time after boot against the uptime), else this module's
    import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        now = time.perf_counter()
        return now - age if 0 <= age < 3600 else T_START
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_metric(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, key: str) -> List[Dict]:
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_dirs(root: Path) -> None:
    """Every kernel and build cache inside the checkout, at fixed paths."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(args, root: Path, device):
    """The cell's files and the run's context."""
    import torch

    from benchmark.trace import Trace
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    lim_file = root / "benchmark" / "limits" / f"{cell['name']}.json"
    limits = (json.loads(lim_file.read_text()) if lim_file.exists()
              else None)

    def read_peak():
        if torch.device(device).type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(device))

    ctx = SimpleNamespace(
        config=cfg, traffic=traffic, device=device, seed=args.seed,
        seconds=args.seconds, trace=Trace() if args.trace else None,
        read_peak=read_peak, tmpdir=None)
    return bench, cell, ctx, limits


def check(driver, ctx, out, limits: Dict) -> Dict[str, Dict]:
    """Each compared number with its limit."""
    ref = driver.reference(ctx, out)
    values = driver.readings(ctx, out, ref)
    return {name: {"value": values[name], "limit": lim}
            for name, lim in limits["limits"].items()}


def main(argv=None, root: Optional[str] = None, device=None,
         out_stream=None) -> int:
    """Run the cell; returns the exit code. `device` None means the
    card(s) the cell asks for; a test passes "cpu" to drive the rest of
    a run without a card."""
    args = parse(argv)
    root = Path(root or os.getcwd()).resolve()
    out_stream = out_stream or sys.stdout
    cache_dirs(root)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch
    try:
        bench, cell, ctx, limits = prepare(args, root, device or "cuda")
    except (OSError, KeyError, ValueError) as e:
        note(f"benchmark: cannot read the cell's files: {e!r}")
        return 1
    if limits is None:
        note(f"benchmark: {cell['name']} has no limits file")
        return 1
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            note(f"benchmark: {cell['name']} needs {cell['chips']} CUDA "
                 f"device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 1
        ctx.device = torch.device("cuda", 0)
    try:
        importlib.import_module("view_neti_tpu_torch")
    except ImportError as e:
        note(f"benchmark: the program is not importable: {e!r}")
        return 1
    driver = importlib.import_module(
        f"benchmark.drivers.{ctx.traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        ctx.tmpdir = tmp
        try:
            out = driver.run(ctx)
            found = forbidden_modules()
            if found:
                note(f"benchmark: the process holds {found} after the "
                     f"window; the benchmark measures the port alone")
                return 1
            run = SimpleNamespace(record=out, trace=None, work=None,
                                  process_start=process_start())
            if args.trace:
                from benchmark import flops, trace
                run.trace = trace.reduce(ctx.trace.prof)
                if run.trace is not None:
                    run.trace.units = out.steps
                    run.trace.extra = {"steps": getattr(out, "n_steps", 1)}
                run.work = flops.unit_work(ctx.traffic["kind"], ctx.config,
                                           ctx.traffic)
            key = "per_layer" if args.trace else "end_to_end"
            metrics = {}
            for m in cell_metrics(bench, cell["name"], key):
                value = load_metric(root, m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
            t_check = time.perf_counter()
            checked = check(driver, ctx, out, limits)
            note(f"timing setup_s {out.t0 - run.process_start:.3f} "
                 f"window_s {out.t1 - out.t0:.3f} "
                 f"metrics_s {t_check - out.t1:.3f} "
                 f"check_s {time.perf_counter() - t_check:.3f}")
        except Exception:  # the boundary: no result line, a failed exit
            traceback.print_exc(file=sys.stderr)
            return 1
    correct = (out.failed == 0 and out.attempted > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checked.values()))
    dev = {"platform": "gpu" if torch.device(ctx.device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if torch.device(ctx.device).type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out.peak_bytes or 0}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        from benchmark import trace
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = trace.breakdown(run.trace)
    result["check"] = checked
    for name, c in checked.items():
        note(f"check {name} {c['value']!r} limit {c['limit']!r}")
    found = forbidden_modules()
    if found:
        note(f"benchmark: the process holds {found}")
        return 1
    print(json.dumps(result), file=out_stream, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
