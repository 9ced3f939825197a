"""CUDA graphs: the port's counterpart of the JAX package's one dispatch per
sampling run (the denoise loop's jit, view_neti_tpu/inference/pipeline.py)
and per training window (make_multi_step under optim.steps_per_dispatch).

`Graphed(fn, name)` wraps fn(*args), whose args are tensors, or
dataclasses, dicts, lists and tuples of tensors and plain values. With every
tensor on the CPU (or `enabled` off) a call is fn's own: the plain path the
tests run. On the card, the first call with a new signature (the args'
structure and plain values, and their tensors' shapes, dtypes and devices)
runs fn eagerly on a side stream: that run is the call's result and the
warm-up (the kernels' libraries load, their shared-memory limits are
raised, cuBLAS makes its handles), and a function called once is never
captured. The second call captures fn into a torch.cuda.CUDAGraph over
static copies of the args; it and every later call with that signature
copy their tensors into the static copies, replay the graph and return
clones of the graph's outputs. Capture changes when work is
launched, not what runs: the graph holds the kernels fn launches eagerly,
on the same shapes, in the same order.

A capture or replay that fails raises CaptureError, naming fn's frame where
the capture broke; nothing falls back to eager.

The kernel wrappers' launch counters (ops/flash_attention.py,
ops/fused_conv.py) count where a kernel is launched, each also by design
(launch_counts). A capture launches nothing, so the counts
it adds are taken back and kept as the graph's record of its launches, and
every replay adds that record.

Spans (utils/profiling.span), labelled with the Graphed's name: a first
call's eager run is "graph.warmup", a capture "graph.capture", and a
replayed call's copy-in, replay and clone-out "graph.replay".
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from view_neti_tpu_torch.utils.profiling import span


class CaptureError(RuntimeError):
    """A CUDA graph's capture or replay failed."""


def kernel_wrappers() -> Dict[str, Callable]:
    """The four kernel wrappers, by the kernels' ids, whose `launches`
    count their launches."""
    from view_neti_tpu_torch.ops import flash_attention as fa
    from view_neti_tpu_torch.ops import fused_conv as fc
    return {"K1": fa.flash_attention, "K2": fa.flash_attention_bwd_dq,
            "K3": fa.flash_attention_bwd_dkv,
            "K4": fc.fused_affine_silu_conv3x3}


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Each kernel wrapper's launch count, {"K1": n, ...}, and the split by
    design of K1 ("K1 sm90", "K1 mma_sync": ops/flash_attention.py::
    fwd_design), K2 and K3 ("K2 sm90", ..., "K3 mma_sync": bwd_design)
    and K4 ("K4 sm90", "K4 mma_sync": ops/fused_conv.py::conv_design),
    the launches inside CUDA graph replays included; reset sets them all
    to 0 first."""
    wrappers = kernel_wrappers()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts.update({f"{k} {design}": n for k in ("K1", "K2", "K3", "K4")
                   for design, n in wrappers[k].designs.items()})
    if reset:
        counts = dict.fromkeys(counts, 0)
        set_launch_counts(counts)
    return counts


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the launch counters that `counts` names (launch_counts' keys)."""
    wrappers = kernel_wrappers()
    for key, n in counts.items():
        kernel, _, design = key.partition(" ")
        if design:
            wrappers[kernel].designs[design] = n
        else:
            wrappers[kernel].launches = n


# ------------------------------------------------------------- trees ----

def flatten(obj) -> Tuple[List[torch.Tensor], Any]:
    """(the tensors of obj in a fixed order, its structure with every
    tensor replaced by its slot): dataclasses, dicts, lists and tuples are
    walked, anything else is a plain value kept in the structure."""
    tensors: List[torch.Tensor] = []
    return tensors, _walk(obj, tensors)


def _walk(x, tensors: List[torch.Tensor]):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep `tensors` alive until the
    # interpreter's cyclic collector ran, and device memory with them
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("T", len(tensors) - 1)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("D", type(x), tuple(
            (f.name, _walk(getattr(x, f.name), tensors))
            for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return ("M", tuple((k, _walk(v, tensors)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return ("L" if isinstance(x, list) else "U",
                tuple(_walk(v, tensors) for v in x))
    return ("V", x)


def unflatten(tree, tensors: List[torch.Tensor]):
    """The inverse of flatten, with `tensors` in the slots."""
    kind = tree[0]
    if kind == "T":
        return tensors[tree[1]]
    if kind == "D":
        return tree[1](**{n: unflatten(t, tensors) for n, t in tree[2]})
    if kind == "M":
        return {k: unflatten(t, tensors) for k, t in tree[1]}
    if kind in ("L", "U"):
        items = [unflatten(t, tensors) for t in tree[1]]
        return items if kind == "L" else tuple(items)
    return tree[1]


def signature(tensors: List[torch.Tensor], tree) -> tuple:
    return (tree, tuple((tuple(t.shape), t.dtype, t.device)
                        for t in tensors))


def _where(err: BaseException) -> str:
    """The innermost frame outside torch and this module in the first
    exception of err's chain that has one: the op where the capture
    broke."""
    torch_dir = Path(torch.__file__).resolve().parent
    chain, seen = [], err
    while seen is not None and seen not in chain:
        chain.append(seen)
        seen = seen.__cause__ or seen.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if not Path(f.filename).resolve().is_relative_to(torch_dir)
                  and Path(f.filename).resolve() != Path(__file__).resolve()]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"
    return "an op inside torch"


# ------------------------------------------------------------ graphs ----

@dataclasses.dataclass
class Capture:
    """One captured signature: the graph, its static args and outputs, its
    launches (launch_counts' keys), the capture's host seconds and the
    bytes its private memory pool reserved."""
    graph: torch.cuda.CUDAGraph
    static_args: List[torch.Tensor]
    out_tensors: List[torch.Tensor]
    out_tree: Any
    launches: Dict[str, int]
    capture_s: float
    pool_bytes: int
    replays: int = 0


class Graphed:
    """fn captured once per signature on the card and replayed per call;
    fn itself on the CPU or with enabled=False (see the module's
    docstring). log(message) is told of every capture after the first."""

    def __init__(self, fn: Callable, name: str, enabled: bool = True,
                 log: Optional[Callable[[str], None]] = None):
        self.fn = fn
        self.name = name
        self.enabled = enabled
        self.log = log
        self.captures: Dict[tuple, Capture] = {}
        self._warm = set()

    def __call__(self, *args):
        tensors, tree = flatten(args)
        if (not self.enabled or not tensors
                or any(t.device.type != "cuda" for t in tensors)):
            return self.fn(*args)
        key = signature(tensors, tree)
        cap = self.captures.get(key)
        if cap is None:
            if key not in self._warm:
                self._warm.add(key)
                with span("graph.warmup", self.name):
                    return self._warm_up(tensors, tree)
            if self.captures and self.log is not None:
                shapes = ", ".join(str(tuple(t.shape)) for t in tensors[:2])
                self.log(f"{self.name}: capturing an additional CUDA graph "
                         f"for inputs {shapes} (a ragged or new shape)")
            with span("graph.capture", self.name):
                cap = self.captures[key] = self._capture(tensors, tree)
        with span("graph.replay", self.name):
            for static, t in zip(cap.static_args, tensors):
                static.copy_(t)
            self.replay(cap)
            return unflatten(cap.out_tree,
                             [t.clone() for t in cap.out_tensors])

    def replay(self, cap: Capture) -> None:
        """Replay a capture and count its launches."""
        try:
            cap.graph.replay()
        except Exception as e:
            raise CaptureError(f"{self.name}: CUDA graph replay failed: "
                               f"{e}") from e
        cap.replays += 1
        now = launch_counts()
        set_launch_counts({k: now[k] + n for k, n in cap.launches.items()})

    def _warm_up(self, tensors, tree):
        """fn eagerly on a side stream, as PyTorch's capture recipe warms
        up, ordered after and before the ambient stream's work."""
        ambient = torch.cuda.current_stream(tensors[0].device)
        side = torch.cuda.Stream(tensors[0].device)
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            result = self.fn(*unflatten(tree, tensors))
        ambient.wait_stream(side)
        for t in flatten(result)[0]:
            # made on the side stream, used on the ambient one
            t.record_stream(ambient)
        return result

    def _capture(self, tensors, tree) -> Capture:
        device = tensors[0].device
        static = [t.detach().clone() for t in tensors]
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # torch.cuda.graph empties the allocator's cache on entry: empty it
        # first, so that the growth of reserved memory is the graph's pool
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.fn(*unflatten(tree, static))
        except Exception as e:
            raise CaptureError(f"{self.name}: CUDA graph capture failed at "
                               f"{_where(e)}: {e}") from e
        finally:
            # the capture launched nothing: take its counts back
            after = launch_counts()
            set_launch_counts(before)
        capture_s = time.perf_counter() - t0
        out_tensors, out_tree = flatten(out)
        return Capture(graph, static, out_tensors, out_tree,
                       {k: after[k] - before[k] for k in before
                        if after[k] != before[k]}, capture_s,
                       torch.cuda.memory_reserved(device) - reserved)
