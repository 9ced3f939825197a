"""The resumable train state of a run (the port's counterpart of
view_neti_tpu/checkpoint_orbax.py, which is TPU machinery and not ported).

One file per saved step, <exp_dir>/train_state/state-<step>.msgpack,
written through the port's msgpack codec (utils/msgpack_codec.py):

  {"step": the global step,
   "trainable": the mappers in the JAX tree layout (Coach.jax_trainable),
   "opt_state": {"adamw": AdamW's own state, one list per parameter group
                 (SlicedAdamW's slices, in order) of one entry per
                 parameter: {"exp_avg", "exp_avg_sq", "step"}, or {} for
                 a slice that never ran;
                 "counts": {key: [active steps of each slice]}},
   "obj_constants" / "view_constants": the mappers' frequency matrices}

The Coach writes one where the JAX Coach writes its orbax state (each
checkpoint save when log.checkpoint_backend is "orbax") and prunes them
with the checkpoints under log.checkpoints_total_limit. Nothing else needs
saving for an exact resume: the data stream and the step's draws depend
on the position alone (training/coach.py).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from view_neti_tpu_torch import weight_port
from view_neti_tpu_torch.utils import msgpack_codec

STATE_DIR = "train_state"


def state_path(exp_dir, step: int) -> Path:
    return Path(exp_dir) / STATE_DIR / f"state-{int(step)}.msgpack"


def latest_state(exp_dir) -> Path:
    """The newest state under <exp_dir>/train_state (by its step)."""
    root = Path(exp_dir) / STATE_DIR
    states = sorted(root.glob("state-*.msgpack"),
                    key=lambda p: int(p.stem.split("-")[1]))
    if not states:
        raise FileNotFoundError(f"no train states under {root}")
    return states[-1]


def _adamw_state(optimizer) -> List[List[Dict]]:
    """AdamW's per-parameter state, one list per parameter group; {} for a
    parameter whose slice never ran (step 0)."""
    def entry(p):
        state = optimizer.state.get(p)
        if not state or float(state["step"]) == 0:
            return {}
        return {"exp_avg": state["exp_avg"].detach().cpu().numpy(),
                "exp_avg_sq": state["exp_avg_sq"].detach().cpu().numpy(),
                "step": float(state["step"])}
    return [[entry(p) for p in group["params"]]
            for group in optimizer.param_groups]


def save(path: Path, coach) -> Path:
    """Write the Coach's train state at its global step to `path`."""
    trainable, obj_c, view_c = coach.jax_trainable()
    opt = coach.optimizer
    state = {"step": int(coach.global_step), "trainable": trainable,
             "opt_state": {
                 "adamw": _adamw_state(opt.optimizer),
                 "counts": {k: [int(c) for c in v]
                            for k, v in opt.counts.items()}},
             "obj_constants": obj_c, "view_constants": view_c}
    state = {k: v for k, v in state.items() if v is not None}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_codec.packb(state))
    return path


def load(path: Path) -> Dict:
    """The state tree of a file; raises where it holds no step."""
    state = msgpack_codec.unpackb(Path(path).read_bytes())
    if "step" not in state:
        raise RuntimeError(
            f"train state at {path} has no 'step' entry: it predates "
            "resume support; re-save a checkpoint with this version or "
            "restore the mapper msgpack manually")
    return state


def restore(coach, state: Dict) -> int:
    """Load a state tree into the Coach's mappers and optimizer; returns its
    global step."""
    text, opt = coach.built.text, coach.optimizer
    obj_c, view_c = state.get("obj_constants"), state.get("view_constants")
    sds = weight_port.from_jax_trainable(state["trainable"], obj_c, view_c)
    if "object" in sds:
        for mapper, sd in zip(text.obj_mappers, sds["object"]):
            mapper.load_state_dict(sd, strict=True)
    if "view" in sds:
        text.view_mapper.load_state_dict(sds["view"], strict=True)

    opt_state = state["opt_state"]
    counts = {k: [int(c) for c in v] for k, v in opt_state["counts"].items()}
    if set(counts) != set(opt.counts):
        raise ValueError(f"train state optimizes {sorted(counts)}, the run "
                         f"{sorted(opt.counts)}")
    opt.load_state(opt_state["adamw"], counts)
    return int(np.asarray(state["step"]))


def resolve(exp_dir, resume_from: Optional[str]) -> Optional[Path]:
    """The state file that log.resume_from names: a path, or "latest" for
    the newest under <exp_dir>/train_state."""
    if not resume_from:
        return None
    if str(resume_from) == "latest":
        return latest_state(exp_dir)
    return Path(resume_from)
