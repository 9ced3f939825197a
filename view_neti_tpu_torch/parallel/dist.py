"""The rank layout over torch.distributed: the port's counterpart of the dp
and tp axes of view_neti_tpu/parallel/mesh.py.

The JAX package shards the fused batch's leading axis over a device mesh
and lets XLA reduce the gradients. The port runs one process per rank, in
a dp x tp layout: rank r sits at dp index r // tp and tp index r % tp
(mesh.py's reshape(n_dp, n_tp)); the tp group is tp consecutive ranks,
the dp group the ranks of one tp index. The ranks of a tp group hold the
same rows and compute them together (parallel/tensor.py splits the frozen
UNet's and CLIP's projections over them under parallel.tensor_parallel;
without it they are replicas), so everything below that concerns rows is
cut by the dp index:

  * every rank holds the frozen stack and the mappers (replicated), runs
    the same loader from the same seed and draws the whole fused batch's
    random numbers from the same generator seed, then keeps its own
    contiguous rows of both (shard_rows, shard_object_idx, shard_draws),
    so that each row gets the numbers the one-process run gives it;
  * after the backward, one all-reduce over one flat fp32 buffer averages
    the mappers' gradients and the step's loss over the dp group
    (all_reduce_step_), so every rank steps the same optimizer on the same
    gradients. Its sum runs in
    rank order on every rank (all_reduce_mean_): a requirement, so that
    a run's mappers do not depend on the backend or on the cards;
  * mode 3's object_idx (G,) is per group, not per row (mesh.py replicates
    it): a rank's rows may hold part of a group or straddle two, and
    shard_object_idx regroups them so that each row keeps its group's
    object mapper;
  * validation sweeps split their cameras over the dp groups (split_items)
    and bring the uint8 images to rank 0 (gather_to_main), which scores and
    writes them; only rank 0 writes files.

The launch (init_distributed) comes from torchrun's RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT; or from the JAX
package's VIEW_NETI_COORDINATOR (host:port), VIEW_NETI_NUM_PROCESSES and
VIEW_NETI_PROCESS_ID (mesh.py:25-50: one process a host, unless
LOCAL_RANK and LOCAL_WORLD_SIZE say how many share it); or from an explicit
store (a FileStore: the tests, chip_smoke.py). The backend follows the layout of
the ranks: nccl when each rank of a host has a card of its own, gloo when
they share a card (NCCL refuses two ranks on one device) or run on the
CPU. gloo moves host memory, so on that path the gradient buffer goes
through a host copy.

Nothing falls back: a process group that does not form raises, a
collective that fails raises CollectiveError on its rank (the process
group's timeout ends the ranks that wait on a dead one), and the backend is
never switched after a failure.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from view_neti_tpu_torch.utils.device import resolve_device

TIMEOUT_S = 900   # a rank that waits longer on a collective ends the run


class CollectiveError(RuntimeError):
    """A collective failed on this rank: the run cannot go on."""


@dataclass
class DataParallel:
    """The rank's place in a run. backend None: one process and no process
    group, and every helper below is then the identity. tp_world is the
    size of a tp group (1 until with_layout sets the run's), tp_group and
    dp_group the rank's two subgroups (None: the world's group), and
    tensor_parallel whether the frozen stack is split over the tp group
    (parallel/tensor.py) rather than replicated on it."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    shared_card: bool = False
    timeout_s: float = TIMEOUT_S
    tp_world: int = 1
    tensor_parallel: bool = False
    tp_group: Any = None
    dp_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def active(self) -> bool:
        return self.backend is not None

    @property
    def dp_world(self) -> int:
        return self.world // self.tp_world

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp_world

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp_world

    @property
    def sharded(self) -> bool:
        """The frozen stack is split over a tp group of several ranks."""
        return self.active and self.tensor_parallel and self.tp_world > 1


def _launch(store, rank, world_size):
    """(init_process_group's arguments, rank, world, local rank, local
    world) of the launch, or None for one process."""
    env = os.environ
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("init_distributed: a store needs rank and "
                             "world_size")
        return (dict(store=store, rank=rank, world_size=world_size), rank,
                world_size, rank, world_size)
    if "RANK" in env and "WORLD_SIZE" in env:           # torchrun
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        return (dict(init_method="env://", rank=rank, world_size=world),
                rank, world, int(env.get("LOCAL_RANK", rank)),
                int(env.get("LOCAL_WORLD_SIZE", world)))
    world = int(env.get("VIEW_NETI_NUM_PROCESSES", "1"))
    if world <= 1:
        return None
    coordinator = env.get("VIEW_NETI_COORDINATOR")
    if not coordinator or "VIEW_NETI_PROCESS_ID" not in env:
        raise ValueError("VIEW_NETI_NUM_PROCESSES > 1 needs "
                         "VIEW_NETI_COORDINATOR (host:port) and "
                         "VIEW_NETI_PROCESS_ID")
    rank = int(env["VIEW_NETI_PROCESS_ID"])
    # the JAX launch runs one process a host; LOCAL_* name a host's share
    local_rank = int(env.get("LOCAL_RANK", "0"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", "1"))
    if not 0 <= local_rank < local_world:
        raise ValueError(f"LOCAL_RANK={local_rank} outside "
                         f"LOCAL_WORLD_SIZE={local_world}")
    return (dict(init_method=f"tcp://{coordinator}", rank=rank,
                 world_size=world), rank, world, local_rank, local_world)


def init_distributed(device=None, store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> DataParallel:
    """Join the run's process group, or return the one-process record when
    nothing launched several ranks (no torchrun or VIEW_NETI_* variables,
    no store). device None is the card (the rank's own, or cuda:0 when the
    host's ranks share it); "cpu" runs the ranks on the CPU over gloo. A
    store (with rank and world_size, the ranks on one host) takes the
    place of the environment.
    """
    launch = _launch(store, rank, world_size)
    if launch is None:
        return DataParallel(device=resolve_device(device))
    init, rank, world, local_rank, local_world = launch
    shared = False
    if device is None or torch.device(device).type == "cuda":
        shared = local_world > torch.cuda.device_count()
        dev = resolve_device(None, local_rank, shared)
    else:
        dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    tdist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **init)
    return DataParallel(rank=rank, world=world, local_rank=local_rank,
                        device=dev, backend=backend, shared_card=shared,
                        timeout_s=timeout_s)


def destroy(dp: DataParallel) -> None:
    """Leave the process group at the end of a run."""
    if dp.active and tdist.is_initialized():
        tdist.destroy_process_group()


def resolve(parallel, micro_batch_size: int, world: int) -> int:
    """The dp degree of a run of `world` ranks whose fused batch is
    micro_batch_size rows: the counterpart of the JAX Coach's mesh setup
    (view_neti_tpu/training/coach.py:194-218).

    use_mesh false with several ranks, a tp that does not divide the world
    size, an explicit dp other than world / tp, and a batch that dp does
    not divide raise ValueError. dp 0 is world / tp. One deviation is
    deliberate: where the JAX auto mode shrinks dp to the largest device
    count that divides the batch (coach.py:206-211), the port raises,
    since a launched rank cannot sit idle as an unused TPU core does
    (ROADMAP §5). One process is dp 1 whatever the config says, as a
    single device is in the JAX Coach."""
    if world <= 1:
        return 1
    if parallel.use_mesh is False:
        raise ValueError(
            f"parallel.use_mesh is false but {world} ranks were launched: "
            "launch one process, or set parallel.use_mesh true or null")
    tp = parallel.tp
    if tp < 1 or world % tp:
        raise ValueError(
            f"parallel.tp={tp} does not divide the world size {world}: "
            "launch a multiple of tp ranks")
    dp = parallel.dp or world // tp
    if dp != world // tp:
        raise ValueError(
            f"parallel.dp={parallel.dp} but {world} ranks were launched at "
            f"tp={tp}: dp must be the world size / tp ({world // tp}), or "
            "0 for it")
    if micro_batch_size % dp:
        divisors = [d for d in range(1, micro_batch_size + 1)
                    if micro_batch_size % d == 0]
        raise ValueError(
            f"effective batch {micro_batch_size} not divisible by dp={dp}; "
            "adjust optim.train_batch_size/gradient_accumulation_steps or "
            f"parallel.dp (the dp degrees that divide it: {divisors})")
    return dp


def with_layout(dp: DataParallel, tp: int,
                tensor_parallel: bool) -> DataParallel:
    """The rank's record in a dp x tp layout (resolve has checked it): its
    tp group (tp consecutive ranks) and its dp group (the ranks of its tp
    index), made with torch.distributed.new_group, which every rank calls
    for every group in the same order. tensor_parallel with tp 1 splits
    nothing (mesh.py:139-140); tp > 1 without it makes the tp ranks
    replicas that compute the same rows. One process, and tp 1, keep the
    record as it is."""
    if not dp.active or tp == 1:
        return dataclasses.replace(dp, tp_world=1, tensor_parallel=False,
                                   tp_group=None, dp_group=None)
    timeout = datetime.timedelta(seconds=dp.timeout_s)
    n_dp = dp.world // tp
    tp_group = dp_group = None
    for g in range(n_dp):
        group = _collective(tdist.new_group, list(range(g * tp, (g + 1) * tp)),
                            timeout=timeout)
        if g == dp.rank // tp:
            tp_group = group
    for t in range(tp):
        group = _collective(tdist.new_group, list(range(t, dp.world, tp)),
                            timeout=timeout)
        if t == dp.rank % tp:
            dp_group = group
    return dataclasses.replace(dp, tp_world=tp,
                               tensor_parallel=bool(tensor_parallel),
                               tp_group=tp_group, dp_group=dp_group)


# ----------------------------------------------------------- the rows ----

def rows(dp: DataParallel, batch_size: int) -> Tuple[int, int]:
    """The rank's contiguous rows [lo, hi) of a batch of batch_size rows:
    its dp group's (resolve has checked that dp divides the batch)."""
    n = batch_size // dp.dp_world
    return dp.dp_index * n, (dp.dp_index + 1) * n


def shard_rows(x, dp: DataParallel):
    """The rank's rows of x along its leading axis (a tensor or an
    array)."""
    lo, hi = rows(dp, len(x))
    return x[lo:hi]


def local_groups(lo: int, hi: int, group_size: int
                 ) -> List[Tuple[int, int, int]]:
    """The equal groups of rows [lo, hi) of a batch in groups of
    group_size, as (global group, first position in it, rows): the runs
    of the range inside each global group when they are of one length,
    else one group per row."""
    runs, r = [], lo
    while r < hi:
        g, j = divmod(r, group_size)
        n = min(hi - r, group_size - j)
        runs.append((g, j, n))
        r += n
    if len({n for _, _, n in runs}) > 1:
        runs = [(r // group_size, r % group_size, 1) for r in range(lo, hi)]
    return runs


def shard_object_idx(object_idx, dp: DataParallel, batch_size: int):
    """The rank's object_idx: an int stays; mode 3's (G,) group indices
    (groups of batch_size / G contiguous rows) become those of the rank's
    local groups (local_groups), which text_forward reads as equal
    groups, so that every row keeps its group's object mapper."""
    idx = np.asarray(object_idx)
    if idx.ndim == 0 or not dp.active:
        return object_idx
    lo, hi = rows(dp, batch_size)
    group_size = batch_size // len(idx)
    return np.asarray([idx[g] for g, _, _ in
                       local_groups(lo, hi, group_size)], idx.dtype)


def shard_draws(draws, dp: DataParallel, batch_size: int,
                group_size: Optional[int] = None):
    """The rank's part of the whole batch's StepDraws
    (training/train_step.py): its rows of every per-row draw, and of the
    nested-dropout draws, which are layer-major (K, B) flattened, or for
    mode 3's grouped object mapper (group_size) group-major (G, K,
    group_size), regrouped as shard_object_idx groups the rows."""
    if not dp.active:
        return draws
    lo, hi = rows(dp, batch_size)

    def per_row(x):
        return x[lo:hi]

    def layer_major(x):
        return x.reshape(-1, batch_size)[:, lo:hi].reshape(-1)

    def grouped(x):
        x = x.reshape(batch_size // group_size, -1, group_size)
        return torch.cat([x[g, :, j:j + n].reshape(-1)
                          for g, j, n in local_groups(lo, hi, group_size)])

    dropout = None
    if draws.dropout:
        dropout = {key: tuple((grouped if key == "object" and group_size
                               else layer_major)(t) for t in d)
                   for key, d in draws.dropout.items()}
    augment = draws.augment
    if augment is not None:
        augment = dataclasses.replace(augment, **{
            f.name: per_row(getattr(augment, f.name))
            for f in dataclasses.fields(augment)})
    return dataclasses.replace(
        draws, vae_eps=per_row(draws.vae_eps), noise=per_row(draws.noise),
        timesteps=per_row(draws.timesteps), dropout=dropout,
        augment=augment)


def split_items(items: Sequence, rank: int, world: int) -> list:
    """Share `rank` of `world` contiguous shares of items (a sweep's share
    of dp group `rank`), the first len % world shares one more."""
    items = list(items)
    base, extra = divmod(len(items), world)
    start = rank * base + min(rank, extra)
    return items[start:start + base + (rank < extra)]


# ------------------------------------------------------- collectives ----

def _collective(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:   # re-raised: the run cannot go on
        raise CollectiveError(f"{fn.__name__} failed: {e}") from e


def all_reduce_mean_(dp: DataParallel,
                     tensors: Sequence[torch.Tensor]) -> None:
    """Average tensors over the dp group in place through one flat fp32
    buffer: every rank gathers every dp rank's buffer (one all-gather) and
    adds them in dp order, then divides by the dp degree on the buffer's
    device. The ranks of a tp group hold the same tensors, so every rank
    ends with the same bits.

    The order is a requirement, not a detail: a run's mappers must not
    depend on the backend or on the cards, so that gloo on one card, NCCL
    across cards and one process that adds the ranks' gradients in rank
    order give the same bits. A ring or tree all-reduce adds in an order
    that depends on the backend, the segment and the cards, and in bf16
    training a difference of one rounding grows step by step (Adam's first
    steps take the sign of each gradient). The price is dp x the buffer's
    bytes on every rank. gloo on tensors on the card: the buffer goes
    through a host copy, which waits for the work that produced it."""
    if not dp.active or dp.dp_world == 1:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    send = flat.cpu() if dp.backend == "gloo" and flat.is_cuda else flat
    parts = [torch.empty_like(send) for _ in range(dp.dp_world)]
    _collective(tdist.all_gather, parts, send, group=dp.dp_group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    flat.copy_(total)
    flat.div_(dp.dp_world)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_step_(dp: DataParallel, optimizer, loss: torch.Tensor
                     ) -> torch.Tensor:
    """A train step's one collective over the dp group: the mean over the
    dp ranks of every trainable parameter's gradient (zeros where a rank has none, so that
    every rank sends the same tensors in the same order:
    SlicedAdamW.gradients) and of the step's loss, which it returns."""
    mean = loss.detach().float().reshape(1).clone()
    all_reduce_mean_(dp, optimizer.gradients() + [mean])
    return mean[0]


def gather_to_main(dp: DataParallel, obj: Any) -> Optional[list]:
    """Every rank's obj, in rank order, on rank 0; None on the others."""
    if not dp.active:
        return [obj]
    out = [None] * dp.world if dp.is_main else None
    _collective(tdist.gather_object, obj, out, dst=0)
    return out


def broadcast_from_main(dp: DataParallel, obj: Any = None) -> Any:
    """Rank 0's obj on every rank."""
    if not dp.active:
        return obj
    box = [obj]
    _collective(tdist.broadcast_object_list, box, src=0)
    return box[0]


def barrier(dp: DataParallel) -> None:
    """Wait for every rank (after rank 0 writes what the others read)."""
    if dp.active:
        _collective(tdist.barrier)
