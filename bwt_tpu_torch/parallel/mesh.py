"""Data-parallel serving over ``torch.distributed``: one process a device.

The counterpart of ``bwt_tpu.parallel.mesh``'s dp half.  JAX runs one
controller over every device of a ``jax.sharding.Mesh``; PyTorch's idiom
is one process a device, so here each rank is one process, holds one
device (``Mesh.device``) and runs the single-device kernels on its own
share of the batch, and the collectives along a mesh axis join the
ranks' results:

* **dp** — read batches split into contiguous shares, one a dp
  coordinate; the index is replicated into every rank's device.  The
  merge is an all-gather along 'dp' in batch order, so every rank ends
  with the full answer, equal to the single-device run's.
* **tp** — the axis the sharded suffix sort runs along
  (``parallel/suffix_dist.py``).  The tp-sharded index and its serving
  (``shard_index``, ``tp_view``, ``fmi_spec_tree``, ``tp_locate``, a
  driver over a mesh with tp > 1) are not ported yet and raise
  NotImplementedError.

The mesh lays ranks out as ``bwt_tpu.parallel.make_mesh`` lays out
devices: rank ``r`` sits at ``dp = r // tp``, ``tp = r % tp``.  Where JAX
returns a global array sharded over the mesh, the functions here return
the rank's local shard; ``gather_hits`` and ``host_fetch`` give every
rank the whole value as numpy, as ``bwt_tpu``'s do for every process.

Only the collective helpers (``_all_gather``, ``_all_reduce``,
``_ppermute``) know the backend.  NCCL takes tensors on the card; gloo
takes host memory, so a card tensor is copied through the host there
(the ranks' kernels still run on their cards).  Every copy between host
and device that a helper makes adds its bytes to ``STAGED_BYTES``.

On one machine: ``torchrun --nproc-per-node N script.py`` (rank and world
from the environment, one card a rank over NCCL), or ranks that share one
card over gloo with ``device="cuda:0"`` given to :func:`make_mesh`; on the
CPU, gloo with ``device="cpu"`` and a ``file://`` rendezvous
(``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.ops import search

STAGED_BYTES = 0  # bytes the collectives copied between host and device
MERGE_S = 0.0  # host seconds spent in the drivers' merges (merging())

TP_TODO = "ROADMAP Queue 1 item 7b"


def tp_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the tp-sharded index and its serving are not ported "
        f"({TP_TODO})")


def init_distributed(backend=None, init_method=None, world_size=None,
                     rank=None, timeout=None) -> None:
    """Join this process to the world (``dist.init_process_group``); a
    no-op when a group is already initialized.  ``backend`` defaults to
    'nccl' where the process sees a card and 'gloo' where it does not;
    ranks that share one card must name 'gloo'.  ``init_method`` defaults
    to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, as torchrun sets them).  ``timeout`` (seconds or a
    timedelta) bounds every collective, so a rank whose peer died fails
    instead of waiting.  Any failure of the init is raised."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    if timeout is not None:
        kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                         else datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend=backend, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (dp, tp) mesh of ranks.

    ``shape`` {"dp": .., "tp": ..}; ``coords`` this rank's coordinate on
    each axis; ``groups`` the process group of this rank's line along each
    axis and ``lines`` its global ranks in axis order; ``device`` the
    rank's device; ``backend`` the world's backend."""
    shape: dict
    coords: dict
    groups: dict
    lines: dict
    device: torch.device
    backend: str


def _rank_device(device) -> torch.device:
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(
                f"make_mesh: this rank's device {device} does not exist "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                f" card(s)); pass device='cpu' to run on the CPU")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def make_mesh(n_devices: int | None = None, *, tp: int = 1,
              device=None) -> Mesh:
    """The (dp, tp) mesh over the world's ranks, one device a rank:
    ``n_devices`` (default, and the only value accepted: the world size)
    ranks shaped (n // tp, tp).  ``device`` is this rank's device, by
    default ``cuda:{LOCAL_RANK}``; a card that does not exist raises (it
    never falls back to the CPU).  Every rank must call this, in the same
    order as its other group creations: it makes one process group a line
    of each axis."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n}: the mesh spans the world's "
                         f"{world} ranks, one device a rank")
    if tp < 1 or n % tp:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    backend = str(dist.get_backend())
    device = _rank_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend takes tensors on a card; use "
                         "gloo for a CPU mesh")
    dp, me = n // tp, dist.get_rank()
    lines = {"dp": [[d * tp + t for d in range(dp)] for t in range(tp)],
             "tp": [[d * tp + t for t in range(tp)] for d in range(dp)]}
    groups, mine = {}, {}
    for axis in ("dp", "tp"):  # every rank makes every group, in order
        for line in lines[axis]:
            g = dist.new_group(line)
            if me in line:
                groups[axis], mine[axis] = g, line
    return Mesh(shape={"dp": dp, "tp": tp},
                coords={"dp": me // tp, "tp": me % tp}, groups=groups,
                lines=mine, device=device, backend=backend)


def require_dp(mesh: Mesh, what: str) -> None:
    """Raise NotImplementedError for a mesh with tp > 1: the drivers serve
    a replicated index over dp only."""
    if mesh.shape["tp"] > 1:
        raise tp_not_ported(f"{what} over a mesh with tp="
                            f"{mesh.shape['tp']}")


# --------------------------------------------------------------------------
# the collectives along one axis; the only code that knows the backend
# --------------------------------------------------------------------------


def _move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; a copy between host and device counts."""
    global STAGED_BYTES
    device = torch.device(device)
    if t.device.type != device.type:
        STAGED_BYTES += t.numel() * t.element_size()
    return t.to(device).contiguous()


def _for_backend(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: the rank's card for NCCL, host
    memory for gloo."""
    return _move(t, mesh.device if mesh.backend == "nccl" else "cpu")


def _all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape along the line) along ``axis``,
    concatenated on dim 0 in axis order, on ``t``'s device."""
    x = _for_backend(mesh, t)
    out = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, x, group=mesh.groups[axis])
    return _move(torch.cat(out), t.device)


def _all_reduce(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``axis`` (``t`` unchanged)."""
    x = _for_backend(mesh, t)
    if x is t:
        x = t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return _move(x, t.device)


def _ppermute(mesh: Mesh, axis: str, t: torch.Tensor, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` along ``axis``: for each ``(src, dst)`` of
    ``perm`` (axis coordinates) rank ``dst`` receives rank ``src``'s
    ``t``; a rank that no pair sends to gets zeros.  Every rank of the
    line calls it with the same ``perm``."""
    me, line, g = mesh.coords[axis], mesh.lines[axis], mesh.groups[axis]
    x = _for_backend(mesh, t)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, line[dst], group=g))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, line[src], group=g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _move(out, t.device)


def _all_gather_ragged(mesh: Mesh, axis: str, t: torch.Tensor):
    """:func:`_all_gather` of tensors whose dim 0 differs by rank: the
    lengths first, then the rows padded to the longest.  Returns the
    concatenation and each rank's length."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = _all_gather(mesh, axis, n).tolist()
    top = max(sizes)
    pad = t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))
    rows = _all_gather(mesh, axis, torch.cat([t, pad]))
    return torch.cat([rows[k * top:k * top + s]
                      for k, s in enumerate(sizes)]), sizes


# --------------------------------------------------------------------------
# dp serving
# --------------------------------------------------------------------------


def share(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's contiguous share ``[lo, hi)`` of a batch of ``n`` along
    'dp': shares of ``ceil(n / dp)``, the last ones shorter or empty."""
    per = -(-n // mesh.shape["dp"])
    lo = min(mesh.coords["dp"] * per, n)
    return lo, min(lo + per, n)


@contextlib.contextmanager
def merging():
    """A driver's merge (packing, collectives, unpacking, the wait for the
    slowest rank): its host seconds go to ``MERGE_S``, and the cyclic
    garbage collector is paused for it, since a merge allocates many
    objects and no cycles."""
    global MERGE_S
    was_enabled = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        MERGE_S += time.perf_counter() - t0
        if was_enabled:
            gc.enable()


def gather_batch(mesh: Mesh, local) -> np.ndarray:
    """Every rank's rows of its share (numpy, rows on dim 0), concatenated
    in dp order, which is batch order, on every rank."""
    local = torch.from_numpy(np.array(local, copy=True, order="C"))
    return _all_gather_ragged(mesh, "dp", local)[0].numpy()


def replicate_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """The index on this rank's device (every rank holds a whole copy)."""
    return fmi.to(mesh.device)


def shard_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """Not ported: the tp-sharded index (ROADMAP Queue 1 item 7b)."""
    raise tp_not_ported("shard_index")


def tp_view(fmi_local: FMIndex, tp_axis: str = "tp") -> FMIndex:
    """Not ported: the tp-sharded index (ROADMAP Queue 1 item 7b)."""
    raise tp_not_ported("tp_view")


def fmi_spec_tree(fmi: FMIndex):
    """Not ported: the tp-sharded index (ROADMAP Queue 1 item 7b)."""
    raise tp_not_ported("fmi_spec_tree")


def tp_locate(fmi_sharded: FMIndex, patterns, lengths, mesh: Mesh):
    """Not ported: the tp-sharded index (ROADMAP Queue 1 item 7b)."""
    raise tp_not_ported("tp_locate")


def shard_patterns(patterns, lengths, mesh: Mesh):
    """This rank's contiguous share of a read batch (numpy or tensors)
    along 'dp', as int32 tensors on its device (the batch must divide the
    dp size)."""
    patterns = torch.as_tensor(patterns, dtype=torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    B, dp = patterns.shape[0], mesh.shape["dp"]
    if B % dp:
        raise ValueError(f"a batch of {B} does not divide the dp size {dp}")
    lo, hi = share(B, mesh)
    return (patterns[lo:hi].to(mesh.device).contiguous(),
            lengths[lo:hi].to(mesh.device).contiguous())


def sharded_search_step(fmi: FMIndex, patterns, lengths, mesh: Mesh):
    """One data-parallel search step on this rank's share: the backward
    search (one K3 launch on a card), the SA walk of every interval
    start (one K4 launch), -1 where the interval emptied before the final
    character, the match counts, and ``total``, the matched reads of the
    whole batch (an all-reduce along 'dp').  Returns ``(positions,
    counts, total)``: the rank's (B/dp,) shards, where ``bwt_tpu``
    returns global arrays (:func:`gather_hits` joins them), and a 0-d
    tensor."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=fmi.device)
    r = search.backward_search(fmi, patterns, lengths)
    pos = search.unc_sa(fmi, r["start"])
    pos = torch.where(search._emptied_early(r, lengths), -1, pos)
    counts = torch.where(r["alive"], r["end"] - r["start"], 0)
    hits = (pos >= 0).sum(dtype=torch.int32).reshape(1)
    return pos, counts, _all_reduce(mesh, "dp", hits)[0]


def host_fetch(tensors, mesh: Mesh | None = None) -> list[np.ndarray]:
    """Each tensor as numpy: without a mesh, this rank's own; with one,
    every rank's dp shard all-gathered along 'dp' in batch order, so every
    rank holds the whole value."""
    if mesh is None:
        return [t.cpu().numpy() for t in tensors]
    with merging():
        return [_all_gather(mesh, "dp", t).cpu().numpy() for t in tensors]


def gather_hits(positions, mesh: Mesh | None = None) -> np.ndarray:
    """The dp shards of a hit list in the global batch order, on every
    rank (an all-gather along 'dp'); without a mesh, ``positions`` as
    numpy."""
    if mesh is None:
        return np.asarray(positions.cpu() if isinstance(
            positions, torch.Tensor) else positions)
    return host_fetch([positions], mesh)[0]
