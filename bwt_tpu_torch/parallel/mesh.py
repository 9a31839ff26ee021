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
* **tp** — the index's sequence tables (``bwt_words``, ``buckets``,
  ``sa_samples``, ``isa_samples``) cut into contiguous blocks, one a tp
  coordinate (``shard_index``, ``bwt_tpu``'s padded layout), for an index
  larger than one card; C and endloc stay whole.  A ``tp_view`` of the
  blocks serves every query: the plain versions (the CPU) gather from the
  local block and all-reduce over 'tp' (``ops/rank.take_fill``), as
  ``bwt_tpu`` psums; the kernels (a card) stay one launch each and read
  the row they need from whichever rank's block holds it, through a
  device table of the blocks' pointers (``parallel/peer.py`` maps the
  peers' blocks).  Reads split along 'dp' only: the ranks of a tp group
  run the same lanes, so the plain reads issue the same all-reduces on
  every rank.  The sharded suffix sort runs along 'tp' too
  (``parallel/suffix_dist.py``).

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

from bwt_tpu_torch.index import FMIndex, Shard
from bwt_tpu_torch.ops import search

STAGED_BYTES = 0  # bytes the collectives copied between host and device
MERGE_S = 0.0  # host seconds spent in the drivers' merges (merging())


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


# --------------------------------------------------------------------------
# tp: the sequence-sharded index
# --------------------------------------------------------------------------

_TABLES = ("bwt_words", "buckets", "sa_samples", "isa_samples")
_KERNEL_TABLES = ("buckets", "sa_samples", "isa_samples")  # read by kernels


def _index_specs(sharded: bool, has_isa: bool = True) -> dict:
    """The placement of each index field: "tp" (cut into sequence blocks
    over 'tp') or "replicated"."""
    spec = {f: ("tp" if sharded else "replicated") for f in _TABLES}
    spec.update(C="replicated", endloc="replicated")
    if not has_isa:
        del spec["isa_samples"]
    return spec


def fmi_spec_tree(fmi: FMIndex) -> dict:
    """Each field's placement, as ``bwt_tpu``'s PartitionSpec tree gives
    it: the sequence tables "tp" for a tp view, every field "replicated"
    otherwise (``isa_samples`` only where the index has it)."""
    return _index_specs(fmi.tp_axis is not None, fmi.isa_samples is not None)


def block_rows(n: int, tp: int) -> int:
    """The rows each block of an ``n``-row table holds: the table padded
    with zero rows to a multiple of ``tp``, then cut in ``tp``."""
    return (n + (-n) % tp) // tp


def _block(x: torch.Tensor, per: int, coord: int) -> torch.Tensor:
    """Rows ``[coord per, (coord + 1) per)`` of ``x`` padded with zero rows."""
    part = x[coord * per:(coord + 1) * per]
    pad = per - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_zeros((pad,) + tuple(x.shape[1:]))])
    return part


def shard_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """This rank's part of ``fmi`` cut along the sequence over 'tp'
    (``bwt_tpu.parallel.shard_index``'s layout: each sequence table
    zero-padded to a multiple of tp, block ``coords['tp']`` of it here; C
    and endloc whole), on the rank's device, from an index on the host or
    a card.  Only this rank's blocks are put on its device.  On a card
    each block the kernels read is an allocation of its own, and the
    ranks of the tp group exchange and open each other's blocks
    (``parallel.peer``), so the view's device tables hold every block's
    pointer; every rank of the group must call it.  Query the result
    through :func:`tp_view`; :func:`release_view` is its teardown."""
    tp, coord, dev = mesh.shape["tp"], mesh.coords["tp"], mesh.device
    fields, blocks, pers = _cut(fmi, tp, coord, dev)
    tables = peers = None
    if dev.type == "cuda":
        from bwt_tpu_torch.parallel import peer

        ptrs, peers = peer.exchange(blocks, coord, tp, mesh.groups["tp"], dev)
        tables = {f: torch.tensor(p, dtype=torch.int64, device=dev)
                  for f, p in ptrs.items()}
    shard = Shard(coord=coord, size=tp, word_per=pers["bwt_words"],
                  bucket_per=pers["buckets"], sample_per=pers["sa_samples"],
                  mesh=mesh, tables=tables, peers=peers)
    return dataclasses.replace(fmi, **fields, shard=shard)


def _cut(fmi: FMIndex, tp: int, coord: int, dev: torch.device):
    """Block ``coord`` of each sequence table on ``dev`` (on a card, each
    table the kernels read an allocation of its own, ``parallel.peer``)
    and the whole C and endloc: (fields, {table: its peer.Block}, {table:
    rows a block})."""
    fmi.require_whole("shard_index")
    spec = _index_specs(True, fmi.isa_samples is not None)
    pers = {f: block_rows(getattr(fmi, f).shape[0], tp)
            for f, where in spec.items() if where == "tp"}
    fields, blocks = {}, {}
    for f, where in spec.items():
        x = getattr(fmi, f)
        if where != "tp":
            fields[f] = x.to(dev)
            continue
        part = _block(x, pers[f], coord).contiguous()
        if dev.type == "cuda" and f in _KERNEL_TABLES:
            from bwt_tpu_torch.parallel import peer

            blocks[f], fields[f] = peer.alloc(part, dev)
        else:
            fields[f] = part.to(dev)
    return fields, blocks, pers


def view_in_process(fmi: FMIndex, tp: int, coord: int = 0) -> FMIndex:
    """A tp view of ``fmi`` (on a card) whose ``tp`` blocks are all made in
    this process, each an allocation of its own: block ``coord`` is the
    view's, and its device tables point at every block.  The kernels'
    tp form reads it as it reads a view of a group's blocks, without IPC
    (how the card tests and ``chip_smoke.py`` hold that form to the
    replicated kernels); its plain reads need ``tp`` 1.
    :func:`release_view` frees the blocks."""
    from bwt_tpu_torch.parallel import peer

    dev = fmi.device
    if dev.type != "cuda":
        raise ValueError("view_in_process builds the kernels' tables on a "
                         "card")
    cuts = [_cut(fmi, tp, j, dev) for j in range(tp)]
    fields, _, pers = cuts[coord]
    tables = {f: torch.tensor([c[1][f].ptr for c in cuts], dtype=torch.int64,
                              device=dev) for f in cuts[0][1]}
    own = [b for c in cuts for b in c[1].values()]
    shard = Shard(coord=coord, size=tp, word_per=pers["bwt_words"],
                  bucket_per=pers["buckets"], sample_per=pers["sa_samples"],
                  tables=tables, peers=peer.Peers(own=own, opened=[],
                                                  device=dev))
    return dataclasses.replace(fmi, **fields, shard=shard, tp_axis="tp")


def tp_view(fmi_local: FMIndex, tp_axis: str = "tp") -> FMIndex:
    """Mark a :func:`shard_index` result as a tp view (``FMIndex.tp_axis``,
    as ``bwt_tpu``'s marks one): every query then reads through the tp
    forms.  Checks that the blocks hold the shard's rows."""
    sh = fmi_local.shard
    if sh is None:
        raise ValueError("tp_view marks a shard_index result; this index is "
                         "whole")
    if tp_axis != "tp":
        raise ValueError(f"tp_axis {tp_axis!r}: the mesh's tp axis is 'tp'")
    want = dict(bwt_words=sh.word_per, buckets=sh.bucket_per,
                sa_samples=sh.sample_per, isa_samples=sh.sample_per)
    for f, per in want.items():
        x = getattr(fmi_local, f)
        if x is not None and x.shape[0] != per:
            raise ValueError(f"{f}: a block of {x.shape[0]} rows where the "
                             f"shard holds {per}")
    for f, per in (("buckets", fmi_local.bucket_rows),
                   ("sa_samples", fmi_local.sample_rows)):
        if block_rows(per, sh.size) != want[f]:
            raise ValueError(f"{f}: blocks of {want[f]} rows for a table of "
                             f"{per} over tp={sh.size}")
    return dataclasses.replace(fmi_local, tp_axis=tp_axis)


def _as_view(fmi: FMIndex) -> FMIndex:
    """A shard_index result marked (the search steps take either)."""
    if fmi.shard is not None and fmi.tp_axis is None:
        return tp_view(fmi)
    return fmi


def release_view(fmi: FMIndex) -> None:
    """The teardown of a tp view on the card (every rank of the group
    calls it): each rank closes its mappings of the peers' blocks, the
    group meets, then each frees its own (``parallel.peer.Peers.close``).
    The view must not be queried after.  A no-op for a whole index and
    for a view on the CPU."""
    if fmi.shard is not None and fmi.shard.peers is not None:
        fmi.shard.peers.close()


def serving_index(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """The index a driver serves from on this rank: for a dp mesh the
    whole index on the rank's device (:func:`replicate_index`); for tp > 1
    ``fmi`` itself where it is a view of this mesh's shard, else
    ``tp_view(shard_index(fmi, mesh))``, which the driver releases when it
    is done (:func:`done_serving`)."""
    if mesh.shape["tp"] == 1:
        if fmi.shard is not None:
            raise ValueError("a tp view served over a mesh with tp=1")
        return replicate_index(fmi, mesh)
    if fmi.shard is None:
        return tp_view(shard_index(fmi, mesh))
    return _mesh_view(fmi, mesh)


def _mesh_view(fmi: FMIndex, mesh: Mesh) -> FMIndex:
    """``fmi``, a shard_index result or its view, marked, and checked to
    hold this rank's block of ``mesh``'s tp group."""
    fmi = _as_view(fmi)
    if fmi.shard is None or (fmi.shard.size, fmi.shard.coord) != (
            mesh.shape["tp"], mesh.coords["tp"]):
        raise ValueError(
            "the index is not a tp view of this rank's block of the mesh "
            f"(tp={mesh.shape['tp']}, tp coordinate {mesh.coords['tp']})")
    return fmi


def done_serving(served: FMIndex, given: FMIndex) -> None:
    """Release ``served`` if :func:`serving_index` made it from the whole
    index ``given``."""
    if given.shard is None and served.shard is not None:
        release_view(served)


def _locate_step(fmi: FMIndex, patterns, lengths):
    """Backward search (one K3 launch on a card), the SA walk of every
    interval start (one K4 launch), -1 where the interval emptied before
    the final character, and the match counts."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=fmi.device)
    r = search.backward_search(fmi, patterns, lengths)
    pos = search.unc_sa(fmi, r["start"])
    pos = torch.where(search._emptied_early(r, lengths), -1, pos)
    counts = torch.where(r["alive"], r["end"] - r["start"], 0)
    return pos, counts


def tp_locate(fmi_sharded: FMIndex, patterns, lengths, mesh: Mesh):
    """Locate (backward search, then the SA walk, seqindex.c:228-277) of
    this rank's dp share of a batch (:func:`shard_patterns`) over a
    tp-sharded index (a :func:`shard_index` result or its view): K3 then
    K4 over the view on a card, the plain versions with their all-reduces
    over 'tp' on the CPU.  Returns this rank's shards of (positions,
    counts), which :func:`gather_hits` joins; equal to the single-device
    ``search.locate`` and ``search.count_matches``."""
    return _locate_step(_mesh_view(fmi_sharded, mesh), patterns, lengths)


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
    """One search step on this rank's dp share, over a replicated index or
    a tp-sharded one (a :func:`shard_index` result or its view): the
    backward search (one K3 launch on a card), the SA walk of every
    interval start (one K4 launch), -1 where the interval emptied before
    the final character, the match counts, and ``total``, the matched
    reads of the whole batch (an all-reduce along 'dp' only: the ranks of
    a tp group hold the same lanes).  Returns ``(positions, counts,
    total)``: the rank's (B/dp,) shards, where ``bwt_tpu`` returns global
    arrays (:func:`gather_hits` joins them), and a 0-d tensor."""
    pos, counts = _locate_step(_as_view(fmi), patterns, lengths)
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
