"""bwt_tpu_torch.parallel held to bwt_tpu on the CPU, tolerance 0.

Two worlds of four gloo ranks (``torch.multiprocessing`` spawn, a
``file://`` rendezvous under ``tmp_path``, every collective under a
timeout) run the port's multi-device paths once each; every rank writes
what it got to ``tmp_path`` and the tests compare each rank's outputs here
with ``bwt_tpu``'s:

* world "dp" (a dp = 4 mesh): ``sharded_search_step`` + ``gather_hits``
  and ``total``, against ``bwt_tpu.parallel.sharded_search_step`` on a
  dp = 4 mesh of the 8 virtual devices and against ``search.locate``;
  ``align_reads``, ``rna_seq`` and ``search_reads`` with ``mesh=`` against
  ``bwt_tpu``'s single-device device engine (``tests/test_parallel.py``
  holds that equal to ``bwt_tpu``'s mesh path), on test_parallel.py's
  inputs: 100 reads of 80 bp with N's, 77 reads of 60 bp (shares of 20,
  20, 20, 17) and three reads (fewer than ranks); ``anchor_scan_mesh``
  against ``bwt_tpu``'s on a dp = 4 mesh; the refusals of a mesh
  without the device engine and ``init_distributed`` twice;
* world "tp" (tp = 4 and dp = 2 x tp = 2 meshes): ``sharded_suffix_array``
  on test_parallel.py's six SA cases against ``bwt_tpu.ops.suffix``, one
  also against ``bwt_tpu``'s sharded sort on a tp = 4 mesh;
  ``build_index_sharded`` of a 30,000-base genome, whose reference-format
  bytes must equal ``bwt_tpu.build_index``'s; the tp-sharded index
  (``shard_index``, ``tp_view``): ``tp_locate`` and
  ``sharded_search_step`` over it against ``bwt_tpu.parallel.tp_locate``
  and ``sharded_search_step`` over ``bwt_tpu``'s ``shard_index``,
  ``align_reads``, ``rna_seq`` and ``search_reads`` with tp > 1 against
  ``bwt_tpu``'s single-device device engine on
  test_tp_sharded_driver_automatons_match_single_device's problem,
  test_tp_out_of_contract_garbage_parity's fuzzed problem (seed 4005)
  against ``bwt_tpu``'s host and device engines, the view's refusals, and
  a tp read one rank skips, which raises on the others at the group's
  timeout.

The ranks import neither jax nor bwt_tpu: this module imports them only
inside the tests, which run in the pytest process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import pickle
import time

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 240  # a world's wall, and every collective's bound


# --------------------------------------------------------------------------
# the inputs, made the same way by the ranks and by the tests
# --------------------------------------------------------------------------


def search_problem(batch=64):
    """test_parallel.py's _problem: 64 x 20-mers of a 3,000-base genome."""
    from bwt_tpu_torch import codec

    g = codec.random_genome(3000, seed=3)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 3000 - 20, size=batch)
    pats = np.stack([codes[s:s + 20] for s in starts]).astype(np.int32)
    return g, pats, np.full((batch,), 20, np.int32)


def driver_problem():
    """test_parallel.py's driver inputs: a 6,000-base genome (sa_rate 8),
    100 reads of 80 bp with up to two substitutions, N among them."""
    from bwt_tpu_torch import codec

    g = codec.random_genome(6000, seed=11)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(5)
    reads = []
    for _ in range(100):
        j = int(rng.integers(0, len(codes) - 80))
        r = codes[j:j + 80].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 80))] = rng.integers(0, 6)  # N is 5
        reads.append(r)
    return g, reads


def anchor_problem(sr):
    """anchor_scan_mesh's batch: 76 of the 60-bp reads (a multiple of 4)."""
    return np.stack(sr[:76]).astype(np.int32), np.full((76,), 60, np.int32)


def sa_cases():
    """test_parallel.py's six SA cases (the last takes the fallback)."""
    rng = np.random.default_rng(9)
    return [
        rng.integers(0, 4, size=5000).astype(np.uint8),
        rng.integers(0, 4, size=4097).astype(np.uint8),
        np.zeros(2048, np.uint8),
        np.tile(np.array([0, 1, 2, 3, 0, 1], np.uint8), 500),
        np.tile(np.array([0, 1], np.uint8), 600),
        rng.integers(0, 4, size=100).astype(np.uint8),
    ]


BIG_GENOME = (30000, 13)  # build_index_sharded's length and seed


def _norm(results):
    return [(p, str(c) if c else None, s) for p, c, s in results]


def tp_mesh(tp: int, coord: int):
    """The view of a (1, tp) mesh that rank ``coord`` holds, made without a
    world: enough for ``shard_index`` on the CPU, which cuts blocks and
    runs no collective."""
    from bwt_tpu_torch.parallel.mesh import Mesh

    return Mesh(shape={"dp": 1, "tp": tp}, coords={"dp": 0, "tp": coord},
                groups={}, lines={}, device=torch.device("cpu"),
                backend="gloo")


def tp_driver_problem():
    """test_tp_sharded_driver_automatons_match_single_device's problem: a
    6,000-base genome (sa_rate 8), 40 reads of 80 bp with up to two
    substitutions, N among them."""
    from bwt_tpu_torch import codec

    g = codec.random_genome(6000, seed=21)
    codes = codec.encode_genome(g)
    rng = np.random.default_rng(9)
    reads = []
    for _ in range(40):
        j = int(rng.integers(0, len(codes) - 80))
        r = codes[j:j + 80].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 80))] = rng.integers(0, 6)  # N is 5
        reads.append(r)
    return g, reads


def garbage_problem():
    """test_tp_out_of_contract_garbage_parity's fuzzed problem (seed 4005):
    its genome, sa_rate and reads, some of whose mms intervals land past
    the suffix array."""
    from bwt_tpu_torch import codec

    rng = np.random.default_rng(4005)
    glen = int(rng.integers(3000, 12000))
    g = codec.random_genome(glen, seed=int(rng.integers(1e6)))
    rate = int(rng.choice([4, 8]))
    codes = codec.encode_genome(g)
    nreads = int(rng.integers(16, 64))
    L = int(rng.integers(40, 100))
    reads = []
    for _ in range(nreads):
        j = int(rng.integers(0, glen - L))
        r = codes[j:j + L].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, L))] = int(rng.integers(0, 6))
        reads.append(r)
    return g, rate, reads


TP_SKIP_TIMEOUT_S = 5  # the group a rank skips a read on


def _raises(exc, fn) -> str | None:
    """The message of ``exc`` raised by ``fn()``; None if it did not."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _world_dp(rank, tmp):
    import torch.distributed as dist

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.parallel import mesh as pmesh

    out = {}
    init = dict(backend="gloo", init_method=f"file://{tmp}/rdv_dp",
                world_size=WORLD, rank=rank, timeout=TIMEOUT_S)
    parallel.init_distributed(**init)
    parallel.init_distributed(**init)  # a no-op the second time
    out["world"] = (dist.get_world_size(), dist.get_rank())
    mesh = parallel.make_mesh(WORLD, tp=1, device="cpu")
    out["coords"] = dict(mesh.coords)

    g, pats, lens = search_problem()
    fmi = parallel.replicate_index(
        bwt_tpu_torch.build_index(g, device="cpu"), mesh)
    p, ln = parallel.shard_patterns(pats, lens, mesh)
    pos, counts, total = parallel.sharded_search_step(fmi, p, ln, mesh)
    out["step"] = dict(
        local=parallel.gather_hits(pos), positions=parallel.gather_hits(
            pos, mesh), counts=parallel.host_fetch([counts], mesh)[0],
        total=int(total))
    out["odd_batch"] = _raises(ValueError, lambda: parallel.shard_patterns(
        pats[:63], lens[:63], mesh))

    g, reads = driver_problem()
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device="cpu")
    rr, sr = [r[:50] for r in reads], [r[:60] for r in reads[:77]]
    out["align"] = _norm(aligner.align_reads(fmi, g, reads, with_strand=True,
                                             mesh=mesh))
    out["rna"] = rnaseq.rna_seq(fmi, rr, mesh=mesh)
    out["search"] = exact.search_reads(fmi, sr, mesh=mesh)
    n, pos = exact.anchor_scan_mesh(mesh, fmi, *anchor_problem(sr))
    out["anchor_scan_mesh"] = (parallel.gather_hits(n, mesh),
                               parallel.gather_hits(pos, mesh))
    out["few"] = dict(
        align=_norm(aligner.align_reads(fmi, g, reads[:3], with_strand=True,
                                        mesh=mesh)),
        rna=rnaseq.rna_seq(fmi, rr[:3], mesh=mesh),
        search=exact.search_reads(fmi, sr[:3], mesh=mesh))
    out["refused"] = dict(
        align_host=_raises(ValueError, lambda: aligner.align_reads(
            fmi, g, reads[:4], engine="host", mesh=mesh)),
        rna_host=_raises(ValueError, lambda: rnaseq.rna_seq(
            fmi, rr[:4], engine="host", mesh=mesh)))
    out["staged"] = pmesh.STAGED_BYTES  # CPU tensors: nothing staged

    # config.elastic_fallback: rank 1's device runs fail once each; it
    # re-runs its share on the CPU and joins the merge
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                              elastic_fallback=True)
    err = io.StringIO()
    with _failing_once(rank == 1), contextlib.redirect_stderr(err):
        out["elastic"] = dict(
            align=_norm(aligner.align_reads(fmi, g, reads, with_strand=True,
                                            mesh=mesh, config=cfg)),
            rna=rnaseq.rna_seq(fmi, rr, mesh=mesh, config=cfg),
            search=exact.search_reads(fmi, sr, mesh=mesh, config=cfg))
    out["elastic_stderr"] = err.getvalue()
    dist.barrier()
    return out


@contextlib.contextmanager
def _failing_once(on: bool):
    """With ``on``, the first call of each driver's device run (the aligner's
    device engine, rna_seq's, search_reads' scan) raises
    ``KernelLaunchError``; the later calls, the re-run's, go through."""
    from bwt_tpu_torch.models import aligner, exact, rnaseq
    from bwt_tpu_torch.ops import _kernels

    sites = [(aligner, "_align_reads_device"), (rnaseq, "rna_seq_device"),
             (exact, "_scan_on_cpu")]
    saved = [getattr(m, name) for m, name in sites]

    def once(orig):
        calls = []

        def run(*a, **kw):
            if not calls:
                calls.append(1)
                raise _kernels.KernelLaunchError("injected device failure")
            return orig(*a, **kw)
        return run

    if on:
        for (m, name), orig in zip(sites, saved):
            setattr(m, name, once(orig))
    try:
        yield
    finally:
        for (m, name), orig in zip(sites, saved):
            setattr(m, name, orig)


def _world_tp(rank, tmp):
    import torch.distributed as dist

    import bwt_tpu_torch
    from bwt_tpu_torch import codec, io, parallel
    from bwt_tpu_torch.models import aligner, exact, rnaseq

    out = {}
    parallel.init_distributed(
        backend="gloo", init_method=f"file://{tmp}/rdv_tp",
        world_size=WORLD, rank=rank, timeout=TIMEOUT_S)
    tp4 = parallel.make_mesh(WORLD, tp=4, device="cpu")
    dp2tp2 = parallel.make_mesh(WORLD, tp=2, device="cpu")
    out["coords"] = (dict(tp4.coords), dict(dp2tp2.coords))
    out["sa"] = {name: [parallel.sharded_suffix_array(c, m, axis="tp")
                        for c in sa_cases()]
                 for name, m in (("tp4", tp4), ("dp2tp2", dp2tp2))}
    n, seed = BIG_GENOME
    fmi = parallel.build_index_sharded(codec.random_genome(n, seed=seed), tp4)
    io.write_ref_index(fmi, tmp / f"sharded{rank}.idx")

    out["tp"] = {name: _tp_paths(m) for name, m in (("tp4", tp4),
                                                    ("dp2tp2", dp2tp2))}
    out["garbage"] = _tp_garbage(dp2tp2)
    out["elastic"] = _tp_elastic(dp2tp2)
    out["wide"] = _tp_wide(dp2tp2)
    out["skip"] = _tp_skip(tp4)
    dist.barrier()
    return out


def _tp_paths(mesh):
    """The tp paths over ``mesh``: tp_locate and sharded_search_step on the
    search problem, the three drivers on the tp driver problem, every
    rank's outputs whole (gathered along 'dp')."""
    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.models import aligner, exact, rnaseq

    out = {}
    g, pats, lens = search_problem(32)
    fmi = bwt_tpu_torch.build_index(g, device="cpu")
    sharded = parallel.shard_index(fmi, mesh)
    p, ln = parallel.shard_patterns(pats, lens, mesh)
    pos, cnt = parallel.tp_locate(sharded, p, ln, mesh)
    out["tp_locate"] = (parallel.gather_hits(pos, mesh),
                        parallel.host_fetch([cnt], mesh)[0])
    view = parallel.tp_view(sharded)
    pos, _, total = parallel.sharded_search_step(view, p, ln, mesh)
    out["step"] = (parallel.gather_hits(pos, mesh), int(total))
    out["spec"] = (parallel.fmi_spec_tree(view), parallel.fmi_spec_tree(fmi))
    out["blocks"] = {f: tuple(getattr(view, f).shape)
                     for f in ("bwt_words", "buckets", "sa_samples",
                               "isa_samples")}

    g, reads = tp_driver_problem()
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device="cpu")
    out["align"] = _norm(aligner.align_reads(fmi, g, reads, with_strand=True,
                                             mesh=mesh))
    out["rna"] = rnaseq.rna_seq(fmi, [r[:50] for r in reads], mesh=mesh)
    out["search"] = exact.search_reads(fmi, [r[:60] for r in reads[:37]],
                                       mesh=mesh)
    return out


def _tp_elastic(mesh):
    """config.elastic_fallback over tp views of ``mesh`` (dp 2 x tp 2), the
    three drivers given the tp driver problem's whole index: the ranks of
    dp coordinate 1, a whole tp group (on the CPU a view's reads
    all-reduce over its group, so the group fails together), fail each
    device run once, re-run their share on the CPU and join the merge
    along 'dp'.  Each rank's outputs, whether it failed, and its stderr."""
    import bwt_tpu_torch
    from bwt_tpu_torch.models import aligner, exact, rnaseq

    g, reads = tp_driver_problem()
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device="cpu")
    cfg = dataclasses.replace(bwt_tpu_torch.DEFAULT_CONFIG,
                              elastic_fallback=True)
    failed = mesh.coords["dp"] == 1
    err = io.StringIO()
    with _failing_once(failed), contextlib.redirect_stderr(err):
        out = dict(
            align=_norm(aligner.align_reads(fmi, g, reads, with_strand=True,
                                            mesh=mesh, config=cfg)),
            rna=rnaseq.rna_seq(fmi, [r[:50] for r in reads], mesh=mesh,
                               config=cfg),
            search=exact.search_reads(fmi, [r[:60] for r in reads[:37]],
                                      mesh=mesh, config=cfg))
    return dict(out, failed=failed, stderr=err.getvalue())


def _tp_wide(mesh):
    """The wide (int64) index of the search problem over a tp view of
    ``mesh``: sharded_search_step and tp_locate, whole (gathered along
    'dp'), the positions' dtype and the view's block of rows."""
    import bwt_tpu_torch
    from bwt_tpu_torch import parallel

    g, pats, lens = search_problem(32)
    fmi = bwt_tpu_torch.build_index(g, index_dtype=np.int64, device="cpu")
    view = parallel.tp_view(parallel.shard_index(fmi, mesh))
    p, ln = parallel.shard_patterns(pats, lens, mesh)
    pos, _, total = parallel.sharded_search_step(view, p, ln, mesh)
    lpos, cnt = parallel.tp_locate(view, p, ln, mesh)
    return dict(step=(parallel.gather_hits(pos, mesh), int(total)),
                locate=(parallel.gather_hits(lpos, mesh),
                        parallel.host_fetch([cnt], mesh)[0]),
                dtypes=(str(pos.dtype), str(lpos.dtype), str(cnt.dtype)),
                rows=tuple(view.buckets.shape))


def _tp_garbage(mesh):
    """align_reads over a tp view on the fuzzed out-of-contract problem,
    and a view's refusals."""
    import bwt_tpu_torch
    from bwt_tpu_torch import io, parallel
    from bwt_tpu_torch.models import aligner

    g, rate, reads = garbage_problem()
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=rate, device="cpu")
    view = parallel.tp_view(parallel.shard_index(fmi, mesh))
    out = dict(align=_norm(aligner.align_reads(view, g, reads,
                                               with_strand=True, mesh=mesh)))
    out["refused"] = dict(
        to_numpy=_raises(ValueError, view.to_numpy),
        to=_raises(ValueError, lambda: view.to("cpu")),
        write_ref=_raises(ValueError, lambda: io.write_ref_index(view, "x")),
        write_npz=_raises(ValueError, lambda: io.write_npz_index(view, "x")),
        unmarked=_raises(ValueError, lambda: parallel.shard_index(
            fmi, mesh).lf(0)),
        host=_raises(ValueError, lambda: aligner.align_reads(
            view, g, reads[:2], engine="host", mesh=mesh)))
    return out


def _tp_skip(mesh):
    """Rank 1 skips a tp read that the others make, on a tp group whose
    collectives time out after TP_SKIP_TIMEOUT_S: the others raise, none
    waits past it.  Returns (raised, seconds) on the others, None on
    rank 1."""
    import datetime

    import torch.distributed as dist

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.parallel.mesh import Mesh

    g, _, _ = search_problem()
    fmi = bwt_tpu_torch.build_index(g, device="cpu")
    group = dist.new_group(mesh.lines["tp"], timeout=datetime.timedelta(
        seconds=TP_SKIP_TIMEOUT_S))
    short = Mesh(shape=mesh.shape, coords=mesh.coords,
                 groups=dict(mesh.groups, tp=group), lines=mesh.lines,
                 device=mesh.device, backend=mesh.backend)
    view = parallel.tp_view(parallel.shard_index(fmi, short))
    if dist.get_rank() == 1:
        return None
    t0 = time.monotonic()
    raised = _raises(RuntimeError, lambda: view.lf(torch.arange(8)))
    return raised is not None, time.monotonic() - t0


def _rank_main(rank, world, tmp):
    """One rank: run ``world``'s work, write it to ``tmp/<world><rank>``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        out = {"dp": _world_dp, "tp": _world_tp}[world](rank, tmp)
        (tmp / f"{world}{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start(world, tmp):
    import torch.multiprocessing as mp

    return mp.spawn(_rank_main, args=(world, tmp), nprocs=WORLD, join=False)


def _finish(ctx, world, tmp) -> list:
    """Wait for a world's ranks (TIMEOUT_S in all); a rank that failed or
    overran fails the test, and the others are stopped."""
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world} ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [pickle.loads((tmp / f"{world}{r}.pkl").read_bytes())
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started together; bwt_tpu's references are computed
    while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    started = {w: _start(w, tmp) for w in ("dp", "tp")}
    ref = _references(tmp)
    return {w: _finish(ctx, w, tmp) for w, ctx in started.items()}, ref, tmp


def _references(tmp):
    import bwt_tpu
    from bwt_tpu import codec as jcodec
    from bwt_tpu import io as jio
    from bwt_tpu import parallel as jparallel
    from bwt_tpu.models import aligner, exact, rnaseq
    from bwt_tpu.ops import search, suffix

    ref = {}
    g, pats, lens = search_problem()
    jfmi = bwt_tpu.build_index(g)
    mesh = jparallel.make_mesh(4, tp=1)
    pos, counts, total = jparallel.sharded_search_step(
        jparallel.replicate_index(jfmi, mesh),
        *jparallel.shard_patterns(pats, lens, mesh), mesh)
    ref["step"] = dict(positions=jparallel.gather_hits(pos, mesh),
                       counts=np.asarray(counts), total=int(total),
                       locate=np.asarray(search.locate(jfmi, pats, lens)))

    g, reads = driver_problem()
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    rr, sr = [r[:50] for r in reads], [r[:60] for r in reads[:77]]
    ref["align"] = _norm(aligner.align_reads(jfmi, g, reads, engine="device",
                                             with_strand=True))
    ref["rna"] = np.asarray(rnaseq.rna_seq(jfmi, rr, engine="device"))
    ref["search"] = exact.search_reads(jfmi, sr)
    mesh = jparallel.make_mesh(4, tp=1)
    ref["anchor_scan_mesh"] = [np.asarray(x) for x in exact.anchor_scan_mesh(
        mesh, jparallel.replicate_index(jfmi, mesh), *anchor_problem(sr))]

    ref["tp"] = _tp_references()
    ref["sa"] = [np.asarray(suffix.suffix_array(c)) for c in sa_cases()]
    ref["sa_jax_sharded"] = jparallel.sharded_suffix_array(
        sa_cases()[0], jparallel.make_mesh(4, tp=4), axis="tp")
    n, seed = BIG_GENOME
    jio.write_ref_index(bwt_tpu.build_index(jcodec.random_genome(n,
                                                                 seed=seed)),
                        tmp / "single.idx")
    return ref


def _tp_references():
    """bwt_tpu's answers to the tp world's problems: tp_locate and
    sharded_search_step over its shard_index on the 8 virtual devices
    (tp = 4), the single-device device engines on the driver problem, and
    the host and device engines on the fuzzed problem."""
    import bwt_tpu
    from bwt_tpu import parallel as jparallel
    from bwt_tpu.models import aligner, exact, rnaseq
    from bwt_tpu.ops import search

    ref = {}
    g, pats, lens = search_problem(32)
    jfmi = bwt_tpu.build_index(g)
    mesh = jparallel.make_mesh(8, tp=4)
    p, ln = jparallel.shard_patterns(pats, lens, mesh)
    pos, cnt = jparallel.tp_locate(jparallel.shard_index(jfmi, mesh), p, ln,
                                   mesh)
    step, _, total = jparallel.sharded_search_step(
        jparallel.shard_index(jfmi, mesh), p, ln, mesh)
    ref.update(tp_locate=(np.asarray(pos), np.asarray(cnt)),
               step=(np.asarray(step), int(total)),
               locate=np.asarray(search.locate(jfmi, pats, lens)),
               count=np.asarray(search.count_matches(jfmi, pats, lens)))

    g, reads = tp_driver_problem()
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    ref["align"] = _norm(aligner.align_reads(jfmi, g, reads, engine="device",
                                             with_strand=True))
    ref["rna"] = np.asarray(rnaseq.rna_seq(jfmi, [r[:50] for r in reads],
                                           engine="device"))
    ref["search"] = exact.search_reads(jfmi, [r[:60] for r in reads[:37]])

    g, rate, reads = garbage_problem()
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    ref["garbage"] = {e: _norm(aligner.align_reads(
        jfmi, g, reads, engine=e, with_strand=True))
        for e in ("host", "device")}
    return ref


# --------------------------------------------------------------------------
# world "dp"
# --------------------------------------------------------------------------


def test_mesh_layout_and_init_twice(worlds):
    outs, _, _ = worlds
    for r, o in enumerate(outs["dp"]):
        assert o["world"] == (WORLD, r)  # the second init was a no-op
        assert o["coords"] == {"dp": r, "tp": 0}
    for r, o in enumerate(outs["tp"]):  # rank r at dp = r // tp, r % tp
        assert o["coords"] == ({"dp": 0, "tp": r}, {"dp": r // 2,
                                                    "tp": r % 2})


def test_sharded_search_step_matches_bwt_tpu(worlds):
    outs, ref, _ = worlds
    want = ref["step"]
    assert np.array_equal(want["positions"], want["locate"])
    for r, o in enumerate(outs["dp"]):
        got = o["step"]
        assert np.array_equal(got["positions"], want["positions"]), r
        assert np.array_equal(got["counts"], want["counts"]), r
        assert got["total"] == want["total"] == int((want["locate"] >= 0)
                                                    .sum()), r
        # without a mesh, gather_hits is the rank's own shard
        assert np.array_equal(got["local"], want["positions"][r * 16:
                                                              (r + 1) * 16])
        assert o["odd_batch"] and "divide" in o["odd_batch"]


def test_align_reads_mesh_matches_bwt_tpu(worlds):
    outs, ref, _ = worlds
    assert any(c for _, c, _ in ref["align"])
    for r, o in enumerate(outs["dp"]):
        assert o["align"] == ref["align"], r
        assert o["few"]["align"] == ref["align"][:3], r


def test_rna_seq_mesh_matches_bwt_tpu(worlds):
    outs, ref, _ = worlds
    for r, o in enumerate(outs["dp"]):
        assert np.array_equal(o["rna"], ref["rna"]), r
        assert np.array_equal(o["few"]["rna"], ref["rna"][:3]), r


def test_search_reads_mesh_matches_bwt_tpu(worlds):
    outs, ref, _ = worlds
    want = ref["search"]
    assert len(want["fwd_pos"]) == 77 and want["paired"].dtype == bool
    for r, o in enumerate(outs["dp"]):
        for key in want:
            assert np.array_equal(o["search"][key], want[key]), (r, key)
            assert np.array_equal(o["few"]["search"][key],
                                  want[key][:3]), (r, key)


def test_elastic_mesh_one_rank_recovers(worlds):
    """config.elastic_fallback over a dp mesh: rank 1's device runs fail,
    it re-runs its share on the CPU (one stderr line a driver) and joins
    the merge; every rank's result equals bwt_tpu's single-device run."""
    outs, ref, _ = worlds
    for r, o in enumerate(outs["dp"]):
        got = o["elastic"]
        assert got["align"] == ref["align"], r
        assert np.array_equal(got["rna"], ref["rna"]), r
        for key in ref["search"]:
            assert np.array_equal(got["search"][key],
                                  ref["search"][key]), (r, key)
        lines = o["elastic_stderr"].splitlines()
        assert len(lines) == (3 if r == 1 else 0), (r, lines)
        assert all("KernelLaunchError" in ln and "elastic_fallback" in ln
                   for ln in lines)


def test_elastic_tp_group_recovers(worlds):
    """config.elastic_fallback over dp 2 x tp 2 views: the tp group whose
    device runs fail re-runs its share on a CPU copy of the whole index
    the caller passed (one stderr line a driver) and joins the merge;
    every rank's result equals bwt_tpu's single-device run."""
    outs, ref, _ = worlds
    assert sorted(o["elastic"]["failed"] for o in outs["tp"]) == [
        False, False, True, True]
    for r, o in enumerate(outs["tp"]):
        got = o["elastic"]
        assert got["align"] == ref["tp"]["align"], r
        assert np.array_equal(got["rna"], ref["tp"]["rna"]), r
        for key in ref["tp"]["search"]:
            assert np.array_equal(got["search"][key],
                                  ref["tp"]["search"][key]), (r, key)
        lines = got["stderr"].splitlines()
        assert len(lines) == (3 if got["failed"] else 0), (r, lines)
        assert all("KernelLaunchError" in ln and "elastic_fallback" in ln
                   for ln in lines)


def test_anchor_scan_mesh_matches_bwt_tpu(worlds):
    outs, ref, _ = worlds
    want = ref["anchor_scan_mesh"]
    assert (want[0] > 0).any()
    for r, o in enumerate(outs["dp"]):
        for got, w in zip(o["anchor_scan_mesh"], want):
            assert np.array_equal(got, w), r


def test_mesh_needs_the_device_engine(worlds):
    outs, _, _ = worlds
    for o in outs["dp"]:
        assert "device engine" in o["refused"]["align_host"]
        assert "device engine" in o["refused"]["rna_host"]
        assert o["staged"] == 0


# --------------------------------------------------------------------------
# world "tp"
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", ["tp4", "dp2tp2"])
def test_sharded_suffix_array_matches_bwt_tpu(worlds, mesh_name):
    outs, ref, _ = worlds
    for r, o in enumerate(outs["tp"]):
        for k, (got, want) in enumerate(zip(o["sa"][mesh_name], ref["sa"])):
            assert got.dtype == np.int32
            assert np.array_equal(got, want), (r, k)
    assert np.array_equal(ref["sa_jax_sharded"], ref["sa"][0])


def test_build_index_sharded_reference_bytes(worlds):
    _, _, tmp = worlds
    want = (tmp / "single.idx").read_bytes()
    for r in range(WORLD):
        assert (tmp / f"sharded{r}.idx").read_bytes() == want, r


MESHES = ("tp4", "dp2tp2")


@pytest.mark.parametrize("mesh_name", MESHES)
def test_tp_locate_matches_bwt_tpu(worlds, mesh_name):
    outs, ref, _ = worlds
    want = ref["tp"]
    assert np.array_equal(want["tp_locate"][0], want["locate"])
    assert np.array_equal(want["tp_locate"][1], want["count"])
    for r, o in enumerate(outs["tp"]):
        pos, cnt = o["tp"][mesh_name]["tp_locate"]
        assert np.array_equal(pos, want["locate"]), r
        assert np.array_equal(cnt, want["count"]), r


@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_search_step_over_a_view_matches_bwt_tpu(worlds, mesh_name):
    """test_sharded_index_matches_replicated's case: the step over a tp
    view equals bwt_tpu's over its shard_index, and its total counts the
    whole batch once (an all-reduce along 'dp' only)."""
    outs, ref, _ = worlds
    want_pos, want_total = ref["tp"]["step"]
    assert np.array_equal(want_pos, ref["tp"]["locate"])
    for r, o in enumerate(outs["tp"]):
        pos, total = o["tp"][mesh_name]["step"]
        assert np.array_equal(pos, want_pos), r
        assert total == want_total == int((want_pos >= 0).sum()), r


@pytest.mark.parametrize("path", ["step", "locate"])
def test_wide_tp_view_matches_bwt_tpu(worlds, path):
    """The wide (int64) index over a tp view of the dp 2 x tp 2 mesh (12-int
    blocks): sharded_search_step and tp_locate equal bwt_tpu's over its
    shard_index (whose wide tp path tests/test_int64_index.py holds to its
    int32 one), as int64."""
    outs, ref, _ = worlds
    for r, o in enumerate(outs["tp"]):
        w = o["wide"]
        assert w["dtypes"] == ("torch.int64",) * 3, r
        assert w["rows"][1] == 12, r
        if path == "step":
            pos, total = w["step"]
            want_pos, want_total = ref["tp"]["step"]
            assert pos.dtype == np.int64 and total == want_total, r
        else:
            pos, cnt = w["locate"]
            want_pos = ref["tp"]["locate"]
            assert np.array_equal(cnt, ref["tp"]["count"]), r
        assert np.array_equal(pos, want_pos), r


@pytest.mark.parametrize("mesh_name", MESHES)
def test_tp_view_blocks_and_spec_tree(worlds, mesh_name):
    """Each rank holds about 1/tp of every sequence table (bwt_tpu's padded
    blocks) and fmi_spec_tree names the placement shard_index follows."""
    import bwt_tpu_torch
    from bwt_tpu_torch.parallel.mesh import block_rows

    outs, _, _ = worlds
    tp = {"tp4": 4, "dp2tp2": 2}[mesh_name]
    fmi = bwt_tpu_torch.build_index(search_problem()[0], device="cpu")
    for r, o in enumerate(outs["tp"]):
        spec_view, spec_whole = o["tp"][mesh_name]["spec"]
        assert spec_view == dict(bwt_words="tp", buckets="tp",
                                 sa_samples="tp", isa_samples="tp",
                                 C="replicated", endloc="replicated"), r
        assert set(spec_whole.values()) == {"replicated"}, r
        for f, shape in o["tp"][mesh_name]["blocks"].items():
            whole = getattr(fmi, f).shape
            assert shape == (block_rows(whole[0], tp),) + tuple(whole[1:]), f


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("driver", ["align", "rna", "search"])
def test_tp_drivers_match_bwt_tpu(worlds, mesh_name, driver):
    """align_reads (with_strand), rna_seq and search_reads over a tp view
    on test_tp_sharded_driver_automatons_match_single_device's problem
    equal bwt_tpu's single-device device engine on every rank."""
    outs, ref, _ = worlds
    want = ref["tp"][driver]
    for r, o in enumerate(outs["tp"]):
        got = o["tp"][mesh_name][driver]
        if driver == "align":
            assert any(c for _, c, _ in want)
            assert got == want, r
        elif driver == "rna":
            assert np.array_equal(got, want), r
        else:
            for key in want:
                assert np.array_equal(got[key], want[key]), (r, key)


def test_tp_out_of_contract_garbage_parity(worlds):
    """The fuzzed problem whose mms intervals land past the suffix array:
    the port's align_reads over a tp view (dp 2 x tp 2) reads the same
    garbage as bwt_tpu's host and device engines (wrap-then-fill with the
    global row counts)."""
    outs, ref, _ = worlds
    want = ref["tp"]["garbage"]
    assert want["host"] == want["device"]
    for r, o in enumerate(outs["tp"]):
        assert o["garbage"]["align"] == want["host"], r


def test_tp_view_refusals(worlds):
    outs, _, _ = worlds
    for r, o in enumerate(outs["tp"]):
        got = o["garbage"]["refused"]
        for what in ("to_numpy", "to", "write_ref", "write_npz"):
            assert got[what] and "whole index" in got[what], (r, what)
        assert got["unmarked"] and "tp_view" in got["unmarked"], r
        assert got["host"] and "device engine" in got["host"], r


def test_tp_skipped_read_raises_at_the_group_timeout(worlds):
    """A rank that skips a tp read leaves the others in its all-reduce
    only until the group's timeout: they raise, and none hangs."""
    outs, _, _ = worlds
    assert outs["tp"][1]["skip"] is None
    for r in (0, 2, 3):
        raised, seconds = outs["tp"][r]["skip"]
        assert raised, r
        assert seconds < TP_SKIP_TIMEOUT_S + 30, (r, seconds)


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------


def test_tp_view_checks_its_shard():
    """tp_view marks only a shard of the right shape and axis; a view
    serves only the mesh whose block it holds, and is never cut again."""
    import bwt_tpu_torch
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.parallel import mesh as pmesh

    g, pats, lens = search_problem(8)
    fmi = bwt_tpu_torch.build_index(g, device="cpu")
    with pytest.raises(ValueError, match="whole"):
        parallel.tp_view(fmi)
    sharded = parallel.shard_index(fmi, tp_mesh(2, 1))
    with pytest.raises(ValueError, match="tp axis"):
        parallel.tp_view(sharded, tp_axis="dp")
    cut = dataclasses.replace(sharded, buckets=sharded.buckets[:-1])
    with pytest.raises(ValueError, match="rows"):
        parallel.tp_view(cut)
    view = parallel.tp_view(sharded)
    assert view.tp is view.shard and fmi.tp is None
    with pytest.raises(ValueError, match="not a tp view"):
        parallel.tp_locate(view, pats, lens, tp_mesh(4, 1))
    with pytest.raises(ValueError, match="not a tp view"):
        pmesh.serving_index(view, tp_mesh(2, 0))
    with pytest.raises(ValueError, match="tp=1"):
        pmesh.serving_index(view, tp_mesh(1, 0))
    with pytest.raises(ValueError, match="whole index"):
        parallel.shard_index(view, tp_mesh(2, 0))
    assert pmesh.serving_index(sharded, tp_mesh(2, 1)).tp_axis == "tp"
    pmesh.release_view(view)  # nothing to release on the CPU


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_shard_index_blocks_match_bwt_tpu(tp):
    """The port's blocks are bwt_tpu.parallel.shard_index's shards on the
    8-device CPU mesh, array by array (the cutting needs no world)."""
    import bwt_tpu
    from bwt_tpu import parallel as jparallel

    import bwt_tpu_torch
    from bwt_tpu_torch import parallel

    g = search_problem()[0]
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=8)
    jsh = jparallel.shard_index(jfmi, jparallel.make_mesh(8, tp=tp))
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=8, device="cpu")
    for coord in range(tp):
        view = parallel.tp_view(parallel.shard_index(fmi, tp_mesh(tp, coord)))
        for f in ("bwt_words", "buckets", "sa_samples", "isa_samples", "C",
                  "endloc"):
            arr = getattr(jsh, f)
            got = getattr(view, f).numpy()
            if f == "bwt_words":
                got = got.view(np.uint32)
            spec = parallel.fmi_spec_tree(view)[f]
            want = next(
                np.asarray(sh.data) for sh in arr.addressable_shards
                if spec == "replicated" or (sh.index[0].start or 0)
                == coord * got.shape[0])
            assert got.dtype == want.dtype and np.array_equal(got, want), (
                coord, f)


def test_build_index_given_sa_matches_bwt_tpu():
    import bwt_tpu
    from bwt_tpu import codec as jcodec
    from bwt_tpu.ops import suffix as jsuffix

    import bwt_tpu_torch

    codes = jcodec.encode_genome(jcodec.random_genome(5000, seed=4))
    sa = np.asarray(jsuffix.suffix_array(codes))
    for rate in (8, 32):
        want = bwt_tpu.build_index(codes, sa=sa, sa_sample_rate=rate)
        got = bwt_tpu_torch.build_index(codes, sa=sa, sa_sample_rate=rate,
                                        verify=True, device="cpu").to_numpy()
        for f in ("bwt_words", "buckets", "sa_samples", "C", "endloc",
                  "isa_samples"):
            assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
        assert (got["length"], got["sa_rate"]) == (want.length, want.sa_rate)


def test_build_index_given_sa_refusals():
    import bwt_tpu_torch
    from bwt_tpu_torch.ops import suffix

    codes = np.random.default_rng(1).integers(0, 4, 500).astype(np.uint8)
    sa = suffix.suffix_array(codes, device="cpu").numpy()
    with pytest.raises(ValueError, match="precomputed sa"):
        bwt_tpu_torch.build_index(codes, sa=sa, index_dtype=np.int64,
                                  device="cpu")
    bad = sa.copy()
    bad[[3, 4]] = bad[[4, 3]]
    with pytest.raises(AssertionError, match="verification"):
        bwt_tpu_torch.build_index(codes, sa=bad, verify=True, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bwt_tpu_torch.build_index(codes, sa=sa[:-1], device="cpu")


def test_make_mesh_without_a_world_or_a_card():
    from bwt_tpu_torch import parallel
    from bwt_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="does not exist"):
            pmesh._rank_device(None)  # never the CPU by itself


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_half_is_the_stable_merge(seed):
    """The merge-split step's merge of two sorted blocks equals the stable
    sort of their concatenation, lower block first, on keys with many ties
    (both halves; the payload row says which column went where)."""
    from bwt_tpu_torch.parallel.suffix_dist import _merge_half, _sort_rows

    rng = np.random.default_rng(seed)
    n = 1000
    lower, upper = (_sort_rows(torch.from_numpy(np.stack(
        [rng.integers(0, 50, n), np.arange(n) + k * n]))) for k in (0, 1))
    want = _sort_rows(torch.cat([lower, upper], 1))
    assert torch.equal(_merge_half(lower, upper, low=True), want[:, :n])
    assert torch.equal(_merge_half(lower, upper, low=False), want[:, n:])
