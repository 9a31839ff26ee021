"""Spliced / RNA-seq alignment prototype: the rnaseqtest.c model family.

The reference's maximum-mappable-suffix splice chaining (``mms_search``
rnaseqtest.c:43-68, position-aware ``mms_continue`` :75-127, ``mms_gap``
:131-160, the ``rna_seq`` main loop :172-243) as host generators over the
executor's fused service (:mod:`bwt_tpu_torch.models.batch_exec`), with
the reference's return-value quirks:

  * break-path positions are ``unc_sa(start_of_empty_interval) + 1``
    while full-match positions are ``unc_sa(start)`` with no +1
    (rnaseqtest.c:55 vs :67);
  * ``*len_p`` on the break path is ``len - i + 1`` with ``i`` one
    below the failing character (= chars_matched + 3);
  * the reported position is the *first* anchor's: later
    continuations never update it (``genpos = mmspos`` only,
    rnaseqtest.c:189-241).

The reference's debug prints (rnaseqtest.c:113, :117) are not
reproduced.

Where the reference is undefined: rnaseqtest.c's own search loops index
``fmi->C[pattern[i]]`` / ``rank(fmi, pattern[i], ...)`` with the raw
character (e.g. :49-50, :60-61), so a read with an N (code 5) reads
``C[5]`` / ``C[6]`` out of bounds.  Here such a read is defined: the
search sees the rank(5) that the fused service computes, and the result
equals ``bwt_tpu``'s host engine, not the C binary's garbage.

Two engines with equal results: the host generators over the executor
(``engine="host"``), and the device automaton (``engine="device"``,
:func:`rna_seq_device`), the whole main loop a read on the device, one launch
of the K9 kernel a chunk of reads (:mod:`bwt_tpu_torch.ops.automaton`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex, recovery_copy, refuse_wide
from bwt_tpu_torch.models.batch_exec import (
    BatchExecutor, QueryService, _host_array, _to_device, _to_host_async)
from bwt_tpu_torch.ops import automaton

# test hook: a nonzero value overrides the automaton's iteration cap, to
# force the capped reads' re-run on the host
_TEST_CAP = 0


def _eval_mms_search(r: dict, length: int, cutoff: int):
    """Pure post-processing of one mms_search bsearch reply
    (rnaseqtest.c:43-68); shared by the sequential generator and the
    speculative retry chain in :func:`rna_seq_gen`."""
    if r["alive"] or r["nmatched"] >= length - 1:
        return r["pos"], length
    len_p = r["nmatched"] + 3
    if r["nmatched"] + 2 > cutoff:
        return r["pos"] + 1, len_p
    return -1, len_p


def _eval_mms_gap(r: dict, length: int):
    """Pure post-processing of one mms_gap bsearch reply
    (rnaseqtest.c:131-160)."""
    if r["alive"] or r["nmatched"] >= length - 1:
        return r["pos"], length
    return -1, r["nmatched"] + 3


def mms_search_gen(row: int, length: int, cutoff: int):
    """Returns (pos, len_p) per rnaseqtest.c:43-68.  ``row`` is the
    read's bank handle; the search covers its length-prefix.

    The reference checks emptiness at the TOP of its loop
    (rnaseqtest.c:51), so an interval emptied by the final character
    exits the loop normally and takes the full-match path — returning
    ``unc_sa(start)`` of the empty interval.  ``nmatched >= length-1``
    captures exactly that case.  Both paths read the service's fused
    ``pos`` (= unc_sa of the final interval start) — one round, not
    two."""
    r = yield ("bsearch", row, 0, length)
    return _eval_mms_search(r, length, cutoff)


def mms_gap_gen(row: int, length: int, cutoff: int, lastpos: int):
    """Returns (pos, len_p) per rnaseqtest.c:131-160.  Note the
    reference's break-path candidate scan (rnaseqtest.c:146-151)
    iterates ``for (j = start; j < end; ...)`` over the *empty*
    interval that triggered the break — it never executes, so any
    break returns -1; only a full match yields a position.  As in
    :func:`mms_search_gen`, emptied-by-the-final-character counts as a
    full match (top-of-loop check, rnaseqtest.c:144)."""
    r = yield ("bsearch", row, 0, length)
    return _eval_mms_gap(r, length)


def mms_continue_gen(row: int, length: int, cutoff: int, lastpos: int,
                     use_isa: bool = False):
    """Position-aware continuation (rnaseqtest.c:75-127): at the loop
    iteration where ``len - i == cutoff`` (i.e. after cutoff-1 matched
    characters), scan the current interval for a match within 6 nt
    upstream of ``lastpos`` and, if found, narrow the interval to it
    before continuing.  ``use_isa`` answers the scan with one
    inverse-SA window query (identical narrowing; see
    ops.search.isa_window)."""
    if length < cutoff:
        # the checkpoint is unreachable; behavior collapses to mms_gap
        return (yield from mms_gap_gen(row, length, cutoff, lastpos))
    # Phase 1: the cutoff-1 characters before the checkpoint
    # (the slice pattern[length-cutoff+1 : length] of the prefix).
    # With isa_samples the checkpoint scan is answered IN the same
    # dispatch (fused inverse-SA window, batch_exec OP_BEXT): the
    # minimal in-interval row among positions
    # [lastpos - cutoff - 6, lastpos) == the first entry the
    # reference's SA-row scan accepts (rnaseqtest.c:110-121).
    fuse = use_isa and cutoff + 6 <= 32
    if fuse:
        r = yield ("bsearch_ext", row, length - cutoff + 1, cutoff - 1,
                   lastpos - cutoff - 6, cutoff + 6)
    else:
        r = yield ("bsearch", row, length - cutoff + 1, cutoff - 1)
    if not r["alive"]:
        # Emptied before the checkpoint: len - i <= cutoff at the
        # break, so the acceptance test (rnaseqtest.c:86) always fails.
        return -1, r["nmatched"] + 3
    # Checkpoint (len - i == cutoff): scan current matches.  Without
    # the fused window, fetch the candidate walk lazily in
    # geometrically growing chunks — the scan almost always narrows
    # within the first few entries while the interval width grows
    # linearly with genome size; chunking preserves the exact scan
    # order.
    start, end = r["start"], r["end"]
    if fuse:
        if r["wrow"] >= 0:
            start, end = r["wrow"], r["wrow"] + 1
    else:
        base, w = start, 32
        narrowed = False
        while base < end and not narrowed:
            hi = min(end, base + w)
            poss = yield ("unc_sa_range", base, hi)
            for k, p in enumerate(np.asarray(poss)):
                pos = int(p)
                if pos < lastpos and lastpos - (pos + cutoff) <= 6:
                    start, end = base + k, base + k + 1
                    narrowed = True
                    break
            base, w = hi, w * 4
    # Phase 2: the remaining prefix pattern[:length-cutoff+1].  The
    # full-match path triggers whenever every top-of-loop emptiness
    # check passed — including an interval emptied by the very last
    # character (rnaseqtest.c:84-103), which reads unc_sa() of the
    # EMPTY final interval.
    l2 = length - cutoff + 1
    r = yield ("mms_continue_full", row, 0, l2, start, end)
    if r["alive"] or r["nmatched"] >= l2 - 1:
        return r["pos"], length
    # Break: the candidate scan is over the empty interval (see
    # mms_gap_gen) — always -1.  len - i + 1 == (cutoff-1) + m + 3.
    return -1, cutoff + r["matched"] + 2


def rna_seq_gen(row: int, length: int, anchor_cutoff: int = 14,
                cont_cutoff: int = 10, use_isa: bool = False,
                spec: int = 1):
    """The rna_seq main loop (rnaseqtest.c:172-243).  Returns the first
    anchor's genome position (the value the reference printf's).
    Cutoffs default to the reference's hardcoded 14 / 10
    (rnaseqtest.c:197, :219).

    ``spec``: speculative depth for the two length-decrement retry
    loops (rnaseqtest.c:198-201 anchor hunt, :227-236 gap re-anchor).
    Each retry's request is ``bsearch`` of a deterministically shorter
    prefix, so up to ``spec`` of them issue as one batch_exec "par"
    round; replies are consumed in sequential order and the unused
    tail discarded — outputs identical at any depth."""
    i = length
    mmspos, mmslen = yield from mms_search_gen(row, i, anchor_cutoff)
    while mmspos == -1 and i > anchor_cutoff:
        lens = []
        j = i
        while j > anchor_cutoff and len(lens) < spec:
            j -= 1
            lens.append(j)
        if len(lens) == 1:
            replies = [(yield ("bsearch", row, 0, lens[0]))]
        else:
            replies = yield ("par", [("bsearch", row, 0, l) for l in lens])
        for l, r in zip(lens, replies):
            i = l
            mmspos, mmslen = _eval_mms_search(r, l, anchor_cutoff)
            if mmspos != -1:
                break
    i -= mmslen
    while i > 18:
        genpos = mmspos
        i -= 3
        nextpos, mmslen = yield from mms_continue_gen(
            row, i, cont_cutoff, genpos, use_isa
        )
        if nextpos != -1:
            i -= mmslen
        else:
            while i > anchor_cutoff:
                lens = []
                j = i
                while j > anchor_cutoff and len(lens) < spec:
                    j -= 1
                    lens.append(j)
                if len(lens) == 1:
                    replies = [(yield ("bsearch", row, 0, lens[0]))]
                else:
                    replies = yield (
                        "par", [("bsearch", row, 0, l) for l in lens]
                    )
                done = False
                for l, r in zip(lens, replies):
                    i = l
                    nextpos, mmslen = _eval_mms_gap(r, l)
                    if nextpos != -1:
                        i -= mmslen
                        done = True
                        break
                if done:
                    break
    return mmspos


def rna_seq_device(fmi: FMIndex, reads, *, config=None, service=None,
                   mesh=None):
    """:func:`rna_seq` on the device automaton: one launch of the K9
    kernel a chunk of ``config.search_batch`` reads (its plain version on
    the CPU, or anywhere with ``service.svc_impl = "plain"``); the same
    results as the host engine.  Needs ``fmi.isa_samples`` and
    ``cont_cutoff + 6 <= 32``, else raises ValueError.  Writes its counters
    into ``service.last_stats``: ``automaton_launches``, ``chunks``,
    ``capped`` (reads re-run on the host at the cap) and ``max_iters``
    (the most iterations a read ran).

    ``mesh``: a :class:`bwt_tpu_torch.parallel.Mesh`: each rank runs the
    engine on its contiguous share of the reads along 'dp'
    (``parallel.mesh.share``; an empty share when there are fewer reads
    than ranks) on its own device, one K9 launch a chunk, and one
    all-gather along 'dp' gives every rank the whole array in read order,
    equal to the single-device run's.  With tp > 1 the ranks of a tp group
    run the same share over a tp view (``parallel.mesh.serving_index``:
    ``fmi`` itself if it is one).

    The cyclic garbage collector is paused for the call: the engine
    allocates no cycles."""
    refuse_wide(fmi, "rna_seq")
    if mesh is None:
        return _rna_seq_device_gc(fmi, reads, config, service)
    return _on_mesh(fmi, reads, service, mesh,
                    lambda served, part, svc: _rna_seq_device_gc(
                        served, part, config, svc))


def _rna_seq_device_gc(fmi, reads, config, service):
    import gc

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _rna_seq_device_inner(fmi, reads, config=config,
                                     service=service)
    finally:
        if was_enabled:
            gc.enable()


def _on_mesh(fmi, reads, service, mesh, run):
    """A driver's run on a mesh: ``run(served, part, service)`` on this
    rank's share ``part`` of the reads along 'dp', over the index it
    serves from (``parallel.mesh.serving_index``), then one all-gather
    along 'dp' of the (n,) results."""
    from bwt_tpu_torch.parallel import mesh as pmesh

    given, fmi = fmi, pmesh.serving_index(fmi, mesh)
    if service is not None and service.fmi.shard is not fmi.shard:
        # a service over the whole index: serve from the view
        service = QueryService(fmi, config=service.config)
    lo, hi = pmesh.share(len(reads), mesh)
    res = run(fmi, reads[lo:hi], service)
    pmesh.done_serving(fmi, given)
    with pmesh.merging():
        return pmesh.gather_batch(mesh, res)


def _rna_seq_device_inner(fmi, reads, *, config=None, service=None):
    from bwt_tpu_torch.config import DEFAULT

    cfg = config or (service.config if service is not None else DEFAULT)
    if fmi.isa_samples is None:
        raise ValueError("rna_seq_device requires an index with isa_samples")
    if cfg.rnaseq_cont_cutoff + 6 > 32:
        raise ValueError("rna_seq_device requires cont_cutoff + 6 <= 32")
    svc = service if service is not None else QueryService(fmi, config=cfg)
    is_mat = isinstance(reads, np.ndarray) and reads.ndim == 2
    if is_mat:
        codes_list = np.ascontiguousarray(reads).astype(np.uint8, copy=False)
    else:
        codes_list = [codec.encode_read(r) if isinstance(r, (str, bytes))
                      else np.asarray(r, np.uint8) for r in reads]
    n = len(codes_list)
    dev = fmi.device
    plain = svc.svc_impl == "plain"
    seed = svc.seed  # built once, on the caller's service
    stats = dict(automaton_launches=0, chunks=0, capped=0, max_iters=0)

    def dispatch(svc_i, sub, resolve):
        """Register a chunk, upload its bank, launch the automaton and
        queue the copy back of its packed output; returns the host tensor
        and the event that marks the copy done, without synchronising."""
        svc_i.reset_reads()
        m = len(sub)
        _base, rl = svc_i.add_reads_batch(sub)
        bank = svc_i.bank8
        R = bank.shape[0]
        lens = np.zeros(R, np.int32)
        lens[:m] = rl
        live0 = torch.arange(R, device=dev) < m
        before = automaton.AUTOMATON_LAUNCHES
        out = automaton.rna_seq_automaton_packed(
            fmi, bank, _to_device(lens, dev), live0,
            None if seed is None else seed.rows,
            ac=cfg.rnaseq_anchor_cutoff, cc=cfg.rnaseq_cont_cutoff,
            resolve=svc_i._has_n if resolve is None else resolve,
            cap_steps=_TEST_CAP, seed_k=0 if seed is None else seed.k,
            plain=plain)
        stats["automaton_launches"] += automaton.AUTOMATON_LAUNCHES - before
        stats["chunks"] += 1
        # queued right behind this chunk's launch, so that its fetch does
        # not wait for the next chunk's
        return _to_host_async(out)

    def fetch(pend, sub):
        """A chunk's results, once its copy back is done; reads still live
        at the iteration cap re-run on the host generators (their device
        state is mid-flight), which gives their values unchanged."""
        out = _host_array(pend)
        automaton.automaton_raise(fmi, out)
        m = len(sub)
        res, capped, iters = (a[:m] for a in automaton.unpack(out))
        res = res.copy()
        stats["max_iters"] = max(stats["max_iters"],
                                 int(iters.max(initial=0)))
        bad = np.flatnonzero(capped)
        if bad.size:
            stats["capped"] += int(bad.size)
            svc_f = QueryService(fmi, config=cfg)
            gens = []
            for k in bad:
                row = svc_f.add_read(sub[k])
                gens.append(rna_seq_gen(
                    row, len(sub[k]), cfg.rnaseq_anchor_cutoff,
                    cfg.rnaseq_cont_cutoff, True, cfg.rnaseq_spec_depth))
            res[bad] = np.asarray(BatchExecutor(svc_f).run(gens), np.int32)
        return res

    chunk = cfg.search_batch
    if n <= chunk:
        res = fetch(dispatch(svc, codes_list, None), codes_list)
        svc.last_stats = stats
        return res
    # a software pipeline over the chunks: a chunk's bank is built and
    # uploaded, and its launch queued, while the previous chunk runs; the
    # previous chunk's fetch comes after.  resolve is decided over all the
    # reads; each chunk's service keeps its bank alive until its fetch
    resolve = (bool((codes_list == 5).any()) if is_mat
               else any(bool((r == 5).any()) for r in codes_list))
    out = np.empty(n, np.int32)
    prev = None
    for lo in range(0, n, chunk):
        sub = codes_list[lo : lo + chunk]
        pend = dispatch(QueryService(fmi, config=cfg), sub, resolve)
        if prev is not None:
            plo, psub, ppend = prev
            out[plo : plo + len(psub)] = fetch(ppend, psub)
        prev = (lo, sub, pend)
    plo, psub, ppend = prev
    out[plo : plo + len(psub)] = fetch(ppend, psub)
    svc.last_stats = stats
    return out


def rna_seq(fmi: FMIndex, reads, *, config=None, service=None,
            engine: str = "auto", mesh=None):
    """Batched spliced alignment: the first anchor's position per
    read (np.int32 array) for ASCII strings or code arrays.  A reusable
    :class:`~bwt_tpu_torch.models.batch_exec.QueryService` keeps device
    state across calls.

    ``engine``: "device" runs the device automaton (:func:`rna_seq_device`),
    "host" the host generators over the executor; "auto" (the default)
    takes the automaton when it can run (the index has ``isa_samples`` and
    ``cont_cutoff + 6 <= 32``), as ``bwt_tpu`` does.  The results are the
    same either way, and equal the JAX package's for either of its
    engines.  ``mesh`` shards the reads over its 'dp' axis
    (:func:`rna_seq_device`) and needs the device engine (ValueError
    otherwise).

    With ``config.elastic_fallback`` set, a device failure in either
    engine (``ops._kernels.device_failure``) prints one line on stderr and
    the host engine runs the reads again on a CPU copy of the index
    (``index.recovery_copy``: it raises the card's error again if the card
    is gone, as ``bwt_tpu``'s host copy does; ``rna_seq`` has no genome to
    rebuild from).  On a mesh a rank re-runs its own share so, then joins
    the merge; a tp view the caller passed has no CPU copy, and the device
    error is raised again."""
    from bwt_tpu_torch.config import DEFAULT
    from bwt_tpu_torch.ops import _kernels

    if engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    refuse_wide(fmi, "rna_seq")
    cfg = config or (service.config if service is not None else DEFAULT)
    use_dev = engine == "device" or (
        engine == "auto" and fmi.isa_samples is not None
        and cfg.rnaseq_cont_cutoff + 6 <= 32)
    if mesh is not None and not use_dev:
        raise ValueError("mesh= requires the device engine "
                         "(an index with isa_samples)")

    def run(served, part, svc):
        if use_dev:
            return rna_seq_device(served, part, config=cfg, service=svc)
        return _rna_seq_host(served, part, cfg, svc)

    def attempt(served, part, svc):
        # the re-run copies the caller's index, not a tp view served from
        return _kernels.elastic(
            cfg, "rna_seq device engine failed",
            "re-running on the CPU backend",
            lambda: run(served, part, svc),
            lambda err: _rna_seq_host(
                recovery_copy(fmi, err), part,
                dataclasses.replace(cfg, elastic_fallback=False), None))

    if mesh is None:
        return attempt(fmi, reads, service)
    return _on_mesh(fmi, reads, service, mesh, attempt)


def _rna_seq_host(fmi, reads, cfg, service):
    """The host engine: one generator a read over the executor."""
    svc = service if service is not None else QueryService(fmi, config=cfg)
    svc.reset_reads()
    gens = []
    for r in reads:
        p = (codec.encode_read(r) if isinstance(r, (str, bytes))
             else np.asarray(r, np.uint8))
        row = svc.add_read(p)
        gens.append(rna_seq_gen(row, len(p), cfg.rnaseq_anchor_cutoff,
                                cfg.rnaseq_cont_cutoff,
                                fmi.isa_samples is not None,
                                cfg.rnaseq_spec_depth))
    return np.asarray(BatchExecutor(svc).run(gens), np.int32)
