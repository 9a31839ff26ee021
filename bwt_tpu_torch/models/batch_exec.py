"""Batched coroutine executor: sequential control flow per read, device
work fused into one service call per round.

Each read runs its driver (single_align.c:26-298) as a host generator
that yields FM-index and DP requests.  Every round, the executor collects
one pending request per live generator and runs them together: the
FM-index opcodes as one fused service call (:func:`_service_core`, on the
card one launch of the service kernel, :mod:`bwt_tpu_torch.ops.service`:
per lane the backward search, the unc_sa walk, the inverse-SA window scan
and the C[c]+rank adjunct), the DP stitches as one wavefront fill and
backtrack per padded shape
(:func:`bwt_tpu_torch.ops.dp_wavefront.dp_stitch`).  Per-read
request sequences, and so the outputs, are those of running each read
alone.  Lanes pad to a power of two per round.

Request protocol (``yield`` values; ``row`` is a handle from
:meth:`QueryService.add_read`):
  ("mms", row, off, ln)                     -> (matched, sp, ep, pos)
                                               pos = unc_sa(sp)
  ("mms_ext", row, off, ln, curpos, curgap) -> (matched, sp, ep, wbest)
                                               wbest = genome position
                                               of the first interval
                                               entry within curgap+3 of
                                               curpos (-1 none); needs
                                               fmi.isa_samples
  ("mms_continue", row, off, ln, sp, ep)    -> (matched, sp, ep)
  ("mms_continue_full", row, off, ln, sp, ep) -> dict: the same plus the
                                               final (possibly empty)
                                               interval and pos =
                                               unc_sa(final start)
  ("bsearch", row, off, ln)                 -> dict of backward_search's
                                               results (no N handling) and
                                               pos = unc_sa(final start)
  ("bsearch_ext", row, off, ln, wlo, wwid)  -> the same plus wbest / wrow:
                                               the genome position and the
                                               SA row of the minimal
                                               final-interval row among
                                               positions [wlo, wlo+wwid)
                                               (-1 none); needs
                                               fmi.isa_samples
  ("unc_sa", idx)                           -> position
  ("unc_sa_range", start, end)              -> positions of rows [start, end)
  ("isa_range", plo, phi)                   -> SA rows of positions
                                               [plo, phi), -1 out of range
                                               (phi-plo <= 32)
  ("crank", c, idx)                         -> C[c] + rank(c, idx)
  ("nw", row, roff, rlen, rrev, gstart, glen, grev)
                                            -> (endpos, runs): nw_fast's
                                               endpoint and CIGAR runs in
                                               push order (pre-flip)
  ("sw", row, roff, rlen, rrev, gstart, glen, grev)
                                            -> runs (direct push order)
  ("par", [req, ...])                       -> [reply, ...]: every
                                               sub-request runs in the
                                               same round
Generators finish with ``return value``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex, refuse_wide
from bwt_tpu_torch.ops import dp_wavefront
from bwt_tpu_torch.ops import search
from bwt_tpu_torch.ops import service
from bwt_tpu_torch.ops.service import (  # noqa: F401  (the opcode numbers)
    OP_BEXT, OP_BSEARCH, OP_CONT, OP_CRANK, OP_MEXT, OP_MMS, OP_NONE, OP_UNC)
from bwt_tpu_torch.utils.profiling import span as _span

_OPC = {"mms": OP_MMS, "mms_continue": OP_CONT, "mms_continue_full": OP_CONT,
        "bsearch": OP_BSEARCH, "unc_sa": OP_UNC, "crank": OP_CRANK,
        "mms_ext": OP_MEXT, "bsearch_ext": OP_BEXT}
_EXT_OPS = ("mms_ext", "bsearch_ext")
# opcodes whose reply reads _POS: with ext the round walks only for these
_POS_OPS = ("mms", "mms_continue", "mms_continue_full", "bsearch",
            "bsearch_ext", "unc_sa")

# backtrack runs per DP job returned compactly; jobs with more runs are
# decoded from the raw op row (_ops_to_runs)
_RLE_R = dp_wavefront.RLE_R


def _pow2(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _pad16(n: int, floor: int = 16) -> int:
    return max(floor, -(-n // 16) * 16)


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  To the card through pinned memory and a
    copy that does not wait for the kernels already queued (a copy from
    pageable memory would)."""
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _to_host_async(t: torch.Tensor):
    """Start the copy of a device tensor to the host: (host tensor, event).
    From the card into pinned memory, queued behind the work already on the
    stream, with an event the caller waits on (``event.synchronize()``)
    before reading; a CPU tensor is returned as it is, with no event."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_array(pend) -> np.ndarray:
    """The numpy array of a :func:`_to_host_async` copy, once it is done."""
    host, done = pend
    if done is not None:
        done.synchronize()
    return host.numpy()


def dp_shape(rlen, glen):
    """Padded shape of one DP job: each dim a multiple of 32, floor 32.  The
    one shape grid of every DP path (the executor's rounds,
    :func:`dp_jobs_blocks`, the aligner's phase B)."""
    return (max(32, -(-int(rlen) // 32) * 32),
            max(32, -(-int(glen) // 32) * 32))


def dp_shapes(rlen, glen):
    """:func:`dp_shape` over numpy arrays."""
    rl = np.asarray(rlen, np.int64)
    gl = np.asarray(glen, np.int64)
    return (np.maximum(32, -(-rl // 32) * 32),
            np.maximum(32, -(-gl // 32) * 32))


# --------------------------------------------------------------------------
# The fused service
# --------------------------------------------------------------------------


def _service_core(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx, *,
                  resolve: bool, ext: bool = False, seed_rows=None,
                  seed_k: int = 0, plain: bool = False):
    """One fused round over (B,) int32 lane fields
    (:func:`~bwt_tpu_torch.ops.service.service_round`): on the card one
    launch of the service kernel; on the CPU, or anywhere with ``plain``,
    its plain version.

    ``bank`` (R, Lb) int32 or uint8 patterns; ``opc`` the opcodes; mms /
    mms_continue / mms_ext / bsearch / bsearch_ext lanes search
    ``bank[row, off:off+ln]`` backward (``sp``/``ep`` carry the incoming
    interval for mms_continue, curpos/curgap for mms_ext, the window's
    low end and width for bsearch_ext, ``sp`` carries c for crank);
    ``idx`` is the unc_sa / crank index.  ``resolve`` turns on N handling
    (seqindex.c:317-340) for mms and mms_continue lanes; ``ext`` the
    inverse-SA window scan for the ``_ext`` lanes; ``seed_rows`` /
    ``seed_k`` a seed table that mms and bsearch lanes may start from.
    Every loop lane also gets the unc_sa its caller asks next (mms: of the
    match interval's start; the others: of the final interval's start).

    Returns the 13 result columns (_MMS_M .. _WROW) as (B,) views of the
    round's one packed tensor."""
    return tuple(service.service_round(
        fmi, bank, opc, row, off, ln, sp, ep, idx, resolve=resolve, ext=ext,
        seed_rows=seed_rows, seed_k=seed_k, plain=plain).unbind(0))


(_MMS_M, _CONT_M, _START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS,
 _POS, _CRANK, _WBEST, _WROW) = range(service.NCOLS)

_SEARCH_COLS = (_START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS, _POS)
_SEARCH_KEYS = ("start", "end", "sp", "ep", "nmatched", "alive", "skips",
                "pos")

# per opcode, the result columns its reply reads and, for a dict reply,
# the key of each (a tuple reply takes them in order, a single column is
# the reply itself)
_OP_COLS = {
    "mms": (_MMS_M, _OSP, _OEP, _POS),
    "mms_ext": (_MMS_M, _OSP, _OEP, _WBEST),
    "mms_continue": (_CONT_M, _OSP, _OEP),
    "mms_continue_full": (
        _CONT_M, _OSP, _OEP, _START, _END, _NM, _ALIVE, _POS),
    # a lane without an ext opcode has -1 in both window columns
    "bsearch": _SEARCH_COLS + (_WBEST, _WROW),
    "bsearch_ext": _SEARCH_COLS + (_WBEST, _WROW),
    "unc_sa": (_POS,),
    "crank": (_CRANK,),
}
_OP_KEYS = {
    "mms_continue_full": ("matched", "sp", "ep", "start", "end", "nmatched",
                          "alive", "pos"),
    "bsearch": _SEARCH_KEYS + ("wbest", "wrow"),
    "bsearch_ext": _SEARCH_KEYS + ("wbest", "wrow"),
}


# --------------------------------------------------------------------------
# Batched DP (tail/head/gap stitches)
# --------------------------------------------------------------------------


def _stitch_fn(plain: bool):
    return dp_wavefront.dp_stitch_plain if plain else dp_wavefront.dp_stitch


def _dp_core(bank, genome, row, roff, rlen, rrev, gstart, glen, grev,
             want_nw, *, L1: int, L2: int, scoring=None, plain=False):
    """Batched NW/SW stitch on (B,) int32 job fields
    (:func:`~bwt_tpu_torch.ops.dp_wavefront.dp_stitch`): on the card one
    kernel launch that gathers the slices, fills the DP, takes the nw
    endpoint, walks the pointers back and run-length encodes the ops; on
    the CPU, or anywhere with ``plain``, the plain version over the plain
    fill.  Returns (maxloc, i_resid, j_resid, nrun, vals, counts, ops), the
    first six views of the stitch's one packed tensor; the caller appends
    the I/D residuals (smw.c:99-104)."""
    P, ops = _stitch_fn(plain)(bank, genome, row, roff, rlen, rrev, gstart,
                               glen, grev, want_nw, L1=L1, L2=L2,
                               scoring=scoring)
    return (*dp_wavefront.unpack(P), ops)


_OP_CHARS = ("M", "I", "D")


def _ops_to_runs(ops_row: np.ndarray, i_resid: int, j_resid: int):
    """RLE one backtrack row (walk order) plus the leftover border runs
    (smw.c:99-104): [(op_char, count), ...] in push order."""
    live = ops_row[ops_row != 3]
    runs = []
    if live.size:
        cut = np.flatnonzero(np.diff(live)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [live.size]])
        runs = [(_OP_CHARS[live[s]], int(e - s)) for s, e in zip(starts, ends)]
    if i_resid:
        runs.append(("I", int(i_resid)))
    if j_resid:
        runs.append(("D", int(j_resid)))
    return runs


def dp_jobs_blocks(svc, row, roff, rlen, rrev, gstart, glen, grev,
                   want_nw):
    """Run a flat array of DP jobs (one stitch call per padded shape, as the
    executor's :meth:`BatchExecutor._start_dp` groups them) and return the
    results as arrays, for the aligner's host compose:

      endpos  (J,) int32, the nw endpoint minus 1 (the executor's "nw"
              reply);
      blk_ops (J, W) int8, run ops 0 / 1 / 2 in push order with the I / D
              border residuals appended (smw.c:99-104), -1 padding;
      blk_cnt (J, W) int32, run lengths;
      blk_len (J,) int32, the runs of each job.

    W grows past RLE_R + 2 for the jobs with more runs than the compact
    form holds, which are decoded from their raw op rows."""
    J = len(row)
    bank = svc.bank
    buckets: dict[tuple[int, int], list[int]] = {}
    for j in range(J):
        buckets.setdefault(dp_shape(rlen[j], glen[j]), []).append(j)
    pend = []
    for (L1, L2), members in buckets.items():
        m = np.asarray(members)
        f = np.zeros((8, _pow2(len(m))), np.int32)
        for k, a in enumerate((row, roff, rlen, rrev, gstart, glen, grev,
                               want_nw)):
            f[k, :len(m)] = np.asarray(a)[m]
        small, ops = _stitch_fn(svc.dp_impl == "plain")(
            bank, svc.genome_dev, *torch.from_numpy(f).to(svc.device).unbind(0),
            L1=L1, L2=L2, scoring=svc.scoring)
        pend.append((small.cpu().numpy()[:len(m)], ops, m))

    W = _RLE_R + 2
    for small, _, _ in pend:
        W = max(W, int(small[:, 3].max(initial=0)) + 2)
    endpos = np.zeros(J, np.int32)
    blk_ops = np.full((J, W), -1, np.int8)
    blk_cnt = np.zeros((J, W), np.int32)
    blk_len = np.zeros(J, np.int32)
    t = np.arange(_RLE_R)
    for small, ops_dev, m in pend:
        maxloc, i_res, j_res, nrun, vals, counts = dp_wavefront.unpack(small)
        B = len(m)
        nr = np.minimum(nrun, _RLE_R)
        valid = t[None, :] < nr[:, None]
        bo = np.full((B, W), -1, np.int8)
        bc = np.zeros((B, W), np.int32)
        bo[:, :_RLE_R] = np.where(valid, vals, -1)
        bc[:, :_RLE_R] = np.where(valid, counts, 0)
        rows = np.arange(B)
        has_i = i_res > 0
        bo[rows[has_i], nr[has_i]] = 1
        bc[rows[has_i], nr[has_i]] = i_res[has_i]
        cd = nr + has_i
        has_j = j_res > 0
        bo[rows[has_j], cd[has_j]] = 2
        bc[rows[has_j], cd[has_j]] = j_res[has_j]
        bl = cd + has_j
        over = np.nonzero(nrun > _RLE_R)[0]
        if over.size:
            ops_np = ops_dev.cpu().numpy()
            for k in over:
                runs = _ops_to_runs(ops_np[k], int(i_res[k]), int(j_res[k]))
                bo[k] = -1
                bc[k] = 0
                for q, (oc, cn) in enumerate(runs):
                    bo[k, q] = _OP_CHARS.index(oc)
                    bc[k, q] = cn
                bl[k] = len(runs)
        endpos[m] = maxloc - 1
        blk_ops[m] = bo
        blk_cnt[m] = bc
        blk_len[m] = bl
    return endpos, blk_ops, blk_cnt, blk_len


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------


class _LazyRowViews(list):
    """A list of per-read bank-row views whose elements materialize on
    first access.  add_reads_batch installs one per batch; ``len()``
    answers without materializing (add_reads_batch's empty-bank check and
    add_read's handle only need the count).  Any element access, iteration
    or mutation first fills the list from the (rows, lens, stride)
    source."""

    def __init__(self, rows, lens, stride):
        super().__init__()
        self._src = (rows, lens, stride)

    def _fill(self):
        if self._src is not None:
            rows, lens, stride = self._src
            self._src = None
            super().extend(
                rows[k, : lens[k // stride]] for k in range(rows.shape[0]))
        return self

    def __len__(self):
        if self._src is not None:
            return self._src[0].shape[0]
        return super().__len__()

    def __iter__(self):
        return super(_LazyRowViews, self._fill()).__iter__()

    def __getitem__(self, i):
        return super(_LazyRowViews, self._fill()).__getitem__(i)

    def append(self, x):
        super(_LazyRowViews, self._fill()).append(x)

    def extend(self, xs):
        super(_LazyRowViews, self._fill()).extend(xs)


_SEED_CACHE: dict = {}


def _seed_for(fmi: FMIndex, k: int) -> search.SeedTable:
    """Per-(index, k) seed-table cache, keyed by the buckets tensor's
    identity; the entry holds a strong reference to that tensor so that
    its id cannot be reused while cached.  Bounded (a k = 12 table is
    100 MB): a fifth entry evicts the cache wholesale."""
    key = (id(fmi.buckets), k)
    ent = _SEED_CACHE.get(key)
    if ent is not None and ent[0] is fmi.buckets:
        return ent[1]
    tab = search.build_seed_table(fmi, k=k)
    if len(_SEED_CACHE) >= 4:
        _SEED_CACHE.clear()
    _SEED_CACHE[key] = (fmi.buckets, tab)
    return tab


class QueryService:
    """Device state for executor runs: the FM-index, the genome codes
    (for nw/sw requests) and the per-run pattern bank, all on the
    index's device.

    ``dp_impl`` = "kernel" (default) runs each bucket of DP stitches as
    one launch of the stitch kernel on a card (its plain version on the
    CPU); "plain" forces the plain version on any device, to compare the
    two.  ``svc_impl`` does the same for the fused service round and the
    service kernel.  The bank is uploaded once, as the (R, Lb) uint8 codes
    that the service kernel and the automaton read (``bank8``); its int32
    copy (``bank``) is made at first need, by the DP stitch or the plain
    service."""

    def __init__(self, fmi: FMIndex, genome=None, config=None):
        from bwt_tpu_torch.config import DEFAULT

        refuse_wide(fmi, "QueryService")
        self.fmi = fmi
        self.config = config or DEFAULT
        self.device = fmi.device
        self.scoring = self.config.dp_scoring
        if genome is None:
            self.genome_dev = None
        elif isinstance(genome, torch.Tensor):
            self.genome_dev = genome.to(device=self.device, dtype=torch.int32)
        else:
            self.genome_dev = torch.from_numpy(
                np.asarray(genome, np.uint8)).to(self.device).to(torch.int32)
        self._reads: list[np.ndarray] = []
        self._has_n = False
        self.bank8 = None  # (R, Lb) uint8 on the device, once built
        self._bank32 = None
        self._seed = None
        self.dp_impl = "kernel"
        self.svc_impl = "kernel"
        self.last_stats: dict = {}  # the last run's counters

    @property
    def seed(self) -> search.SeedTable | None:
        """The seed table the device automaton's searches start from
        (``config.automaton_seed_k``; None when 0), built at first use and
        cached per (index, k) across services.  On the card at the
        configured k (one launch of the seed-table kernel); on the CPU at
        ``min(k, 6)``, as ``bwt_tpu`` clamps off the TPU.  The table
        changes no result, only the steps a search takes."""
        if self._seed is None and self.config.automaton_seed_k:
            k = self.config.automaton_seed_k
            if not search._on_card(self.fmi):
                k = min(k, 6)  # a 4^12-row build is the card's size
            self._seed = _seed_for(self.fmi, k)
        return self._seed

    @property
    def bank(self) -> torch.Tensor:
        """The bank as (R, Lb) int32 codes on the device, converted from
        ``bank8`` at first need."""
        if self._bank32 is None:
            self._bank32 = self._ensure_bank8().to(torch.int32)
        return self._bank32

    def add_read(self, codes) -> int:
        """Register a read's codes; returns its bank row handle."""
        arr = np.asarray(codes, np.uint8)
        self._reads.append(arr)
        if (arr == 5).any():
            self._has_n = True
        self.bank8 = self._bank32 = None
        return len(self._reads) - 1

    def add_reads_batch(self, codes_list, *, with_revcomp: bool = False):
        """Register a batch of reads at once on an empty bank: read k at
        row base + k, or with ``with_revcomp`` at base + 2k and its reverse
        complement at base + 2k + 1.  ``codes_list`` is a (n, L) code
        matrix or a list of code arrays.  Builds the bank on the host and
        uploads it in one copy; returns (first_row, lengths)."""
        base = len(self._reads)
        if base:
            raise ValueError("add_reads_batch requires an empty bank")
        n = len(codes_list)
        stride = 2 if with_revcomp else 1
        is_mat = isinstance(codes_list, np.ndarray) and codes_list.ndim == 2
        if is_mat:
            Lb = _pad16(max(codes_list.shape[1], 1))
            lens = np.full((n,), codes_list.shape[1], np.int32)
            uniform = n > 0
        else:
            Lb = _pad16(max((len(r) for r in codes_list), default=1))
            lens = np.fromiter((len(r) for r in codes_list), np.int32, n)
            uniform = n > 0 and bool((lens == lens[0]).all())
        mat = np.zeros((_pow2(stride * n), Lb), np.uint8)
        comp = codec._COMPLEMENT
        with _span("A.bank.pack"):
            if uniform:
                fwd = (codes_list.astype(np.uint8, copy=False) if is_mat else
                       np.stack([np.asarray(r, np.uint8)
                                 for r in codes_list]))
                mat[0 : stride * n : stride, : lens[0]] = fwd
                if with_revcomp:
                    mat[1 : 2 * n : 2, : lens[0]] = comp[fwd][:, ::-1]
            else:
                for k, r in enumerate(codes_list):
                    arr = np.asarray(r, np.uint8)
                    mat[stride * k, : len(arr)] = arr
                    if with_revcomp:
                        mat[stride * k + 1, : len(arr)] = comp[arr][::-1]
        rows = mat[: stride * n]
        with _span("A.bank.views"):
            # the per-read row views materialize only if add_read or a
            # rebuild of the bank needs them
            self._reads = _LazyRowViews(rows, lens, stride)
            self._has_n = int(rows.max(initial=0)) == 5
        with _span("A.bank.upload"):
            self.bank8 = _to_device(mat, self.device)
        self._bank32 = None
        return base, lens

    def read_lengths(self) -> np.ndarray:
        """(n_reads,) int32 lengths of the registered reads, without
        materializing a batch's row views."""
        r = self._reads
        if isinstance(r, _LazyRowViews) and r._src is not None:
            return np.asarray(r._src[1], np.int32)
        return np.fromiter((len(x) for x in r), np.int32, len(r))

    def reset_reads(self) -> None:
        """Drop all registered reads."""
        self._reads = []
        self._has_n = False
        self.bank8 = self._bank32 = None

    def _ensure_bank8(self) -> torch.Tensor:
        if self.bank8 is None:
            Lb = _pad16(max((len(r) for r in self._reads), default=1))
            mat = np.zeros((_pow2(len(self._reads)), Lb), np.uint8)
            for k, r in enumerate(self._reads):
                mat[k, : len(r)] = r
            self.bank8 = torch.from_numpy(mat).to(self.device)
        return self.bank8


class BatchExecutor:
    """Runs request-yielding generators to completion; each round of
    pending requests runs as one fused service call (mms, mms_ext,
    mms_continue, mms_continue_full, bsearch, bsearch_ext, unc_sa, crank),
    one flattened unc_sa walk (unc_sa_range), one isa window call
    (isa_range) and one DP call per padded shape (nw, sw).  ``stats``
    counts the rounds and calls, ``svc_launches`` the service kernel's
    launches among them, and clocks the service, the DP and the
    generators."""

    def __init__(self, fmi_or_service: FMIndex | QueryService, genome=None):
        if isinstance(fmi_or_service, QueryService):
            self.svc = fmi_or_service
        else:
            self.svc = QueryService(fmi_or_service, genome)
        self.fmi = self.svc.fmi
        self.stats = {"rounds": 0, "svc_calls": 0, "dp_calls": 0,
                      "rng_calls": 0, "svc_launches": 0, "t_svc": 0.0,
                      "t_dp": 0.0,
                      "t_dp_finish": 0.0,  # the host decode's part of t_dp
                      "t_gen": 0.0}

    def _lanes(self, fields: np.ndarray) -> list[torch.Tensor]:
        """(k, B) host int32 fields -> k device (B,) tensors, one copy."""
        dev = torch.from_numpy(fields).to(self.svc.device)
        return list(dev.unbind(0))

    # -- round executors -------------------------------------------------

    def _start_service(self, items):
        """One upload of the (7, B) lane fields, one service round, one
        copy back of its packed result, whose tail is the walk's flag."""
        t0 = time.perf_counter()
        plain = self.svc.svc_impl == "plain"
        bank = self.svc.bank if plain else self.svc._ensure_bank8()
        f = np.zeros((7, _pow2(len(items))), np.int32)  # opc row off ln sp ep idx
        ext = walk = False
        for k, (_, r) in enumerate(items):
            op = r[0]
            f[0, k] = _OPC[op]
            if op in ("mms", "bsearch"):
                f[1, k], f[2, k], f[3, k] = r[1], r[2], r[3]
            elif op == "unc_sa":
                f[6, k] = r[1]
            elif op == "crank":  # c rides in sp
                f[4, k], f[6, k] = r[1], r[2]
            else:
                # mms_ext: sp = curpos, ep = curgap; bsearch_ext: sp =
                # the window's low end, ep = its width
                f[1:6, k] = r[1:6]
                ext = ext or op in _EXT_OPS
            walk = walk or op in _POS_OPS
        before = service.SERVICE_LAUNCHES
        out = service.service_round_packed(
            self.fmi, bank, *self._lanes(f),
            resolve=self.svc._has_n, ext=ext, walk=walk or not ext,
            plain=plain).cpu().numpy()
        service.service_raise(self.fmi, out)
        self.stats["svc_calls"] += 1
        self.stats["svc_launches"] += service.SERVICE_LAUNCHES - before
        self.stats["t_svc"] += time.perf_counter() - t0
        return items, out[:-2].reshape(service.NCOLS, -1)

    @staticmethod
    def _finish_service(pend) -> dict:
        """Replies from the round's columns, by ``_OP_COLS``: the columns
        go to Python lists once and, per opcode present, to one tuple a
        lane, so that the loop over the items only picks its lane's."""
        items, cols = pend
        n = len(items)
        ops = {r[0] for _, r in items}
        cv = {c: cols[c, :n].tolist() for op in ops for c in _OP_COLS[op]}
        if _ALIVE in cv:
            cv[_ALIVE] = (cols[_ALIVE, :n] != 0).tolist()
        rows = {op: (cv[_OP_COLS[op][0]] if len(_OP_COLS[op]) == 1
                     else list(zip(*(cv[c] for c in _OP_COLS[op]))))
                for op in ops}
        replies = {}
        for k, (i, r) in enumerate(items):
            op = r[0]
            reply = rows[op][k]
            if op in _OP_KEYS:
                reply = dict(zip(_OP_KEYS[op], reply))
                if op != "mms_continue_full":
                    reply["eff_len"] = int(r[3])
            replies[i] = reply
        return replies

    def _start_unc_sa_flat(self, idxs: list[int]) -> np.ndarray:
        arr = np.zeros((1, _pow2(len(idxs))), np.int32)
        arr[0, : len(idxs)] = idxs
        (idx,) = self._lanes(arr)
        return search.unc_sa(self.fmi, idx).cpu().numpy()

    def _start_isa(self, items):
        f = np.zeros((2, _pow2(len(items))), np.int32)
        for k, (_, r) in enumerate(items):
            f[0, k] = r[1]
            f[1, k] = r[2] - r[1]
        out = search.isa_window(self.fmi, *self._lanes(f)).cpu().numpy()
        return items, out

    @staticmethod
    def _finish_isa(pend) -> dict:
        items, out = pend
        return {i: out[k, : max(int(r[2] - r[1]), 0)]
                for k, (i, r) in enumerate(items)}

    def _start_dp(self, items):
        """Group nw/sw requests by padded DP shape; one upload, one stitch
        and one copy back per shape bucket (and the raw op rows when a
        job has more runs than the compact form holds)."""
        t0 = time.perf_counter()
        if self.svc.genome_dev is None:
            raise ValueError(
                "nw/sw requests require a genome-backed QueryService")
        bank = self.svc.bank
        buckets: dict[tuple[int, int], list] = {}
        for i, r in items:
            buckets.setdefault(dp_shape(r[3], r[6]), []).append((i, r))
        pend = []
        for (L1, L2), members in buckets.items():
            f = np.zeros((8, _pow2(len(members))), np.int32)
            for k, (_, r) in enumerate(members):
                f[:7, k] = r[1:8]  # row roff rlen rrev gstart glen grev
                f[7, k] = 1 if r[0] == "nw" else 0
            small, ops = _stitch_fn(self.svc.dp_impl == "plain")(
                bank, self.svc.genome_dev, *self._lanes(f), L1=L1, L2=L2,
                scoring=self.svc.scoring)
            small = small.cpu().numpy()
            ops_np = (ops.cpu().numpy()
                      if small[:, 3].max(initial=0) > _RLE_R else None)
            pend.append((small, ops_np, members))
            self.stats["dp_calls"] += 1
        self.stats["t_dp"] += time.perf_counter() - t0
        return pend

    @staticmethod
    def _finish_dp(pend) -> dict:
        replies = {}
        for small, ops_np, members in pend:
            ml, ir, jr, nr, vl, cl = (a.tolist()
                                      for a in dp_wavefront.unpack(small))
            for k, (i, r) in enumerate(members):
                if nr[k] > _RLE_R:
                    rr = _ops_to_runs(ops_np[k], ir[k], jr[k])
                else:
                    v, c = vl[k], cl[k]
                    rr = [(_OP_CHARS[v[t]], c[t]) for t in range(nr[k])]
                    if ir[k]:
                        rr.append(("I", ir[k]))
                    if jr[k]:
                        rr.append(("D", jr[k]))
                replies[i] = (ml[k] - 1, rr) if r[0] == "nw" else rr
        return replies

    # -- scheduler -------------------------------------------------------

    def run(self, gens: list) -> list:
        """Drive all generators to completion; returns their values."""
        results = [None] * len(gens)
        live: dict[int, object] = {}
        pending: dict[int, tuple] = {}

        def step(i, send_value):
            try:
                pending[i] = gens[i].send(send_value)
                live[i] = gens[i]
            except StopIteration as e:
                results[i] = e.value
                live.pop(i, None)
                pending.pop(i, None)

        for i in range(len(gens)):
            step(i, None)
        while live:
            self.stats["rounds"] += 1
            replies = self._collect_round(self._dispatch_round(list(live),
                                                               pending))
            t0 = time.perf_counter()
            for i, out in replies.items():
                step(i, out)
            self.stats["t_gen"] += time.perf_counter() - t0
        self.svc.last_stats = dict(self.stats)
        return results

    def _dispatch_round(self, ids, pending):
        """Classify the round's requests and run every device call.
        Returns a bundle for :meth:`_collect_round`."""
        svc_items, rng_items, dp_items, isa_items = [], [], [], []
        par_n: dict[int, int] = {}
        flat = []
        for i in ids:
            r = pending[i]
            if r[0] == "par":
                par_n[i] = len(r[1])
                flat.extend(((i, j), sub) for j, sub in enumerate(r[1]))
            else:
                flat.append((i, r))
        for key, r in flat:
            if r[0] in _OPC:
                svc_items.append((key, r))
            elif r[0] == "unc_sa_range":
                rng_items.append((key, r))
            elif r[0] == "isa_range":
                isa_items.append((key, r))
            elif r[0] in ("nw", "sw"):
                dp_items.append((key, r))
            else:
                raise ValueError(f"unknown request op {r[0]!r}")
        svc_pend = self._start_service(svc_items) if svc_items else None
        spans = [(int(r[1]), int(r[2])) for _, r in rng_items]
        flat_idx = [v for s, e in spans for v in range(s, e)]
        rng_out = self._start_unc_sa_flat(flat_idx) if flat_idx else None
        if rng_items:
            self.stats["rng_calls"] += 1
        isa_pend = self._start_isa(isa_items) if isa_items else None
        dp_pend = self._start_dp(dp_items) if dp_items else None
        return (svc_pend, isa_pend, rng_items, spans, rng_out, dp_pend,
                par_n)

    def _collect_round(self, bundle) -> dict:
        """Unpack one round's host results into per-generator replies."""
        svc_pend, isa_pend, rng_items, spans, rng_out, dp_pend, par_n = bundle
        replies: dict = {}
        if svc_pend is not None:
            replies.update(self._finish_service(svc_pend))
        if isa_pend is not None:
            replies.update(self._finish_isa(isa_pend))
        offp = 0
        for (i, _), (s, e) in zip(rng_items, spans):
            replies[i] = rng_out[offp : offp + (e - s)] if e > s \
                else np.zeros((0,), np.int32)
            offp += max(e - s, 0)
        if dp_pend is not None:
            t0 = time.perf_counter()
            replies.update(self._finish_dp(dp_pend))
            dt = time.perf_counter() - t0
            self.stats["t_dp"] += dt
            self.stats["t_dp_finish"] += dt
        for i, n in par_n.items():
            replies[i] = [replies.pop((i, j)) for j in range(n)]
        return replies
