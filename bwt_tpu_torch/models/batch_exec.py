"""Batched coroutine executor: sequential control flow per read, device
work fused into one service call per round.

Each read runs its driver (single_align.c:26-298) as a host generator
that yields FM-index and DP requests.  Every round, the executor collects
one pending request per live generator and runs them together: the
FM-index opcodes as one fused service call (:func:`_service_core`: one
shared lockstep LF loop under per-lane masks, plus the unc_sa walk, the
inverse-SA window and C[c]+rank adjuncts), the DP stitches as one
wavefront fill and backtrack per padded shape
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

from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.ops import dp_wavefront
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.ops import search

# service opcodes (the numbers of bwt_tpu.models.batch_exec)
OP_NONE, OP_MMS, OP_CONT, OP_UNC, OP_CRANK, OP_MEXT = 0, 1, 2, 4, 5, 6
_OPC = {"mms": OP_MMS, "mms_continue": OP_CONT, "unc_sa": OP_UNC,
        "crank": OP_CRANK, "mms_ext": OP_MEXT}

_I32_MAX = 0x7FFFFFFF

# backtrack runs per DP job returned compactly; jobs with more runs are
# decoded from the raw op row (_ops_to_runs)
_RLE_R = dp_wavefront.RLE_R


def _pow2(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _pad16(n: int, floor: int = 16) -> int:
    return max(floor, -(-n // 16) * 16)


def dp_shape(rlen, glen):
    """Padded shape of one DP job: each dim a multiple of 32, floor 32."""
    return (max(32, -(-int(rlen) // 32) * 32),
            max(32, -(-int(glen) // 32) * 32))


# --------------------------------------------------------------------------
# The fused service
# --------------------------------------------------------------------------


def _service_core(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx, *,
                  resolve: bool, ext: bool = False):
    """One fused round over (B,) int32 lane fields.

    ``bank`` (R, Lb) int32 patterns; ``opc`` the opcodes; mms /
    mms_continue / mms_ext lanes search ``bank[row, off:off+ln]``
    backward (``sp``/``ep`` carry the incoming interval for
    mms_continue, curpos/curgap for mms_ext, ``sp`` carries c for
    crank); ``idx`` is the unc_sa / crank index.  ``resolve`` turns on
    N handling (seqindex.c:317-340); ``ext`` the inverse-SA window for
    mms_ext lanes.  Every loop lane also gets the unc_sa its caller asks
    next (mms: of the match interval's start; mms_continue: of the final
    interval's start).

    Returns the 12 result columns (_MMS_M .. _WBEST) as (B,) tensors."""
    B = opc.shape[0]
    Lb = bank.shape[1]
    dev = opc.device
    is_mms = (opc == OP_MMS) | (opc == OP_MEXT)
    is_cont = opc == OP_CONT
    in_loop = is_mms | is_cont
    zeros = torch.zeros_like(opc)

    pats = bank[row.long()]  # (B, Lb)
    pos = torch.arange(Lb, dtype=torch.int32, device=dev)[None, :]
    j_of_p = off[:, None] + ln[:, None] - 1 - pos  # step of column p
    in_read = (j_of_p >= 0) & (j_of_p < ln[:, None])
    if resolve:
        # trailing-N strip for mms lanes: skips = first step with a
        # non-N char (ln when all N), clamped at 0
        nonn = (pats != 5) & in_read
        first_nonn = torch.where(nonn, j_of_p, _I32_MAX).amin(dim=1)
        skips = torch.where(
            is_mms, torch.minimum(first_nonn, ln).clamp(min=0), zeros)
    else:
        skips = zeros
    # steps per lane: mms strips trailing N (min 1); mms_continue has no
    # initial-character step, modelled as ln + 1 steps with step 1 on
    # char ln-1 (single_align.c:31-44)
    eff = torch.where(is_cont, ln + 1,
                      torch.where(is_mms, ln - skips, ln).clamp(min=1))

    def char_at(t):
        ci = (off + eff - 1 - t).clamp(0, Lb - 1).long()
        return pats.gather(1, ci[:, None]).squeeze(1)

    c0 = char_at(0)
    # ln <= 0 is reference UB (pattern[len-1] out of bounds): the search
    # sees 'A' and takes no steps
    c0 = torch.where(is_mms & (ln <= 0), 0, c0)
    if resolve:
        c0 = torch.where(is_mms & (c0 == 5), 0, c0)  # all-N read -> 'A'
    start = torch.where(is_cont, sp, search.take_c(fmi.C, c0))
    end = torch.where(is_cont, ep, search.take_c(fmi.C, c0 + 1))
    alive = end > start
    incoming_empty = is_cont & ~alive
    nmatched = (alive & ~is_cont).to(torch.int32)
    osp, oep = start, end

    steps = int(torch.where(in_loop, eff, 0).max()) if B else 0
    for t in range(1, steps):
        active = alive & (t <= eff - 1) & in_loop
        if not bool(active.any()):
            break
        c = char_at(t)
        if resolve:
            c, ns, ne = search._resolve_step(fmi, c, start, end, in_loop)
        else:
            ns, ne = search._step(fmi, c, start, end)
        ok = ne > ns
        start = torch.where(active, ns, start)
        end = torch.where(active, ne, end)
        upd = active & ok
        osp = torch.where(upd, ns, osp)
        oep = torch.where(upd, ne, oep)
        nmatched = nmatched + upd.to(torch.int32)
        alive = alive & (~active | ok)

    matched_mms = nmatched + skips
    matched_cont = nmatched - incoming_empty.to(torch.int32)
    walk0 = torch.where(opc == OP_UNC, idx,
                        torch.where(opc == OP_MMS, osp,
                                    torch.where(is_cont, start, zeros)))
    if ext:
        W = 32
        m_ext = opc == OP_MEXT
        # |pos + seglen - curpos| <= curgap + 3 as a window over the mms
        # interval [osp, oep) (single_align.c:218-223)
        wlo = torch.where(m_ext, sp - matched_mms - (ep + 3), sp)
        wwid = torch.where(m_ext, (2 * (ep + 3) + 1).clamp(0, W), zeros)
        consumes_pos = (opc == OP_MMS) | is_cont | (opc == OP_UNC)
        pos_out = (search.unc_sa(fmi, walk0) if bool(consumes_pos.any())
                   else zeros)
        rows = search.isa_window(fmi, wlo, wwid, W=W)
        valid = ((rows >= osp[:, None]) & (rows < oep[:, None])
                 & (rows >= 0) & m_ext[:, None])
        # the minimal in-interval row is the first entry the reference's
        # sequential SA-row scan would accept
        j = torch.where(valid, rows, _I32_MAX).argmin(dim=1)
        has = valid.gather(1, j[:, None]).squeeze(1)
        wbest = torch.where(has, wlo + j.to(torch.int32), -1)
    else:
        pos_out = search.unc_sa(fmi, walk0)
        wbest = torch.full_like(opc, -1)

    is_crank = opc == OP_CRANK
    c_arg = torch.where(is_crank, sp, zeros).clamp(0, 4)
    i_arg = torch.where(is_crank, idx, zeros)
    crank = rank_ops.wrap32(
        search.take_c(fmi.C, c_arg).to(torch.int64)
        + rank_ops.rank(fmi.buckets, fmi.endloc, c_arg, i_arg).to(torch.int64))
    return (matched_mms, matched_cont, start, end, osp, oep, nmatched,
            alive.to(torch.int32), skips, pos_out, crank, wbest)


(_MMS_M, _CONT_M, _START, _END, _OSP, _OEP, _NM, _ALIVE, _SKIPS,
 _POS, _CRANK, _WBEST) = range(12)

# result columns each opcode's reply reads
_OP_COLS = {
    "mms": (_MMS_M, _OSP, _OEP, _POS),
    "mms_ext": (_MMS_M, _OSP, _OEP, _WBEST),
    "mms_continue": (_CONT_M, _OSP, _OEP),
    "unc_sa": (_POS,),
    "crank": (_CRANK,),
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


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------


class QueryService:
    """Device state for executor runs: the FM-index, the genome codes
    (for nw/sw requests) and the per-run pattern bank, all on the
    index's device.

    ``dp_impl`` = "kernel" (default) runs each bucket of DP stitches as
    one launch of the stitch kernel on a card (its plain version on the
    CPU); "plain" forces the plain version on any device, to compare the
    two."""

    def __init__(self, fmi: FMIndex, genome=None, config=None):
        from bwt_tpu_torch.config import DEFAULT

        self.fmi = fmi
        self.config = config or DEFAULT
        if self.config.elastic_fallback:
            raise NotImplementedError(
                "config.elastic_fallback is not ported (ROADMAP Queue 1: "
                "multi-device and recovery)")
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
        self.bank = None
        self.dp_impl = "kernel"
        self.last_stats: dict = {}  # the last executor run's counters

    def add_read(self, codes) -> int:
        """Register a read's codes; returns its bank row handle."""
        arr = np.asarray(codes, np.uint8)
        self._reads.append(arr)
        if (arr == 5).any():
            self._has_n = True
        self.bank = None
        return len(self._reads) - 1

    def reset_reads(self) -> None:
        """Drop all registered reads."""
        self._reads = []
        self._has_n = False
        self.bank = None

    def _ensure_bank(self):
        if self.bank is None:
            Lb = _pad16(max((len(r) for r in self._reads), default=1))
            mat = np.zeros((_pow2(len(self._reads)), Lb), np.uint8)
            for k, r in enumerate(self._reads):
                mat[k, : len(r)] = r
            self.bank = torch.from_numpy(mat).to(self.device).to(torch.int32)
        return self.bank


class BatchExecutor:
    """Runs request-yielding generators to completion; each round of
    pending requests runs as one fused service call, one flattened
    unc_sa walk, one isa window call and one DP call per padded shape."""

    def __init__(self, fmi_or_service: FMIndex | QueryService, genome=None):
        if isinstance(fmi_or_service, QueryService):
            self.svc = fmi_or_service
        else:
            self.svc = QueryService(fmi_or_service, genome)
        self.fmi = self.svc.fmi
        self.stats = {"rounds": 0, "svc_calls": 0, "dp_calls": 0,
                      "rng_calls": 0, "t_svc": 0.0, "t_dp": 0.0,
                      "t_dp_finish": 0.0,  # the host decode's part of t_dp
                      "t_gen": 0.0, "dp_shapes": {}}  # "L1xL2" -> jobs

    def _lanes(self, fields: np.ndarray) -> list[torch.Tensor]:
        """(k, B) host int32 fields -> k device (B,) tensors, one copy."""
        dev = torch.from_numpy(fields).to(self.svc.device)
        return list(dev.unbind(0))

    # -- round executors -------------------------------------------------

    def _start_service(self, items):
        t0 = time.perf_counter()
        bank = self.svc._ensure_bank()
        f = np.zeros((7, _pow2(len(items))), np.int32)  # opc row off ln sp ep idx
        ext = False
        for k, (_, r) in enumerate(items):
            op = r[0]
            f[0, k] = _OPC[op]
            if op == "mms":
                f[1, k], f[2, k], f[3, k] = r[1], r[2], r[3]
            elif op in ("mms_continue", "mms_ext"):
                # mms_ext: sp = curpos, ep = curgap
                f[1:6, k] = r[1:6]
                ext = ext or op == "mms_ext"
            elif op == "unc_sa":
                f[6, k] = r[1]
            else:  # crank: c rides in sp
                f[4, k], f[6, k] = r[1], r[2]
        out = _service_core(self.fmi, bank, *self._lanes(f),
                            resolve=self.svc._has_n, ext=ext)
        needed = sorted({c for _, r in items for c in _OP_COLS[r[0]]})
        host = torch.stack([out[c] for c in needed]).cpu().numpy()
        self.stats["svc_calls"] += 1
        self.stats["t_svc"] += time.perf_counter() - t0
        return items, dict(zip(needed, host))

    @staticmethod
    def _finish_service(pend) -> dict:
        items, cols = pend
        n = len(items)
        cv = {c: a[:n].tolist() for c, a in cols.items()}
        replies = {}
        for k, (i, r) in enumerate(items):
            op = r[0]
            if op == "mms":
                replies[i] = (cv[_MMS_M][k], cv[_OSP][k], cv[_OEP][k],
                              cv[_POS][k])
            elif op == "mms_ext":
                replies[i] = (cv[_MMS_M][k], cv[_OSP][k], cv[_OEP][k],
                              cv[_WBEST][k])
            elif op == "mms_continue":
                replies[i] = (cv[_CONT_M][k], cv[_OSP][k], cv[_OEP][k])
            elif op == "unc_sa":
                replies[i] = cv[_POS][k]
            else:
                replies[i] = cv[_CRANK][k]
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
        bank = self.svc._ensure_bank()
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
            shapes = self.stats["dp_shapes"]
            shapes[f"{L1}x{L2}"] = shapes.get(f"{L1}x{L2}", 0) + len(members)
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
