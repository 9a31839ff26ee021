"""Anchored seed-and-extend alignment — the single_align.c drivers.

Per-read semantics follow the reference (``align_read_anchored``
single_align.c:163-298, ``mms_mismatch`` :50-160, ``align_read``
:300-358): retry budgets, proximity tolerances, stack resets and the
head-alignment return-value quirk (the final head block returns
``curpos - len``, the in-loop one ``curpos - x``, single_align.c:271 vs
:297).  Two engines with equal results.  The device engine (``engine="device"``,
the default on an index with ``isa_samples``) runs each chunk of reads as
one launch of the aligner automaton (K10, :mod:`bwt_tpu_torch.ops.automaton`,
phase A), which records every read's DP stitches in a log on the device,
then replays the logs there (phase B): one launch of the log stitch (K11a)
a DP shape bucket and one of the compose (K11b,
:mod:`bwt_tpu_torch.ops.compose`) a chunk, and one copy of the composed
runs to the host.  The host engine runs each read's control flow as a host
generator; FM-index queries and DP stitches run batched across reads, one
fused call per round, through
:class:`~bwt_tpu_torch.models.batch_exec.BatchExecutor`.  It is also the
device engine's escape for the rare reads it cannot finish.

Deviations from the reference, all where C is undefined:
  * ``nmisses`` is read before it is written when the read is no
    longer than the anchor (single_align.c:166); it is 0 here, and the
    result is 0 either way.
  * ``mms_continue`` on a pattern containing N indexes ``C[5]`` in C;
    here N resolves as in ``mms``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.models.batch_exec import (
    _OP_CHARS, BatchExecutor, QueryService, _host_array, _to_device,
    _to_host_async, dp_jobs_blocks)
from bwt_tpu_torch.ops import automaton as au
from bwt_tpu_torch.ops import compose as cmp
from bwt_tpu_torch.ops import dp_wavefront as dpw
from bwt_tpu_torch.utils.cigar import Cigar
from bwt_tpu_torch.utils.profiling import span as _span

DEFAULT_ANCHOR_LEN = 12  # single_align.c:483

# Candidate-interval scans fetch unc_sa_range in geometrically growing
# chunks: the reference scans sequentially and almost always stops within
# the first few entries (single_align.c:218-223).
CAND_CHUNK = 32

_OPC_BYTES = np.frombuffer("".join(_OP_CHARS).encode(), np.uint8)
_RUNS_RE = None  # compiled at first use


class _RenderedCigar(Cigar):
    """A Cigar whose render string was built vectorized (numpy over the
    compose's ops and counts) instead of from a per-read ops list.  ``ops``
    is parsed from the string at first access, which drops the string
    (``_render`` None); from then on it behaves as a plain Cigar (render
    recomputes from ops, so a mutation stays coherent).  Until then render
    and truth read the string, without an exception to catch."""

    __slots__ = ("_render",)

    def __getattr__(self, name):  # only while the ops slot is unset
        if name == "ops":
            global _RUNS_RE
            if _RUNS_RE is None:
                import re

                _RUNS_RE = re.compile(r"(\d+)(\D)")
            # render order is top-first, the reverse of ops
            ops = [[op, int(cnt)]
                   for cnt, op in _RUNS_RE.findall(self._render)][::-1]
            self.ops = ops
            self._render = None
            return ops
        raise AttributeError(name)

    def render(self) -> str:
        r = self._render
        return super().render() if r is None else r

    def __bool__(self) -> bool:
        r = self._render
        return super().__bool__() if r is None else bool(r)


def _yield_nw(row, roff, rlen, rrev, gstart, glen, grev, s: Cigar):
    """nw_fast through the batched DP service (smw.c:26-111); a
    zero-length read returns 0 (smw.c:28-30); runs flip onto ``s``."""
    if rlen == 0:
        return 0
    endpos, runs = yield ("nw", row, roff, rlen, rrev, gstart, max(glen, 0),
                          grev)
    tmp = Cigar()
    for op, count in runs:
        tmp.push(op, count)
    tmp.flip_onto(s)
    return endpos


def _yield_sw(row, roff, rlen, rrev, gstart, glen, grev, s: Cigar):
    """sw_fast through the batched DP service (smw.c:117-200): both ends
    pinned, runs pushed directly."""
    runs = yield ("sw", row, roff, rlen, rrev, gstart, max(glen, 0), grev)
    for op, count in runs:
        s.push(op, count)


def mms_mismatch_gen(genome: np.ndarray, row: int, length: int, sp: int,
                     ep: int):
    """Hypothesis search at an MMS break (single_align.c:50-160):
    substitution, 1-3 nt genome insertion, 1-3 nt genome deletion, each
    checked by re-running mms_continue.  Returns (best_align, sp', ep',
    genomeskips); genomeskips is None when the reference leaves its
    out-parameter untouched."""
    if length < 2:  # single_align.c:54-61
        loc = yield ("unc_sa", sp)
        sub_c = int(genome[max(loc - 1, 0)])
        nsp = yield ("crank", sub_c, sp)
        return 1, nsp, nsp + 1, 0

    best_align = 0
    best_pos = -1
    genomeskips = None
    for i in range(sp, ep):
        # 1) substitution: LF-step the genome char before this match
        loc = yield ("unc_sa", i)
        sub_c = int(genome[max(loc - 1, 0)])
        sub_idx = yield ("crank", sub_c, i)
        ins_idx = sub_idx
        sub_align, sub_idx, sub_end = yield (
            "mms_continue", row, 0, length - 1, sub_idx, sub_idx + 1)
        sub_align += 1
        best_align = sub_align
        best_pos = sub_idx
        if sub_align > 6 or sub_align == length:
            genomeskips = 0
            break

        # 1.5) genome insertion of 1..3 nt.  The reference reuses
        # ins_end across the three attempts without resetting it
        # (single_align.c:89-119); the stale end is kept.
        bleh = ins_idx
        ins_end = ins_idx + 1
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end)
        if ins_align > 5 or ins_align == length:
            best_align, best_pos, genomeskips = sub_align, sub_idx, 1
            break

        sub_c = int(genome[max(loc - 2, 0)])
        ins_idx = yield ("crank", sub_c, bleh)
        blah = ins_idx
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end)
        if ins_align > 5 or ins_align == length:
            best_align, best_pos, genomeskips = sub_align, sub_idx, 2
            break

        sub_c = int(genome[max(loc - 3, 0)])
        ins_idx = yield ("crank", sub_c, blah)
        ins_align, ins_idx, ins_end = yield (
            "mms_continue", row, 0, length, ins_idx, ins_end)
        if ins_align > 5 or ins_align == length:
            best_align, best_pos, genomeskips = sub_align, sub_idx, 3
            break

        # 2) genome deletion of 1..3 nt: drop pattern chars, same spot
        for skip, thresh in ((1, 6), (2, 7), (3, 8)):
            del_align, del_idx, _ = yield (
                "mms_continue", row, 0, length - skip, i, i + 1)
            del_align += skip
            if del_align > thresh or del_align == length:
                best_align, best_pos, genomeskips = del_align, del_idx, -skip
                break
        else:
            continue
        break

    return best_align, best_pos, best_pos + 1, genomeskips


def align_read_anchored_gen(genome: np.ndarray, glen: int, row: int,
                            length: int, anchor_len: int, s: Cigar,
                            use_isa: bool = False, spec: int = 1,
                            isa_spec: int = 9):
    """Anchor in the read tail, NW-stitch the tail, chain backward via
    proximity-checked MMS segments with SW gap fills, NW-align the head
    (single_align.c:163-298).  Returns the 0-based genome position of
    the read start, or 0 for unaligned.

    ``use_isa`` answers the backward-extension proximity scan with one
    inverse-SA window query (the service's mms_ext) instead of walking
    unc_sa over the interval: the same result in O(window).  ``spec`` /
    ``isa_spec`` issue that many deterministic retries per round ("par");
    replies are consumed in the sequential loop's order, so the output
    is the same at any depth."""
    olen = length
    anchmisses = length // 10
    nmisses = 0  # C: uninitialized (see module docstring)
    curpos = -1
    anchlen = 0
    ln = length

    while ln > anchor_len and anchmisses > 0:
        nmisses = 0
        while ln > anchor_len and anchmisses > 0:
            lns, l, a = [], ln, anchmisses
            while l > anchor_len and a > 0 and len(lns) < spec:
                lns.append(l)
                l -= 3
                a -= 1
            if len(lns) == 1:
                replies = [(yield ("mms", row, 0, ln))]
            else:
                replies = yield ("par", [("mms", row, 0, x) for x in lns])
            hit = None
            for rep in replies:
                seglen, sp, ep, pos = rep
                if seglen < anchor_len or ep - sp > 1:
                    anchmisses -= 1
                    ln -= 3
                    continue
                hit = rep
                break
            if hit is None:
                continue
            seglen, sp, ep, pos = hit
            ln -= seglen
            anchlen = seglen
            nmisses = olen // 5
            curpos = pos
            # NW-stitch the tail beyond the anchor (single_align.c:190-203)
            buflen = 10 + (olen - (ln + seglen))
            if buflen + curpos + seglen > glen:
                buflen = glen - curpos - seglen
            yield from _yield_nw(row, ln + seglen, olen - (ln + seglen), 0,
                                 curpos + seglen, buflen, 0, s)
            s.push("M", seglen)
            break

        if nmisses < 1:
            continue

        # backward extension (single_align.c:212-255)
        while ln > nmisses and ln > 4 and nmisses > 0:
            if use_isa:
                curgap = 10
                g0 = 1
                while g0 < 10 and curgap == 10:
                    chunk = list(range(g0, min(g0 + max(isa_spec, 1), 10)))
                    g0 = chunk[-1] + 1
                    if len(chunk) == 1:
                        replies = [(yield ("mms_ext", row, 0, ln - chunk[0],
                                           curpos, chunk[0]))]
                    else:
                        replies = yield ("par", [
                            ("mms_ext", row, 0, ln - g, curpos, g)
                            for g in chunk])
                    for g, (seglen, start, end, wbest) in zip(chunk,
                                                              replies):
                        if (start >= end or wbest < 0
                                or abs(wbest + seglen - curpos) - g > 3):
                            continue
                        nmisses -= g
                        pos_k = wbest
                        buflen = curpos - (pos_k + seglen)
                        if buflen < 0:
                            s.push("I", -buflen)
                        else:
                            # ln - curgap can go negative; the reference's
                            # pointer arithmetic is UB there
                            # (single_align.c:231) and the Python slice
                            # semantics (wrap to the read's tail) are the
                            # defined behaviour
                            st = ln - g
                            if st < 0:
                                st += length
                            yield from _yield_sw(row, st, max(ln - st, 0), 0,
                                                 pos_k + seglen, buflen, 0, s)
                        s.push("M", seglen)
                        curpos = pos_k
                        ln -= seglen + g
                        curgap = 0
                        break
                if curgap:
                    nmisses = 0
                continue

            curgap = 1
            matched = False
            while curgap < 10:
                seglen, start, end, _pos = yield ("mms", row, 0, ln - curgap)
                base, w = start, CAND_CHUNK
                while base < end and not matched:
                    hi = min(end, base + w)
                    poss = yield ("unc_sa_range", base, hi)
                    base, w = hi, w * 4
                    for pos_k in (int(x) for x in poss):
                        if abs(pos_k + seglen - curpos) - curgap <= 3:
                            nmisses -= curgap
                            matched = True
                            buflen = curpos - (pos_k + seglen)
                            if buflen < 0:
                                s.push("I", -buflen)
                            else:
                                # see the UB note on the isa path above
                                st = ln - curgap
                                if st < 0:
                                    st += length
                                yield from _yield_sw(
                                    row, st, max(ln - st, 0), 0,
                                    pos_k + seglen, buflen, 0, s)
                            s.push("M", seglen)
                            curpos = pos_k
                            ln -= seglen + curgap
                            curgap = 0
                            break
                if matched:
                    break
                curgap += 1
            if curgap:
                nmisses = 0

        if nmisses > 0:
            # head alignment, reversed strings (single_align.c:256-272)
            buflen = min(ln + 10, curpos)
            x = yield from _yield_nw(row, 0, ln, 1, curpos - buflen, buflen,
                                     1, s)
            return curpos - x

        ln -= anchlen
        anchmisses -= anchlen // 10
        s.reset()

    if ln > nmisses or nmisses < 1:
        return 0

    buflen = min(ln + 10, curpos)
    yield from _yield_nw(row, 0, ln, 1, curpos - buflen, buflen, 1, s)
    return curpos - ln  # quirk: ignores the NW endpoint (single_align.c:297)


def align_read_gen(genome: np.ndarray, row: int, length: int, thresh: int):
    """Chain up to 10 MMS segments (with mms_mismatch recovery); accept
    if the segments lie within 6 nt of each other and cover 2/3 of the
    read (single_align.c:300-358).  Returns the 0-based position or 0."""
    starts = [0] * 10
    lens = [0] * 10
    nmisses = length // 10
    olen = length
    ln = length
    nsegments = 0
    while nsegments < 10:
        if ln < 10:
            break
        seglen, start, end, _pos = yield ("mms", row, 0, ln)
        if seglen < thresh:
            mlen, start, end, _skips = yield from mms_mismatch_gen(
                genome, row, ln - seglen, start, end)
            if mlen + seglen > 2 * thresh:
                ln -= seglen + mlen + 3
                starts[nsegments] = start
                lens[nsegments] = seglen + mlen
                nsegments += 1
                continue
            nmisses -= 1
            if nmisses + 1 == 0:
                return 0
            ln -= 3
            nsegments -= 1
            if nsegments > -1:
                starts[nsegments] -= 3
                lens[nsegments] += 3
            nsegments += 1
            continue
        if (ln - seglen == 0) or ((ln - seglen > 10) and end - start == 1):
            starts[nsegments] = start
            lens[nsegments] = seglen
            ln -= seglen + 3
            nsegments += 1
            continue
        mlen, start, end, _skips = yield from mms_mismatch_gen(
            genome, row, ln - seglen, start, end)
        ln -= seglen + mlen + 3
        starts[nsegments] = start
        lens[nsegments] = seglen + mlen
        nsegments += 1

    totlen = lens[0]
    if nsegments == 10:
        return 0
    for i in range(nsegments - 1):
        p1 = yield ("unc_sa", starts[i + 1])
        p0 = yield ("unc_sa", starts[i])
        if abs(p1 + lens[i + 1] - p0) < 7:
            totlen += lens[i + 1]
        else:
            return 0
    if 3 * totlen > 2 * olen:
        pos = yield ("unc_sa", starts[nsegments - 1])
        return pos - ln
    return 0


def _read_gen(genome, glen, fwd_row, fwd_len, rev_row, rev_len, anchor_len,
              use_isa=False, spec=1, isa_spec=9):
    """One read's single_align flow: forward, then reverse complement
    (single_align.c:483-503).  Returns (position, Cigar, reverse) with
    the 1-based position (0 = unaligned)."""
    s = Cigar()
    pos = yield from align_read_anchored_gen(
        genome, glen, fwd_row, fwd_len, anchor_len, s, use_isa, spec,
        isa_spec)
    if pos:
        return pos + 1, s, False
    s = Cigar()
    pos = yield from align_read_anchored_gen(
        genome, glen, rev_row, rev_len, anchor_len, s, use_isa, spec,
        isa_spec)
    if pos:
        return pos + 1, s, True
    return 0, None, False


def _as_genome_codes(genome) -> np.ndarray:
    if isinstance(genome, (str, bytes)):
        return codec.encode_genome(genome)
    return np.asarray(genome, np.uint8)


def _align_reads_host(fmi, genome, glen, codes_list, anchor_len, cfg, svc):
    """The host-generator engine: one generator per read, batched by
    :class:`BatchExecutor`."""
    svc.reset_reads()
    gens = []
    for fwd in codes_list:
        rev = codec.revcomp(fwd)
        fr = svc.add_read(fwd)
        rr = svc.add_read(rev)
        gens.append(_read_gen(genome, glen, fr, len(fwd), rr, len(rev),
                              anchor_len, fmi.isa_samples is not None,
                              cfg.spec_depth, cfg.isa_spec_depth))
    return BatchExecutor(svc).run(gens)


# --------------------------------------------------------------------------
# The device engine: phase A (the automaton), phase B (the log replay)
# --------------------------------------------------------------------------
#
# Reads are registered as one bank a chunk, read k's strands at rows 2k and
# 2k + 1.  Phase A is one automaton launch (K10); right behind it on the
# stream, phase B's job bucketing (a sort of the log's stitch slots by DP
# shape) and one copy to the host of the bucket counts and the walk's flag.
# Phase B waits for those counts, then launches the log stitch (K11a) once a
# non-empty bucket and the compose (K11b) once, and copies the composed
# runs back.  Reads the device cannot finish escape: a run-width overflow
# is re-composed on the host from its log (the redo path), a truncated log,
# a read live at the iteration cap or a head stitch that lands on 0 (the
# strand-retry quirk, single_align.c:271) re-runs on the host engine.

# test hooks: a nonzero cap overrides the automaton's (to force the capped
# reads' escape); the compose's merged-run width (lowered to force redos)
_TEST_CAP = 0
_RUNS_K = cmp.RUNS_K

# the DP shape grid of phase B's buckets: dp_shape's (a stitch's result does
# not depend on its padding)
_DP_GRAN = 32


def _assemble_logs(svc, n, mode, curpos, strand, lp, ovf, kinds, roffs,
                   rlens, glens, gstarts, capped=None, lanes=None):
    """Phase B on the host, from logs fetched as numpy arrays: every log's
    DP jobs through :func:`~bwt_tpu_torch.models.batch_exec.dp_jobs_blocks`,
    then each read's CIGAR composed in numpy: NW and head blocks reversed
    (the Cigar flip, smw.c:99-111, stack.c:51-59), M / I pushes in log
    order, one adjacent-equal-op merge (push merging is associative over
    adjacency, so one merge at the end equals the generator's nested ones).

    Returns (results, fallback): results[k] = (pos, Cigar, rev) or (0, None,
    False), None for the reads that need the host engine (a truncated log,
    a read capped mid-flight, a head on 0).  ``lanes`` gives each row's lane
    in the bank when the arrays are a subset of a chunk (the redo path)."""
    mode, curpos, strand, lp = (np.asarray(x)[:n]
                                for x in (mode, curpos, strand, lp))
    ovf = np.asarray(ovf)[:n].astype(bool)
    if capped is not None:
        ovf = ovf | np.asarray(capped)[:n].astype(bool)
    kinds, roffs, rlens, glens, gstarts = (
        np.asarray(x)[:n] for x in (kinds, roffs, rlens, glens, gstarts))
    slot = np.arange(au.LOGN)[None, :]
    active = (mode != 0) & ~ovf
    vmask = active[:, None] & (slot < np.minimum(lp, au.LOGN)[:, None])
    jobmask = vmask & ((kinds == au.K_NW) | (kinds == au.K_SW)
                       | (kinds == au.K_HEAD))
    jk, jt = np.nonzero(jobmask)  # row-major: each read's log order
    head_end = np.zeros(n, np.int64)
    if jk.size:
        jkind = kinds[jk, jt]
        is_head = jkind == au.K_HEAD
        is_sw = jkind == au.K_SW
        jlane = jk if lanes is None else np.asarray(lanes)[jk]
        endpos, blk_ops, blk_cnt, blk_len = dp_jobs_blocks(
            svc, (2 * jlane + strand[jk]).astype(np.int32),
            roffs[jk, jt].astype(np.int32), rlens[jk, jt].astype(np.int32),
            is_head.astype(np.int32), gstarts[jk, jt].astype(np.int32),
            glens[jk, jt].astype(np.int32), is_head.astype(np.int32),
            (~is_sw).astype(np.int32))
        # the Cigar flip: NW and head blocks are consumed top-first
        Wb = blk_ops.shape[1]
        tb = np.arange(Wb)[None, :]
        nwj = np.nonzero(~is_sw)[0]
        if nwj.size:
            bl = blk_len[nwj][:, None]
            idx = np.where(tb < bl, np.maximum(bl - 1 - tb, 0), tb)
            blk_ops[nwj] = np.take_along_axis(blk_ops[nwj], idx, 1)
            blk_cnt[nwj] = np.take_along_axis(blk_cnt[nwj], idx, 1)
        head_end[jk[is_head]] = endpos[is_head]
    else:
        Wb = 1
        blk_ops = np.zeros((0, 1), np.int8)
        blk_cnt = np.zeros((0, 1), np.int32)

    # (read, slot, run) -> one run stream a read, in log order
    big_o = np.full((n, au.LOGN, Wb), -1, np.int8)
    big_c = np.zeros((n, au.LOGN, Wb), np.int64)
    mm = vmask & (kinds == au.K_M)
    im = vmask & (kinds == au.K_I)
    big_o[..., 0] = np.where(mm, 0, np.where(im, 1, -1))
    big_c[..., 0] = np.where(mm | im, glens, 0)
    if jk.size:
        big_o[jk, jt] = blk_ops
        big_c[jk, jt] = blk_cnt
    flat_o = big_o.reshape(n, -1)
    flat_c = big_c.reshape(n, -1)
    keep = flat_o >= 0  # count-0 runs stay: the C stack prints "0M"
    read_of = np.broadcast_to(np.arange(n)[:, None], flat_o.shape)[keep]
    so = flat_o[keep]
    sc = flat_c[keep]
    if so.size:
        new = np.empty(so.size, bool)
        new[0] = True
        new[1:] = (so[1:] != so[:-1]) | (read_of[1:] != read_of[:-1])
        rid = np.cumsum(new) - 1
        csum = np.bincount(rid, weights=sc).astype(np.int64).tolist()
        rops = so[new].tolist()
        bounds = np.searchsorted(read_of[new], np.arange(n + 1))
    else:
        csum, rops, bounds = [], [], np.zeros(n + 1, np.int64)

    res = np.where(mode == 2, curpos,
                   np.where(mode == 1, curpos - head_end, 0))
    results: list = [None] * n
    fallback: list[int] = []
    for k, (m, r, st) in enumerate(zip(mode.tolist(), res.tolist(),
                                       strand.tolist())):
        if ovf[k]:
            fallback.append(k)
        elif m == 0:
            results[k] = (0, None, False)
        elif r == 0:
            fallback.append(k)  # a head on 0: the strand-retry quirk
        else:
            c = Cigar()
            c.ops = [[_OP_CHARS[rops[q]], csum[q]]
                     for q in range(bounds[k], bounds[k + 1])]
            results[k] = (r + 1, c, st == 1)
    return results, fallback


def _job_bucket_sort(mode, lp, ovf, kinds, rlens, glens, *, NB: int,
                     NL2: int):
    """Phase B's DP-shape bucketing of a chunk's log, on the log's device:
    (order, counts), ``order`` the flat job ids (lane * LOGN + slot) sorted
    by bucket (slots that are no job last), ``counts[b]`` bucket b's jobs.
    Bucket b = (l1 - 1) * NL2 + (l2 - 1), l1 and l2 the read and genome
    lengths in granules of ``_DP_GRAN``."""
    dev = kinds.device
    slot = torch.arange(au.LOGN, device=dev)[None, :]
    vmask = ((mode != 0) & (ovf == 0))[:, None] & (
        slot < lp.clamp(max=au.LOGN)[:, None])
    isjob = vmask & ((kinds == au.K_NW) | (kinds == au.K_SW)
                     | (kinds == au.K_HEAD))
    l1 = (-torch.div(-rlens, _DP_GRAN, rounding_mode="floor")).clamp(min=1)
    l2 = (-torch.div(-glens, _DP_GRAN, rounding_mode="floor")).clamp(min=1)
    bid = torch.where(isjob, (l1 - 1) * NL2 + (l2 - 1), NB).reshape(-1)
    order = torch.sort(bid.to(torch.int64), stable=True).indices
    # index_add_, not bincount: bincount reads its input's maximum back to
    # the host, a synchronisation in the middle of the queued work
    counts = torch.zeros(NB + 1, dtype=torch.int32, device=dev).index_add_(
        0, bid.to(torch.int64), torch.ones_like(bid, dtype=torch.int32))
    return order.to(torch.int32), counts[:NB]


def _bucket_ids(order, offset: int, count: int):
    """One bucket's (lane, slot) job lists, (count,) int32 each."""
    ids = order[offset:offset + count]
    return (torch.div(ids, au.LOGN, rounding_mode="floor").contiguous(),
            (ids % au.LOGN).contiguous())


class _Chunk:
    """One chunk of the device engine on its way through the pipeline."""

    __slots__ = ("svc", "sub", "log", "order", "NL2", "small", "comp",
                 "stats")

    def __init__(self, svc, sub, log, order, NL2, small, stats):
        self.svc, self.sub, self.log, self.order = svc, sub, log, order
        self.NL2, self.small, self.stats = NL2, small, stats
        self.comp = None


def _align_chunk_dispatch(fmi, glen, codes_list, anchor_len, resolve, svc,
                          seed, stats) -> _Chunk:
    """Phase A of one chunk: register the reads as one bank, launch the
    automaton and, behind it, the job bucketing and the copy back of the
    bucket counts and the walk's flag; nothing waits for the device."""
    n = len(codes_list)
    dev = fmi.device
    svc.reset_reads()
    with _span("A.bank_build"):
        _base, rl = svc.add_reads_batch(codes_list, with_revcomp=True)
    bank8 = svc.bank8
    Bp, Lb = bank8.shape[0] // 2, bank8.shape[1]
    lens = np.zeros(Bp, np.int32)
    lens[:n] = rl
    live0 = torch.arange(Bp, device=dev) < n
    before = au.ALIGN_LAUNCHES
    with _span("A.launch"):
        log = au.align_automaton_packed(
            fmi, bank8, _to_device(lens, dev), live0, glen,
            None if seed is None else seed.rows, anchor_len=anchor_len,
            resolve=svc._has_n if resolve is None else resolve,
            cap_steps=_TEST_CAP, seed_k=0 if seed is None else seed.k,
            plain=svc.svc_impl == "plain")
    stats["align_launches"] += au.ALIGN_LAUNCHES - before
    stats["chunks"] += 1
    v = au.align_unpack(log)
    NL1 = -(-Lb // _DP_GRAN)
    NL2 = -(-(Lb + 10) // _DP_GRAN)  # a stitch's genome span <= Lb + 10
    with _span("B.bucket_sort+counts"):
        order, counts = _job_bucket_sort(v["mode"], v["lp"], v["ovf"],
                                         v["kinds"], v["rlens"], v["glens"],
                                         NB=NL1 * NL2, NL2=NL2)
        small = _to_host_async(torch.cat([counts, log[-4:]]))
    return _Chunk(svc, codes_list, log, order, NL2, small, stats)


def _assemble_dispatch(fmi, c: _Chunk) -> None:
    """The device half of phase B: wait for the chunk's bucket counts (and
    raise what the walk's flag says), launch the log stitch once a
    non-empty bucket and the compose once, and start the copy of the
    composed rows back."""
    svc, stats = c.svc, c.stats
    small = _host_array(c.small)
    counts, flag = small[:-4], small[-4:]
    au.align_automaton_raise(fmi, c.log, flag)
    Bp = au.align_lanes(c.log)
    with _span("B.prep_zeros"):
        acc = dpw.log_acc(Bp, fmi.device)
    plain = svc.dp_impl == "plain"
    bank = svc.bank
    offs = np.concatenate([[0], np.cumsum(counts)])
    before = dpw.LOG_STITCH_LAUNCHES, cmp.COMPOSE_LAUNCHES
    with _span("B.dp_buckets"):
        for b in np.nonzero(counts)[0].tolist():
            l1, l2 = divmod(b, c.NL2)
            L1, L2 = _DP_GRAN * (l1 + 1), _DP_GRAN * (l2 + 1)
            with _span(f"B.dp_bucket_{L1}x{L2}_J{counts[b]}"):
                jk, jt = _bucket_ids(c.order, int(offs[b]), int(counts[b]))
                dpw.dp_log_stitch(c.log, bank, svc.genome_dev, jk, jt, acc,
                                  L1=L1, L2=L2, scoring=svc.scoring,
                                  plain=plain)
            stats["buckets"] += 1
    with _span("B.compose_dispatch"):
        c.comp = _to_host_async(cmp.compose(c.log, acc, K=_RUNS_K,
                                            plain=plain))
    stats["log_stitch_launches"] += dpw.LOG_STITCH_LAUNCHES - before[0]
    stats["compose_launches"] += cmp.COMPOSE_LAUNCHES - before[1]


def _assemble_fetch(c: _Chunk):
    """The host half of phase B: the chunk's (pos, Cigar, rev) results from
    its composed rows, the reads to re-compose on the host (redo) and the
    reads to re-run on the host engine (fallback).  Returns (results,
    fallback, redo)."""
    n = len(c.sub)
    with _span("B.fetch2"):
        rows = _host_array(c.comp)[:n]
    with _span("B.host_build"):
        res, meta, nrun = rows[:, 0], rows[:, 1], rows[:, 2]
        mlv = meta & 3
        strandv = (meta >> 2) & 1
        cpd = ((meta >> 6) & 1).astype(bool)
        ovfl = ((meta >> 5) & 1).astype(bool)  # a truncated log
        # a run count past a compose width (the RLE block, the stream, the
        # merged runs, an int16 count, the 8 runs of the row): re-compose
        badrv = (((meta >> 3) & 3) != 0) | (((meta >> 7) & 1) != 0)
        aligned = (mlv != 0) & ~cpd & ~ovfl
        ok = aligned & ~badrv & (res != 0)
        results: list = [None] * n
        for k in np.nonzero((mlv == 0) & ~cpd)[0].tolist():
            results[k] = (0, None, False)
        fallback = np.nonzero(cpd | ((mlv != 0) & ~cpd & ovfl)
                              | (aligned & ~badrv & (res == 0)))[0].tolist()
        redo = np.nonzero(aligned & badrv)[0].tolist()
        c.stats["capped"] += int(cpd.sum())
        okl = np.nonzero(ok)[0]
        if okl.size:
            _render_rows(rows, okl, res, nrun, strandv, results)
    return results, fallback, redo


def _render_rows(rows, okl, res, nrun, strandv, results) -> None:
    """results[k] = (pos, CIGAR, rev) for the composed rows ``okl``: the runs
    top-first ("<count><op>" a run, columns reversed) as a fixed-width byte
    matrix, digits by division, leading zeros masked and dropped by the
    compress."""
    with _span("B.hb.gather"):
        m, K = okl.size, 8
        ops = ((rows[okl, 3].astype(np.uint32)[:, None]
                >> (2 * np.arange(K, dtype=np.uint32))[None, :]) & 3
               ).astype(np.int64) - 1
        cnts = rows[okl, 4:12].astype(np.int64)
        valid = np.arange(K)[None, :] < nrun[okl, None]
    with _span("B.hb.render"):
        W = 6  # up to 5 digits (a count is below 32768) and the op
        bm = np.zeros((m, K, W), np.uint8)
        rem = cnts
        started = np.zeros((m, K), bool)
        for q, p10 in enumerate((10000, 1000, 100, 10)):
            d = rem // p10
            rem = rem - d * p10
            started |= d > 0
            bm[..., q] = np.where(started, 48 + d, 0)
        bm[..., 4] = 48 + rem
        bm[..., 5] = _OPC_BYTES[ops]
        bm[~valid] = 0
        flatm = bm[:, ::-1, :].reshape(m, K * W)
        mask = flatm != 0
        offs = np.concatenate([[0], np.cumsum(mask.sum(1))]).tolist()
        flat = flatm[mask].tobytes().decode()
        posl = (res[okl].astype(np.int64) + 1).tolist()
        revl = (strandv[okl] == 1).tolist()
    with _span("B.hb.objloop"):
        new_c = _RenderedCigar.__new__
        for j, k in enumerate(okl.tolist()):
            cig = new_c(_RenderedCigar)
            cig._render = flat[offs[j]:offs[j + 1]]
            results[k] = (posl[j], cig, revl[j])


def _take_rows(log, sel: np.ndarray) -> dict:
    """The log rows of lanes ``sel`` of a packed automaton output, as numpy
    arrays: one gather and one copy."""
    v = au.align_unpack(log)
    idx = torch.from_numpy(np.asarray(sel, np.int64)).to(log.device)
    names = au.ALIGN_COLS + au.LOG_COLS
    got = torch.cat([v[c][idx].reshape(len(sel), -1) for c in names],
                    1).cpu().numpy()
    out, at = {}, 0
    for c in names:
        w = 1 if c in au.ALIGN_COLS else au.LOGN
        out[c] = got[:, at] if w == 1 else got[:, at:at + w]
        at += w
    return out


def _redo_host(svc, results, fallback, redo, log):
    """Re-compose on the host the reads whose runs overflowed a width of the
    device compose (from their fetched logs), in place of their results."""
    sel = np.asarray(redo, np.int64)
    r = _take_rows(log, sel)
    rsub, fsub = _assemble_logs(
        svc, len(sel), r["mode"], r["curpos"], r["strand"], r["lp"],
        np.zeros(len(sel), bool), r["kinds"], r["roffs"], r["rlens"],
        r["glens"], r["gstarts"], lanes=sel)
    for b, k in enumerate(redo):
        results[k] = rsub[b]
    fallback.extend(redo[b] for b in fsub)
    return results, fallback


def _run_fallback(genome, glen, codes_list, anchor_len, cfg, svc, results,
                  fallback):
    """Re-run the escaped reads (a truncated log, the cap, a head on 0) on
    the host engine, over the chunk's bank."""
    if fallback:
        gens = [_read_gen(genome, glen, 2 * k, len(codes_list[k]), 2 * k + 1,
                          len(codes_list[k]), anchor_len, True,
                          cfg.spec_depth, cfg.isa_spec_depth)
                for k in fallback]
        for k, o in zip(fallback, BatchExecutor(svc).run(gens)):
            results[k] = o
    return results


def _align_reads_device(fmi, genome, glen, codes_list, anchor_len, cfg, svc):
    """The device engine over all the reads; the same results as the host
    engine.  Writes its counters into ``svc.last_stats``: ``chunks``,
    ``align_launches`` (K10), ``buckets`` and ``log_stitch_launches``
    (K11a), ``compose_launches`` (K11b), ``capped``, ``redo`` and
    ``fallback`` (reads that took each escape), and the host's seconds in
    each stage: ``t_a`` (registering a chunk, its upload, the automaton's
    launch and the bucketing queued behind it), ``t_b`` (the wait for the
    bucket counts, then the stitch and compose launches), ``t_fetch`` (the
    wait for the composed rows, then the results built from them) and
    ``t_escapes``.

    The cyclic garbage collector is paused for the call: the results are
    about three objects a read that live on, so its passes would scan the
    whole heap again and again, and the engine makes no cycles."""
    import gc

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _align_reads_device_inner(fmi, genome, glen, codes_list,
                                         anchor_len, cfg, svc)
    finally:
        if was_enabled:
            gc.enable()


def _align_reads_device_inner(fmi, genome, glen, codes_list, anchor_len, cfg,
                              svc):
    if fmi.isa_samples is None:
        raise ValueError("the device engine requires an index with "
                         "isa_samples")
    n = len(codes_list)
    chunk = cfg.search_batch
    seed = svc.seed  # built once, on the caller's service
    stats = dict(chunks=0, align_launches=0, buckets=0, log_stitch_launches=0,
                 compose_launches=0, capped=0, redo=0, fallback=0, t_a=0.0,
                 t_b=0.0, t_fetch=0.0, t_escapes=0.0)

    def clocked(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        stats[key] += time.perf_counter() - t0
        return out

    if n <= chunk:
        resolve = None  # the chunk's own N scan
    elif isinstance(codes_list, np.ndarray):
        resolve = bool((codes_list == 5).any())
    else:
        resolve = any(bool((np.asarray(r) == 5).any()) for r in codes_list)

    def service():
        if n <= chunk:
            return svc
        s = QueryService(fmi, svc.genome_dev, cfg)
        s.svc_impl, s.dp_impl = svc.svc_impl, svc.dp_impl
        return s

    # a pipeline of three stages over the chunks: chunk i's automaton is
    # queued first, then chunk i - 1's phase B (its wait on the bucket counts
    # ends with its own automaton, while chunk i's runs), then the host half
    # of chunk i - 2, whose rows were copied while the card ran chunk i - 1
    done, waiting, prev = [], [], None
    for lo in range(0, max(n, 1), chunk):
        sub = codes_list[lo:lo + chunk]
        c = clocked("t_a", _align_chunk_dispatch, fmi, glen, sub, anchor_len,
                    resolve, service(), seed, stats)
        if prev is not None:
            clocked("t_b", _assemble_dispatch, fmi, prev)
            waiting.append(prev)
        if len(waiting) > 1:
            e = waiting.pop(0)
            done.append((e, *clocked("t_fetch", _assemble_fetch, e)))
        prev = c
    clocked("t_b", _assemble_dispatch, fmi, prev)
    waiting.append(prev)
    done += [(e, *clocked("t_fetch", _assemble_fetch, e)) for e in waiting]

    # the escapes last, chunk by chunk: the host re-compose, then the host
    # engine
    t0 = time.perf_counter()
    results: list = []
    for e, res_i, fb, redo in done:
        if redo:
            stats["redo"] += len(redo)
            with _span(f"B.redo_n{len(redo)}"):
                res_i, fb = _redo_host(e.svc, res_i, fb, redo, e.log)
        stats["fallback"] += len(fb)
        results.extend(_run_fallback(genome, glen, e.sub, anchor_len, cfg,
                                     e.svc, res_i, fb))
    stats["t_escapes"] = time.perf_counter() - t0
    svc.last_stats = stats
    return results


def _merge_results(mesh, part: list) -> list:
    """The ranks' (pos, Cigar | None, rev) results in read order on every
    rank: each rank's rows (position, whether it has a CIGAR, the strand,
    the length of the CIGAR's rendering) and its renderings joined into one
    string, both gathered along 'dp'.  The CIGARs come back as
    :class:`_RenderedCigar`, as the device engine builds them (a
    ``_RenderedCigar`` pickles by parsing its ops; a rendering does not)."""
    from bwt_tpu_torch.parallel import mesh as pmesh

    texts = ["" if c is None else c.render() for _, c, _ in part]
    rows = np.array([(p, c is not None, rev, len(t)) for (p, c, rev), t
                     in zip(part, texts)], np.int64).reshape(-1, 4)
    rows = pmesh.gather_batch(mesh, rows)
    text = pmesh.gather_batch(mesh, np.frombuffer(
        "".join(texts).encode(), np.uint8)).tobytes().decode()
    new_c, out, at = _RenderedCigar.__new__, [], 0
    for (p, has, rev, n) in rows.tolist():
        cig = None
        if has:
            cig = new_c(_RenderedCigar)
            cig._render = text[at:at + n]
        out.append((p, cig, bool(rev)))
        at += n
    return out


def align_reads(fmi: FMIndex, genome, reads, *, anchor_len: int | None = None,
                config=None, service: QueryService | None = None,
                with_strand: bool = False, engine: str = "auto", mesh=None):
    """Align a batch of reads (ASCII strings, code arrays, or a 2-D uint8
    code matrix).

    Returns a list of (position, Cigar | None): the 1-based genome
    position of the alignment start (0 = unaligned) and its CIGAR, or
    (position, Cigar, reverse) triples with ``with_strand``.  A reusable
    ``service`` keeps the genome upload across calls.

    ``engine``: "device" runs the device engine (the automaton and its
    phase B, :func:`_align_reads_device`), "host" the host generators over
    the executor; "auto" (the default) takes the device engine when the
    index has ``isa_samples`` and no read is longer than 32,767 bases (the
    log's int16 columns), as ``bwt_tpu`` does, else the host engine.  A
    longer read raises ValueError with "device".  The results are the same
    either way, and equal the JAX package's for either of its engines.

    ``mesh``: a :class:`bwt_tpu_torch.parallel.Mesh` runs the device engine
    on every rank, each on its contiguous share of the reads along 'dp'
    (``parallel.mesh.share``; a rank whose share is empty, when there are
    fewer reads than ranks, aligns none) and on its own device, then
    gathers the results along 'dp' (:func:`_merge_results`), so every rank
    returns the whole list in read order, equal to the single-device
    run's.  With tp > 1 (``bwt_tpu``'s phase split) the ranks of a tp group
    run the same share: phase A, the automaton and its escapes, over a tp
    view (``parallel.mesh.serving_index``: ``fmi`` itself if it is one),
    phase B against the genome text as on one device.  It needs the device
    engine (ValueError otherwise, and for a read past 32,767 bases)."""
    from bwt_tpu_torch.config import DEFAULT

    if engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None:
        from bwt_tpu_torch.parallel import mesh as pmesh

        given, fmi = fmi, pmesh.serving_index(fmi, mesh)
    if config is not None:
        cfg = config
    elif service is not None:
        cfg = service.config
    else:
        cfg = DEFAULT
    if cfg.elastic_fallback:
        raise NotImplementedError(
            "config.elastic_fallback is not ported (ROADMAP Queue 1: "
            "multi-device and recovery)")
    if anchor_len is None:
        anchor_len = cfg.anchor_len
    genome = _as_genome_codes(genome)
    glen = len(genome)
    if service is not None and (service.config is not cfg
                                or service.fmi.shard is not fmi.shard):
        # another config, or a service over the whole index on a tp mesh
        service = QueryService(
            fmi, service.genome_dev if service.genome_dev is not None
            else genome, cfg)
    svc = service if service is not None else QueryService(fmi, genome, cfg)
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        # a matrix of equal-length reads skips the per-read loop
        codes_list = np.ascontiguousarray(reads).astype(np.uint8, copy=False)
        lengths = [codes_list.shape[1]] if codes_list.shape[0] else []
    else:
        codes_list = [codec.encode_read(r) if isinstance(r, (str, bytes))
                      else np.asarray(r, np.uint8) for r in reads]
        lengths = [len(c) for c in codes_list]
    max_len = max(lengths, default=0)
    if max_len > cfg.max_read_len:
        raise ValueError(
            f"read length {max_len} exceeds config.max_read_len "
            f"{cfg.max_read_len} (single_align.c:369's buffer bound)")
    use_dev = engine == "device" or (
        engine == "auto" and fmi.isa_samples is not None)
    if use_dev and max_len > 32767:
        if engine == "device" or mesh is not None:
            raise ValueError(
                f"read length {max_len} exceeds the device automaton's "
                "int16 stitch-log width (32767); use engine='host'")
        use_dev = False
    if mesh is not None and not use_dev:
        raise ValueError("mesh= requires the device engine "
                         "(an index with isa_samples)")
    if mesh is not None:
        lo, hi = pmesh.share(len(codes_list), mesh)
        part = (_align_reads_device(fmi, genome, glen, codes_list[lo:hi],
                                    anchor_len, cfg, svc) if hi > lo else [])
        pmesh.done_serving(fmi, given)
        with pmesh.merging():
            results = _merge_results(mesh, part)
    elif use_dev:
        results = _align_reads_device(fmi, genome, glen, codes_list,
                                      anchor_len, cfg, svc)
    else:
        results = _align_reads_host(fmi, genome, glen, codes_list,
                                    anchor_len, cfg, svc)
    if with_strand:
        return results
    return [(p, c) for p, c, _ in results]


def align_read_anchored(fmi: FMIndex, genome, read, *,
                        anchor_len: int = DEFAULT_ANCHOR_LEN):
    """Single-read anchored alignment, without the reverse-complement retry
    (align_read_anchored, single_align.c:163-298).  Returns
    (position_0based, Cigar)."""
    genome = _as_genome_codes(genome)
    pattern = (codec.encode_read(read) if isinstance(read, (str, bytes))
               else np.asarray(read, np.uint8))
    svc = QueryService(fmi, genome)
    row = svc.add_read(pattern)
    s = Cigar()

    def gen():
        return (yield from align_read_anchored_gen(
            genome, len(genome), row, len(pattern), anchor_len, s,
            fmi.isa_samples is not None))

    (pos,) = BatchExecutor(svc).run([gen()])
    return pos, s


def align_read(fmi: FMIndex, genome, read, *, thresh: int | None = None,
               config=None):
    """Single-read segment-chaining alignment (align_read,
    single_align.c:300); ``thresh`` defaults to config.chain_thresh."""
    from bwt_tpu_torch.config import DEFAULT

    if thresh is None:
        thresh = (config or DEFAULT).chain_thresh
    genome = _as_genome_codes(genome)
    pattern = (codec.encode_read(read) if isinstance(read, (str, bytes))
               else np.asarray(read, np.uint8))
    svc = QueryService(fmi, genome, config)
    row = svc.add_read(pattern)
    (pos,) = BatchExecutor(svc).run(
        [align_read_gen(genome, row, len(pattern), thresh)])
    return pos


def format_ref_output(results) -> str:
    """Render align_reads results like the single_align main loop
    (single_align.c:484-503): '<pos>\\n <CIGAR>\\n' per aligned read,
    '0\\n' per unaligned one."""
    out = []
    for pos, cig, *_ in results:
        if pos:
            out.append(f"{pos}\n")
            out.append(cig.render_ref_line())
        else:
            out.append("0\n")
    return "".join(out)
