"""Anchored seed-and-extend alignment — the single_align.c drivers.

Per-read semantics follow the reference (``align_read_anchored``
single_align.c:163-298, ``mms_mismatch`` :50-160, ``align_read``
:300-358): retry budgets, proximity tolerances, stack resets and the
head-alignment return-value quirk (the final head block returns
``curpos - len``, the in-loop one ``curpos - x``, single_align.c:271 vs
:297).  Each read's control flow runs as a host generator; FM-index
queries and DP stitches run batched across reads, one fused call per
round, through :class:`~bwt_tpu_torch.models.batch_exec.BatchExecutor`.

Deviations from the reference, all where C is undefined:
  * ``nmisses`` is read before it is written when the read is no
    longer than the anchor (single_align.c:166); it is 0 here, and the
    result is 0 either way.
  * ``mms_continue`` on a pattern containing N indexes ``C[5]`` in C;
    here N resolves as in ``mms``.
"""

from __future__ import annotations

import numpy as np

from bwt_tpu_torch import codec
from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.models.batch_exec import BatchExecutor, QueryService
from bwt_tpu_torch.utils.cigar import Cigar

# Candidate-interval scans fetch unc_sa_range in geometrically growing
# chunks: the reference scans sequentially and almost always stops within
# the first few entries (single_align.c:218-223).
CAND_CHUNK = 32


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


def align_reads(fmi: FMIndex, genome, reads, *, anchor_len: int | None = None,
                config=None, service: QueryService | None = None,
                with_strand: bool = False, engine: str = "auto", mesh=None):
    """Align a batch of reads (ASCII strings or code arrays).

    Returns a list of (position, Cigar | None): the 1-based genome
    position of the alignment start (0 = unaligned) and its CIGAR, or
    (position, Cigar, reverse) triples with ``with_strand``.  A reusable
    ``service`` keeps the genome upload across calls.

    ``engine``: "auto" and "host" run the host-generator engine, whose
    output equals the JAX package's for either of its engines.  The
    device automaton ("device") and ``mesh`` are not ported yet."""
    from bwt_tpu_torch.config import DEFAULT

    if engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device" or mesh is not None:
        raise NotImplementedError(
            "the device automaton and mesh= are not ported yet (ROADMAP "
            "Queue 1: the device automaton and its fused phase B; "
            "multi-device); use engine='host' or 'auto'")
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
    if service is not None and service.config is not cfg:
        service = QueryService(
            fmi, service.genome_dev if service.genome_dev is not None
            else genome, cfg)
    svc = service if service is not None else QueryService(fmi, genome, cfg)
    codes_list = []
    for r in reads:
        fwd = (codec.encode_read(r) if isinstance(r, (str, bytes))
               else np.asarray(r, np.uint8))
        if len(fwd) > cfg.max_read_len:
            raise ValueError(
                f"read length {len(fwd)} exceeds config.max_read_len "
                f"{cfg.max_read_len} (single_align.c:369's buffer bound)")
        codes_list.append(fwd)
    results = _align_reads_host(fmi, genome, glen, codes_list, anchor_len,
                                cfg, svc)
    if with_strand:
        return results
    return [(p, c) for p, c, _ in results]


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
