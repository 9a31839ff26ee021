"""Batched FM-index search: lockstep backward search over read batches.

Every read of a batch steps through its characters together; reads that
finish or whose interval empties are masked out, and the loop stops once
no read is active.  The reference's quirks are kept (seqindex.c:228-351):
  * ``reverse_search`` returns ``end - start + 1`` on completion and 0
    only if the interval emptied before the final character's update;
  * ``locate`` returns a position even when the final update emptied
    the interval;
  * ``mms`` strips trailing N's, resolves an inner N to the symbol with
    the most matches in the current interval (first max wins,
    seqindex.c:330-340), and counts the initial character.
"""

from __future__ import annotations

import torch

from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.ops import rank as rank_ops


def _i32(x, fmi: FMIndex) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=fmi.device)


def take_c(C: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C[c] for c in 0..4, and 0 for any other c."""
    ok = (c >= 0) & (c <= 4)
    got = C[c.clamp(0, 4).long()]
    return torch.where(ok, got, torch.zeros_like(got))


def _fetch_pair(fmi: FMIndex, start, end):
    ia = rank_ops._adjust(fmi.endloc, start)
    ib = rank_ops._adjust(fmi.endloc, end)
    return (rank_ops._rows(fmi.buckets, ia), ia & 63,
            rank_ops._rows(fmi.buckets, ib), ib & 63)


def _first_argmax4(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over the last dim (size 4)."""
    best = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    bv = x[..., 0]
    for k in range(1, 4):
        better = x[..., k] > bv
        best = torch.where(better, k, best)
        bv = torch.where(better, x[..., k], bv)
    return best


def _step(fmi: FMIndex, c, start, end):
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    Cc = take_c(fmi.C, c).to(torch.int64)
    return (rank_ops.wrap32(Cc + rank_ops._row_rank(rows_s, c, rs)),
            rank_ops.wrap32(Cc + rank_ops._row_rank(rows_e, c, re_)))


def _resolve_step(fmi: FMIndex, c, start, end, lane_mask=None):
    """N resolution (seqindex.c:330-340) and the LF interval step from
    one shared row fetch.  ``lane_mask`` restricts which lanes resolve;
    unresolved c == 5 lanes step with the same rank(5) arithmetic.
    Returns (c', ns, ne)."""
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    counts = (rank_ops.row_ranks_all4(rows_e, re_).to(torch.int64)
              - rank_ops.row_ranks_all4(rows_s, rs).to(torch.int64))
    best = _first_argmax4(rank_ops.wrap32(counts))
    sel = (c == 5) if lane_mask is None else (lane_mask & (c == 5))
    c = torch.where(sel, best, c)
    Cc = take_c(fmi.C, c).to(torch.int64)
    return (c,
            rank_ops.wrap32(Cc + rank_ops._row_rank(rows_s, c, rs)),
            rank_ops.wrap32(Cc + rank_ops._row_rank(rows_e, c, re_)))


def _char_at(patterns: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """patterns[b, clip(ci[b])] per lane."""
    ci = ci.clamp(0, patterns.shape[1] - 1).long().unsqueeze(1)
    return patterns.gather(1, ci).squeeze(1)


def trailing_n(patterns: torch.Tensor, lengths: torch.Tensor):
    """Count of trailing N's of each ``pattern[:len]`` (mms's strip loop,
    seqindex.c:317-320)."""
    B, L = patterns.shape
    pos = torch.arange(L, dtype=torch.int32, device=patterns.device)
    pos = pos.unsqueeze(0).expand(B, L)
    last_non_n = torch.cummax(
        torch.where(patterns != 5, pos, torch.full_like(pos, -1)), dim=1
    ).values
    out = _char_at(pos - last_non_n, lengths - 1)
    return torch.where(lengths > 0, out, torch.zeros_like(out))


def _run_loop(fmi, patterns, eff_len, state, t0, steps, resolve_n):
    """The lockstep LF loop from step ``t0`` (char eff_len-1-t) on; it
    stops early once no lane is active (the remaining steps would be
    no-ops)."""
    start, end, sp, ep, nmatched, alive = state
    for t in range(t0, steps):
        active = alive & (t <= eff_len - 1)
        if not bool(active.any()):
            break
        c = _char_at(patterns, eff_len - 1 - t)
        if resolve_n:
            c, ns, ne = _resolve_step(fmi, c, start, end)
        else:
            ns, ne = _step(fmi, c, start, end)
        ok = ne > ns
        start = torch.where(active, ns, start)
        end = torch.where(active, ne, end)
        upd = active & ok
        sp = torch.where(upd, ns, sp)
        ep = torch.where(upd, ne, ep)
        nmatched = nmatched + upd.to(torch.int32)
        alive = alive & (~active | ok)
    return start, end, sp, ep, nmatched, alive


def backward_search(fmi: FMIndex, patterns, lengths, *,
                    resolve_n: bool = False, max_len: int | None = None):
    """Lockstep backward search of a read batch.

    ``patterns`` (B, L) int codes, left-aligned; ``lengths`` (B,).
    Returns a dict of (B,) tensors: start/end (final interval, frozen at
    the first empty one), sp/ep (last nonempty interval), nmatched
    (characters consumed while nonempty, counting the first), alive,
    skips (stripped trailing N's) and eff_len.  With ``resolve_n``,
    trailing N's are stripped and inner N's resolved."""
    patterns = _i32(patterns, fmi)
    lengths = _i32(lengths, fmi)
    L = patterns.shape[1]
    steps = max_len if max_len is not None else L
    if resolve_n:
        skips = trailing_n(patterns, lengths)
        eff_len = lengths - skips
    else:
        skips = torch.zeros_like(lengths)
        eff_len = lengths
    eff_len = eff_len.clamp(min=1)
    c0 = _char_at(patterns, eff_len - 1)
    if resolve_n:
        # an all-N read leaves c0 == 5; the reference reads C[5]/C[6]
        # out of bounds there (UB) — clamp to 'A'
        c0 = torch.where(c0 == 5, 0, c0)
    start = take_c(fmi.C, c0)
    end = take_c(fmi.C, c0 + 1)
    alive = end > start
    state = (start, end, start, end, alive.to(torch.int32), alive)
    start, end, sp, ep, nmatched, alive = _run_loop(
        fmi, patterns, eff_len, state, 1, steps, resolve_n)
    return dict(start=start, end=end, sp=sp, ep=ep, nmatched=nmatched,
                alive=alive, skips=skips, eff_len=eff_len)


def _emptied_early(r, lengths):
    return (~r["alive"]) & (r["nmatched"] <= lengths - 2)


def reverse_search(fmi: FMIndex, patterns, lengths):
    """Match count per read with the reference's +1 quirk
    (seqindex.c:228-242)."""
    lengths = _i32(lengths, fmi)
    r = backward_search(fmi, patterns, lengths)
    return torch.where(_emptied_early(r, lengths), 0,
                       r["end"] - r["start"] + 1)


def count_matches(fmi: FMIndex, patterns, lengths):
    """True number of matches (no reference quirk)."""
    r = backward_search(fmi, patterns, lengths)
    return torch.where(r["alive"], r["end"] - r["start"], 0)


def loc_search(fmi: FMIndex, patterns, lengths):
    """Final SA interval (start, end) per read (seqindex.c:280-309)."""
    r = backward_search(fmi, patterns, lengths)
    return r["start"], r["end"]


def unc_sa(fmi: FMIndex, idx, max_steps: int | None = None):
    """SA[idx] per lane by LF walks to the nearest sampled row
    (seqindex.c:244-255): a lane walks while its row is not a multiple
    of ``sa_rate``; the result is ``sa_samples[row / rate] + steps``,
    wrapped by length+1."""
    i = _i32(idx, fmi)
    mask = fmi.sa_rate - 1
    shift = fmi.sa_rate.bit_length() - 1
    steps = torch.zeros_like(i)
    t = 0
    while max_steps is None or t < max_steps:
        live = (i & mask) != 0
        if not bool(live.any()):
            break
        nxt = rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, i)
        i = torch.where(live, nxt, i)
        steps = steps + live.to(torch.int32)
        t += 1
    x = rank_ops.take_fill(fmi.sa_samples, i >> shift) + steps
    return torch.where(x > fmi.length, x - (fmi.length + 1), x)


def locate(fmi: FMIndex, patterns, lengths):
    """First-match position per read (seqindex.c:258-277); -1 when the
    interval emptied before the final character."""
    lengths = _i32(lengths, fmi)
    r = backward_search(fmi, patterns, lengths)
    pos = unc_sa(fmi, r["start"])
    return torch.where(_emptied_early(r, lengths), -1, pos)


def isa_window(fmi: FMIndex, plo, width, *, W: int = 32):
    """``rows[b, j] = SA^-1[plo[b]+j]`` for ``j < width[b]`` and ``0 <=
    plo+j <= length``, else -1: anchor at the ISA sample at or above the
    window's top and LF-chain downward (``ISA[p-1] = lf(ISA[p])``).
    Needs ``fmi.isa_samples``.  Contract: ``width <= W``."""
    if fmi.isa_samples is None:
        raise ValueError("isa_window requires an index with isa_samples")
    plo = _i32(plo, fmi)
    width = _i32(width, fmi)
    n, r = fmi.length, fmi.sa_rate
    shift = r.bit_length() - 1
    B = plo.shape[0]
    p_hi = torch.clamp(plo + width - 1, max=n)
    anchor = torch.clamp(((p_hi + r - 1) >> shift) << shift, 0, n)
    nsamp = fmi.isa_samples.shape[0]
    row = fmi.isa_samples[(anchor >> shift).clamp(0, nsamp - 1).long()]
    if n % r:
        # ISA[length] == 0 (the sentinel suffix is SA row 0) anchors the
        # tail window when length is not a multiple of the rate
        row = torch.where(anchor == n, 0, row)
    out = torch.full((B, W), -1, dtype=torch.int32, device=fmi.device)
    jidx = torch.arange(W, dtype=torch.int32, device=fmi.device)[None, :]
    floor = plo.clamp(min=0)
    span = torch.where(width > 0, anchor - floor + 1, 0)
    tmax = min(int(span.max()) if B else 0, (r - 1) + W)
    for t in range(tmax):
        pcur = anchor - t
        ok = (pcur >= floor) & (pcur <= p_hi) & (width > 0)
        sel = (jidx == (pcur - plo)[:, None]) & ok[:, None]
        out = torch.where(sel, row[:, None], out)
        nxt = rank_ops.lf(fmi.buckets, fmi.C, fmi.endloc, row)
        row = torch.where(pcur > floor, nxt, row)
    return out


def mms(fmi: FMIndex, patterns, lengths):
    """Maximum mappable suffix (seqindex.c:314-351).  Returns (matched,
    sp, ep); matched includes the stripped trailing N's."""
    r = backward_search(fmi, patterns, lengths, resolve_n=True)
    return r["nmatched"] + r["skips"], r["sp"], r["ep"]


def mms_continue(fmi: FMIndex, patterns, lengths, sp, ep):
    """Continuation of an MMS search (single_align.c:26-46): processes
    pattern[len-1] .. pattern[0] from interval (sp, ep).  Returns
    (matched, sp', ep'); an empty incoming interval yields -1."""
    patterns = _i32(patterns, fmi)
    lengths = _i32(lengths, fmi)
    start, end = _i32(sp, fmi), _i32(ep, fmi)
    alive = end > start
    state = (start, end, start, end, torch.zeros_like(lengths), alive)
    _, _, osp, oep, nmatched, _ = _run_loop(
        fmi, patterns, lengths, state, 0, patterns.shape[1], True)
    return nmatched - (~alive).to(torch.int32), osp, oep
