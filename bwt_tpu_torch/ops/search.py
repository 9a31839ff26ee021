"""Batched FM-index search: backward search and SA walks over read batches.

On the card, a batch's backward search is one launch of the K3 kernel
(``csrc/backward_search.cu``, one thread per read) and its SA walks one
launch of K4 (``csrc/unc_sa.cu``, one thread per walk); :func:`locate`
is one launch of ``csrc/locate.cu`` (search, then walk, in one thread per
read), and the anchor hunt of ``models/exact.py`` one launch of
``csrc/anchor_scan.cu`` (:func:`anchor_scan_kernel`).  All four run the
device functions of ``csrc/fm_search.cuh`` over the rank/LF functions of
K2 (``csrc/fm_rank.cuh``).  On the CPU the same wrappers run the plain
versions, :func:`backward_search_plain`, :func:`unc_sa_plain` and
:func:`locate_plain`, in which every read of a batch steps through its
characters together, finished reads are masked out, and the loop stops
once no read is active.  Over a tp view (``parallel.tp_view``) the
kernels run their tp form, each row read through the view's device table
of block pointers, and the plain versions read every table through the
tp form of ``rank.take_fill`` (a local gather and an all-reduce over
'tp').  On the wide (int64) index (``FMIndex.wide``) every kernel runs
its wide instantiation (the 32-byte device rows over their 64-bit bases,
``FMIndex.rows32`` and ``bases``; int64 intervals and positions), and the
intervals, positions and seed rows come back int64 where ``bwt_tpu``'s do
under x64; the plain versions read the 12-int rows (``ops/rank.py``).
The reference's quirks are kept (seqindex.c:228-351):
  * ``reverse_search`` returns ``end - start + 1`` on completion and 0
    only if the interval emptied before the final character's update;
  * ``locate`` returns a position even when the final update emptied
    the interval;
  * ``mms`` strips trailing N's, resolves an inner N to the symbol with
    the most matches in the current interval (first max wins,
    seqindex.c:330-340), and counts the initial character.
"""

from __future__ import annotations

import dataclasses

import torch

from bwt_tpu_torch.index import FMIndex, refuse_wide
from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.utils.profiling import span as _span


def _i32(x, fmi: FMIndex) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=fmi.device)


def _pos(x, fmi: FMIndex) -> torch.Tensor:
    """SA rows or positions in the index's type (int64 on a wide index)."""
    return torch.as_tensor(x, dtype=fmi.pos_dtype, device=fmi.device)


def take_c(C: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C[c] for c in 0..4, and 0 for any other c."""
    ok = (c >= 0) & (c <= 4)
    got = C[c.clamp(0, 4).long()]
    return torch.where(ok, got, torch.zeros_like(got))


def _fetch_pair(fmi: FMIndex, start, end):
    """Bucket rows at (start, end): two gathers, or on a tp view one
    stacked fetch and one all-reduce (``bwt_tpu``'s ``rows2``)."""
    ia = rank_ops._adjust(fmi.endloc, start)
    ib = rank_ops._adjust(fmi.endloc, end)
    tp = fmi.tp
    if tp is None:
        return (rank_ops._rows(fmi.buckets, ia), ia & 63,
                rank_ops._rows(fmi.buckets, ib), ib & 63)
    ia, ib = torch.broadcast_tensors(ia, ib)
    rows = rank_ops._rows(fmi.buckets, torch.stack([ia, ib]), tp,
                          fmi.bucket_rows)
    return rows[0], ia & 63, rows[1], ib & 63


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
    return (rank_ops.fit(rows_s, Cc + rank_ops._row_rank(rows_s, c, rs)),
            rank_ops.fit(rows_e, Cc + rank_ops._row_rank(rows_e, c, re_)))


def _resolve_step(fmi: FMIndex, c, start, end, lane_mask=None):
    """N resolution (seqindex.c:330-340) and the LF interval step from
    one shared row fetch.  ``lane_mask`` restricts which lanes resolve;
    unresolved c == 5 lanes step with the same rank(5) arithmetic.
    Returns (c', ns, ne)."""
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    counts = (rank_ops.row_ranks_all4(rows_e, re_).to(torch.int64)
              - rank_ops.row_ranks_all4(rows_s, rs).to(torch.int64))
    best = _first_argmax4(rank_ops.fit(rows_s, counts))
    sel = (c == 5) if lane_mask is None else (lane_mask & (c == 5))
    c = torch.where(sel, best, c)
    Cc = take_c(fmi.C, c).to(torch.int64)
    return (c,
            rank_ops.fit(rows_s, Cc + rank_ops._row_rank(rows_s, c, rs)),
            rank_ops.fit(rows_e, Cc + rank_ops._row_rank(rows_e, c, re_)))


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


# --------------------------------------------------------------------------
# k-mer seed table: skip the first k steps of every search
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeedTable:
    """Backward-search state after the first k steps for every k-mer.

    ``rows[key]`` = (start, end, sp, ep, nmatched, alive) after k steps of
    :func:`backward_search` on the k-mer whose character processed at
    step t sits in bits 2t..2t+1 of ``key``.  Valid only for reads of
    length >= k with no N among their last k characters.  The rows are
    int64 for a wide index, as ``bwt_tpu``'s are."""

    rows: torch.Tensor  # (4^k, 6) int32, or int64 for a wide index
    k: int


_SEED_CHUNK = 1 << 22  # keys or parents per pass of the plain build

# the levels of the table that one thread of the K5 kernel expands below a
# state of its prefix (csrc/seed_rows.cu: kFused)
SEED_FUSED = 3


def seed_prefix(k: int) -> int:
    """The characters of a key that the K5 schedule searches key by key
    before it expands the last :data:`SEED_FUSED` levels: max(k - 3, 1)."""
    return max(k - SEED_FUSED, 1)


def _seed_children(fmi: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    """The four children of each state of ``rows`` ((P, 6) seed-table rows):
    (4, P, 6), child c the state after one more backward-search step on
    character c.  Both ends' rows are fetched once and ranked for all four
    characters; a dead state passes to its children unchanged, as the
    search's masked step leaves it."""
    start, end, sp, ep, nmatched, alive = rows.unbind(1)
    alive = alive != 0
    rows_s, rs, rows_e, re_ = _fetch_pair(fmi, start, end)
    lo = rank_ops.row_ranks_all4(rows_s, rs).to(torch.int64)
    hi = rank_ops.row_ranks_all4(rows_e, re_).to(torch.int64)
    kids = []
    for c in range(4):
        cc = take_c(fmi.C, torch.full_like(start, c)).to(torch.int64)
        ns = rank_ops.fit(rows_s, cc + lo[:, c])
        ne = rank_ops.fit(rows_e, cc + hi[:, c])
        upd = alive & (ne > ns)
        kids.append(torch.stack([
            torch.where(alive, ns, start), torch.where(alive, ne, end),
            torch.where(upd, ns, sp), torch.where(upd, ne, ep),
            nmatched + upd.to(torch.int32), upd.to(torch.int32)], dim=1))
    return torch.stack(kids)


def _seed_rows_plain(fmi: FMIndex, k: int) -> torch.Tensor:
    """The plain PyTorch version of the seed-table kernel, on any device,
    on the kernel's schedule: the first ``P = seed_prefix(k)`` characters of
    every key below 4^P key by key, straight from the key bits (in chunks of
    keys), then levels P..k-1 in place.  Level t holds the states of the
    keys mod 4^(t+1); child c of row p < 4^t goes to row p + c * 4^t, so
    the rows a level reads are the ones its first child overwrites, and no
    scratch is needed."""
    out = torch.empty((4 ** k, 6), dtype=fmi.pos_dtype, device=fmi.device)
    P = seed_prefix(k)
    for lo in range(0, 4 ** P, _SEED_CHUNK):
        keys = torch.arange(lo, min(lo + _SEED_CHUNK, 4 ** P),
                            dtype=torch.int32, device=fmi.device)
        c0 = keys & 3
        start = take_c(fmi.C, c0)
        end = take_c(fmi.C, c0 + 1)
        alive = end > start
        nmatched = alive.to(torch.int32)
        sp, ep = start, end
        for t in range(1, P):
            ns, ne = _step(fmi, (keys >> (2 * t)) & 3, start, end)
            ok = ne > ns
            start = torch.where(alive, ns, start)
            end = torch.where(alive, ne, end)
            upd = alive & ok
            sp = torch.where(upd, ns, sp)
            ep = torch.where(upd, ne, ep)
            nmatched = nmatched + upd.to(torch.int32)
            alive = alive & ok
        out[lo:lo + keys.shape[0]] = torch.stack(
            [start, end, sp, ep, nmatched, alive.to(torch.int32)], dim=1)
    for t in range(P, k):
        n = 4 ** t
        for lo in range(0, n, _SEED_CHUNK):
            hi = min(lo + _SEED_CHUNK, n)
            kids = _seed_children(fmi, out[lo:hi])
            for c in range(4):
                out[c * n + lo:c * n + hi] = kids[c]
    return out


def _seed_rows_kernel(fmi: FMIndex, k: int) -> torch.Tensor:
    """Launch ``csrc/seed_rows.cu`` (K5) once: a thread a key below
    4^seed_prefix(k), each expanding its last levels (the plain version's
    schedule)."""
    global SEED_LAUNCHES
    _check_index(fmi)
    if not 1 <= k <= 15:
        raise ValueError(f"seed table k {k} outside 1..15")
    out = torch.empty((4 ** k, 6), dtype=fmi.pos_dtype, device=fmi.device)
    lib = _kernels.library()
    launch = lib.seed_rows_wide_launch if fmi.wide else lib.seed_rows_launch
    err = launch(k, *_index_args(fmi), out.data_ptr(), _stream(fmi.device))
    _kernels.check_launch(err, "seed_rows kernel launch")
    SEED_LAUNCHES += 1
    return out


def _seed_rows(fmi: FMIndex, k: int) -> torch.Tensor:
    """(4^k, 6) seed-table rows (int64 on a wide index): one launch of the K5 kernel for an
    index on the card, the plain version on the CPU."""
    if _on_card(fmi):
        return _seed_rows_kernel(fmi, k)
    return _seed_rows_plain(fmi, k)


def build_seed_table(fmi: FMIndex, k: int = 8) -> SeedTable:
    return SeedTable(rows=_seed_rows(fmi, k), k=k)


def _seed_key(patterns: torch.Tensor, lengths: torch.Tensor, k: int):
    """key = sum_t pattern[len-1-t] << 2t over the last k characters,
    in wrapping int32 arithmetic."""
    L = patterns.shape[1]
    j = torch.arange(L, dtype=torch.int32, device=patterns.device)[None, :]
    t = lengths[:, None] - 1 - j  # processing step of char j
    w = torch.where((t >= 0) & (t < k),
                    torch.ones_like(t) << (2 * t.clamp(0, 15)), 0)
    return rank_ops.wrap32((patterns * w).sum(dim=1, dtype=torch.int64))


# --------------------------------------------------------------------------
# backward search: the K3 kernel and its plain version
# --------------------------------------------------------------------------

# kernel launches made by the wrappers below (plain counters; callers
# reset them to show that a run went through the kernels)
BS_LAUNCHES = 0
UNC_LAUNCHES = 0
LOCATE_LAUNCHES = 0
ANCHOR_LAUNCHES = 0
SEED_LAUNCHES = 0
ISA_LAUNCHES = 0

_FIELDS = ("start", "end", "sp", "ep", "nmatched", "alive", "skips",
           "eff_len")


def _on_card(fmi: FMIndex) -> bool:
    """True for an index on a CUDA device, False on the CPU; any other
    device raises."""
    if fmi.device.type == "cuda":
        return True
    if fmi.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {fmi.device}")


def backward_search_plain(fmi: FMIndex, patterns, lengths, *,
                          resolve_n: bool = False, max_len: int | None = None,
                          start=None, end=None,
                          seed_table: SeedTable | None = None):
    """The plain PyTorch version of the backward-search kernel, on any
    device.  The initial state is C[c0] of the last character (t0 = 1;
    with ``resolve_n`` trailing N's are stripped first), or the given
    interval ``(start, end)`` with no length clamp (t0 = 0,
    :func:`mms_continue`), or the seed-table row of the last k
    characters (t0 = k, :func:`backward_search_seeded`).  Returns the
    dict :func:`backward_search` returns."""
    patterns = _i32(patterns, fmi)
    lengths = _i32(lengths, fmi)
    L = patterns.shape[1]
    steps = max_len if max_len is not None else L
    skips = torch.zeros_like(lengths)
    eff_len = lengths
    if start is not None:
        start, end = _pos(start, fmi), _pos(end, fmi)
        alive = end > start
        state = (start, end, start, end, torch.zeros_like(lengths), alive)
        t0 = 0
    elif seed_table is not None:
        rows = rank_ops.take_fill(
            seed_table.rows, _seed_key(patterns, lengths, seed_table.k))
        state = (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4],
                 rows[:, 5] > 0)
        t0 = seed_table.k
    else:
        if resolve_n:
            skips = trailing_n(patterns, lengths)
            eff_len = lengths - skips
        eff_len = eff_len.clamp(min=1)
        c0 = _char_at(patterns, eff_len - 1)
        if resolve_n:
            # an all-N read leaves c0 == 5; the reference reads C[5]/C[6]
            # out of bounds there (UB) — clamp to 'A'
            c0 = torch.where(c0 == 5, 0, c0)
        s0 = take_c(fmi.C, c0)
        e0 = take_c(fmi.C, c0 + 1)
        alive = e0 > s0
        state = (s0, e0, s0, e0, alive.to(torch.int32), alive)
        t0 = 1
    out = _run_loop(fmi, patterns, eff_len, state, t0, steps, resolve_n)
    return dict(zip(_FIELDS, (*out, skips, eff_len)))


def _check_index(fmi: FMIndex) -> None:
    """The index layout the kernels read through raw pointers: int32
    fields and (n, 8) rows, or for the wide index (n, 12) rows and int64
    ``C``, ``endloc`` and ``sa_samples``, the row and sample counts int32
    either way; on a card, the wide index's device layout (``rows32`` and
    ``bases``, which its kernels read in place of the 12-int rows); on a tp
    view, the blocks and the view's device tables of their pointers."""
    tp = fmi.tp
    wide = fmi.wide
    for name in ("buckets", "C", "endloc", "sa_samples"):
        t = getattr(fmi, name)
        want = torch.int64 if wide and name != "buckets" else torch.int32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"index field {name} must be contiguous "
                             f"{str(want)[6:]}")
    if (fmi.buckets.dim() != 2 or fmi.C.shape != (5,)
            or fmi.endloc.numel() != 1):
        raise ValueError("index must have (n, 8) or (n, 12) buckets, (5,) "
                         "C and a scalar endloc")
    if max(fmi.bucket_rows, fmi.sample_rows) >= 2 ** 31:
        raise ValueError("the kernels number bucket rows and samples in "
                         "int32: this index has more")
    if wide and fmi.device.type == "cuda":
        _check_device_rows(fmi)
    if tp is None:
        return
    if (fmi.buckets.shape[0] != tp.bucket_per
            or fmi.sa_samples.shape[0] != tp.sample_per):
        raise ValueError("a tp view's blocks must hold its shard's rows")
    if tp.tables is None:
        raise ValueError("a tp view on a card reads its blocks through the "
                         "device tables of their pointers, which "
                         "parallel.shard_index makes on the card")
    if tp.peers is not None and tp.peers.closed:
        raise ValueError("this tp view was released (parallel.release_view)")


def _check_device_rows(fmi: FMIndex) -> None:
    """A wide index on a card holds the layout its kernels read: rows32
    of the bucket rows (a tp view: its block of them), and the whole
    bases, one entry a superblock of the global table and the sentinel."""
    rows = fmi.buckets.shape[0]
    nsb = rank_ops.superblocks(fmi.bucket_rows)
    r32, bases = fmi.rows32, fmi.bases
    if (r32 is None or bases is None
            or r32.dtype != torch.int32 or bases.dtype != torch.int64
            or tuple(r32.shape) != (rows, rank_ops.ROW_INTS)
            or tuple(bases.shape) != (nsb + 1, 4)
            or not (r32.is_contiguous() and bases.is_contiguous())
            or r32.device != fmi.device or bases.device != fmi.device):
        raise ValueError(
            "a wide index on a card is read through its device layout: "
            f"contiguous rows32 ({rows}, {rank_ops.ROW_INTS}) int32 and bases "
            f"({nsb + 1}, 4) int64 on {fmi.device} (FMIndex.__post_init__)")
    if fmi.shard is not None and (fmi.shard.tables is None
                                  or "rows32" not in fmi.shard.tables):
        raise ValueError("a wide tp view on a card reads the blocks of its "
                         "rows32, which parallel.shard_index makes")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _index_args(fmi: FMIndex) -> tuple:
    """The index as the launch functions take it: the bucket table, its
    rows and 0 (fm::Index), or on a tp view the device table of the
    blocks' pointers, the global rows and the rows a block holds
    (fm::IndexTp); then C and endloc.  A wide index passes its rows32 as
    the table, and its bases last."""
    tp = fmi.tp
    name = "rows32" if fmi.wide else "buckets"
    if tp is None:
        rows = getattr(fmi, name)
        table = (rows.data_ptr(), rows.shape[0], 0)
    else:
        table = (tp.tables[name].data_ptr(), fmi.bucket_rows, tp.bucket_per)
    bases = (fmi.bases.data_ptr(),) if fmi.wide else ()
    return (*table, fmi.C.data_ptr(), fmi.endloc.data_ptr(), *bases)


def _sample_table(fmi: FMIndex, name: str) -> tuple:
    """A sample table (``sa_samples`` or ``isa_samples``) as the launch
    functions take it: pointer, rows and 0, or on a tp view the device
    table of its blocks' pointers, the global rows and a block's rows."""
    tp = fmi.tp
    if tp is None:
        t = getattr(fmi, name)
        return t.data_ptr(), t.shape[0], 0
    return tp.tables[name].data_ptr(), fmi.sample_rows, tp.sample_per


def _samples_args(fmi: FMIndex) -> tuple:
    """The sampled suffix array as the launch functions take it
    (fm::Samples / fm::SamplesTp; the wide launches take the length as
    a 64-bit integer)."""
    return (*_sample_table(fmi, "sa_samples"), fmi.sa_rate.bit_length() - 1,
            fmi.length)


def _check_reads(patterns: torch.Tensor, lengths: torch.Tensor) -> None:
    if patterns.dim() != 2 or lengths.shape != patterns.shape[:1]:
        raise ValueError(f"patterns (B, L) and lengths (B,) expected, got "
                         f"{tuple(patterns.shape)} and {tuple(lengths.shape)}")
    if patterns.shape[0] and patterns.shape[1] == 0:
        raise ValueError("patterns must have at least one column")


def _seed_args(fmi: FMIndex, seed_table: SeedTable | None) -> tuple:
    """The seed table as the launch functions take it (fm::SeedRows);
    nulls for none."""
    if seed_table is None:
        return None, 0, 0
    rows = seed_table.rows
    if (rows.device != fmi.device or rows.dtype != fmi.pos_dtype
            or rows.dim() != 2 or rows.shape[1] != 6
            or not rows.is_contiguous()):
        raise ValueError(
            f"seed_table.rows must be a contiguous (4^k, 6) "
            f"{str(fmi.pos_dtype)[6:]} tensor on {fmi.device}")
    return rows.data_ptr(), rows.shape[0], seed_table.k


def _backward_search_kernel(fmi: FMIndex, patterns, lengths, *,
                            resolve_n: bool = False,
                            max_len: int | None = None, start=None,
                            end=None, seed_table: SeedTable | None = None):
    """Launch ``csrc/backward_search.cu`` (K3): one thread per read.  On a
    wide index its wide instantiation writes int64 records, whose match
    count, skips and effective length come back int32 as ``bwt_tpu``'s
    do (the match count of a seeded search stays int64, as the seed
    row's is there)."""
    global BS_LAUNCHES
    _check_index(fmi)
    dev = fmi.device
    patterns = _i32(patterns, fmi).contiguous()
    lengths = _i32(lengths, fmi).contiguous()
    _check_reads(patterns, lengths)
    B, L = patterns.shape
    steps = max_len if max_len is not None else L
    out = torch.empty((len(_FIELDS), B), dtype=fmi.pos_dtype, device=dev)
    mode, sp, ep = 0, None, None
    if start is not None:
        mode = 1
        sp = _pos(start, fmi).contiguous()
        ep = _pos(end, fmi).contiguous()
        if sp.shape != (B,) or ep.shape != (B,):
            raise ValueError("start and end must be (B,)")
    elif seed_table is not None:
        mode = 2
    seed = _seed_args(fmi, seed_table if mode == 2 else None)
    if B:
        lib = _kernels.library()
        launch = (lib.backward_search_wide_launch if fmi.wide
                  else lib.backward_search_launch)
        err = launch(
            patterns.data_ptr(), lengths.data_ptr(), B, L, steps,
            int(resolve_n), mode,
            None if sp is None else sp.data_ptr(),
            None if ep is None else ep.data_ptr(), *seed,
            *_index_args(fmi), out.data_ptr(), _stream(dev))
        _kernels.check_launch(err, "backward_search kernel launch")
        BS_LAUNCHES += 1
    r = dict(zip(_FIELDS, out.unbind(0)))
    r["alive"] = r["alive"] != 0
    if fmi.wide:
        for name in ("skips", "eff_len") + (("nmatched",) if mode != 2
                                            else ()):
            r[name] = r[name].to(torch.int32)
    return r


def search_lanes(fmi: FMIndex, patterns, lengths, **kw):
    """Backward search in any of the initial-state modes of
    :func:`backward_search_plain` (same keywords): the K3 kernel for an
    index on the card, the plain version on the CPU."""
    if _on_card(fmi):
        return _backward_search_kernel(fmi, patterns, lengths, **kw)
    return backward_search_plain(fmi, patterns, lengths, **kw)


def backward_search(fmi: FMIndex, patterns, lengths, *,
                    resolve_n: bool = False, max_len: int | None = None):
    """Backward search of a read batch.

    ``patterns`` (B, L) int codes, left-aligned; ``lengths`` (B,).
    Returns a dict of (B,) tensors: start/end (final interval, frozen at
    the first empty one), sp/ep (last nonempty interval), nmatched
    (characters consumed while nonempty, counting the first), alive,
    skips (stripped trailing N's) and eff_len.  With ``resolve_n``,
    trailing N's are stripped and inner N's resolved.  On the card this
    is one launch of the K3 kernel; on the CPU, the plain version."""
    return search_lanes(fmi, patterns, lengths, resolve_n=resolve_n,
                        max_len=max_len)


def backward_search_seeded(fmi: FMIndex, table: SeedTable, patterns,
                           lengths, *, max_len: int | None = None):
    """:func:`backward_search` with the first k steps answered by the
    seed table (one row read).  Caller contract: every length >= k and
    no N among the last k characters of any read."""
    return search_lanes(fmi, patterns, lengths, max_len=max_len,
                        seed_table=table)


def _search(fmi, patterns, lengths, seed_table):
    if seed_table is not None:
        return backward_search_seeded(fmi, seed_table, patterns, lengths)
    return backward_search(fmi, patterns, lengths)


def _emptied_early(r, lengths):
    return (~r["alive"]) & (r["nmatched"] <= lengths - 2)


def reverse_search(fmi: FMIndex, patterns, lengths, seed_table=None):
    """Match count per read with the reference's +1 quirk
    (seqindex.c:228-242)."""
    lengths = _i32(lengths, fmi)
    r = _search(fmi, patterns, lengths, seed_table)
    return torch.where(_emptied_early(r, lengths), 0,
                       r["end"] - r["start"] + 1)


def count_matches(fmi: FMIndex, patterns, lengths, seed_table=None):
    """True number of matches (no reference quirk)."""
    r = _search(fmi, patterns, lengths, seed_table)
    return torch.where(r["alive"], r["end"] - r["start"], 0)


def loc_search(fmi: FMIndex, patterns, lengths, seed_table=None):
    """Final SA interval (start, end) per read (seqindex.c:280-309)."""
    r = _search(fmi, patterns, lengths, seed_table)
    return r["start"], r["end"]


# --------------------------------------------------------------------------
# SA lookup by LF walks: the K4 kernel and its plain version
# --------------------------------------------------------------------------


def _overrun(row: int, bound: int, length: int) -> RuntimeError:
    return RuntimeError(
        f"unc_sa: the LF walk from row {row} did not reach a sampled row "
        f"within length + 1 = {bound} steps; rows past the suffix array "
        f"(above {length}) can walk forever")


def unc_sa_plain(fmi: FMIndex, idx, max_steps: int | None = None):
    """The plain PyTorch version of the SA-walk kernel, on any device.
    A lane walks while its row is not a multiple of ``sa_rate``, at most
    ``length + 1`` steps (``max_steps`` lowers the cap); a lane still
    walking at that bound raises RuntimeError."""
    pos, over = unc_sa_flagged(fmi, idx, max_steps)
    if bool(over.any()):
        lane = int(over.reshape(-1).to(torch.int8).argmax())
        raise _overrun(int(pos.reshape(-1)[lane]), fmi.length + 1,
                       fmi.length)
    return pos


def unc_sa_flagged(fmi: FMIndex, idx, max_steps: int | None = None):
    """:func:`unc_sa_plain` without the raise: (positions, overran), an
    overrunning lane's position the row it walked from, as the kernels
    leave it."""
    i0 = i = _pos(idx, fmi)
    mask = fmi.sa_rate - 1
    shift = fmi.sa_rate.bit_length() - 1
    bound = fmi.length + 1
    limit = bound if max_steps is None else min(max_steps, bound)
    steps = torch.zeros_like(i)
    t = 0
    while t < limit:
        live = (i & mask) != 0
        if not bool(live.any()):
            break
        nxt = fmi.lf(i)
        i = torch.where(live, nxt, i)
        steps = steps + live.to(torch.int32)
        t += 1
    over = ((i & mask) != 0) & (limit == bound)
    x = fmi.sample_at(fmi.sa_samples, i >> shift) + steps
    pos = torch.where(x > fmi.length, x - (fmi.length + 1), x)
    return torch.where(over, i0, pos), over


def _unc_sa_kernel(fmi: FMIndex, idx, max_steps: int | None = None):
    """Launch ``csrc/unc_sa.cu`` (K4): one thread per walk; reads the
    kernel's overrun flag back and raises like :func:`unc_sa_plain`."""
    global UNC_LAUNCHES
    _check_index(fmi)
    dev = fmi.device
    i = _pos(idx, fmi)
    flat = i.reshape(-1).contiguous()
    B = flat.shape[0]
    bound = fmi.length + 1
    limit = bound if max_steps is None else min(max_steps, bound)
    out = torch.empty_like(flat)
    if B:
        flag = torch.zeros(2, dtype=fmi.pos_dtype, device=dev)
        lib = _kernels.library()
        launch = lib.unc_sa_wide_launch if fmi.wide else lib.unc_sa_launch
        err = launch(
            flat.data_ptr(), B, *_index_args(fmi), *_samples_args(fmi),
            max(limit, 0), int(limit == bound), out.data_ptr(),
            flag.data_ptr(), _stream(dev))
        _kernels.check_launch(err, "unc_sa kernel launch")
        UNC_LAUNCHES += 1
        if limit == bound:
            n_over, top = flag.tolist()  # top = B - the first lane over
            if n_over:
                raise _overrun(int(flat[B - top]), bound, fmi.length)
    return out.reshape(i.shape)


def unc_sa(fmi: FMIndex, idx, max_steps: int | None = None):
    """SA[idx] per lane by LF walks to the nearest sampled row
    (seqindex.c:244-255): a lane walks while its row is not a multiple
    of ``sa_rate``; the result is ``sa_samples[row / rate] + steps``,
    wrapped by length+1.  A walk longer than length + 1 steps (only a
    row past the suffix array takes one) raises RuntimeError.  On the
    card this is one launch of the K4 kernel; on the CPU, the plain
    version."""
    if _on_card(fmi):
        return _unc_sa_kernel(fmi, idx, max_steps)
    return unc_sa_plain(fmi, idx, max_steps)


def locate_plain(fmi: FMIndex, patterns, lengths, seed_table=None):
    """The plain PyTorch version of the locate kernel, on any device:
    the plain backward search (seeded or not), then the plain SA walk of
    every lane's interval start."""
    lengths = _i32(lengths, fmi)
    r = backward_search_plain(fmi, patterns, lengths, seed_table=seed_table)
    pos = unc_sa_plain(fmi, r["start"])
    return torch.where(_emptied_early(r, lengths), -1, pos)


def locate_kernel(fmi: FMIndex, patterns, lengths, seed_table=None):
    """Launch ``csrc/locate.cu``: one thread per read searches and walks.
    Returns (B + 2,) int32 (int64 on a wide index): the positions, then
    the kernel's flag.  It does not synchronise: :func:`locate` reads the
    flag and raises."""
    global LOCATE_LAUNCHES
    _check_index(fmi)
    dev = fmi.device
    patterns = _i32(patterns, fmi).contiguous()
    lengths = _i32(lengths, fmi).contiguous()
    _check_reads(patterns, lengths)
    B, L = patterns.shape
    seed = _seed_args(fmi, seed_table)
    out = torch.empty(B + 2, dtype=fmi.pos_dtype, device=dev)
    out[B:] = 0
    if B:
        with _span("search.locate.launch"):
            lib = _kernels.library()
            launch = lib.locate_wide_launch if fmi.wide else lib.locate_launch
            err = launch(
                patterns.data_ptr(), lengths.data_ptr(), B, L, *seed,
                *_index_args(fmi), *_samples_args(fmi), out.data_ptr(),
                _stream(dev))
            _kernels.check_launch(err, "locate kernel launch")
        LOCATE_LAUNCHES += 1
    return out


def locate(fmi: FMIndex, patterns, lengths, seed_table=None):
    """First-match position per read (seqindex.c:258-277); -1 when the
    interval emptied before the final character.  Every read's interval
    start is walked, so a start past the suffix array raises
    RuntimeError as :func:`unc_sa` does.  On the card this is one launch
    of the locate kernel; on the CPU, the plain version.  The call is the
    span ``search.locate``, the launch ``search.locate.launch``."""
    with _span("search.locate"):
        if not _on_card(fmi):
            return locate_plain(fmi, patterns, lengths, seed_table)
        out = locate_kernel(fmi, patterns, lengths, seed_table)
        B = out.shape[0] - 2
        n_over, top = out[B:].tolist()  # top = B - the first lane over
        if n_over:  # the lane's slot holds the row it walked from
            raise _overrun(int(out[B - top]), fmi.length + 1, fmi.length)
        return out[:B]


# --------------------------------------------------------------------------
# the anchor hunt of models/exact.py: the fused kernel's launch
# --------------------------------------------------------------------------

_PATTERN_ELEM = {torch.int32: 4, torch.uint8: 1, torch.int8: -1}
# the anchor-scan kernel's threads a read (kTileFwd, kTileRev in
# csrc/anchor_scan.cu): forward, and reversed where a random prefix of
# min_anchor characters rarely occurs in the genome (4^min_anchor >= 16
# (length + 1)); a reversed hunt at a shorter min_anchor takes the first
ANCHOR_TILES = (1, 16)


def anchor_scan_kernel(fmi: FMIndex, patterns: torch.Tensor,
                       lengths: torch.Tensor, *, min_anchor: int,
                       reverse: bool = False, out: torch.Tensor | None = None):
    """Launch ``csrc/anchor_scan.cu``: a tile of threads per read
    (:data:`ANCHOR_TILES`) runs the whole anchor hunt
    (``models.exact.anchor_scan_plain``), consecutive trips side by side,
    and the SA walk of its last anchor.  ``patterns`` (B, L) int32, uint8
    or int8 codes and ``lengths`` (B,) int32, contiguous, on the index's
    device.  Returns ``out``, (2B + 4,) int32 (int64 on a wide index): the
    anchor counts, the positions, and the kernel's flag (pass an all-zero
    ``out`` to reuse one).  It does not
    synchronise: the caller reads the flag with the results and hands
    both to :func:`anchor_scan_raise`."""
    global ANCHOR_LAUNCHES
    _check_index(fmi)
    dev = fmi.device
    _check_reads(patterns, lengths)
    B, L = patterns.shape
    for name, t, ok in (("patterns", patterns, tuple(_PATTERN_ELEM)),
                        ("lengths", lengths, (torch.int32,))):
        if t.device != dev or t.dtype not in ok or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev} "
                             f"of dtype {' / '.join(map(str, ok))}")
    dt = fmi.pos_dtype
    if out is None:
        out = torch.zeros(2 * B + 4, dtype=dt, device=dev)
    elif (out.device != dev or out.dtype != dt
          or out.shape != (2 * B + 4,) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous (2B + 4,) "
                         f"{str(dt)[6:]} tensor on {dev}")
    if not -2 ** 31 <= min_anchor < 2 ** 31:
        raise ValueError(f"min_anchor {min_anchor} is not an int32")
    if B:
        lib = _kernels.library()
        launch = (lib.anchor_scan_wide_launch if fmi.wide
                  else lib.anchor_scan_launch)
        err = launch(
            patterns.data_ptr(), _PATTERN_ELEM[patterns.dtype],
            lengths.data_ptr(), B, L, int(min_anchor), int(reverse),
            *_index_args(fmi), *_samples_args(fmi), out.data_ptr(),
            _stream(dev))
        _kernels.check_launch(err, "anchor_scan kernel launch")
        ANCHOR_LAUNCHES += 1
    return out


def no_progress(read: int, min_anchor: int) -> RuntimeError:
    """What the anchor hunt raises, from the kernel's flag or from the
    plain version, for a trip that would repeat forever."""
    return RuntimeError(
        f"anchor_scan: read {read} made an anchor that consumes nothing "
        f"(matched + skipped <= 0 passes min_anchor = {min_anchor}); the "
        f"hunt would never end")


def anchor_scan_raise(fmi: FMIndex, out, min_anchor: int,
                      first: int = 0) -> None:
    """Raise what the flag of an :func:`anchor_scan_kernel` output says:
    a hunt that made no progress, or a walk from a row past the suffix
    array.  ``out`` is the kernel's (2B + 4,) output, as a tensor on any
    device (reading it synchronises) or as a numpy array; ``first`` is
    the number of the batch's first read, for the message."""
    B = (len(out) - 4) // 2
    n_over, top_over, n_stuck, top_stuck = out[2 * B:].tolist()
    if n_stuck:
        raise no_progress(first + B - top_stuck, min_anchor)
    if n_over:  # the lane's position slot holds the row it walked from
        raise _overrun(int(out[B + B - top_over]), fmi.length + 1, fmi.length)


def isa_window_plain(fmi: FMIndex, plo, width, *, W: int = 32):
    """The plain PyTorch version of the inverse-SA window kernel, on any
    device: every lane chains down together, one LF step an iteration."""
    refuse_wide(fmi, "isa_window")
    if fmi.isa_samples is None:
        raise ValueError("isa_window requires an index with isa_samples")
    plo = _i32(plo, fmi)
    width = _i32(width, fmi)
    n, r = fmi.length, fmi.sa_rate
    shift = r.bit_length() - 1
    B = plo.shape[0]
    p_hi = torch.clamp(plo + width - 1, max=n)
    anchor = torch.clamp(((p_hi + r - 1) >> shift) << shift, 0, n)
    # anchor in [0, n] keeps its sample in the table
    row = fmi.sample_at(fmi.isa_samples, anchor >> shift)
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
        nxt = fmi.lf(row)
        row = torch.where(pcur > floor, nxt, row)
    return out


def _isa_args(fmi: FMIndex) -> tuple:
    """The inverse-SA samples as the launch functions take them
    (fm::Isa / fm::IsaTp, as :func:`_sample_table`)."""
    isa = fmi.isa_samples
    if isa is None:
        raise ValueError("isa_window requires an index with isa_samples")
    if isa.dtype != torch.int32 or not isa.is_contiguous():
        raise ValueError("index field isa_samples must be contiguous int32")
    return _sample_table(fmi, "isa_samples")


def isa_tile(rate: int, W: int) -> int:
    """The threads a window of the K6 kernel (``csrc/isa_window.cu``) at
    sample rate ``rate`` and row width ``W``: the most ISA sample segments
    (the positions p with one ceil(p / rate)) that W consecutive positions
    touch, rounded down to a power of two, at most a warp (8 at rate 4 and
    W = 32, where a window of 9 segments gives one thread two; 2 at rate
    32).  The source's header has each tile's time."""
    segments = (max(W, 1) + rate - 2) // rate + 1
    return min(32, 1 << (segments.bit_length() - 1))


def _isa_window_kernel(fmi: FMIndex, plo, width, *, W: int = 32,
                       tile: int | None = None):
    """Launch ``csrc/isa_window.cu`` (K6): a tile of threads a window, each
    chaining one ISA sample segment of it; ``tile`` (a power of two up to
    32) overrides :func:`isa_tile`, for timing the other tiles."""
    global ISA_LAUNCHES
    refuse_wide(fmi, "isa_window")
    _check_index(fmi)
    isa = _isa_args(fmi)
    plo = _i32(plo, fmi).contiguous()
    width = _i32(width, fmi).contiguous()
    if plo.dim() != 1 or width.shape != plo.shape:
        raise ValueError("plo and width must be (B,)")
    B = plo.shape[0]
    out = torch.empty((B, W), dtype=torch.int32, device=fmi.device)
    if B and W > 0:
        lib = _kernels.library()
        err = lib.isa_window_launch(
            plo.data_ptr(), width.data_ptr(), B, W, *_index_args(fmi), *isa,
            fmi.sa_rate.bit_length() - 1, fmi.length,
            isa_tile(fmi.sa_rate, W) if tile is None else tile,
            out.data_ptr(), _stream(fmi.device))
        _kernels.check_launch(err, "isa_window kernel launch")
        ISA_LAUNCHES += 1
    return out


def isa_window(fmi: FMIndex, plo, width, *, W: int = 32):
    """``rows[b, j] = SA^-1[plo[b]+j]`` for ``j < width[b]`` and ``0 <=
    plo+j <= length``, else -1: anchor at the ISA sample at or above the
    window's top and LF-chain downward (``ISA[p-1] = lf(ISA[p])``).
    Needs ``fmi.isa_samples``.  Contract: ``width <= W``.  On the card
    this is one launch of the K6 kernel; on the CPU, the plain version.
    A wide index raises ValueError, as ``bwt_tpu`` has no wide form of it
    (its chain's loop carry breaks there)."""
    if _on_card(fmi):
        return _isa_window_kernel(fmi, plo, width, W=W)
    return isa_window_plain(fmi, plo, width, W=W)


def mms(fmi: FMIndex, patterns, lengths):
    """Maximum mappable suffix (seqindex.c:314-351).  Returns (matched,
    sp, ep); matched includes the stripped trailing N's."""
    r = backward_search(fmi, patterns, lengths, resolve_n=True)
    return r["nmatched"] + r["skips"], r["sp"], r["ep"]


def mms_continue(fmi: FMIndex, patterns, lengths, sp, ep):
    """Continuation of an MMS search (single_align.c:26-46): processes
    pattern[len-1] .. pattern[0] from interval (sp, ep).  Returns
    (matched, sp', ep'); an empty incoming interval yields -1."""
    sp, ep = _pos(sp, fmi), _pos(ep, fmi)
    r = search_lanes(fmi, patterns, lengths, resolve_n=True, start=sp,
                     end=ep)
    return r["nmatched"] - (ep <= sp).to(torch.int32), r["sp"], r["ep"]
