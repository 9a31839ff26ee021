"""The fused service round: every FM-index request of one executor round
answered together, over (B,) int32 lane fields.

The counterpart of ``bwt_tpu.models.batch_exec._service_core``.  A lane
carries an opcode and runs, by opcode, a backward search over a slice of
the pattern bank (mms, mms_continue and raw backward search under their
own rules for N's, the initial interval and the match count), the SA walk
its caller asks next, the inverse-SA window scan of the ``_ext`` opcodes
and the C[c] + rank adjunct.  On the card the whole round is one launch of
``csrc/service.cu`` (K7, one thread a lane over the device functions of
``csrc/fm_search.cuh``, a tile of four a lane on a round of at most 2^14
lanes, which scans an ``_ext`` lane's window in slices); on the CPU the same
wrapper runs
:func:`service_round_plain`, the lockstep PyTorch version, which also runs
on the card when asked (``plain=True``), to compare the two.

Result columns, in ``bwt_tpu``'s order: ``MMS_M`` (mms match count,
stripped N's included), ``CONT_M`` (mms_continue's, -1 for an empty
incoming interval), ``START`` / ``END`` (the final, possibly empty
interval), ``OSP`` / ``OEP`` (the last nonempty one), ``NM``, ``ALIVE``,
``SKIPS``, ``POS`` (the walk), ``CRANK``, ``WBEST`` / ``WROW`` (the window
scan's genome position and SA row, -1 for none).  Every column is defined
on every lane, padding lanes included, and equal between the kernel and
the plain version.

Not carried over from ``bwt_tpu``: the speculative anchor retries
(``spec_anch`` / ``am``), the sharded index (``tp_axis``), ``full_steps``
and the walk's compaction ladder (a thread stops on its own).
"""

from __future__ import annotations

import torch

from bwt_tpu_torch.index import FMIndex, refuse_wide
from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.ops import search

# service opcodes (the numbers of bwt_tpu.models.batch_exec)
OP_NONE, OP_MMS, OP_CONT, OP_BSEARCH, OP_UNC, OP_CRANK = 0, 1, 2, 3, 4, 5
OP_MEXT, OP_BEXT = 6, 7

(MMS_M, CONT_M, START, END, OSP, OEP, NM, ALIVE, SKIPS, POS, CRANK, WBEST,
 WROW) = range(13)
NCOLS = 13
W = 32  # positions of one inverse-SA window

_I32_MAX = 0x7FFFFFFF

# kernel launches made by service_round_packed (a plain counter; callers
# reset it to show that a run went through the kernel)
SERVICE_LAUNCHES = 0


def consumes_pos(opc):
    """Lanes whose reply reads ``POS``: with ``ext`` the walk runs only if
    the round has one (``bwt_tpu``'s ``lax.cond``)."""
    return ((opc == OP_MMS) | (opc == OP_CONT) | (opc == OP_BSEARCH)
            | (opc == OP_BEXT) | (opc == OP_UNC))


def service_round_plain(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx, *,
                        resolve: bool, ext: bool = False, seed_rows=None,
                        seed_k: int = 0, width: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the service kernel, on any device:
    every lane steps through its characters together, finished lanes are
    masked out, and the loop stops once no lane is active.

    ``bank`` (R, Lb) integer codes; the seven (B,) int32 fields: ``opc``;
    ``row``, ``off``, ``ln`` address ``bank[row, off:off+ln]``; ``sp`` /
    ``ep`` carry the incoming interval (mms_continue), curpos / curgap
    (mms_ext), the window's low end / width (bsearch_ext), ``sp`` the
    symbol (crank); ``idx`` the walk's row (unc_sa) or the rank's index
    (crank).  ``resolve`` turns on N handling for mms and mms_continue
    lanes (seqindex.c:317-340; a raw backward search never resolves);
    ``ext`` the window scan; ``seed_rows`` (4^seed_k, 6) lets mms and raw
    lanes with ``ln > 0``, at least ``seed_k`` effective characters and no
    N among the first ``seed_k`` start from their table row.  Out-of-range
    operands read like ``jnp.take``: a bank row or a table key in [-n, 0)
    wraps and one further out reads the int32 minimum, a column clips.
    ``width`` rehearses the kernel's tile on an ``ext`` round (a power of
    two up to 32): the window cut into ``width`` slices of ceil(wwid /
    width) positions, each chained from the sample above its own top, and
    the least in-interval row taken over the slices; the columns are the
    same at every width.  Returns the (13, B) int32 result columns.  A
    walk from a row past the suffix array raises RuntimeError
    (:func:`search.unc_sa_plain`)."""
    cols, over = service_round_flagged(
        fmi, bank, opc, row, off, ln, sp, ep, idx, resolve=resolve, ext=ext,
        seed_rows=seed_rows, seed_k=seed_k, width=width)
    if bool(over.any()):
        lane = int(over.to(torch.int8).argmax())
        raise search._overrun(int(cols[POS, lane]), fmi.length + 1,
                              fmi.length)
    return cols


def service_round_flagged(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx,
                          *, resolve: bool, ext: bool = False,
                          seed_rows=None, seed_k: int = 0, width: int = 1):
    """:func:`service_round_plain` without the raise: (columns, overran),
    (B,) bool, an overrunning lane's ``POS`` the row it walked from, as the
    kernel leaves it."""
    refuse_wide(fmi, "the service round")
    bank = bank.to(torch.int32)
    B = opc.shape[0]
    Lb = bank.shape[1]
    dev = opc.device
    is_mms = (opc == OP_MMS) | (opc == OP_MEXT)
    is_cont = opc == OP_CONT
    is_bs = (opc == OP_BSEARCH) | (opc == OP_BEXT)
    in_loop = is_mms | is_cont | is_bs
    resolve_lane = is_mms | is_cont
    zeros = torch.zeros_like(opc)

    pats = rank_ops.take_fill(bank, row)  # (B, Lb)
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
    # steps per lane: mms strips trailing N (min 1); a raw search runs ln
    # (min 1); mms_continue has no initial-character step, modelled as
    # ln + 1 steps with step 1 on char ln-1 (single_align.c:31-44)
    eff = torch.where(is_cont, ln + 1,
                      torch.where(is_mms, ln - skips, ln).clamp(min=1))

    if seed_rows is not None:
        # the characters of steps 0..k-1 sit at window steps skips ..
        # skips+k-1; a seeded lane enters the loop shifted by k - 1
        can_seed = (is_mms | is_bs) & (ln > 0) & (eff >= seed_k)
        wj = j_of_p - skips[:, None]
        inw = (wj >= 0) & (wj < seed_k) & in_read
        if resolve:
            can_seed = can_seed & ~(inw & (pats == 5)).any(dim=1)
        wts = torch.where(inw, torch.ones_like(wj) << (2 * wj.clamp(0, 15)),
                          0)
        key = rank_ops.wrap32((pats.to(torch.int64) * wts).sum(dim=1))
        srow = rank_ops.take_fill(seed_rows, torch.where(can_seed, key, 0))
        tsh = torch.where(can_seed, seed_k - 1, 0).to(torch.int32)
    else:
        tsh = zeros

    def char_at(t):
        ci = (off + eff - 1 - t - tsh).clamp(0, Lb - 1).long()
        return pats.gather(1, ci[:, None]).squeeze(1)

    c0 = char_at(0)
    # ln <= 0 is reference UB (pattern[len-1] out of bounds): the search
    # sees 'A' and takes no steps
    c0 = torch.where((is_mms | is_bs) & (ln <= 0), 0, c0)
    if resolve:
        c0 = torch.where(is_mms & (c0 == 5), 0, c0)  # all-N read -> 'A'
    start = torch.where(is_cont, sp, search.take_c(fmi.C, c0))
    end = torch.where(is_cont, ep, search.take_c(fmi.C, c0 + 1))
    alive = end > start
    incoming_empty = is_cont & ~alive
    nmatched = (alive & ~is_cont).to(torch.int32)
    osp, oep = start, end
    if seed_rows is not None:
        start = torch.where(can_seed, srow[:, 0], start)
        end = torch.where(can_seed, srow[:, 1], end)
        osp = torch.where(can_seed, srow[:, 2], osp)
        oep = torch.where(can_seed, srow[:, 3], oep)
        nmatched = torch.where(can_seed, srow[:, 4], nmatched)
        alive = torch.where(can_seed, srow[:, 5] > 0, alive)

    steps = int(torch.where(in_loop, eff - tsh, 0).max()) if B else 0
    for t in range(1, steps):
        active = alive & (t + tsh <= eff - 1) & in_loop
        if not bool(active.any()):
            break
        c = char_at(t)
        if resolve:
            c, ns, ne = search._resolve_step(fmi, c, start, end, resolve_lane)
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
    # mms lanes walk from the match interval's start, mms_continue and raw
    # lanes from the final, possibly empty interval's (the callers' quirk
    # value, rnaseqtest.c:55/:67), mms_ext lanes from row 0
    walk0 = torch.where(opc == OP_UNC, idx,
                        torch.where(opc == OP_MMS, osp,
                                    torch.where(is_cont | is_bs, start,
                                                zeros)))
    # an ext round walks only if one of its lanes consumes POS
    walks = not ext or bool(consumes_pos(opc).any())
    if walks:
        pos_out, over = search.unc_sa_flagged(fmi, walk0)
    else:
        pos_out, over = zeros, torch.zeros_like(opc, dtype=torch.bool)
    if ext:
        m_ext = opc == OP_MEXT
        any_ext = m_ext | (opc == OP_BEXT)
        # mms_ext: |pos + seglen - curpos| <= curgap + 3 as a window over
        # the mms interval [osp, oep) (single_align.c:218-223);
        # bsearch_ext: the caller's [lo, lo + width) over the final
        # interval [start, end) (rnaseqtest.c:110-121)
        wlo = torch.where(m_ext, sp - matched_mms - (ep + 3), sp)
        wwid = torch.where(m_ext, 2 * (ep + 3) + 1, ep)
        wwid = torch.where(any_ext, wwid.clamp(0, W), zeros)
        ilo = torch.where(m_ext, osp, start)[:, None]
        ihi = torch.where(m_ext, oep, end)[:, None]
        # the minimal in-interval row is the first entry the reference's
        # sequential SA-row scan would accept; the rows of distinct
        # positions are distinct, so the least over the slices is it
        size = (wwid + width - 1) // width
        best = torch.full_like(opc, _I32_MAX)
        best_j = zeros
        for q in range(_width(width)):
            lo = q * size
            rows = search.isa_window_plain(
                fmi, wlo + lo, torch.minimum(size, wwid - lo).clamp(min=0),
                W=W)
            valid = (rows >= ilo) & (rows < ihi) & (rows >= 0)
            least, j = torch.where(valid, rows, _I32_MAX).min(dim=1)
            take = least < best
            best = torch.where(take, least, best)
            best_j = torch.where(take, lo + j.to(torch.int32), best_j)
        has = (best != _I32_MAX) & any_ext
        wbest = torch.where(has, wlo + best_j, -1)
        wrow = torch.where(has, best, -1)
    else:
        wbest = wrow = torch.full_like(opc, -1)

    is_crank = opc == OP_CRANK
    c_arg = torch.where(is_crank, sp, zeros).clamp(0, 4)
    i_arg = torch.where(is_crank, idx, zeros)
    crank = rank_ops.wrap32(
        search.take_c(fmi.C, c_arg).to(torch.int64)
        + fmi.rank(c_arg, i_arg).to(torch.int64))
    return torch.stack([matched_mms, matched_cont, start, end, osp, oep,
                        nmatched, alive.to(torch.int32), skips, pos_out,
                        crank, wbest, wrow]), over


def _width(width: int) -> int:
    if width not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"width {width} is not a power of two up to 32")
    return width


_BANK_ELEM = {torch.int32: 4, torch.uint8: 1}


def _service_kernel(fmi: FMIndex, bank, fields, *, resolve, ext, seed_rows,
                    seed_k, walk) -> torch.Tensor:
    """Launch ``csrc/service.cu`` (K7): one thread a lane, a tile of
    threads on a small round (the kernel picks).  Returns the
    flat (13 B + 2,) output, columns then flag, without synchronising."""
    global SERVICE_LAUNCHES
    refuse_wide(fmi, "the service round")
    search._check_index(fmi)
    dev = fmi.device
    B = fields[0].shape[0]
    if (bank.device != dev or bank.dtype not in _BANK_ELEM or bank.dim() != 2
            or bank.shape[1] == 0 or not bank.is_contiguous()):
        raise ValueError(f"bank must be a contiguous (R, Lb) int32 or uint8 "
                         f"tensor on {dev}")
    for f in fields:
        if (f.device != dev or f.dtype != torch.int32 or f.shape != (B,)
                or not f.is_contiguous()):
            raise ValueError(f"the lane fields must be contiguous (B,) int32 "
                             f"tensors on {dev}")
    isa = search._isa_args(fmi) if ext else (None, 0, 0)
    table = (None if seed_rows is None
             else search.SeedTable(rows=seed_rows, k=seed_k))
    if table is not None and not 1 <= seed_k <= 15:
        raise ValueError(f"seed_k {seed_k} outside 1..15")
    out = torch.empty(NCOLS * B + 2, dtype=torch.int32, device=dev)
    out[NCOLS * B:] = 0
    if B:
        if walk is None:  # a synchronising read; the executor passes it
            walk = not ext or bool(consumes_pos(fields[0]).any())
        lib = _kernels.library()
        err = lib.service_launch(
            bank.data_ptr(), _BANK_ELEM[bank.dtype], bank.shape[0],
            bank.shape[1], *(f.data_ptr() for f in fields), B, int(resolve),
            int(ext), int(walk), *search._seed_args(fmi, table),
            *search._index_args(fmi), *search._samples_args(fmi),
            *isa, out.data_ptr(), search._stream(dev))
        _kernels.check_launch(err, "service kernel launch")
        SERVICE_LAUNCHES += 1
    return out


def service_round_packed(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx,
                         *, resolve: bool, ext: bool = False, seed_rows=None,
                         seed_k: int = 0, walk: bool | None = None,
                         plain: bool = False) -> torch.Tensor:
    """One service round as one flat (13 B + 2,) int32 tensor: the result
    columns (column c at [c B, (c + 1) B)), then the walk's overrun flag
    (its count of lanes, and B - the first such lane, whose ``POS`` slot
    then holds the row it walked from).  On the card this is one launch of
    the service kernel and does not synchronise: the caller copies the
    tensor back once and hands it to :func:`service_raise`.  On the CPU,
    or anywhere with ``plain``, it runs :func:`service_round_plain`, which
    raises by itself.  ``walk`` says whether an ``ext`` round has a lane
    that consumes ``POS`` (None: read from ``opc``, which synchronises on
    the card); ``bank`` is int32 or uint8."""
    fields = (opc, row, off, ln, sp, ep, idx)
    if plain or not search._on_card(fmi):
        cols = service_round_plain(fmi, bank, *fields, resolve=resolve,
                                   ext=ext, seed_rows=seed_rows,
                                   seed_k=seed_k)
        return torch.cat([cols.reshape(-1), cols.new_zeros(2)])
    return _service_kernel(fmi, bank, fields, resolve=resolve, ext=ext,
                           seed_rows=seed_rows, seed_k=seed_k, walk=walk)


def service_raise(fmi: FMIndex, out) -> None:
    """Raise what the flag of a :func:`service_round_packed` output says: a
    walk from a row past the suffix array.  ``out`` is the flat output, as
    a tensor on any device (reading it synchronises) or a numpy array."""
    B = (len(out) - 2) // NCOLS
    n_over, top = out[NCOLS * B:].tolist()
    if n_over:
        raise search._overrun(int(out[POS * B + B - top]), fmi.length + 1,
                              fmi.length)


def service_round(fmi: FMIndex, bank, opc, row, off, ln, sp, ep, idx,
                  **kw) -> torch.Tensor:
    """One service round (the keywords of :func:`service_round_packed`):
    the (13, B) result columns, after the flag has been read; a walk past
    the suffix array raises RuntimeError."""
    out = service_round_packed(fmi, bank, opc, row, off, ln, sp, ep, idx,
                               **kw)
    service_raise(fmi, out)
    return out[:-2].view(NCOLS, -1)
