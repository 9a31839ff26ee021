"""The device automatons: a whole main loop's phase machine, one read a lane,
run on the device to its end.  Two of them: rna_seq's (K9) and the
aligner's (K10), below it.

``rna_seq_automaton`` is the counterpart of
``bwt_tpu.models.rnaseq._rna_seq_automaton``, the rna_seq main loop
(rnaseqtest.c:172-243) as one jitted ``lax.while_loop`` there.  Every
iteration a live read issues the service request its host generator would
yield next and moves its phase by the reply:

  ANCHOR, GAP, CONTC  ``bsearch`` over ``bank[b, 0:i]`` (the anchor hunt,
                      the gap hunt, a continuation too short for its
                      checkpoint);
  CONT1               ``bsearch_ext`` over ``bank[b, i-cc+1 : i]`` with the
                      window ``[res-cc-6, res)`` (mms_continue's phase 1
                      and its checkpoint scan);
  CONT2               ``mms_continue_full`` over ``bank[b, 0 : i-cc+1]``
                      from the interval CONT1 narrowed to.

On the card this is one launch of ``csrc/rnaseq_automaton.cu`` (K9): a
tile of :data:`TILE` threads a read keeps the read's state in registers and
runs the machine over the service kernel's lane body until the read is
done or the cap, the searches of a hunt side by side, one a thread, and
CONT1's window scan in slices.  On the CPU, or anywhere with ``plain``, the
same wrapper runs :func:`rna_seq_automaton_plain`, the lockstep version
over the plain service round; its ``width`` rehearses the tile's schedule
(``width`` candidate iterations a round, consumed in order) with the same
outputs at every width.

The iteration cap (``4 * Lb + 64``, or ``cap_steps``) is a bound with a
flag: a read still live there comes back ``capped`` and its ``res`` is not
its result; the caller re-runs it on the host.  Not carried over from
``bwt_tpu``: the compaction ladder (``_ladder``, ``_COMPACT_AT``), a
lockstep remedy, since a tile stops on its own.
"""

from __future__ import annotations

import torch

from bwt_tpu_torch.index import FMIndex
from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import search
from bwt_tpu_torch.ops import service as sv

# the phases of bwt_tpu.models.rnaseq
P_DONE, P_ANCHOR, P_CONT1, P_CONTC, P_CONT2, P_GAP = range(6)
GIVE_UP = 18  # the main loop's hardcoded while (i > 18), rnaseqtest.c:209

# kernel launches made by rna_seq_automaton_packed (a plain counter;
# callers reset it to show that a run went through the kernel)
AUTOMATON_LAUNCHES = 0

# what a lane's candidate did in a round of the plain versions, as they
# hand it to ``on_round``: not issued, issued past the one consumed, then
# by phase; K10's codes carry two more bits, a RESET and a strand retry
EV_NONE, EV_SPEC = 0, 1
RNA_EVENTS = ("none", "spec", "anchor_hit", "anchor_miss", "gap", "cont1",
              "cont2", "contc")
EV_ANCHOR_HIT, EV_ANCHOR_MISS, EV_GAP, EV_CONT1, EV_CONT2, EV_CONTC = range(
    2, 8)
ALIGN_EVENTS = ("none", "spec", "anch_hit", "anch_miss", "anch_fail",
                "ext_accept", "ext_reject", "head")
EV_ANCH_HIT, EV_ANCH_MISS, EV_ANCH_FAIL, EV_EXT_ACCEPT, EV_EXT_REJECT, \
    EV_HEAD = range(2, 8)
EV_RESET, EV_RETRY = 8, 16

# the kernels' tile (csrc's svc::kAutomatonTile): the threads a read, each
# running one candidate iteration of a round
TILE = 4


def _width(width: int) -> int:
    if width not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"width {width} is not a power of two up to 32")
    return width


def default_cap(Lb: int) -> int:
    """The iteration cap for a bank of ``Lb`` columns: every chain of at
    most three iterations (CONT1, CONT2, the gap entry) lowers ``i`` by at
    least one or ends the read, so 3 Lb plus slack bounds a read."""
    return 4 * Lb + 64


def _outer(x, cc: int):
    """The main loop's while (i > 18) test and the i -= 3 continuation entry
    (rnaseqtest.c:209-219)."""
    y = x - 3
    ph_c = torch.where(y < cc, P_CONTC, P_CONT1)
    return (torch.where(x > GIVE_UP, ph_c, P_DONE).to(torch.int32),
            torch.where(x > GIVE_UP, y, x))


def _to_gap(x, ac: int, cc: int):
    """The gap hunt's entry and step: while (i > ac) { --i; mms_gap }
    (rnaseqtest.c:227-236); an exhausted hunt falls through to
    :func:`_outer`."""
    ph_o, i_o = _outer(x, cc)
    again = x > ac
    return (torch.where(again, P_GAP, ph_o).to(torch.int32),
            torch.where(again, x - 1, i_o))


def rna_seq_automaton_plain(fmi: FMIndex, bank, lens, live0, seed_rows=None,
                            *, ac: int, cc: int, resolve: bool,
                            cap_steps: int = 0, seed_k: int = 0,
                            width: int = 1, on_round=None):
    """The plain PyTorch version of K9, on any device: every live read
    takes its iterations together, one service round at a time, until no
    read is live or the cap; the transition is a line-for-line twin of
    ``bwt_tpu``'s while_loop body.  ``bank`` (R, Lb) integer codes, one read
    a row; ``lens`` (R,) int32; ``live0`` (R,) bool, False on padding rows.

    ``width`` is K9's tile schedule (a power of two up to 32; 1 is the
    lockstep of one iteration a round): in the anchor hunt and the gap
    hunt a round issues up to ``width`` candidate iterations a read, the
    searches at ``i - q`` that the sequential run takes next while each
    before it finds nothing and the hunt goes on, under the cap; the first
    one the run stops at, else the last, is consumed with every one before
    it.  CONT1 and CONT2 issue one.  The outputs are the same at every
    width.  ``on_round(fields, cols, events)``, when given, sees each
    round's seven lane fields and 13 result columns over ``R * width``
    lanes (read b's candidate q at lane ``b * width + q``) and what each
    lane's candidate did (:data:`RNA_EVENTS`).

    Returns (res, capped, iters), (R,) int32 each: the first anchor's
    position, whether the read was still live at the cap, and the
    iterations it ran.  A walk from a row past the suffix array raises
    RuntimeError naming the first read to overrun, at its earliest
    iteration."""
    T = _width(width)
    R, Lb = bank.shape
    dev = bank.device
    cap = cap_steps if cap_steps else default_cap(Lb)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    q = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    bank = bank.to(torch.int32)
    ph = torch.where(live0.to(dev, torch.bool), P_ANCHOR,
                     P_DONE).to(torch.int32)
    i = lens.to(dev, torch.int32)
    res = torch.full((R,), -1, dtype=torch.int32, device=dev)
    cs, ce, iters = zeros, zeros, zeros
    halted = torch.zeros(R, dtype=torch.bool, device=dev)
    over_key = torch.zeros(R, dtype=torch.int64, device=dev)
    while True:
        run = (ph != P_DONE) & (iters < cap) & ~halted
        if not bool(run.any()):
            break
        anchor = run & (ph == P_ANCHOR)
        gap_like = run & ((ph == P_GAP) | (ph == P_CONTC))
        c1, c2 = run & (ph == P_CONT1), run & (ph == P_CONT2)
        # the candidates: the hunts step i down by one while i > ac
        hunting = (anchor | gap_like)[:, None]
        issued = run[:, None] & ((q == 0) | (hunting & (i[:, None] - q + 1
                                                        > ac)))
        issued = issued & (iters[:, None] + q < cap)
        i_q = i[:, None] - q
        opc = torch.where(~issued, sv.OP_NONE, torch.where(
            hunting, sv.OP_BSEARCH, torch.where(c1[:, None], sv.OP_BEXT,
                                                sv.OP_CONT)))
        c1q, c2q = c1[:, None], c2[:, None]
        off = torch.where(c1q, i_q - cc + 1, 0)
        ln = torch.where(c1q, cc - 1, torch.where(
            c2q, i_q - cc + 1, torch.where(issued, i_q, 0)))
        sp = torch.where(c1q, res[:, None] - cc - 6,
                         torch.where(c2q, cs[:, None], 0))
        ep = torch.where(c1q, cc + 6, torch.where(c2q, ce[:, None], 0))
        fields = [x.to(torch.int32).expand(R, T).reshape(-1)
                  for x in (opc, rows[:, None], off, ln, sp, ep, 0 * opc)]
        cols, over = sv.service_round_flagged(
            fmi, bank, *fields, resolve=resolve, ext=True,
            seed_rows=seed_rows, seed_k=seed_k)
        cq = cols.view(sv.NCOLS, R, T)
        over = over.view(R, T)

        # which candidate the sequential run stops at: a hunt goes on
        # while nothing is found and i > ac
        alive_q, nm_q, pos_q = cq[sv.ALIVE] > 0, cq[sv.NM], cq[sv.POS]
        full_q = alive_q | (nm_q >= i_q - 1)
        found_q = torch.where(full_q, pos_q, torch.where(
            anchor[:, None] & (nm_q + 2 > ac), pos_q + 1, -1)) != -1
        goes_on = hunting & ~found_q & (i_q > ac)
        stop = issued & (over | ~goes_on)
        qs = torch.where(stop.any(1), stop.to(torch.int8).argmax(1),
                         issued.sum(1) - 1).clamp(min=0)
        sel = cq.gather(2, qs.reshape(1, R, 1).expand(sv.NCOLS, R, 1))[..., 0]
        qs = torch.where(run, qs.to(torch.int32), 0)
        # the state after the qs searches that found nothing before it
        i = i - qs
        iters = iters + qs
        # a walk past the suffix array stops its read where it happened
        over_sel = run & over.gather(1, qs[:, None].long())[:, 0]
        over_key = torch.where(
            over_sel, ((cap - iters).to(torch.int64) << 32) | (R - rows),
            over_key)
        res = torch.where(over_sel, sel[sv.POS], res)
        halted = halted | over_sel
        run = run & ~over_sel
        st, en = sel[sv.START], sel[sv.END]
        nm, alive = sel[sv.NM], sel[sv.ALIVE] > 0
        pos, wrow = sel[sv.POS], sel[sv.WROW]

        # the success exit of GAP, CONTC and CONT2: mmslen == i, so
        # i -= mmslen lands on 0 and _outer(0) is DONE
        ph_f, i_f = _to_gap(i, ac, cc)

        # ANCHOR: _eval_mms_search and the anchor hunt (rnaseqtest.c:197-201)
        full = alive | (nm >= i - 1)
        mmspos = torch.where(full, pos, torch.where(nm + 2 > ac, pos + 1, -1))
        mmslen = torch.where(full, i, nm + 3)
        hunt = (mmspos == -1) & (i > ac)
        ph_acc, i_acc = _outer(i - mmslen, cc)
        a_ph = torch.where(hunt, P_ANCHOR, ph_acc)
        a_i = torch.where(hunt, i - 1, i_acc)
        a_res = torch.where(hunt, res, mmspos)

        # GAP, CONTC: _eval_mms_gap (rnaseqtest.c:131-160; mms_continue
        # on a length under the cutoff collapses to mms_gap)
        gsucc = torch.where(alive | (nm >= i - 1), pos, -1) != -1
        g_ph = torch.where(gsucc, P_DONE, ph_f)
        g_i = torch.where(gsucc, 0, i_f)

        # CONT1: mms_continue's phase 1; a dead interval fails to the gap
        # hunt, else narrow to the window's row when there is one
        # (rnaseqtest.c:84-121)
        ncs = torch.where(wrow >= 0, wrow, st)
        nce = torch.where(wrow >= 0, wrow + 1, en)
        c1_ph = torch.where(alive, P_CONT2, ph_f)
        c1_i = torch.where(alive, i, i_f)

        # CONT2: mms_continue's phase 2 over pattern[:i-cc+1]
        l2 = i - cc + 1
        c2succ = torch.where(alive | (nm >= l2 - 1), pos, -1) != -1
        c2_ph = torch.where(c2succ, P_DONE, ph_f)
        c2_i = torch.where(c2succ, 0, i_f)

        if on_round is not None:
            ev = torch.where(anchor, torch.where(
                hunt, EV_ANCHOR_MISS, EV_ANCHOR_HIT), torch.where(
                    c1, EV_CONT1, torch.where(c2, EV_CONT2, torch.where(
                        (ph == P_CONTC) & (qs == 0), EV_CONTC, EV_GAP))))
            before = torch.where(anchor, EV_ANCHOR_MISS, EV_GAP)[:, None]
            before = torch.where((q == 0) & (ph == P_CONTC)[:, None],
                                 EV_CONTC, before)
            events = torch.where(q < qs[:, None], before, torch.where(
                q == qs[:, None], ev[:, None], EV_SPEC))
            on_round(fields, cols, torch.where(issued, events,
                                               EV_NONE).reshape(-1))
        anchor, gap_like = anchor & run, gap_like & run
        c1, c2 = c1 & run, c2 & run
        iters = iters + run.to(torch.int32)
        ph2 = torch.where(anchor, a_ph, torch.where(
            gap_like, g_ph, torch.where(c1, c1_ph, torch.where(c2, c2_ph,
                                                               ph))))
        i2 = torch.where(anchor, a_i, torch.where(
            gap_like, g_i, torch.where(c1, c1_i, torch.where(c2, c2_i, i))))
        res = torch.where(anchor, a_res, res).to(torch.int32)
        cs = torch.where(c1, ncs, cs)
        ce = torch.where(c1, nce, ce)
        ph, i = ph2.to(torch.int32), i2.to(torch.int32)
    if bool(halted.any()):
        b = int(over_key.argmax())
        raise search._overrun(int(res[b]), fmi.length + 1, fmi.length)
    return res, (ph != P_DONE).to(torch.int32), iters


def flag_offset(R: int) -> int:
    """Where the overrun flag starts in a packed output of ``R`` reads:
    after the three columns, at an even offset."""
    return (3 * R + 1) & ~1


def unpack(out):
    """(res, capped, iters) of a packed output, as views."""
    R = (len(out) - 4) // 3  # the flag's offset pads 3 R to even
    return out[:R], out[R:2 * R], out[2 * R:3 * R]


def _check(fmi: FMIndex, bank, lens, live0) -> None:
    dev = fmi.device
    if (bank.device != dev or bank.dtype != torch.uint8 or bank.dim() != 2
            or bank.shape[1] == 0 or not bank.is_contiguous()):
        raise ValueError(f"bank must be a contiguous (R, Lb) uint8 tensor "
                         f"on {dev}")
    R = bank.shape[0]
    if (lens.device != dev or lens.dtype != torch.int32 or lens.shape != (R,)
            or not lens.is_contiguous()):
        raise ValueError(f"lens must be a contiguous ({R},) int32 tensor on "
                         f"{dev}")
    if (live0.device != dev or live0.dtype != torch.bool
            or live0.shape != (R,) or not live0.is_contiguous()):
        raise ValueError(f"live0 must be a contiguous ({R},) bool tensor on "
                         f"{dev}")


def _automaton_kernel(fmi: FMIndex, bank, lens, live0, seed_rows, *, ac, cc,
                      resolve, cap, seed_k) -> torch.Tensor:
    """Launch ``csrc/rnaseq_automaton.cu`` (K9): a tile of :data:`TILE`
    threads a read.  Returns the packed output without synchronising."""
    global AUTOMATON_LAUNCHES
    search._check_index(fmi)
    _check(fmi, bank, lens, live0)
    isa = search._isa_args(fmi)
    table = (None if seed_rows is None
             else search.SeedTable(rows=seed_rows, k=seed_k))
    if table is not None and not 1 <= seed_k <= 15:
        raise ValueError(f"seed_k {seed_k} outside 1..15")
    R, Lb = bank.shape
    F = flag_offset(R)
    out = torch.empty(F + 4, dtype=torch.int32, device=fmi.device)
    out[F:] = 0
    if R:
        lib = _kernels.library()
        err = lib.rnaseq_automaton_launch(
            bank.data_ptr(), R, Lb, lens.data_ptr(), live0.data_ptr(), ac, cc,
            int(resolve), cap, *search._seed_args(fmi, table),
            *search._index_args(fmi), *search._samples_args(fmi), *isa,
            out.data_ptr(), search._stream(fmi.device))
        _kernels.check_launch(err, "rnaseq_automaton kernel launch")
        AUTOMATON_LAUNCHES += 1
    return out


def rna_seq_automaton_packed(fmi: FMIndex, bank, lens, live0, seed_rows=None,
                             *, ac: int, cc: int, resolve: bool,
                             cap_steps: int = 0, seed_k: int = 0,
                             plain: bool = False) -> torch.Tensor:
    """The automaton over ``R`` reads as one flat int32 tensor: ``res``,
    ``capped`` and the iterations each read ran ((R,) each, :func:`unpack`
    splits them), then in the last four entries the walk's overrun flag (its
    count of reads, a pad word, and a 64-bit key naming the first read to
    overrun, whose ``res`` slot then holds the row it walked from).  On
    the card this is one launch of K9 over the uint8 ``bank`` and does not
    synchronise: the caller copies the tensor back once and hands it to
    :func:`automaton_raise`.  On the CPU, or anywhere with ``plain``, it
    runs :func:`rna_seq_automaton_plain`, which raises by itself.  Needs
    ``fmi.isa_samples``."""
    R, Lb = bank.shape
    cap = cap_steps if cap_steps else default_cap(Lb)
    if plain or not search._on_card(fmi):
        parts = rna_seq_automaton_plain(
            fmi, bank, lens, live0, seed_rows, ac=ac, cc=cc, resolve=resolve,
            cap_steps=cap, seed_k=seed_k)
        out = torch.zeros(flag_offset(R) + 4, dtype=torch.int32,
                          device=bank.device)
        out[:3 * R] = torch.cat(parts)
        return out
    return _automaton_kernel(fmi, bank, lens, live0, seed_rows, ac=ac, cc=cc,
                             resolve=resolve, cap=cap, seed_k=seed_k)


def automaton_raise(fmi: FMIndex, out) -> None:
    """Raise what the flag of a :func:`rna_seq_automaton_packed` output
    says: a walk from a row past the suffix array, named as the plain
    version names it (the first read to overrun, at its earliest
    iteration).  ``out`` is a tensor on any device (reading it
    synchronises) or a numpy array."""
    n_over, _, lane_key, _ = (int(x) for x in out[-4:].tolist())
    if n_over:
        lane = (len(out) - 4) // 3 - (lane_key & 0xFFFFFFFF)
        raise search._overrun(int(out[lane]), fmi.length + 1, fmi.length)


def rna_seq_automaton(fmi: FMIndex, bank, lens, live0, seed_rows=None, *,
                      ac: int, cc: int, resolve: bool, cap_steps: int = 0,
                      seed_k: int = 0, plain: bool = False):
    """The rna_seq automaton over one bank of reads (the keywords of
    :func:`rna_seq_automaton_packed`): (res, capped), (R,) int32 each,
    after the flag has been read; a walk past the suffix array raises
    RuntimeError."""
    out = rna_seq_automaton_packed(
        fmi, bank, lens, live0, seed_rows, ac=ac, cc=cc, resolve=resolve,
        cap_steps=cap_steps, seed_k=seed_k, plain=plain)
    automaton_raise(fmi, out)
    res, capped, _ = unpack(out)
    return res, capped


# --------------------------------------------------------------------------
# The aligner's automaton (single_align's align_read_anchored and its
# forward / reverse main loop), K10
# --------------------------------------------------------------------------
#
# The counterpart of ``bwt_tpu.models.aligner._align_automaton``: every
# iteration a live read issues one service request (``mms`` of
# ``bank[row, 0:ln]`` in ANCH, ``mms_ext`` of ``bank[row, 0:ln-g]`` with
# curpos / curgap in EXT, none in HEAD) and moves its phase by the reply.
# DP stitches never feed back into the FM control flow, so the automaton only
# records them, with the M / I pushes between them, in a 16-slot log a read;
# phase B replays the log.  A reset (s.reset(), single_align.c:276) rewinds
# the log pointer.  The log's columns keep ``bwt_tpu``'s narrow types as
# values: roffs, rlens and glens wrap as int16 where they are written (kinds
# are 1..5), and writes past slot 15 are dropped and set ``ovf``.
#
# On the card this is one launch of ``csrc/align_automaton.cu`` (K10): a
# tile of TILE threads a read runs the forward strand, then the reverse one,
# over the service kernel's lane body, its phase state in registers and its
# log slots written straight into the output; a round runs the anchor
# retries or the curgaps side by side, one a thread, and consumes them in
# the sequential order.  Not carried over from ``bwt_tpu``: the compaction
# ladder (a tile stops on its own), the speculative anchor retries
# (``spec_anch``, a lockstep option that folds several retries into one
# service op and one iteration; the tile's candidates are a schedule whose
# outputs, the iteration count included, are the sequential loop's) and the
# sharded form (``_align_automaton_mesh``).

A_DONE, A_ANCH, A_EXT, A_HEAD = 0, 1, 2, 3
K_NW, K_SW, K_M, K_I, K_HEAD = 1, 2, 3, 4, 5
LOGN = 16

# the per-read columns of a packed K10 output, then the five log columns
ALIGN_COLS = ("mode", "curpos", "strand", "lp", "ovf", "capped", "iters")
LOG_COLS = ("kinds", "roffs", "rlens", "glens", "gstarts")

# kernel launches made by align_automaton_packed (a plain counter; callers
# reset it to show that a run went through the kernel)
ALIGN_LAUNCHES = 0


def align_default_cap(Lb: int) -> int:
    """The aligner automaton's iteration cap for a bank of ``Lb`` columns:
    every phase transition consumes read characters toward a budget or ends
    the strand, so 8 Lb plus slack is never reached by a known input."""
    return 8 * Lb + 64


def wrap_signed(x, bits: int):
    """Integer values as a ``bits``-bit signed column of ``bwt_tpu`` keeps
    them (its int8 / int16 casts)."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def align_flag_offset(Bp: int) -> int:
    """Where the walk's overrun flag starts in a packed K10 output of ``Bp``
    reads: after the seven columns and the five (Bp, 16) log columns, at an
    even offset."""
    return ((len(ALIGN_COLS) + len(LOG_COLS) * LOGN) * Bp + 1) & ~1


def align_lanes(out) -> int:
    """The reads ``Bp`` of a packed K10 output."""
    return (len(out) - 4) // (len(ALIGN_COLS) + len(LOG_COLS) * LOGN)


def align_unpack(out) -> dict:
    """The named views of a packed K10 output (a tensor or numpy array):
    the seven (Bp,) columns and the five (Bp, LOGN) log columns."""
    Bp = align_lanes(out)
    views = {c: out[k * Bp:(k + 1) * Bp] for k, c in enumerate(ALIGN_COLS)}
    base = len(ALIGN_COLS) * Bp
    for k, c in enumerate(LOG_COLS):
        lo = base + k * LOGN * Bp
        views[c] = out[lo:lo + LOGN * Bp].reshape(Bp, LOGN)
    return views


def align_automaton_plain(fmi: FMIndex, bank, lens, live0, glen: int,
                          seed_rows=None, *, anchor_len: int, resolve: bool,
                          cap_steps: int = 0, seed_k: int = 0, width: int = 1,
                          on_round=None):
    """The plain PyTorch version of K10, on any device: every live read
    takes its iterations together, one service round at a time, until no
    read is live or the cap; the transition is a line-for-line twin of
    ``bwt_tpu``'s while_loop body.  ``bank`` (2 Bp, Lb) integer codes, read
    k's forward strand at row 2k and its reverse complement at 2k + 1;
    ``lens`` (Bp,) int32 (0 on padding); ``live0`` (Bp,) bool; ``glen`` the
    genome's length.

    ``width`` is K10's tile schedule (a power of two up to 32; 1 is the
    lockstep of one iteration a round): a round issues up to ``width``
    candidate iterations a read, the ones the sequential run takes next
    while each before it fails and the hunt goes on: the anchor retries at
    ``ln - 3q`` (ANCH) or the curgaps ``g + q`` (EXT), each under the cap.
    The first candidate the sequential run stops at (a hit, an accept, an
    exhausted hunt, a walk that overran), else the last one, is consumed
    with every one before it; the rest are discarded.  The outputs are the
    same at every width.  ``on_round(fields, cols, events)``, when given,
    sees each round's seven lane fields and 13 result columns over
    ``Bp * width`` lanes (read b's candidate q at lane ``b * width + q``)
    and what each lane's candidate did (:data:`ALIGN_EVENTS`, with the
    :data:`EV_RESET` and :data:`EV_RETRY` bits).

    Returns a dict of int32 tensors: ``mode`` (0 unaligned, 1 ended at the
    in-loop head stitch, 2 a head with ln == 0), ``curpos``, ``strand``,
    ``lp`` (the log pointer), ``ovf``, ``capped`` (live at the cap: the
    state is mid-flight), ``iters`` (iterations each read ran), (Bp,) each,
    and the log: ``kinds``, ``roffs``, ``rlens``, ``glens`` (count of an M /
    I entry), ``gstarts``, (Bp, LOGN) each.  A walk from a row past the
    suffix array raises RuntimeError naming the first read to overrun, at
    its earliest iteration."""
    T = _width(width)
    Bp = lens.shape[0]
    Lb = bank.shape[1]
    dev = bank.device
    cap = cap_steps if cap_steps else align_default_cap(Lb)
    bank = bank.to(torch.int32)
    lane = torch.arange(Bp, dtype=torch.int32, device=dev)
    zeros = torch.zeros(Bp, dtype=torch.int32, device=dev)
    slots = torch.arange(LOGN, dtype=torch.int32, device=dev)[None, :]
    q = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    olen = lens.to(dev, torch.int32)
    am0 = olen // 10  # anchmisses budget (single_align.c:170)
    can = (olen > anchor_len) & (am0 > 0)
    ph = torch.where(live0.to(dev, torch.bool) & can, A_ANCH,
                     A_DONE).to(torch.int32)
    strand, ln, am, nm = zeros, olen, am0, zeros
    curpos = torch.full((Bp,), -1, dtype=torch.int32, device=dev)
    anchlen, g, lp, mode, iters = zeros, zeros, zeros, zeros, zeros
    ovf = torch.zeros(Bp, dtype=torch.bool, device=dev)
    halted = torch.zeros(Bp, dtype=torch.bool, device=dev)
    over_key = torch.zeros(Bp, dtype=torch.int64, device=dev)
    log = {c: torch.zeros((Bp, LOGN), dtype=torch.int32, device=dev)
           for c in LOG_COLS}

    def w(c, x):
        return torch.where(c, x, 0)

    while True:
        run = (ph != A_DONE) & (iters < cap) & ~halted
        if not bool(run.any()):
            break
        is_anch, is_ext = run & (ph == A_ANCH), run & (ph == A_EXT)
        # the candidates: the sequential run reaches q while the q before
        # it miss with the hunt going on (ANCH) or reject with curgaps left
        # (EXT), and the cap is not reached
        reach = torch.where(
            is_anch[:, None],
            (ln[:, None] - 3 * q > anchor_len) & (am[:, None] - q > 0),
            is_ext[:, None] & (g[:, None] + q < 10))
        issued = run[:, None] & ((q == 0) | reach) & (iters[:, None] + q < cap)
        c_anch, c_ext = issued & is_anch[:, None], issued & is_ext[:, None]
        ln_q = torch.where(is_anch[:, None], ln[:, None] - 3 * q, ln[:, None])
        g_q = g[:, None] + q
        opc = torch.where(c_anch, sv.OP_MMS,
                          torch.where(c_ext, sv.OP_MEXT, sv.OP_NONE))
        fields = [x.to(torch.int32).reshape(-1) for x in (
            opc, (2 * lane + strand)[:, None].expand(Bp, T), 0 * opc,
            torch.where(c_anch, ln_q, w(c_ext, ln_q - g_q)),
            w(c_ext, curpos[:, None]), w(c_ext, g_q), 0 * opc)]
        cols, over = sv.service_round_flagged(
            fmi, bank, *fields, resolve=resolve, ext=True,
            seed_rows=seed_rows, seed_k=seed_k)
        cq = cols.view(sv.NCOLS, Bp, T)
        over = over.view(Bp, T)

        # which candidate the sequential run stops at
        miss_q = (cq[sv.MMS_M] < anchor_len) | (cq[sv.OEP] - cq[sv.OSP] > 1)
        hunt_q = (ln_q - 3 > anchor_len) & (am[:, None] - q - 1 > 0)
        rej_q = ((cq[sv.OSP] >= cq[sv.OEP]) | (cq[sv.WBEST] < 0)
                 | ((cq[sv.WBEST] + cq[sv.MMS_M] - curpos[:, None]).abs()
                    - g_q > 3))
        goes_on = torch.where(is_anch[:, None], miss_q & hunt_q,
                              is_ext[:, None] & rej_q & (g_q + 1 < 10))
        stop = issued & (over | ~goes_on)
        qs = torch.where(stop.any(1), stop.to(torch.int8).argmax(1),
                         issued.sum(1) - 1).clamp(min=0)
        sel = cq.gather(2, qs.reshape(1, Bp, 1).expand(sv.NCOLS, Bp, 1))[..., 0]
        qs = w(run, qs.to(torch.int32))
        # the state after the qs candidates that failed before it
        ln = torch.where(is_anch, ln - 3 * qs, ln)
        am = torch.where(is_anch, am - qs, am)
        g = torch.where(is_ext, g + qs, g)
        iters = iters + qs
        # a walk past the suffix array stops its read where it happened
        over_sel = run & over.gather(1, qs[:, None].long())[:, 0]
        over_key = torch.where(
            over_sel, ((cap - iters).to(torch.int64) << 32) | (Bp - lane),
            over_key)
        curpos = torch.where(over_sel, sel[sv.POS], curpos)
        halted = halted | over_sel
        was_anch = is_anch
        run = run & ~over_sel
        is_anch, is_ext = run & (ph == A_ANCH), run & (ph == A_EXT)
        is_head = run & (ph == A_HEAD)
        seglen, osp, oep = sel[sv.MMS_M], sel[sv.OSP], sel[sv.OEP]
        pos, wbest = sel[sv.POS], sel[sv.WBEST]

        # ANCH: one mms of pattern[:ln] (single_align.c:174-189)
        a_miss = (seglen < anchor_len) | (oep - osp > 1)
        a_hunt = (ln - 3 > anchor_len) & (am - 1 > 0)  # retry budget
        a_ln = ln - seglen
        a_nm = olen // 5
        buflen0 = 10 + (olen - ln)  # 10 + the tail beyond the anchor
        a_buf = torch.where(buflen0 + pos + seglen > glen,
                            glen - pos - seglen, buflen0)
        a_rlen = olen - ln
        a_low = a_nm < 1  # olen < 5: `if (nmisses < 1) continue;`
        a_re = (a_ln > anchor_len) & (am > 0)
        a_ext_c = (a_ln > a_nm) & (a_ln > 4)

        # EXT: one curgap attempt (single_align.c:224-247)
        e_rej = (osp >= oep) | (wbest < 0) | \
            ((wbest + seglen - curpos).abs() - g > 3)
        e_more = g + 1 < 10
        e_nm = nm - g
        e_buf = curpos - (wbest + seglen)
        e_neg = e_buf < 0
        e_st0 = ln - g
        e_st = torch.where(e_st0 < 0, e_st0 + olen, e_st0)  # the UB wrap
        e_rl = (ln - e_st).clamp(min=0)
        e_ln = ln - (seglen + g)
        e_ext_c = (e_ln > e_nm) & (e_ln > 4) & (e_nm > 0)

        # HEAD: record the head stitch (single_align.c:256-272)
        h_buf = torch.minimum(ln + 10, curpos)

        # log writes: at most two entries an iteration
        a_acc = is_anch & ~a_miss
        e_acc = is_ext & ~e_rej
        w0 = (a_acc & (a_rlen != 0)) | e_acc | (is_head & (ln > 0))
        k0 = torch.where(is_anch, K_NW, torch.where(
            is_ext, torch.where(e_neg, K_I, K_SW), K_HEAD))
        r0 = torch.where(is_anch, ln, w(is_ext & ~e_neg, e_st))
        l0 = torch.where(is_anch, a_rlen, torch.where(
            is_ext, w(~e_neg, e_rl), ln))
        gl0 = torch.where(is_anch, a_buf.clamp(min=0), torch.where(
            is_ext, e_buf.abs(), h_buf))
        gs0 = torch.where(is_anch, pos + seglen, torch.where(
            is_ext, w(~e_neg, wbest + seglen), curpos - h_buf))
        w1 = a_acc | e_acc  # the M push after a stitch
        s1 = lp + w0.to(torch.int32)
        m0 = w0[:, None] & (slots == lp[:, None])
        m1 = w1[:, None] & (slots == s1[:, None])
        for c, v0, v1 in (("kinds", k0, K_M), ("roffs", wrap_signed(r0, 16), 0),
                          ("rlens", wrap_signed(l0, 16), 0),
                          ("glens", wrap_signed(gl0, 16),
                           wrap_signed(seglen, 16)),
                          ("gstarts", gs0, 0)):
            x = torch.where(m0, v0.to(torch.int32)[:, None], log[c])
            log[c] = torch.where(m1, torch.as_tensor(
                v1, dtype=torch.int32, device=dev).reshape(-1, 1), x)
        lp = s1 + w1.to(torch.int32)
        ovf = ovf | (lp > LOGN)

        # the next state, by phase.  RESET (single_align.c:274-276): ln -=
        # anchlen; anchmisses -= anchlen / 10; s.reset(); the outer loop's
        # test -> ANCH (nmisses 0) or the strand fails (-1)
        def reset_from(x_ln, x_am):
            r_ln = x_ln - anchlen
            r_am = x_am - anchlen // 10
            return (r_ln > anchor_len) & (r_am > 0), r_ln, r_am

        a_ph = torch.where(
            a_miss, torch.where(a_hunt, A_ANCH, -1),
            torch.where(a_low, torch.where(a_re, A_ANCH, -1),
                        torch.where(a_ext_c, A_EXT, A_HEAD)))
        a_ln2 = torch.where(a_miss, ln - 3, a_ln)
        a_am2 = torch.where(a_miss, am - 1, am)
        a_nm2 = torch.where(a_miss | a_low, 0, a_nm)
        a_cp2 = torch.where(a_miss, curpos, pos)
        a_al2 = torch.where(a_miss, anchlen, seglen)

        er_ok, er_ln, er_am = reset_from(ln, am)      # reject, exhausted
        es_ok, es_ln, es_am = reset_from(e_ln, am)    # accept, nm <= 0
        e_ph = torch.where(
            e_rej, torch.where(e_more, A_EXT, torch.where(er_ok, A_ANCH, -1)),
            torch.where(e_ext_c, A_EXT, torch.where(
                e_nm > 0, A_HEAD, torch.where(es_ok, A_ANCH, -1))))
        e_reset = (e_rej & ~e_more) | (~e_rej & ~e_ext_c & (e_nm <= 0))
        e_ln2 = torch.where(
            e_rej, torch.where(e_more, ln, er_ln),
            torch.where(e_ext_c | (e_nm > 0), e_ln, es_ln))
        e_am2 = torch.where(e_rej & ~e_more, er_am,
                            torch.where(e_reset & ~e_rej, es_am, am))
        e_nm2 = torch.where(e_rej, w(e_more, nm), w(~e_reset, e_nm))
        e_cp2 = torch.where(e_rej, curpos, wbest)
        e_g2 = torch.where(e_rej & e_more, g + 1, 1)

        # HEAD: ln == 0 short-circuits to a known result
        h_ph = torch.where(ln > 0, A_DONE,
                           torch.where(curpos != 0, A_DONE, -1))
        h_mode = torch.where(ln > 0, 1, torch.where(curpos != 0, 2, 0))

        ph2 = torch.where(is_anch, a_ph, torch.where(
            is_ext, e_ph, torch.where(is_head, h_ph, ph)))
        ln2 = torch.where(is_anch, a_ln2, torch.where(is_ext, e_ln2, ln))
        am2 = torch.where(is_anch, a_am2, torch.where(is_ext, e_am2, am))
        nm2 = torch.where(is_anch, a_nm2, torch.where(is_ext, e_nm2, nm))
        cp2 = torch.where(is_anch, a_cp2, torch.where(is_ext, e_cp2,
                                                      curpos))
        al2 = torch.where(is_anch, a_al2, anchlen)
        g2 = torch.where(is_anch, torch.where(a_ph == A_EXT, 1, g),
                         torch.where(is_ext, e_g2, g))
        mode2 = torch.where(is_head, h_mode, mode)
        lp2 = torch.where(is_ext & e_reset, 0, lp)
        ovf2 = ovf & ~(is_ext & e_reset)

        # a failed strand: forward -> start over on the reverse row (when
        # the entry condition holds), reverse -> done
        fail = ph2 == -1
        to_rev = fail & (strand == 0)
        if on_round is not None:
            ev = torch.where(is_anch, torch.where(
                ~a_miss, EV_ANCH_HIT, torch.where(a_hunt, EV_ANCH_MISS,
                                                  EV_ANCH_FAIL)),
                torch.where(is_ext, torch.where(e_rej, EV_EXT_REJECT,
                                                EV_EXT_ACCEPT), EV_HEAD))
            ev = (ev | w(is_ext & e_reset, EV_RESET) | w(to_rev, EV_RETRY))
            before = torch.where(was_anch, EV_ANCH_MISS, EV_EXT_REJECT)
            ev = torch.where(over_sel, before, ev)
            events = torch.where(
                q < qs[:, None], before[:, None], torch.where(
                    q == qs[:, None], ev[:, None], EV_SPEC))
            events = torch.where(issued, events, EV_NONE)
            on_round(fields, cols, events.reshape(-1))
        ph2 = torch.where(fail, torch.where(to_rev & can, A_ANCH, A_DONE),
                          ph2)
        iters = iters + run.to(torch.int32)
        ph = ph2.to(torch.int32)
        strand = torch.where(to_rev, 1, strand).to(torch.int32)
        ln = torch.where(to_rev, olen, ln2).to(torch.int32)
        am = torch.where(to_rev, am0, am2).to(torch.int32)
        nm = w(~to_rev, nm2).to(torch.int32)
        curpos = torch.where(to_rev, -1, cp2).to(torch.int32)
        anchlen = w(~to_rev, al2).to(torch.int32)
        g = w(~to_rev, g2).to(torch.int32)
        lp = w(~to_rev, lp2).to(torch.int32)
        ovf = ovf2 & ~to_rev
        mode = w(~(fail & ~to_rev), mode2).to(torch.int32)
    if bool(halted.any()):
        b = int(over_key.argmax())
        raise search._overrun(int(curpos[b]), fmi.length + 1, fmi.length)
    return dict(mode=mode, curpos=curpos, strand=strand, lp=lp,
                ovf=ovf.to(torch.int32),
                capped=(ph != A_DONE).to(torch.int32), iters=iters, **log)


def _align_kernel(fmi: FMIndex, bank, lens, live0, glen, seed_rows, *,
                  anchor_len, resolve, cap, seed_k) -> torch.Tensor:
    """Launch ``csrc/align_automaton.cu`` (K10): a tile of :data:`TILE`
    threads a read.  Returns the packed output without synchronising."""
    global ALIGN_LAUNCHES
    search._check_index(fmi)
    Bp = lens.shape[0]
    dev = fmi.device
    if (bank.device != dev or bank.dtype != torch.uint8 or bank.dim() != 2
            or bank.shape[0] != 2 * Bp or bank.shape[1] == 0
            or not bank.is_contiguous()):
        raise ValueError(f"bank must be a contiguous (2 Bp, Lb) uint8 tensor "
                         f"on {dev}, Bp = {Bp}")
    if (lens.device != dev or lens.dtype != torch.int32
            or not lens.is_contiguous()):
        raise ValueError(f"lens must be a contiguous (Bp,) int32 tensor on "
                         f"{dev}")
    if (live0.device != dev or live0.dtype != torch.bool
            or live0.shape != (Bp,) or not live0.is_contiguous()):
        raise ValueError(f"live0 must be a contiguous ({Bp},) bool tensor on "
                         f"{dev}")
    isa = search._isa_args(fmi)
    table = (None if seed_rows is None
             else search.SeedTable(rows=seed_rows, k=seed_k))
    if table is not None and not 1 <= seed_k <= 15:
        raise ValueError(f"seed_k {seed_k} outside 1..15")
    F = align_flag_offset(Bp)
    out = torch.empty(F + 4, dtype=torch.int32, device=dev)
    out[F:] = 0
    if Bp:
        lib = _kernels.library()
        err = lib.align_automaton_launch(
            bank.data_ptr(), Bp, bank.shape[1], lens.data_ptr(),
            live0.data_ptr(), int(glen), anchor_len, int(resolve), cap,
            *search._seed_args(fmi, table), *search._index_args(fmi),
            *search._samples_args(fmi), *isa, out.data_ptr(),
            search._stream(dev))
        _kernels.check_launch(err, "align_automaton kernel launch")
        ALIGN_LAUNCHES += 1
    return out


def align_automaton_packed(fmi: FMIndex, bank, lens, live0, glen: int,
                           seed_rows=None, *, anchor_len: int, resolve: bool,
                           cap_steps: int = 0, seed_k: int = 0,
                           plain: bool = False) -> torch.Tensor:
    """The aligner automaton over ``Bp`` reads as one flat int32 tensor:
    the seven columns of :data:`ALIGN_COLS`, then the five (Bp, LOGN) log
    columns (:func:`align_unpack` names them), then at
    :func:`align_flag_offset` the walk's overrun flag (its count of reads,
    a pad word, and a 64-bit key naming the first read to overrun, whose
    ``curpos`` then holds the row it walked from).  On the card this is one
    launch of K10 over the uint8 ``bank`` and does not synchronise: the
    caller reads the flag with :func:`align_automaton_raise`.  On the CPU,
    or anywhere with ``plain``, it runs :func:`align_automaton_plain`,
    which raises by itself.  Needs ``fmi.isa_samples``."""
    Bp = lens.shape[0]
    cap = cap_steps if cap_steps else align_default_cap(bank.shape[1])
    if plain or not search._on_card(fmi):
        parts = align_automaton_plain(
            fmi, bank, lens, live0, glen, seed_rows, anchor_len=anchor_len,
            resolve=resolve, cap_steps=cap, seed_k=seed_k)
        out = torch.zeros(align_flag_offset(Bp) + 4, dtype=torch.int32,
                          device=bank.device)
        n = (len(ALIGN_COLS) + len(LOG_COLS) * LOGN) * Bp
        out[:n] = torch.cat([parts[c].reshape(-1)
                             for c in ALIGN_COLS + LOG_COLS])
        return out
    return _align_kernel(fmi, bank, lens, live0, glen, seed_rows,
                         anchor_len=anchor_len, resolve=resolve, cap=cap,
                         seed_k=seed_k)


def align_automaton_raise(fmi: FMIndex, out, flag=None) -> None:
    """Raise what the flag of a :func:`align_automaton_packed` output says:
    a walk from a row past the suffix array, named as the plain version
    names it (the first read to overrun, at its earliest iteration).
    ``out`` is the output, on any device, or a numpy array; ``flag`` its
    last four words where the caller has them on the host already (else
    they are read from ``out``, which synchronises).  Only an overrun reads
    the output's ``curpos`` column."""
    if flag is None:
        flag = out[-4:]
    n_over, _, lane_key, _ = (int(x) for x in flag[-4:].tolist())
    if n_over:
        lane = align_lanes(out) - (lane_key & 0xFFFFFFFF)
        row = int(align_unpack(out)["curpos"][lane])
        raise search._overrun(row, fmi.length + 1, fmi.length)
