"""The device automatons: a whole main loop's phase machine, one read a lane,
run on the device to its end.

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

On the card this is one launch of ``csrc/rnaseq_automaton.cu`` (K9): one
thread a read keeps the read's state in registers and runs the machine
over the service kernel's lane body until the read is done or the cap.
On the CPU, or anywhere with ``plain``, the same wrapper runs
:func:`rna_seq_automaton_plain`, the lockstep version over
:func:`~bwt_tpu_torch.ops.service.service_round_plain`.

The iteration cap (``4 * Lb + 64``, or ``cap_steps``) is a bound with a
flag: a read still live there comes back ``capped`` and its ``res`` is not
its result; the caller re-runs it on the host.  Not carried over from
``bwt_tpu``: the compaction ladder (``_ladder``, ``_COMPACT_AT``), a
lockstep remedy, since a thread stops on its own.
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
                            on_round=None):
    """The plain PyTorch version of K9, on any device: every live read
    takes its iteration together, one service round an iteration, until
    no read is live or the cap; a line-for-line twin of ``bwt_tpu``'s
    while_loop body.  ``bank`` (R, Lb) integer codes, one read a row;
    ``lens`` (R,) int32; ``live0`` (R,) bool, False on padding rows.
    ``on_round(fields, cols)``, when given, sees each round's seven lane
    fields and 13 result columns.  Returns (res, capped, iters), (R,)
    int32 each: the first anchor's position, whether the read was still
    live at the cap, and the iterations it ran.  A walk from a row past
    the suffix array raises RuntimeError."""
    R, Lb = bank.shape
    dev = bank.device
    cap = cap_steps if cap_steps else default_cap(Lb)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    bank = bank.to(torch.int32)
    ph = torch.where(live0.to(dev, torch.bool), P_ANCHOR,
                     P_DONE).to(torch.int32)
    i = lens.to(dev, torch.int32)
    res = torch.full((R,), -1, dtype=torch.int32, device=dev)
    cs, ce, iters = zeros, zeros, zeros
    it = 0
    while it < cap and bool((ph != P_DONE).any()):
        is_bs = (ph == P_ANCHOR) | (ph == P_GAP) | (ph == P_CONTC)
        c1, c2 = ph == P_CONT1, ph == P_CONT2
        opc = torch.where(ph == P_DONE, sv.OP_NONE, torch.where(
            is_bs, sv.OP_BSEARCH, torch.where(c1, sv.OP_BEXT, sv.OP_CONT)))
        off = torch.where(c1, i - cc + 1, 0)
        ln = torch.where(c1, cc - 1, torch.where(
            c2, i - cc + 1, torch.where(ph == P_DONE, 0, i)))
        sp = torch.where(c1, res - cc - 6, torch.where(c2, cs, 0))
        ep = torch.where(c1, cc + 6, torch.where(c2, ce, 0))
        fields = [x.to(torch.int32) for x in (opc, rows, off, ln, sp, ep)]
        fields.append(zeros)
        cols = sv.service_round_plain(
            fmi, bank, *fields, resolve=resolve, ext=True,
            seed_rows=seed_rows, seed_k=seed_k)
        if on_round is not None:
            on_round(fields, cols)
        st, en = cols[sv.START], cols[sv.END]
        nm, alive = cols[sv.NM], cols[sv.ALIVE] > 0
        pos, wrow = cols[sv.POS], cols[sv.WROW]

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

        gap_like = (ph == P_GAP) | (ph == P_CONTC)
        iters = iters + (ph != P_DONE).to(torch.int32)
        ph2 = torch.where(ph == P_ANCHOR, a_ph, torch.where(
            gap_like, g_ph, torch.where(c1, c1_ph, torch.where(c2, c2_ph,
                                                               ph))))
        i2 = torch.where(ph == P_ANCHOR, a_i, torch.where(
            gap_like, g_i, torch.where(c1, c1_i, torch.where(c2, c2_i, i))))
        res = torch.where(ph == P_ANCHOR, a_res, res).to(torch.int32)
        cs = torch.where(c1, ncs, cs)
        ce = torch.where(c1, nce, ce)
        ph, i = ph2.to(torch.int32), i2.to(torch.int32)
        it += 1
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
    """Launch ``csrc/rnaseq_automaton.cu`` (K9): one thread a read.
    Returns the packed output without synchronising."""
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
        if err != 0:
            raise RuntimeError(f"rnaseq_automaton kernel launch failed: CUDA "
                               f"error {err}")
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
