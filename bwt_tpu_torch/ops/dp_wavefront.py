"""Batched anti-diagonal DP: the fill and the whole stitch, each a CUDA
kernel's wrapper beside its plain PyTorch version.

``dp_fill_wavefront(reads, genomes)`` fills, for every job b, the NW DP
matrix of ``reads[b]`` (codes 0-3, 5 = N, zero-padded) against
``genomes[b]`` (codes 0-3, zero-padded) with the reference's scoring
(:mod:`bwt_tpu_torch.ops.align`), and returns ``(vals, ptrs)``, each
(B, L1+L2+1, L1+1) int32, where ``[b, d, i]`` is cell (i, d-i).  It is
bit-equal to ``bwt_tpu.ops.pallas_align.dp_fill_wavefront`` (the Pallas
TPU kernel it replaces), including the cells outside the matrix.

``dp_stitch(bank, genome, row, ..., want_nw, L1=, L2=)`` is the executor's
whole DP step on (B,) job fields: gather the slices, fill, take the nw
endpoint, walk the pointers back and run-length encode the ops.  It is
bit-equal to ``bwt_tpu.models.batch_exec._dp_core`` and returns only the
end cell, the residuals, the runs and the op row of each job.

``nw_fast_batch``, ``nw_endpos_batch`` and ``sw_fast_batch`` (reads,
read_lens, genomes, genome_lens) are :func:`bwt_tpu_torch.ops.align.nw_fast`
and ``sw_fast`` on a batch of pairs, each over one ``dp_fill_wavefront``:
the counterparts of ``bwt_tpu.ops.align``'s, whose XLA fill
(``dp_fill_batch``) the kernel replaces.

A CUDA tensor runs the hand-written kernel (``csrc/dp_wavefront.cu``,
``csrc/dp_stitch.cu``, both over ``csrc/dp_cell.cuh``) and nothing else:
a build or launch failure raises.  A CPU tensor runs the plain version
(:func:`dp_fill_wavefront_plain`, :func:`dp_stitch_plain`), which the
tests hold against the JAX package and the card holds the kernel against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops import automaton as au
from bwt_tpu_torch.ops.align import _backtrack, default_scoring
from bwt_tpu_torch.utils.cigar import Cigar

# kernel launches made by dp_fill_wavefront and by dp_stitch (plain
# counters; callers reset them to show that a run went through a kernel)
LAUNCHES = 0
STITCH_LAUNCHES = 0

# backtrack runs per job that dp_stitch returns compactly; a job with more
# is decoded from its raw op row by the caller
RLE_R = 40

# the tallest DP job (L1, read rows) the stitch kernel's block form takes,
# its carried diagonals in shared memory; a taller one takes the read-back
# form, which keeps them in device scratch.  A test hook: lowering it sends a
# small job through the read-back form
_TALL_ROWS = 11621

_NEG = -(1 << 30)


def _check(reads: torch.Tensor, genomes: torch.Tensor) -> None:
    for name, t in (("reads", reads), ("genomes", genomes)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if reads.shape[0] != genomes.shape[0]:
        raise ValueError(
            f"batch mismatch: reads {tuple(reads.shape)} vs genomes "
            f"{tuple(genomes.shape)}")
    if reads.device != genomes.device:
        raise ValueError(
            f"reads on {reads.device} but genomes on {genomes.device}")


def dp_fill_wavefront(reads: torch.Tensor, genomes: torch.Tensor, *,
                      scoring=None):
    """(vals, ptrs), each (B, L1+L2+1, L1+1) int32; ``scoring`` =
    (match, mismatch, gap_open, gap_extend), default from config."""
    global LAUNCHES
    _check(reads, genomes)
    scoring = tuple(int(s) for s in (scoring or default_scoring()))
    if reads.device.type == "cpu":
        return dp_fill_wavefront_plain(reads, genomes, scoring=scoring)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    B, L1 = reads.shape
    L2 = genomes.shape[1]
    vals = torch.empty((B, L1 + L2 + 1, L1 + 1), dtype=torch.int32,
                       device=reads.device)
    ptrs = torch.empty_like(vals)
    if B == 0:
        return vals, ptrs
    lib = _kernels.library()
    with torch.cuda.device(reads.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_wavefront_launch(
            reads.data_ptr(), genomes.data_ptr(), vals.data_ptr(),
            ptrs.data_ptr(), B, L1, L2, *scoring, stream)
    _kernels.check_launch(err, "dp_wavefront kernel launch")
    LAUNCHES += 1
    return vals, ptrs


def dp_fill_wavefront_plain(reads: torch.Tensor, genomes: torch.Tensor, *,
                            scoring=None):
    """The plain PyTorch version of the kernel: one vectorized step per
    anti-diagonal, on any device."""
    MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = scoring or default_scoring()
    B, L1 = reads.shape
    L2 = genomes.shape[1]
    D, lanes = L1 + L2 + 1, L1 + 1
    dev = reads.device
    vals = torch.zeros((B, D, lanes), dtype=torch.int32, device=dev)
    ptrs = torch.zeros_like(vals)
    i = torch.arange(lanes, device=dev)
    z = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    rvec = torch.cat([z, reads.to(torch.int64)], dim=1)  # rvec[i] = read[i-1]
    # gpad[:, j] = genome[j-1] for j in 1..L2, and 0 for j = 0
    gpad = torch.cat([z, genomes.to(torch.int64)], dim=1)
    prev2 = torch.zeros((B, lanes), dtype=torch.int64, device=dev)
    prev1, pptr1 = prev2, prev2
    for d in range(1, D):
        j = d - i
        g = gpad[:, torch.where((j >= 1) & (j <= L2), j, 0)]
        diag = torch.cat([z, prev2[:, :-1]], dim=1)
        up = torch.cat([z, prev1[:, :-1]], dim=1)
        pup = torch.cat([z, pptr1[:, :-1]], dim=1)
        match = (rvec == 5) | (rvec == g)
        sdiag = diag + torch.where(match, MATCH, MISMATCH)
        sleft = prev1 + GAP_EXTEND + torch.where(pptr1 == 2, 0, GAP_OPEN)
        sup = up + GAP_EXTEND + torch.where(pup == 1, 0, GAP_OPEN)
        v = torch.maximum(torch.maximum(sdiag, sleft), sup)
        p = torch.where(v == sleft, 2, torch.where(v == sup, 1, 0))
        # borders: DP row 0 (i = 0) and column 0 (i = d)
        v[:, 0] = GAP_OPEN + GAP_EXTEND * d
        p[:, 0] = 2
        if d <= L1:
            v[:, d] = GAP_OPEN + GAP_EXTEND * d
            p[:, d] = 1
        vals[:, d] = v.to(torch.int32)
        ptrs[:, d] = p.to(torch.int32)
        prev2, prev1, pptr1 = prev1, v, p
    return vals, ptrs


def matrix_layout(t_d: torch.Tensor, L1: int, L2: int) -> torch.Tensor:
    """(B, L1+L2+1, L1+1) per-diagonal cells -> the conventional (B, L1+1,
    L2+1) matrices, on the tensor's device."""
    dev = t_d.device
    i = torch.arange(L1 + 1, device=dev)[:, None]
    j = torch.arange(L2 + 1, device=dev)[None, :]
    return t_d[:, i + j, i]


def _fill_pairs(reads, genomes, scoring, device):
    """One :func:`dp_fill_wavefront` of a batch of zero-padded pairs on
    ``device`` (default: the card when there is one): (values, pointers),
    each (B, L1+1, L2+1) int32 on the device."""
    from bwt_tpu_torch.index import default_device

    dev = torch.device(device) if device is not None else default_device()
    reads, genomes = (torch.as_tensor(np.asarray(x), dtype=torch.int32)
                      .to(dev).contiguous() for x in (reads, genomes))
    vals, ptrs = dp_fill_wavefront(reads, genomes, scoring=scoring)
    L1, L2 = reads.shape[1], genomes.shape[1]
    return matrix_layout(vals, L1, L2), matrix_layout(ptrs, L1, L2)


def nw_endpos_batch(reads, read_lens, genomes, genome_lens, *, scoring=None,
                    device=None):
    """The batched free-tail endpoints: for pair b (``reads[b,
    :read_lens[b]]`` against ``genomes[b, :genome_lens[b]]``, zero-padded
    code arrays) the first best column of the read's last DP row among
    columns 0..genome_lens[b], minus one: nw_fast's return (smw.c:65-70,
    :110).  One :func:`dp_fill_wavefront` on ``device`` (default: the card
    when there is one).  Returns (endpos (B,), maxloc (B,), values (B,
    L1+1, L2+1), pointers (B, L1+1, L2+1)), int32 tensors on the device, as
    ``bwt_tpu.ops.align.nw_endpos_batch`` returns them; a zero-length read
    gives endpos -1 there as here."""
    values, pointers = _fill_pairs(reads, genomes, scoring, device)
    dev = values.device
    B, _, W = values.shape
    rl = torch.as_tensor(np.asarray(read_lens), dtype=torch.int64).to(dev)
    gl = torch.as_tensor(np.asarray(genome_lens), dtype=torch.int64).to(dev)
    last = values[torch.arange(B, device=dev), rl]  # (B, L2+1)
    cols = torch.arange(W, device=dev)[None, :]
    maxloc = _first_argmax(torch.where(cols <= gl[:, None], last, _NEG),
                           1).to(torch.int32)
    return maxloc - 1, maxloc, values, pointers


def nw_fast_batch(reads, read_lens, genomes, genome_lens, *, scoring=None,
                  device=None):
    """:func:`bwt_tpu_torch.ops.align.nw_fast` for a batch of pairs: (endpos
    (B,) int32, cigars).  The fill and the endpoints run on ``device`` as
    :func:`nw_endpos_batch`; the backtrack of each pair runs on the host.
    A zero-length read gives endpos 0 and an empty CIGAR (smw.c:28-30)."""
    endpos, maxloc, _, pointers = nw_endpos_batch(
        reads, read_lens, genomes, genome_lens, scoring=scoring,
        device=device)
    endpos, maxloc, P = (t.cpu().numpy() for t in (endpos, maxloc, pointers))
    read_lens = np.asarray(read_lens)
    out, cigars = [], []
    for b in range(P.shape[0]):
        c = Cigar()
        if read_lens[b] == 0:
            out.append(0)
        else:
            _backtrack(P[b], int(read_lens[b]), int(maxloc[b]), c, flip=True)
            out.append(int(endpos[b]))
        cigars.append(c)
    return np.asarray(out, np.int32), cigars


def sw_fast_batch(reads, read_lens, genomes, genome_lens, *, scoring=None,
                  device=None) -> list:
    """:func:`bwt_tpu_torch.ops.align.sw_fast` for a batch of pairs, both
    ends pinned: one :func:`dp_fill_wavefront` on ``device`` (default: the
    card when there is one), then each pair's backtrack from (read_lens[b],
    genome_lens[b]) on the host.  Returns the CIGARs."""
    _, pointers = _fill_pairs(reads, genomes, scoring, device)
    P = pointers.cpu().numpy()
    read_lens, genome_lens = np.asarray(read_lens), np.asarray(genome_lens)
    cigars = []
    for b in range(P.shape[0]):
        c = Cigar()
        _backtrack(P[b], int(read_lens[b]), int(genome_lens[b]), c,
                   flip=False)
        cigars.append(c)
    return cigars


# --------------------------------------------------------------------------
# The whole stitch: gather, fill, endpoint, backtrack, run-length ops
# --------------------------------------------------------------------------

_FIELDS = ("row", "roff", "rlen", "rrev", "gstart", "glen", "grev", "want_nw")


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (the strict '>' scan)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, ar, n).amin(dim=dim)


def _rle_device(ops: torch.Tensor):
    """Run-length encode each backtrack row (walk order; op 3 = none).  A
    run is a stretch of equal ops in neighbouring columns.

    Returns (nrun (B,), vals (B, RLE_R), counts (B, RLE_R)), int32: the
    first RLE_R runs, zero past them.  Rows whose run count or a kept
    run's length would pass 32000 report nrun = RLE_R + 1, so the caller
    decodes them from the raw ops."""
    B, S = ops.shape
    dev = ops.device
    live = ops != 3
    prevop = torch.cat([torch.full((B, 1), -1, dtype=ops.dtype, device=dev),
                        ops[:, :-1]], dim=1)
    prevlive = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                          live[:, :-1]], dim=1)
    starts = live & (~prevlive | (ops != prevop))
    rid = torch.cumsum(starts.to(torch.int64), dim=1)  # 1-based run id
    nrun = rid[:, -1]
    keep = rid <= RLE_R
    counts = torch.zeros((B, RLE_R + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, torch.where(live & keep, rid, 0),
                        live.to(torch.int64))
    vals = torch.zeros_like(counts)
    vals.scatter_add_(1, torch.where(starts & keep, rid, 0),
                      torch.where(starts, ops, 0).to(torch.int64))
    counts, vals = counts[:, 1:], vals[:, 1:]
    over = (nrun > 32000) | (counts.amax(dim=1) > 32000)
    nrun = torch.where(over, RLE_R + 1, nrun.clamp(max=32000))
    return (nrun.to(torch.int32), vals.to(torch.int32),
            counts.to(torch.int32))


def _check_stitch(bank, genome, fields) -> None:
    tensors = (("bank", bank, 2), ("genome", genome, 1),
               *((n, f, 1) for n, f in zip(_FIELDS, fields)))
    for name, t, ndim in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape "
                             f"{tuple(t.shape)}")
        if t.device != bank.device:
            raise ValueError(f"bank on {bank.device} but {name} on "
                             f"{t.device}")
    if bank.shape[0] < 1 or bank.shape[1] < 1 or genome.shape[0] < 1:
        raise ValueError("bank and genome must not be empty")
    if any(f.shape != fields[0].shape for f in fields):
        raise ValueError("the eight job fields must have one shape (B,)")


def dp_stitch(bank: torch.Tensor, genome: torch.Tensor, row, roff, rlen,
              rrev, gstart, glen, grev, want_nw, *, L1: int, L2: int,
              scoring=None):
    """The batched NW/SW stitch on (B,) int32 job fields: job b aligns
    ``bank[row, roff:roff+rlen]`` (read codes, (R, Lb) int32) against
    ``genome[gstart:gstart+glen]`` ((G,) int32), either slice reversed
    where ``rrev`` / ``grev`` is 1, in a DP padded to (L1, L2); nw jobs
    (``want_nw`` 1) end at the first maximum of the read's last row, sw
    jobs at (rlen, glen).  ``row`` must lie in [0, R).

    Returns (P, ops), int32.  P (B, 4 + 2 * RLE_R) holds, side by side for
    one copy to the host, maxloc, i_resid, j_resid, nrun, then the first
    RLE_R runs' ops and their lengths in walk order (:func:`unpack` splits
    it); ops (B, L1+L2+1) is the raw op row, column s = diagonal L1+L2-s,
    3 = no op.  On the card this is one launch of ``csrc/dp_stitch.cu``
    (a job past ``_TALL_ROWS`` read rows keeps its carried diagonals in
    device scratch); on the CPU, :func:`dp_stitch_plain`."""
    global STITCH_LAUNCHES
    fields = (row, roff, rlen, rrev, gstart, glen, grev, want_nw)
    _check_stitch(bank, genome, fields)
    L1, L2 = int(L1), int(L2)
    if L1 < 0 or L2 < 0:
        raise ValueError(f"negative DP shape ({L1}, {L2})")
    scoring = tuple(int(s) for s in (scoring or default_scoring()))
    dev = bank.device
    if dev.type == "cpu":
        return dp_stitch_plain(bank, genome, *fields, L1=L1, L2=L2,
                               scoring=scoring)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B = row.shape[0]
    P = torch.empty((B, 4 + 2 * RLE_R), dtype=torch.int32, device=dev)
    ops = torch.empty((B, L1 + L2 + 1), dtype=torch.int32, device=dev)
    if B:
        lib = _kernels.library()
        job_bytes = ctypes.c_longlong()
        lib.dp_stitch_plan(L1, L2, _TALL_ROWS, -1, ctypes.byref(job_bytes))
        # the pointers a byte a cell where the job is too tall for a warp,
        # and the carried diagonals where it is too tall for shared memory
        scratch = None
        if job_bytes.value:
            scratch = torch.empty(B * job_bytes.value, dtype=torch.uint8,
                                  device=dev)
        bank, genome = bank.contiguous(), genome.contiguous()
        fields = [f.contiguous() for f in fields]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dp_stitch_launch(
                bank.data_ptr(), *bank.shape, genome.data_ptr(),
                genome.shape[0], *(f.data_ptr() for f in fields), B, L1, L2,
                *scoring, RLE_R, _TALL_ROWS, P.data_ptr(), ops.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, stream)
        _kernels.check_launch(err, "dp_stitch kernel launch")
        STITCH_LAUNCHES += 1
    return P, ops


def pack(maxloc, i_resid, j_resid, nrun, vals, counts) -> torch.Tensor:
    """(B, 4 + 2 * RLE_R): the stitch's six small outputs side by side."""
    return torch.cat([torch.stack([maxloc, i_resid, j_resid, nrun], dim=1),
                      vals, counts], dim=1)


def unpack(P):
    """The six outputs of a :func:`pack` ed tensor (or numpy array), as
    views: maxloc, i_resid, j_resid, nrun (B,), then the kept runs' ops and
    lengths (B, RLE_R)."""
    return (P[:, 0], P[:, 1], P[:, 2], P[:, 3], P[:, 4:4 + RLE_R],
            P[:, 4 + RLE_R:])


def dp_stitch_plain(bank, genome, row, roff, rlen, rrev, gstart, glen, grev,
                    want_nw, *, L1: int, L2: int, scoring=None, fill=None):
    """The plain PyTorch version of the stitch kernel, on any device: the
    gather (both slices reversed for the head alignment,
    single_align.c:256-272), the fill by anti-diagonals (``fill``, default
    :func:`dp_fill_wavefront_plain`), the nw endpoint (first max of the
    read's last row, smw.c:65-70), one eager step per diagonal of the walk
    back, and :func:`_rle_device`.  Returns (P, ops) as :func:`dp_stitch`
    does; the caller appends the I/D residuals (smw.c:99-104)."""
    B = row.shape[0]
    Lb = bank.shape[1]
    dev = row.device
    k1 = torch.arange(L1, dtype=torch.int32, device=dev)[None, :]
    ridx = torch.where(rrev[:, None] == 1,
                       roff[:, None] + rlen[:, None] - 1 - k1,
                       roff[:, None] + k1)
    reads = bank[row.long()].gather(1, ridx.clamp(0, Lb - 1).long())
    reads = torch.where(k1 < rlen[:, None], reads, 0).contiguous()
    k2 = torch.arange(L2, dtype=torch.int32, device=dev)[None, :]
    gidx = torch.where(grev[:, None] == 1,
                       gstart[:, None] + glen[:, None] - 1 - k2,
                       gstart[:, None] + k2)
    genomes = genome[gidx.clamp(0, genome.shape[0] - 1).long()]
    genomes = torch.where(k2 < glen[:, None], genomes, 0).contiguous()

    fill = fill or dp_fill_wavefront_plain
    vals_d, ptrs_d = fill(reads, genomes, scoring=scoring)  # (B, D, L1+1)
    D = L1 + L2 + 1

    # nw endpoint: cell (i0, d - i0) of every diagonal d
    i0 = rlen.clamp(0, L1)
    rowv = vals_d.gather(
        2, i0.long()[:, None, None].expand(B, D, 1)).squeeze(2)
    jcol = torch.arange(D, dtype=torch.int32, device=dev)[None, :] \
        - i0[:, None]
    validj = (jcol >= 0) & (jcol <= glen.clamp(max=L2)[:, None])
    dstar = _first_argmax(torch.where(validj, rowv, _NEG), 1)
    maxloc = torch.where(validj.any(dim=1), dstar.to(torch.int32) - i0, 0)
    j0 = torch.where(want_nw == 1, maxloc, glen.clamp(0, L2))

    # walk the pointers from (i0, j0); column s of ``ops`` is diagonal
    # D-1-s, 3 = no op.  A step on diagonal d needs i, j > 0, so d >= 2,
    # and no lane starts above max(i0 + j0).
    ops = torch.full((B, D), 3, dtype=torch.int32, device=dev)
    i, j = i0, j0
    dtop = min(int((i0 + j0).max()) if B else 0, D - 1)
    for d in range(dtop, 1, -1):
        on = (i + j == d) & (i > 0) & (j > 0)
        p = ptrs_d[:, d].gather(1, i.long()[:, None]).squeeze(1)
        op = torch.where(on, torch.where((p == 1) | (p == 2), p, 0), 3)
        ops[:, D - 1 - d] = op
        i = i - (on & (op != 2)).to(torch.int32)
        j = j - (on & (op != 1)).to(torch.int32)
    return pack(maxloc, i, j, *_rle_device(ops)), ops


# --------------------------------------------------------------------------
# The stitch from the aligner automaton's log (K11a)
# --------------------------------------------------------------------------
#
# Phase B of the aligner's device engine keeps the automaton's log on the
# device: each DP shape bucket's jobs, named by (lane, slot), gather their
# fields from the log, run the stitch, build their run blocks and scatter
# them into chunk-wide accumulators that the compose (``ops/compose.py``)
# reads.  The counterpart of ``bwt_tpu.models.aligner._dp_scatter_bucket``.

# kernel launches made by dp_log_stitch (a plain counter)
LOG_STITCH_LAUNCHES = 0

# a job's block: its kept runs and the two border residuals
BLOCK_W = RLE_R + 2


def log_acc(Bp: int, device) -> torch.Tensor:
    """Zeroed accumulators of the stitches from one chunk's log, as one flat
    int32 tensor (:func:`acc_unpack` names its parts)."""
    return torch.zeros((au.LOGN * (BLOCK_W + 1) + 2) * Bp, dtype=torch.int32,
                       device=device)


def acc_unpack(acc):
    """The views of a :func:`log_acc` tensor: ``runs_oc`` (Bp, LOGN,
    BLOCK_W), each entry (op + 2) << 24 | count; ``bl3`` (Bp, LOGN), a
    slot's block length; ``head_end`` (Bp,), the head stitch's endpoint
    minus 1; ``over`` (Bp,), 1 where a job had more runs than RLE_R."""
    Bp = acc.shape[0] // (au.LOGN * (BLOCK_W + 1) + 2)
    n, m = au.LOGN * BLOCK_W * Bp, au.LOGN * Bp
    return (acc[:n].reshape(Bp, au.LOGN, BLOCK_W),
            acc[n:n + m].reshape(Bp, au.LOGN),
            acc[n + m:n + m + Bp], acc[n + m + Bp:n + m + 2 * Bp])


def dp_blocks(maxloc, i_res, j_res, nrun, vals, counts, flip):
    """Each job's run block as ``bwt_tpu.models.batch_exec._dp_blocks_core``
    builds it: the kept runs in walk order, the I / D border residuals
    appended (smw.c:99-104), reversed where ``flip`` (the Cigar flip of an
    NW or head stitch, stack.c:51-59).  Returns (bo, bc) (J, BLOCK_W) int32,
    the ops (-1 padding) and counts, bl (J,) the block's length and over
    (J,) bool, more runs than RLE_R (the read is re-composed on the host)."""
    J = nrun.shape[0]
    dev = nrun.device
    t = torch.arange(BLOCK_W, dtype=torch.int32, device=dev)[None, :]
    nr = nrun.clamp(max=RLE_R)
    over = nrun > RLE_R
    bo = torch.where(t < nr[:, None], torch.cat(
        [vals, torch.full((J, 2), -1, dtype=torch.int32, device=dev)], 1), -1)
    bc = torch.where(t < nr[:, None], torch.cat(
        [counts, torch.zeros((J, 2), dtype=torch.int32, device=dev)], 1), 0)
    has_i = i_res > 0
    mi = (t == nr[:, None]) & has_i[:, None]
    bo = torch.where(mi, 1, bo)
    bc = torch.where(mi, i_res[:, None], bc)
    cd = nr + has_i.to(torch.int32)
    has_j = j_res > 0
    mj = (t == cd[:, None]) & has_j[:, None]
    bo = torch.where(mj, 2, bo)
    bc = torch.where(mj, j_res[:, None], bc)
    bl = cd + has_j.to(torch.int32)
    idx = torch.where(flip[:, None] & (t < bl[:, None]),
                      (bl[:, None] - 1 - t).clamp(min=0), t)
    return (bo.gather(1, idx.long()), bc.gather(1, idx.long()), bl, over)


def _log_jobs(log, jk, jt):
    """The stitch fields of the jobs at (lane jk, slot jt) of a packed K10
    output, as the automaton recorded them."""
    v = au.align_unpack(log)
    jkl, jtl = jk.long(), jt.long()
    kind = v["kinds"][jkl, jtl]
    is_head = (kind == au.K_HEAD).to(torch.int32)
    is_sw = kind == au.K_SW
    return ((2 * jk + v["strand"][jkl]).to(torch.int32), v["roffs"][jkl, jtl],
            v["rlens"][jkl, jtl], is_head, v["gstarts"][jkl, jtl],
            v["glens"][jkl, jtl], is_head, (~is_sw).to(torch.int32)), is_sw


def dp_log_stitch_plain(log, bank, genome, jk, jt, acc, *, L1: int, L2: int,
                        scoring=None) -> None:
    """The plain PyTorch version of K11a, on any device: the jobs' fields
    gathered from the log, :func:`dp_stitch_plain`, :func:`dp_blocks`, and
    the scatter into ``acc`` (in place: the accumulators of a chunk are
    updated bucket after bucket)."""
    fields, is_sw = _log_jobs(log, jk, jt)
    P, _ = dp_stitch_plain(bank, genome, *fields, L1=L1, L2=L2,
                           scoring=scoring)
    maxloc, i_res, j_res, nrun, vals, counts = unpack(P)
    bo, bc, bl, ov = dp_blocks(maxloc, i_res, j_res, nrun, vals, counts,
                               ~is_sw)
    runs_oc, bl3, head_end, over = acc_unpack(acc)
    jkl, jtl = jk.long(), jt.long()
    runs_oc[jkl, jtl] = ((bo + 2) << 24) | bc
    bl3[jkl, jtl] = bl
    head_end.index_add_(0, jkl, torch.where(fields[3] == 1, maxloc - 1, 0))
    over.scatter_reduce_(0, jkl, ov.to(torch.int32), "amax")


def dp_log_stitch(log, bank, genome, jk, jt, acc, *, L1: int, L2: int,
                  scoring=None, plain: bool = False) -> None:
    """One DP shape bucket of phase B: the jobs at (lane ``jk``, slot
    ``jt``) of the packed automaton output ``log``, each job's read slice
    from ``bank`` ((2 Bp, Lb) int32) and genome slice from ``genome`` ((G,)
    int32), padded to (L1, L2); their run blocks scatter into ``acc``
    (:func:`log_acc`) in place.  On the card one launch of the stitch
    kernel's log form (``csrc/dp_stitch.cu``), which writes no op row; on
    the CPU, or anywhere with ``plain``, :func:`dp_log_stitch_plain`."""
    global LOG_STITCH_LAUNCHES
    scoring = tuple(int(s) for s in (scoring or default_scoring()))
    L1, L2 = int(L1), int(L2)
    dev = bank.device
    if plain or dev.type == "cpu":
        return dp_log_stitch_plain(log, bank, genome, jk, jt, acc, L1=L1,
                                   L2=L2, scoring=scoring)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Bp = au.align_lanes(log)
    for name, t in (("log", log), ("bank", bank), ("genome", genome),
                    ("jk", jk), ("jt", jt), ("acc", acc)):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    if bank.dim() != 2 or bank.shape[0] != 2 * Bp or genome.dim() != 1:
        raise ValueError(f"bank must be (2 Bp, Lb) for Bp = {Bp}, genome "
                         f"(G,)")
    if acc.shape != ((au.LOGN * (BLOCK_W + 1) + 2) * Bp,):
        raise ValueError(f"acc must be log_acc({Bp})")
    if jk.shape != jt.shape or jk.dim() != 1:
        raise ValueError("jk and jt must have one shape (J,)")
    if L1 < 0 or L2 < 0:
        raise ValueError(f"negative DP shape ({L1}, {L2})")
    J = jk.shape[0]
    if J == 0:
        return None
    lib = _kernels.library()
    job_bytes = ctypes.c_longlong()
    lib.dp_stitch_plan(L1, L2, _TALL_ROWS, RLE_R, ctypes.byref(job_bytes))
    scratch = None
    if job_bytes.value:
        scratch = torch.empty(J * job_bytes.value, dtype=torch.uint8,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_log_stitch_launch(
            log.data_ptr(), Bp, bank.data_ptr(), bank.shape[1],
            genome.data_ptr(), genome.shape[0], jk.data_ptr(), jt.data_ptr(),
            J, L1, L2, *scoring, RLE_R, _TALL_ROWS, acc.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, stream)
    _kernels.check_launch(err, "dp_log_stitch kernel launch")
    LOG_STITCH_LAUNCHES += 1
    return None
