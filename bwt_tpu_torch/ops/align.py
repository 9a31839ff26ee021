"""Gapped-alignment DP on the host: Needleman-Wunsch and its pinned
variant with the reference's pseudo-affine scoring (smw.c:26-200).

Match 0, mismatch -6 (read code 5, 'N', matches everything), gap -3 per
base plus -5 to open, where "open" means the neighbour's direction
pointer does not already continue the same gap (smw.c:48-49).  Ties go
left ('D', pointer 2) first, then up ('I', 1), then diagonal (0)
(smw.c:55-62).  The batched fill for the aligner's stitches is
:mod:`bwt_tpu_torch.ops.dp_wavefront`.
"""

from __future__ import annotations

import numpy as np

from bwt_tpu_torch.utils.cigar import Cigar


def default_scoring() -> tuple[int, int, int, int]:
    """(match, mismatch, gap_open, gap_extend) from the config layer."""
    from bwt_tpu_torch.config import DEFAULT

    return DEFAULT.dp_scoring


def dp_fill(read, genome, scoring=None):
    """DP value and pointer matrices, each (len(read)+1, len(genome)+1),
    for read (codes 0-3/5) vs genome (0-3).  Pointer 0 = diagonal,
    1 = up (read skip, 'I'), 2 = left (genome skip, 'D')."""
    sm, sx, go, ge = scoring if scoring is not None else default_scoring()
    read = np.asarray(read, dtype=np.int64)
    genome = np.asarray(genome, dtype=np.int64)
    l1, l2 = len(read), len(genome)
    values = np.zeros((l1 + 1, l2 + 1), dtype=np.int64)
    pointers = np.zeros((l1 + 1, l2 + 1), dtype=np.int8)
    values[0, 1:] = go + ge * np.arange(1, l2 + 1)
    pointers[0, 1:] = 2
    values[1:, 0] = go + ge * np.arange(1, l1 + 1)
    pointers[1:, 0] = 1
    for i in range(1, l1 + 1):
        rc = read[i - 1]
        match = (rc == 5) | (rc == genome)
        row_above = values[i - 1]
        ptr_above = pointers[i - 1]
        for jj in range(1, l2 + 1):
            skip2 = 0 if pointers[i, jj - 1] == 2 else go
            skip1 = 0 if ptr_above[jj] == 1 else go
            sdiag = row_above[jj - 1] + (sm if match[jj - 1] else sx)
            sleft = values[i, jj - 1] + ge + skip2
            sup = row_above[jj] + ge + skip1
            v = max(sdiag, sleft, sup)
            values[i, jj] = v
            pointers[i, jj] = 2 if v == sleft else 1 if v == sup else 0
    return values, pointers


def _backtrack(pointers, i, j, cigar: Cigar, flip: bool) -> None:
    """Walk pointers from (i, j) to a border, pushing I/D/M runs.
    ``flip=True`` is nw_fast's extra stack flip (smw.c:36, :107);
    ``flip=False`` sw_fast's direct push (smw.c:156-191)."""
    s = Cigar() if flip else cigar
    while i and j:
        d = pointers[i, j]
        if d == 1:
            i -= 1
            s.push("I", 1)
        elif d == 2:
            j -= 1
            s.push("D", 1)
        else:
            i -= 1
            j -= 1
            s.push("M", 1)
    if i:
        s.push("I", i)
    if j:
        s.push("D", j)
    if flip:
        s.flip_onto(cigar)


def nw_fast(read, genome, cigar: Cigar, scoring=None) -> int:
    """Free-tail alignment (smw.c:26-111): the read's last character may
    land on any genome column (best last-row score, first on ties).
    Returns that column minus one and pushes the flipped CIGAR runs; a
    zero-length read returns 0 (smw.c:28-30)."""
    l1 = len(read)
    if l1 == 0:
        return 0
    values, pointers = dp_fill(read, genome, scoring)
    maxloc = int(np.argmax(values[l1]))  # first max == strict > scan
    _backtrack(pointers, l1, maxloc, cigar, flip=True)
    return maxloc - 1


def sw_fast(read, genome, cigar: Cigar, scoring=None) -> None:
    """Both-ends-pinned alignment (smw.c:117-200): backtrack from
    (len(read), len(genome)), pushing runs directly."""
    _, pointers = dp_fill(read, genome, scoring)
    _backtrack(pointers, len(read), len(genome), cigar, flip=False)
