"""The plain reference for FM-index locate, in plain PyTorch on any device.

It builds its own suffix array of ``genome + '$'`` by prefix doubling (one
sort of base-5 keys of ``PACK`` characters, then doubling rounds until
every rank is distinct), its own BWT and occurrence counts, and runs the
textbook backward search over them.  It imports nothing of the program
under test and takes nothing that the program made.

The answer it gives for a pattern ``P`` of length ``m`` is the one the
reference aligner's ``locate`` gives (seqindex.c:258-277):

* ``-1`` when ``P[1:]`` does not occur in the genome (the interval
  emptied before the first character was read);
* otherwise ``SA[r]``, where ``r`` is the number of suffixes of
  ``genome + '$'`` that sort before ``P`` and do not begin with it.  That
  is the first occurrence in suffix order when ``P`` occurs, and the
  position of the first suffix after ``P`` when only ``P[1:]`` occurs;
* ``PAST_END`` when ``r`` is past the last row (``P`` sorts after every
  suffix), which the program refuses with an error.

Rows are numbered from the ``$`` suffix (row 0, position ``n``).
"""

from __future__ import annotations

import dataclasses

import torch

PACK = 27  # characters in one base-5 key: 5**27 < 2**63
PAST_END = -2  # the answer row lies past the last suffix
SIGMA = 4  # A, C, G, T as codes 0..3


def suffix_array(codes: torch.Tensor) -> torch.Tensor:
    """The suffix array of ``codes + '$'`` (codes 0..3, ``$`` the smallest
    symbol), int64 of ``n + 1`` entries, by prefix doubling."""
    n = codes.numel()
    dev = codes.device
    text = torch.zeros(n + 1 + PACK, dtype=torch.uint8, device=dev)
    text[:n] = codes.to(torch.uint8) + 1  # '$' and the padding are 0
    key = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    for k in range(PACK):
        key.mul_(5).add_(text[k:k + n + 1])
    del text
    h = PACK
    while True:
        key, order = torch.sort(key)
        new = torch.ones(n + 1, dtype=torch.bool, device=dev)
        torch.ne(key[1:], key[:-1], out=new[1:])
        if bool(new.all()):
            return order
        del key
        dense = torch.cumsum(new, 0) - 1  # group number, in sorted order
        del new
        rank = torch.empty_like(dense)
        rank[order] = dense
        del dense, order
        # a suffix shorter than h already holds its '$', so its rank is
        # unique and the second key (0 past the end) never decides
        key = rank * (n + 2)
        key[:n + 1 - h] += rank[h:] + 1
        del rank
        h *= 2


@dataclasses.dataclass
class Tables:
    """What the reference derives from the genome alone."""

    sa: torch.Tensor  # (n + 1,) int64
    C: torch.Tensor  # (SIGMA + 1,) int64: first row of each symbol's block
    occ: torch.Tensor  # (SIGMA, n + 2) int32: symbol counts of bwt[:i]
    n: int


def tables(codes: torch.Tensor) -> Tables:
    """The reference's suffix array, symbol blocks and occurrence counts."""
    n = codes.numel()
    sa = suffix_array(codes)
    prev = codes.to(torch.uint8)[(sa - 1).clamp(min=0)]
    bwt = torch.where(sa == 0, SIGMA, prev)  # '$' precedes position 0
    del prev
    occ = torch.zeros(SIGMA, n + 2, dtype=torch.int32, device=codes.device)
    for c in range(SIGMA):
        torch.cumsum(bwt == c, 0, dtype=torch.int32, out=occ[c, 1:])
    del bwt
    counts = torch.bincount(codes.to(torch.int64), minlength=SIGMA)[:SIGMA]
    C = torch.ones(SIGMA + 1, dtype=torch.int64, device=codes.device)
    C[1:] += torch.cumsum(counts, 0)
    return Tables(sa=sa, C=C, occ=occ, n=n)


def backward_search(t: Tables, patterns: torch.Tensor,
                    lengths: torch.Tensor):
    """The textbook backward search of each row of ``patterns`` (codes
    0..3, the first ``lengths[b]`` of row b), last character first.

    Returns ``(row, emptied_early, steps)``: the row before which every
    suffix sorts below the pattern, whether the interval emptied before
    the first character, and the LF steps taken (one a character after
    the last while the interval holds, the step that empties it
    included)."""
    dev = patterns.device
    pats = patterns.to(torch.int64)
    lens = lengths.to(torch.int64)
    B, L = pats.shape
    lane = torch.arange(B, device=dev)
    occ = t.occ.reshape(-1)
    stride = t.n + 2
    c = pats[lane, (lens - 1).clamp(min=0)]
    sp, ep = t.C[c], t.C[c + 1]
    alive = (sp < ep) & (lens > 0)
    matched = alive.to(torch.int64)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(1, L):
        i = lens - 1 - k
        active = alive & (i >= 0)
        if not bool(active.any()):
            break
        c = pats[lane, i.clamp(min=0)]
        nsp = t.C[c] + occ[c * stride + sp]
        nep = t.C[c] + occ[c * stride + ep]
        sp = torch.where(active, nsp, sp)
        ep = torch.where(active, nep, ep)
        ok = nep > nsp
        steps += active
        matched += active & ok
        alive &= ~active | ok
    emptied_early = ~alive & (matched <= lens - 2)
    return sp, emptied_early, steps


def first_match(t: Tables, patterns: torch.Tensor, lengths: torch.Tensor,
                *, with_steps: bool = False):
    """The reference's answer for each pattern (see the module's
    docstring); with ``with_steps`` also the search's LF steps."""
    row, early, steps = backward_search(t, patterns, lengths)
    past = row > t.n
    pos = t.sa[row.clamp(max=t.n)]
    pos = torch.where(past, PAST_END, pos)
    pos = torch.where(early, -1, pos)
    return (pos, steps) if with_steps else pos


def walk_steps(t: Tables, positions: torch.Tensor, rate: int) -> torch.Tensor:
    """LF steps from the row of each suffix position to the nearest row
    that is a multiple of ``rate`` (a sampled row), walking to position
    ``p - 1`` each step and from 0 to ``n`` (row 0, always sampled)."""
    n = t.n
    marked = torch.zeros(n + 1, dtype=torch.bool, device=t.sa.device)
    marked[t.sa[::rate]] = True
    at = torch.arange(n + 1, device=t.sa.device)
    last = torch.cummax(torch.where(marked, at, -1), 0).values
    del marked, at
    p = positions.to(torch.int64)
    before = last[p]
    return torch.where(before >= 0, p - before, p + 1)
