"""The least work of a batch of ``locate``: bytes and operations.

Counted from the inputs and the table sizes alone, so that the count is
the same whatever implements the kernel.

Operations, per LF step, in the two classes that run on different
units at different rates (frozen here; the derivation, for the int32
index's 32-byte row of four 32-bit counts and four words of 16 two-bit
bases, 64 positions a row):

* one rank, ``RANK_OPS`` = 4 * 6 + 1 = 25 integer operations and
  ``RANK_POPC`` = 4 popcounts: for each of the four words that precede or
  hold the position, a mask of the bases before it, an XOR against the
  symbol's 2-bit pattern, the two-lane AND that finds the equal bases, a
  mask, a popcount, an add and a compare; then the row's count of the
  symbol added;
* a backward-search step, ``SEARCH_STEP_OPS`` = 2 * 25 + 4 = 54 and 8
  popcounts: the rank of both ends of the interval, the symbol's block
  start added to both, and the compare that says whether the interval
  emptied;
* an SA-walk step, ``WALK_STEP_OPS`` = 25 + 6 = 31 and 4 popcounts: the
  rank of the row's own symbol, which is first read from the row (a shift
  and a mask), its block start added, the step counted and the row tested
  against the sampling rate.

Bytes: every pattern element, length and answer once (int32); the rows
the steps need (two a search step, one a walk step, 32 bytes each) and a
32-byte sector for each walk's sample, each table counted at most once
whole.
"""

from __future__ import annotations

RANK_OPS = 4 * 6 + 1
RANK_POPC = 4
SEARCH_STEP_OPS = 2 * RANK_OPS + 4
SEARCH_STEP_POPC = 2 * RANK_POPC
WALK_STEP_OPS = RANK_OPS + 6
WALK_STEP_POPC = RANK_POPC

ROW_BYTES = 32  # the int32 index's row
ROW_POSITIONS = 64  # BWT symbols a row covers
SAMPLE_BYTES = 4  # one int32 suffix-array sample
SECTOR = 32


def table_bytes(n: int, sa_rate: int) -> tuple[int, int]:
    """The bytes of the rows and of the SA samples of an int32 index of a
    genome of ``n`` bases."""
    rows = (n + 1 + ROW_POSITIONS - 1) // ROW_POSITIONS + 1
    samples = n // sa_rate + 1
    return ROW_BYTES * rows, SAMPLE_BYTES * samples


def work(*, reads: int, length: int, search_steps: int, walk_steps: int,
         walks: int, n: int, sa_rate: int) -> tuple[int, int, int]:
    """``(bytes, integer operations, popcounts)`` of one batch: ``reads``
    patterns of ``length`` int32 codes that took ``search_steps``
    backward-search steps and ``walks`` walks of ``walk_steps`` LF steps in
    all."""
    rows, samples = table_bytes(n, sa_rate)
    io = 4 * reads * length + 4 * reads + 4 * reads
    index = (min(rows, ROW_BYTES * (2 * search_steps + walk_steps))
             + min(samples, SECTOR * walks))
    ops = SEARCH_STEP_OPS * search_steps + WALK_STEP_OPS * walk_steps
    popc = SEARCH_STEP_POPC * search_steps + WALK_STEP_POPC * walk_steps
    return io + index, ops, popc


def least_seconds(nbytes: float, ops: float, popc: float,
                  peak: dict) -> tuple[float, str]:
    """The least time for the work on a card whose peaks are ``peak``
    (``peaks.json``), and which of the three bounds sets it: the bytes at
    the memory's bandwidth, the integer operations at the integer lanes'
    rate, or the popcounts at theirs (they run on units of their own)."""
    bounds = {"bytes": nbytes / peak["hbm_bytes_per_s"],
              "operations": ops / peak["int_ops_per_s"],
              "popcounts": popc / peak["popc_per_s"]}
    by = max(bounds, key=bounds.get)
    return bounds[by], by
