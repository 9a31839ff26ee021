"""Occ/rank queries over the fused checkpoint+payload bucket layout.

One 32-byte bucket row per 64 BWT entries::

    [occ_A occ_C occ_G occ_T | w0 w1 w2 w3]

``occ_c`` counts symbol ``c`` in ``bwt[0 : 64b]`` and ``w0..w3`` hold
the next 64 bases, 16 little-endian 2-bit lanes per word.  A rank or an
LF step reads one row; the in-bucket count is XOR/mask/popcount over the
four words.  Semantics follow seqindex.c:214-225, sentinel skip included.

Words are int32 tensors holding uint32 bit patterns: PyTorch has no
unsigned shift or popcount on the CPU, so bit work widens to int64 and
masks back to 32 bits.  Index arithmetic stays int32 and wraps as the
reference package's does.  Out-of-range row indices (the C drivers'
garbage arithmetic reaches rank/LF with them) read like ``jnp.take``:
negative indices in [-n, 0) wrap, anything further out reads a row of
the int32 minimum.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_LANES = 0x55555555

BUCKET_WORDS = 4  # payload words per bucket (64 bases)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its unsigned value, as int64."""
    return x.to(torch.int64) & _M32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def eq_mask(words_u: torch.Tensor, c) -> torch.Tensor:
    """One bit (at lane position 2j) per 2-bit lane of ``words_u``
    (unsigned values, int64) equal to ``c``.  ``c`` is taken as uint32,
    like the reference package's multiply, so codes outside 0..3 give
    the same bits there and here."""
    c = torch.as_tensor(c, device=words_u.device).to(torch.int64)
    pat = ((c & _M32) * _LANES) & _M32
    x = words_u ^ pat
    return ~(x | (x >> 1)) & _LANES


def word_count(words_u: torch.Tensor, c) -> torch.Tensor:
    """Count of symbol ``c`` in each full 16-lane word."""
    return popcount32(eq_mask(words_u, c))


def make_buckets(words: torch.Tensor, length: int):
    """Fused bucket rows from packed BWT words.

    ``words`` (nwords,) int32 bit patterns of the compact BWT, zero tail
    lanes; ``length`` BWT entries.  Returns ``(buckets, totals)``:
    (nbuckets+1, 8) int32 rows, the last holding the per-symbol totals
    and a zero payload, and the (4,) int64 totals."""
    nwords = words.shape[0]
    nb = max((nwords + BUCKET_WORDS - 1) // BUCKET_WORDS, 1)
    padded = torch.zeros(nb * BUCKET_WORDS, dtype=torch.int32,
                         device=words.device)
    padded[:nwords] = words
    wu = u32(padded)
    counts = torch.stack([word_count(wu, c) for c in range(4)], dim=-1)
    counts[nwords:] = 0
    if nwords:
        # the zero-padded ('A') tail lanes of the last real word
        counts[nwords - 1, 0] -= (-length) % 16
    bucket_counts = counts.reshape(nb, BUCKET_WORDS, 4).sum(dim=1)
    occ = torch.cat([bucket_counts.new_zeros(1, 4),
                     torch.cumsum(bucket_counts, dim=0)])
    word_rows = torch.cat([padded.reshape(nb, BUCKET_WORDS),
                           padded.new_zeros(1, BUCKET_WORDS)])
    buckets = torch.cat([occ.to(torch.int32), word_rows], dim=1)
    return buckets.contiguous(), occ[-1]


def take_fill(table: torch.Tensor, idx: torch.Tensor, tp=None,
              n: int | None = None) -> torch.Tensor:
    """``table[idx]`` along dim 0 with ``jnp.take``'s default semantics:
    indices in [-n, 0) wrap, indices further out read the dtype
    minimum (in every column).

    ``tp`` (an ``index.Shard``) is the tp form, the counterpart of
    ``bwt_tpu``'s ``take_sharded`` / ``_rows``: ``table`` is this rank's
    block of a table of ``n`` rows cut in blocks of ``table.shape[0]``
    rows.  The index wraps and is checked against the global ``n`` first;
    then each rank gathers the rows it owns from its block (clipped,
    masked to zero elsewhere) and one all-reduce over the tp group
    (``Shard.all_reduce``) makes the true rows on every rank.  Every rank
    of the group must call it with the same indices, in the same order."""
    if tp is None:
        n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    fill = torch.iinfo(table.dtype).min
    if tp is None:
        out = table[idx.clamp(0, n - 1).long()]
    else:
        per = table.shape[0]
        local = idx.to(torch.int64) - tp.coord * per
        mine = (local >= 0) & (local < per)
        out = table[local.clamp(0, per - 1)]
        out = tp.all_reduce(torch.where(
            mine.unsqueeze(-1) if out.dim() > idx.dim() else mine, out, 0))
    if out.dim() > idx.dim():
        return out.masked_fill(oob.unsqueeze(-1), fill)
    return out.masked_fill(oob, fill)


def _rows(buckets: torch.Tensor, i: torch.Tensor, tp=None,
          n: int | None = None) -> torch.Tensor:
    """The bucket row covering (adjusted) index ``i``; ``tp`` and ``n``
    (the global row count) as :func:`take_fill`'s."""
    return take_fill(buckets, i >> 6, tp, n)


def _lane_masks(r: torch.Tensor) -> torch.Tensor:
    """Per payload word, a mask of the lanes below offset ``r`` (0..64),
    unsigned values as int64 (..., 4)."""
    w = torch.arange(BUCKET_WORDS, device=r.device, dtype=torch.int64)
    lanes = (r.to(torch.int64).unsqueeze(-1) - 16 * w).clamp(0, 16)
    below = torch.bitwise_left_shift(torch.ones_like(lanes),
                                     2 * lanes.clamp(max=15)) - 1
    return torch.where(lanes >= 16, _M32, below)


def _sel4(cols: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``cols[..., c]`` for c in 0..3, and 0 for any other c."""
    ok = (c >= 0) & (c < 4)
    got = cols.gather(-1, c.clamp(0, 3).long().unsqueeze(-1)).squeeze(-1)
    return torch.where(ok, got, torch.zeros_like(got))


def _row_rank(rows: torch.Tensor, c: torch.Tensor, r: torch.Tensor):
    occ_c = _sel4(rows[..., :4], c).to(torch.int64)
    eq = eq_mask(u32(rows[..., 4:]), c.unsqueeze(-1))
    cnt = popcount32(eq & _lane_masks(r)).sum(-1)
    return wrap32(occ_c + cnt)


def _row_char(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    w = rows[..., 4:].gather(-1, (r >> 4).long().unsqueeze(-1)).squeeze(-1)
    return ((u32(w) >> (2 * (r & 15)).to(torch.int64)) & 3).to(torch.int32)


def _adjust(endloc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sentinel skip: the stored BWT omits the sentinel row
    (seqindex.c:221-225)."""
    return idx - (idx > endloc).to(idx.dtype)


def rank(buckets, endloc, c, idx, tp=None, n=None):
    """rank of ``c`` in ``bwt[0:idx]`` with sentinel skipping; ``c`` and
    ``idx`` broadcast together.  ``tp`` and ``n``: a tp view's block and
    the global row count (:func:`take_fill`), here and below."""
    idx = torch.as_tensor(idx, dtype=torch.int32, device=buckets.device)
    c = torch.as_tensor(c, dtype=torch.int32, device=buckets.device)
    i = _adjust(endloc, idx)
    c, i = torch.broadcast_tensors(c, i)
    return _row_rank(_rows(buckets, i, tp, n), c, i & 63)


def row_ranks_all4(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """All four symbol ranks from fetched rows at offset ``r``: (..., 4)."""
    words = u32(rows[..., 4:])
    mask = _lane_masks(r)
    cnts = torch.stack(
        [popcount32(eq_mask(words, c) & mask).sum(-1) for c in range(4)],
        dim=-1)
    return wrap32(rows[..., :4].to(torch.int64) + cnts)


def ranks_all4(buckets, endloc, idx, tp=None, n=None):
    """All four symbol ranks at ``idx`` from one row fetch: (..., 4)."""
    i = _adjust(endloc, idx)
    return row_ranks_all4(_rows(buckets, i, tp, n), i & 63)


def bwt_char(buckets, endloc, idx, tp=None, n=None):
    """Character of the sentinel-full BWT at ``idx`` (idx != endloc)."""
    i = _adjust(endloc, idx)
    return _row_char(_rows(buckets, i, tp, n), i & 63)


def row_lf(rows, C, endloc, idx, r):
    """LF-mapping from already-fetched rows (``r`` = in-bucket offset of
    the adjusted index)."""
    c = _row_char(rows, r)
    stepped = wrap32(C[c.long()].to(torch.int64)
                     + _row_rank(rows, c, r).to(torch.int64))
    return torch.where(idx == endloc, torch.zeros_like(stepped), stepped)


def lf(buckets, C, endloc, idx, tp=None, n=None):
    """LF-mapping (seqindex.c:214-219), ``lf(endloc) == 0``."""
    i = _adjust(endloc, idx)
    return row_lf(_rows(buckets, i, tp, n), C, endloc, idx, i & 63)
