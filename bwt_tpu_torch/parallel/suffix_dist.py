"""Suffix-array construction with the sort state sharded over a mesh axis.

The counterpart of ``bwt_tpu.parallel.suffix_dist``: prefix doubling
(``ops/suffix.py``) whose keys, shifted keys and payload are split across
the ranks of one mesh axis, so a rank's sort workspace is 1/p of the
single-device build's and a genome past one card's build peak can be
indexed.  Each rank runs its local sorts on its own device; the ranks
meet only in the collectives of ``parallel/mesh.py``:

* ranks hold text-ordered blocks: rank s owns global positions
  ``[s * nloc, (s + 1) * nloc)``;
* the initial keys are the 12-character packed prefixes of
  ``ops/suffix._initial_ranks``, made from the rank's block and a
  12-character halo from the next rank; the pads past the end take
  unique keys past every real one, so they stay at the global tail and
  never tie;
* ``r2[i] = r[i + k]`` is two block shifts (from ranks s + k // nloc and
  one further) and a slice;
* the global sort of (r, r2) — packed into one int64 key, rank above
  rank of the shifted suffix, with the position as payload — is an
  odd-even block merge-split sort: a local stable sort, then p rounds in
  which partners exchange their blocks, merge the two sorted blocks (the
  lower rank's first on a tie; each key's place by searchsorted in the
  other block) and keep their half;
* dense reranking is a segmented scan: the previous rank's last key for
  the boundary, shard offsets from one all-gather of the ranks' totals;
* the scatter back to text order is a second distributed sort, keyed by
  the SA (a permutation of the positions) with the new rank packed below.

The SA of a sentinel-terminated string is unique, so the result is the
single-device ``suffix.suffix_array``'s (``tests/test_torch_parallel.py``
holds it to ``bwt_tpu``'s on several meshes).
"""

from __future__ import annotations

import numpy as np
import torch

from bwt_tpu_torch import codec
from bwt_tpu_torch.ops import suffix
from bwt_tpu_torch.parallel.mesh import (
    Mesh, _all_gather, _ppermute)

_INIT_K = 12  # matches ops/suffix._INIT_K
_LOW = 32  # a packed key: the first key above bit 32, the second below
_PAD_TOP = 2147400000  # the pads' keys end here, above every real key


def _block_from(mesh: Mesh, ax: str, x: torch.Tensor, d: int):
    """The block ``x`` of rank ``s + d`` along ``ax`` (zeros where
    ``s + d >= p``)."""
    p = mesh.shape[ax]
    if d == 0:
        return x
    if d >= p:
        return torch.zeros_like(x)
    return _ppermute(mesh, ax, x, [(s, s - d) for s in range(d, p)])


def _sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """The columns of ``rows`` stably sorted by row 0."""
    return rows[:, torch.sort(rows[0], stable=True)[1]]


def _merge_half(lower: torch.Tensor, upper: torch.Tensor, low: bool):
    """The first (``low``) or second half of the stable merge of two
    sorted (c, n) blocks, ``lower`` before ``upper`` on a tie: each column's
    place in the merge is its own index plus the count of the other
    block's keys before it (searchsorted), and the columns whose place
    lies in the wanted half are scattered there; the rest go to a spare
    column past the end."""
    n = lower.shape[1]
    at = torch.arange(n, device=lower.device)
    out = lower.new_empty((lower.shape[0], n + 1))
    for rows, place in (
            (lower, at + torch.searchsorted(upper[0], lower[0], side="left")),
            (upper, at + torch.searchsorted(lower[0], upper[0],
                                            side="right"))):
        dst = place if low else place - n
        out[:, torch.where((dst >= 0) & (dst < n), dst, n)] = rows
    return out[:, :n].contiguous()


def _merge_split_sort(mesh: Mesh, ax: str, rows: torch.Tensor):
    """Distributed sort of the (c, nloc) columns ``rows`` by row 0, sharded
    by columns along ``ax``: sorted across the ranks' order after p
    odd-even rounds.  Both partners merge the same two blocks, so they
    keep complementary halves."""
    p, me = mesh.shape[ax], mesh.coords[ax]
    rows = _sort_rows(rows)
    for t in range(p):
        pairs = [(s, s + 1) for s in range(t & 1, p - 1, 2)]
        if not pairs:
            continue
        theirs = _ppermute(mesh, ax, rows,
                           pairs + [(b, a) for a, b in pairs])
        for a, b in pairs:
            if me == a:
                rows = _merge_half(rows, theirs, low=True)
            elif me == b:
                rows = _merge_half(theirs, rows, low=False)
    return rows


def _initial_keys(mesh: Mesh, ax: str, block: torch.Tensor, m: int):
    """The 12-character prefix keys of the rank's block (int64), in
    ``ops/suffix._initial_ranks``' order; the sentinel 0, pads unique."""
    p, me = mesh.shape[ax], mesh.coords[ax]
    nloc, length = block.shape[0], m - 1
    j = me * nloc + torch.arange(nloc, dtype=torch.int64, device=block.device)
    halo = _block_from(mesh, ax, block[:_INIT_K].contiguous(), 1)
    ext = torch.cat([block, halo])
    vals = torch.zeros(nloc, dtype=torch.int64, device=block.device)
    for t in range(_INIT_K):
        vals = vals * 4 + torch.where(j + t < length, ext[t:t + nloc], 0)
    tie = _INIT_K - (j - (length - _INIT_K)).clamp(0, _INIT_K)
    keys = torch.where(j == length, 0, vals * 13 + tie + 1)
    return torch.where(j > length, _PAD_TOP - p * nloc + j, keys)


def _round(mesh: Mesh, ax: str, r: torch.Tensor, m: int, k: int):
    """One doubling round: (new ranks in text order, the SA block in sorted
    order, whether every suffix is now apart)."""
    p, me = mesh.shape[ax], mesh.coords[ax]
    nloc = r.shape[0]
    j = me * nloc + torch.arange(nloc, dtype=torch.int64, device=r.device)
    d, off = divmod(k, nloc)
    a = _block_from(mesh, ax, r, d)
    r2 = a
    if off:  # the next rank's first off ranks complete the window
        r2 = torch.cat([a[off:], _block_from(mesh, ax, a[:off].contiguous(),
                                             1)])
    r2 = torch.where(j + k < m, r2, -1)
    key, sa = _merge_split_sort(
        mesh, ax, torch.stack([(r << _LOW) | (r2 + 1), j]))
    prev = _ppermute(mesh, ax, key[-1:].contiguous(),
                     [(s, s + 1) for s in range(p - 1)])
    changed = (key != torch.cat([prev, key[:-1]])).to(torch.int64)
    if me == 0:
        changed[0] = 0
    local = torch.cumsum(changed, 0)
    g = _all_gather(mesh, ax, torch.stack([local[-1], changed.sum()]))
    g = g.reshape(p, 2)
    ranks = local + g[:me, 0].sum()
    done = int(g[:, 1].sum()) + 1 == p * nloc
    new_r = _merge_split_sort(mesh, ax, ((sa << _LOW) | ranks)[None])[0]
    return new_r & ((1 << _LOW) - 1), sa, done


def sharded_suffix_array(codes, mesh: Mesh, *, axis: str = "tp") -> np.ndarray:
    """Suffix array of ``codes + sentinel`` built with the sort state
    sharded over ``mesh``'s ``axis`` (see the module docstring).  Every
    rank passes the whole genome and uploads only its block; every rank of
    the axis returns the whole SA as an int32 numpy array, equal to
    :func:`bwt_tpu_torch.ops.suffix.suffix_array`'s.  One rank on the axis,
    or a genome under 48 bases a rank, takes the single-device sort on the
    rank's device."""
    codes = np.asarray(codes)
    n = int(codes.shape[0])
    m = n + 1
    p = mesh.shape[axis]
    if p == 1 or m < 4 * p * _INIT_K:
        return suffix.suffix_array(codes, device=mesh.device).cpu().numpy()
    if n > suffix.INT32_MAX_LEN:
        raise ValueError(
            f"genome length {n} exceeds the int32 suffix-array cap "
            f"({suffix.INT32_MAX_LEN})")
    nloc = -(-m // p)
    lo = mesh.coords[axis] * nloc
    block = np.zeros(nloc, np.int64)
    mine = codes[lo:min(lo + nloc, n)]
    block[:mine.shape[0]] = mine
    r = _initial_keys(mesh, axis, torch.from_numpy(block).to(mesh.device), m)
    k = _INIT_K
    while True:
        r, sa, done = _round(mesh, axis, r, m, k)
        k *= 2
        if done or k >= m:
            break
    return _all_gather(mesh, axis, sa.to(torch.int32)).cpu().numpy()[:m]


def build_index_sharded(codes, mesh: Mesh, *, axis: str = "tp", **kwargs):
    """An index whose suffix sort ran sharded over ``mesh``'s ``axis``
    (:func:`sharded_suffix_array`), finished on this rank's device by
    ``build_index(codes, sa=...)``: every rank of the axis holds the whole
    index, equal to :func:`bwt_tpu_torch.build_index`'s.  ``kwargs`` go to
    ``build_index`` (``device`` defaults to the mesh's)."""
    from bwt_tpu_torch.index import build_index

    if isinstance(codes, (str, bytes)):
        codes = codec.encode_genome(codes)
    sa = sharded_suffix_array(codes, mesh, axis=axis)
    kwargs.setdefault("device", mesh.device)
    return build_index(codes, sa=sa, **kwargs)
