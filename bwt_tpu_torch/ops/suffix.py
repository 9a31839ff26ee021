"""Suffix-array construction by prefix doubling over ``torch.sort``, one
bucket of suffixes at a time.

Round 0 orders the positions by their 24-character prefix, the pair of
12-character keys at i and i+12.  Each later round, with stride k, orders
every group of suffixes that still tie (equal k-prefixes) by the rank of
the suffix k further on.  A group's rank is the SA position of its first
member, so ranks stay order-consistent and below ``m``, and a group is one
contiguous slice of the order ``sa`` that the previous round left.  So a
round sorts slices of about :data:`BUCKET` suffixes, one after another,
each by its packed (group, rank of suffix i+k) key alone, writes the
slice's order back into ``sa`` and its new ranks into the next rank
array, and skips the suffixes already alone in their group; round 0
splits the positions by ranges of the first key the same way.

``torch.sort``'s keys, indices and buffers then cover one bucket, and
across a round the sort holds the codes, ``sa``, the ranks and the next
ranks: 13 bytes a base on the int32 index (25 on the wide one), against
about 97 for a sort of the whole genome at once.  A genome under one
bucket takes one sort a round.  Where the packed key would pass int64
(past about 3 * 10^9 positions) a bucket is sorted by two stable sorts
instead, as ``bwt_tpu``'s int64 suffix array sorts its two keys
(``bwt_tpu/ops/suffix.py:80-100``).  The SA of ``seq + sentinel`` is
unique, so the result equals every other correct construction's
(histsortcomp.c:161, csacak.c:521): ``SA[0] == len`` and the row with
``SA[i] == 0`` is ``endloc``.  :data:`LAST_SORT` records what the latest
sort did, round by round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_INIT_K = 12  # initial rank prefix length

# the SA spans len+1 entries with values 0..len, held in int32
INT32_MAX_LEN = (1 << 31) - 2

# the largest stride whose packed key r * stride + r2 + 1 stays inside
# int64 (floor(sqrt(2^63 - 1))); past it the rounds take the two-key sort
PACKED_KEY_MAX = 3037000499

# bound on the first round's keys (12-char prefix * 13 + tie + 1): every
# key lies below it, so it fits int32
_INIT_RANK_BOUND = 13 * ((1 << 24) - 1) + 14

# suffixes a bucket sorts at once (a group of tied suffixes larger than
# this is sorted whole), and positions a pass of the key histogram or the
# BWT's scatter covers
BUCKET = 1 << 22


@dataclasses.dataclass
class SortRecord:
    """What one suffix sort did, a list entry a round (round 0 the ranking
    by the first 24 characters): the buckets it sorted, and the suffixes
    whose group still held another suffix after it."""

    buckets: list[int] = dataclasses.field(default_factory=list)
    unresolved: list[int] = dataclasses.field(default_factory=list)

    @property
    def rounds(self) -> int:
        return len(self.buckets)


# the record of the latest :func:`suffix_array_with_isa` in this process
LAST_SORT: SortRecord | None = None


def _initial_ranks(codes: torch.Tensor, length: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Order-consistent keys of the 12-character prefixes, the sentinel's 0
    last, built in place in ``dtype``.  ``length`` is at least 12.

    Windows past the end read 'A'; a tie digit orders tail windows (which
    contain the sentinel) below equal full windows and shortest-first."""
    keys = torch.zeros(length + 1, dtype=dtype, device=codes.device)
    vals = keys[:length]
    for k in range(_INIT_K):
        vals.mul_(4)
        vals[:length - k].add_(codes[k:])
    # key = vals * 13 + tie + 1, tie 12 on a full window and length - i on
    # the tail's window at i
    vals.mul_(13).add_(_INIT_K + 1)
    vals[length - _INIT_K:] -= torch.arange(_INIT_K, dtype=dtype,
                                            device=codes.device)
    return keys


def _sort_pairs(r: torch.Tensor, r2: torch.Tensor, stride: int):
    """The order of the pairs (r, r2), ties in index order, and whether
    each sorted pair differs from the one before it.  One sort of the
    packed key ``r * stride + r2 + 1`` where that fits int64, built in
    place over ``r`` (int64, the caller's to lose), else a stable sort by
    r2 then a stable sort by r."""
    if stride <= PACKED_KEY_MAX:
        key_s, sa = torch.sort(r.mul_(stride).add_(r2).add_(1), stable=True)
        return sa, key_s[1:] != key_s[:-1]
    _, by2 = torch.sort(r2, stable=True)
    _, by1 = torch.sort(r[by2], stable=True)
    sa = by2[by1]
    rs, r2s = r[sa], r2[sa]
    return sa, (rs[1:] != rs[:-1]) | (r2s[1:] != r2s[:-1])


def _place(order, slots, differs, sa, nxt) -> torch.Tensor:
    """Writes a sorted bucket: the suffixes ``order`` into the slots
    ``slots`` of ``sa`` (ascending, whole groups), and each suffix's new
    rank, the slot of its new group's first member, into ``nxt``.
    ``differs`` says where a sorted key differs from the one before it.
    Returns how many suffixes still share their group (a tensor)."""
    n = order.shape[0]
    sa[slots] = order.to(sa.dtype)
    starts = torch.ones(n, dtype=torch.bool, device=order.device)
    starts[1:] = differs
    ends = torch.ones_like(starts)
    ends[:-1] = differs
    tied = n - (starts & ends).sum()
    # the first index of each suffix's group number in the (sorted) group
    # numbers is its group's first member
    group = torch.cumsum(starts, 0)
    first = torch.searchsorted(group, group)
    del group
    nxt[order] = slots[first].to(nxt.dtype)
    return tied


def _key_ranges(r: torch.Tensor, bound: int):
    """Ranges of key values, in order, covering 0..bound - 1, each holding
    at most :data:`BUCKET` of the keys ``r`` or a single bin of a
    histogram of ``r`` by its top 16 bits: (the first key of each range
    but the first, the number of keys in each range)."""
    m = r.shape[0]
    if m <= BUCKET:
        return [], [m]
    shift = max((bound - 1).bit_length() - 16, 0)
    nbins = ((bound - 1) >> shift) + 1
    hist = torch.zeros(nbins, dtype=torch.int64, device=r.device)
    for c in range(0, m, BUCKET):
        hist += torch.bincount(r[c:c + BUCKET] >> shift, minlength=nbins)
    cum = torch.cumsum(hist, 0).cpu().numpy()
    edges, sizes, lo, done = [], [], 0, 0
    while lo < nbins:
        hi = max(int(np.searchsorted(cum, done + BUCKET, side="right")),
                 lo + 1)
        if lo:
            edges.append(lo << shift)
        sizes.append(int(cum[hi - 1]) - done)
        done, lo = int(cum[hi - 1]), hi
    return edges, sizes


def _by_range(r: torch.Tensor, edges: list[int], sizes: list[int], sa):
    """A counting sort of the positions by key range into ``sa``: range
    j's positions, ascending, fill the slots from ``sum(sizes[:j])``,
    :data:`BUCKET` positions at a time (no synchronisation)."""
    m = r.shape[0]
    dev = r.device
    if not edges:
        sa.copy_(torch.arange(m, dtype=sa.dtype, device=dev))
        return
    inner = torch.tensor(edges, dtype=r.dtype, device=dev)
    fill = torch.tensor(np.cumsum([0] + sizes[:-1]), dtype=torch.int64,
                        device=dev)  # each range's next free slot
    for c in range(0, m, BUCKET):
        rid = torch.bucketize(r[c:c + BUCKET], inner, right=True)
        rid_s, perm = torch.sort(rid, stable=True)
        counts = torch.bincount(rid, minlength=len(sizes))
        # slot of the j-th sorted position: its range's next free slot,
        # plus j, less the range's first index in the sorted chunk
        base = fill - torch.cumsum(counts, 0).sub_(counts)
        dest = base[rid_s].add_(torch.arange(rid_s.shape[0], device=dev))
        sa[dest] = perm.add_(c).to(sa.dtype)
        fill += counts


def _heads(r: torch.Tensor, sa: torch.Tensor, a: int, b: int):
    """Whether each slot a..b-1 of ``sa`` starts its group; slot ``m``
    (past the end, b <= m + 1) counts as a start."""
    m = sa.shape[0]
    e = min(b, m)
    flags = r[sa[a:e]] == torch.arange(a, e, dtype=r.dtype, device=r.device)
    if b > m:
        flags = torch.cat([flags, flags.new_ones(b - m)])
    return flags


def _tied_slices(r: torch.Tensor, sa: torch.Tensor):
    """The slices [a, b) of ``sa``, in order, that hold whole groups, about
    :data:`BUCKET` slots each (a larger group alone), and a group of more
    than one suffix: each slice's a, and its slots that share their group
    (int64)."""
    m = sa.shape[0]
    a = 0
    while a < m:
        end = min(a + BUCKET, m)
        flags = _heads(r, sa, a, end + 1)  # slots a..end
        later = torch.nonzero(flags[1:])
        if later.numel():
            b = a + 1 + int(later[-1])
            f = flags[:b - a + 1]
            slots = torch.nonzero(~(f[:-1] & f[1:])).flatten().add_(a)
        else:  # the group at a runs past the window: find its end
            b = end + 1
            while True:
                e = min(b + BUCKET, m + 1)
                first = torch.nonzero(_heads(r, sa, b, e))
                if first.numel():
                    b += int(first[0])
                    break
                b = e
            slots = torch.arange(a, b, device=sa.device)
        if slots.numel():
            yield a, slots
        a = b


def _first_round(r, bound, k: int, sa, nxt, record) -> int:
    """Round 0: ``sa`` in the order of the key pairs (r[i], r[i+k]) (keys
    below ``bound``; a suffix past the end reads the sentinel's, whose
    first key is unique anyway), ties in position order, and each
    position's rank into ``nxt``, a range of the first key at a time.
    Returns how many suffixes share their group."""
    m = r.shape[0]
    edges, sizes = _key_ranges(r, bound)
    _by_range(r, edges, sizes, sa)
    count, tied, buckets = 0, 0, 0
    for n in sizes:
        if not n:
            continue
        pos = sa[count:count + n]
        perm, differs = _sort_pairs(r[pos].to(torch.int64),
                                    r[pos.clamp_max(m - 1 - k) + k],
                                    bound + 1)
        order = pos[perm]
        del pos, perm
        slots = torch.arange(count, count + n, device=r.device)
        tied += _place(order, slots, differs, sa, nxt)
        count += n
        buckets += 1
    tied = int(tied)
    record.buckets.append(buckets)
    record.unresolved.append(tied)
    return tied


def _round(r, sa, nxt, k: int, record) -> int:
    """One doubling round: each slice of tied groups sorted by (group,
    rank of the suffix ``k`` further on), its order into ``sa`` and its
    ranks into ``nxt``.  Returns how many suffixes share their group."""
    stride = sa.shape[0] + 1
    tied, buckets = 0, 0
    for a, slots in _tied_slices(r, sa):
        pos = sa[slots]
        # a tied suffix's k-prefix holds no sentinel, so pos + k < m
        perm, differs = _sort_pairs(r[pos].to(torch.int64).sub_(a),
                                    r[pos + k], stride)
        order = pos[perm]
        del pos, perm
        tied += _place(order, slots, differs, sa, nxt)
        buckets += 1
    tied = int(tied)
    record.buckets.append(buckets)
    record.unresolved.append(tied)
    return tied


def _index_dtype(dtype) -> torch.dtype:
    """torch.int32 or torch.int64 from a torch or numpy dtype or its
    name; anything else raises ValueError."""
    for t in (torch.int32, torch.int64):
        if dtype is t or (not isinstance(dtype, torch.dtype)
                          and np.dtype(dtype) == np.dtype(str(t)[6:])):
            return t
    raise ValueError(f"unsupported SA dtype {dtype} (int32 or int64)")


def suffix_array_with_isa(codes: torch.Tensor, *, dtype=torch.int32):
    """(SA, ISA) of ``codes + sentinel`` as tensors of ``dtype`` (int32,
    or int64 for the wide index) of length ``len(codes)+1`` on ``codes``'
    device.  ``codes`` holds 0..3 (uint8, or any integer type).  Ranks
    are held in ``dtype``; :data:`LAST_SORT` gets the sort's record."""
    global LAST_SORT
    length = int(codes.shape[0])
    dtype = _index_dtype(dtype)
    if dtype == torch.int32 and length > INT32_MAX_LEN:
        raise ValueError(
            f"genome length {length} exceeds the int32 suffix-array cap "
            f"({INT32_MAX_LEN}); pass dtype=torch.int64")
    record = LAST_SORT = SortRecord()
    m = length + 1
    if m > _INIT_K + 1:
        r = _initial_ranks(codes, length, dtype)
        k, bound = _INIT_K, _INIT_RANK_BOUND
    else:
        r = torch.zeros(m, dtype=dtype, device=codes.device)
        r[:length] = codes
        r[:length] += 1
        k, bound = 1, 5
    sa = torch.empty_like(r)
    nxt = torch.empty_like(r)
    tied = _first_round(r, bound, k, sa, nxt, record)
    r, nxt = nxt, r
    k *= 2
    while tied:
        nxt.copy_(r)
        tied = _round(r, sa, nxt, k, record)
        r, nxt = nxt, r
        k *= 2
    return sa, r


def verify_suffix_array(codes: torch.Tensor, sa: torch.Tensor) -> bool:
    """Exact O(n) check: ``sa`` is a permutation of 0..m-1 and every
    adjacent pair is ordered by (first char, rank of the successor
    suffix) under the claimed inverse."""
    dev = sa.device
    codes = codes.to(device=dev, dtype=torch.int64)
    sa = sa.to(torch.int64)
    m = sa.shape[0]
    if codes.shape[0] + 1 != m:
        return False
    if not bool(((sa >= 0) & (sa < m)).all()):
        return False
    counts = torch.bincount(sa, minlength=m)
    if not bool((counts == 1).all()):
        return False
    inv = torch.empty(m, dtype=torch.int64, device=dev)
    inv[sa] = torch.arange(m, device=dev)
    ext = torch.cat([codes + 1, codes.new_zeros(1)])  # sentinel 0
    inv_next = torch.cat([inv, inv.new_full((1,), -1)])  # inv[m] = -1
    c1, c2 = ext[sa[:-1]], ext[sa[1:]]
    n1, n2 = inv_next[sa[:-1] + 1], inv_next[sa[1:] + 1]
    return bool(((c1 < c2) | ((c1 == c2) & (n1 < n2))).all())


def bwt_from_isa(codes: torch.Tensor, isa: torch.Tensor):
    """Compact BWT (sentinel row skipped, sprintcbwt histsortcomp.c:
    220-250) from the ISA: ``codes[p]`` lands on row ``ISA[p+1]``, one
    lower past the sentinel row ``endloc = ISA[0]``.  Returns
    ``(bwt_codes, endloc)``, the codes in ``codes``' dtype; the scatter
    takes :data:`BUCKET` positions at a time."""
    endloc = isa[0]
    bwt = torch.empty_like(codes)
    for c in range(0, codes.shape[0], BUCKET):
        tail = isa[1 + c:1 + c + BUCKET]
        dest = (tail - (tail > endloc).to(tail.dtype)).long()
        bwt[dest] = codes[c:c + BUCKET]
    return bwt, endloc


def suffix_array(codes, *, device=None, dtype=torch.int32) -> torch.Tensor:
    """Suffix array of ``codes + sentinel`` (``len(codes) + 1`` entries) as
    a tensor of ``dtype`` (int32, or int64) on ``device`` (default: a
    tensor's own device, else the card), by :func:`suffix_array_with_isa`'s
    doubling.  Every correct construction gives this array
    (histsortcomp.c:161, csacak.c:521).

    int32 caps the genome at :data:`INT32_MAX_LEN` bases: past it a
    ValueError, raised before anything is uploaded; int64 has no cap."""
    n = int(codes.shape[0]) if hasattr(codes, "shape") else len(codes)
    dtype = _index_dtype(dtype)
    if dtype == torch.int32 and n > INT32_MAX_LEN:
        raise ValueError(
            f"genome length {n} exceeds the int32 suffix-array cap "
            f"({INT32_MAX_LEN}); pass dtype=torch.int64")
    if isinstance(codes, torch.Tensor):
        dev = torch.device(device) if device is not None else codes.device
        codes = codes.to(dev)
    else:
        from bwt_tpu_torch.index import default_device

        dev = torch.device(device) if device is not None else default_device()
        codes = torch.from_numpy(
            np.ascontiguousarray(codes, dtype=np.uint8)).to(dev)
    return suffix_array_with_isa(codes, dtype=dtype)[0]


def bwt_from_sa(codes: torch.Tensor, sa: torch.Tensor):
    """Compact BWT (sentinel row skipped) from the sequence and its SA
    (sprintcbwt, histsortcomp.c:220-250): each row with ``SA[i] != 0``
    emits ``codes[SA[i] - 1]``, and the row with ``SA[i] == 0`` (``endloc``)
    is dropped.  Returns ``(bwt_codes, endloc)``."""
    m = sa.shape[0]
    endloc = torch.argmin(sa).to(torch.int32)
    j = torch.arange(m - 1, device=sa.device)
    prev = torch.where(j >= endloc, sa[1:], sa[:-1]).to(torch.int64) - 1
    return codes[prev], endloc


def naive_bwt_ascii(text: str) -> str:
    """BWT of an ASCII string with a NUL sentinel put in front, the
    sentinel printed as '$' (``./bwt``, bwt.c:13-61); sorts the rotations,
    for tiny inputs."""
    s = "\0" + text
    n = len(s)
    doubled = s + s
    order = sorted(range(n), key=lambda i: doubled[i:i + n])
    return "".join("$" if s[(i - 1) % n] == "\0" else s[(i - 1) % n]
                   for i in order)
