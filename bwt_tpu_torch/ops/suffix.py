"""Suffix-array construction by prefix doubling over ``torch.sort``.

Each doubling round packs the pair (rank of suffix i, rank of suffix
i+k) into one int64 key and sorts it stably; adjacent-key changes give
the new dense ranks.  The first round starts from 12-character prefix
ranks.  The SA of ``seq + sentinel`` is unique, so the result equals
every other correct construction's (histsortcomp.c:161, csacak.c:521):
``SA[0] == len`` and the row with ``SA[i] == 0`` is ``endloc``.
"""

from __future__ import annotations

import torch

_INIT_K = 12  # initial rank prefix length

# the SA spans len+1 entries with values 0..len, held in int32
INT32_MAX_LEN = (1 << 31) - 2

# bound on the first round's ranks (12-char prefix * 13 + tie + 1); the
# packed-key stride must exceed every rank + 1
_INIT_RANK_BOUND = 13 * ((1 << 24) - 1) + 14


def _initial_ranks(codes: torch.Tensor, length: int) -> torch.Tensor:
    """Order-consistent ranks of the 12-character prefixes (int64).

    Windows past the end read 'A'; a tie digit orders tail windows (which
    contain the sentinel) below equal full windows and shortest-first."""
    pad = torch.zeros(length + _INIT_K, dtype=torch.int64,
                      device=codes.device)
    pad[:length] = codes
    vals = torch.zeros(length, dtype=torch.int64, device=codes.device)
    for k in range(_INIT_K):
        vals = vals * 4 + pad[k:k + length]
    i = torch.arange(length, dtype=torch.int64, device=codes.device)
    tie = 12 - (i - (length - _INIT_K)).clamp(0, _INIT_K)
    keys = vals * 13 + tie + 1
    return torch.cat([keys, keys.new_zeros(1)])


def suffix_array_with_isa(codes: torch.Tensor):
    """(SA, ISA) of ``codes + sentinel`` as int32 tensors of length
    ``len(codes)+1`` on ``codes``' device.  ``codes`` holds 0..3."""
    length = int(codes.shape[0])
    if length > INT32_MAX_LEN:
        raise ValueError(
            f"genome length {length} exceeds the int32 suffix-array cap "
            f"({INT32_MAX_LEN})")
    dev = codes.device
    codes = codes.to(torch.int64)
    m = length + 1
    if m > _INIT_K + 1:
        r = _initial_ranks(codes, length)
        k = _INIT_K
    else:
        r = torch.cat([codes + 1, codes.new_zeros(1)])
        k = 1
    stride = max(m + 2, _INIT_RANK_BOUND + 2)
    while k < m:
        r2 = torch.full((m,), -1, dtype=torch.int64, device=dev)
        r2[: m - k] = r[k:]
        key_s, sa = torch.sort(r * stride + (r2 + 1), stable=True)
        changed = torch.ones(m, dtype=torch.int64, device=dev)
        changed[0] = 0
        changed[1:] = (key_s[1:] != key_s[:-1]).to(torch.int64)
        ranks_sorted = torch.cumsum(changed, dim=0)
        r = torch.empty_like(r)
        r[sa] = ranks_sorted
        k *= 2
        if int(ranks_sorted[-1]) == m - 1:  # every suffix separated
            break
    isa = r.to(torch.int32)
    sa = torch.empty(m, dtype=torch.int32, device=dev)
    sa[r] = torch.arange(m, dtype=torch.int32, device=dev)
    return sa, isa


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
    ``(bwt_codes, endloc)``."""
    endloc = isa[0]
    tail = isa[1:]
    dest = (tail - (tail > endloc).to(tail.dtype)).long()
    bwt = torch.empty_like(codes)
    bwt[dest] = codes
    return bwt, endloc
