"""The PyTorch port's rank/LF and FM-index queries held bit-equal against
bwt_tpu on the same index (CPU), with the verify-skill probes: absent
patterns, N-bearing reads, 1-character reads, reads the length of the
genome, a repetitive genome, and out-of-range rank indices."""

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.ops import rank as jrank
from bwt_tpu.ops import search as jsearch

from bwt_tpu_torch.ops import rank as trank
from bwt_tpu_torch.ops import search as tsearch

from test_torch_index import to_port

LP = 40  # pattern width


@pytest.fixture(scope="module", params=[("rand", 3000, 4), ("rand", 3000, 32),
                                        ("zeros", 500, 8), ("rand", 37, 4)],
                ids=["rand-r4", "rand-r32", "zeros-r8", "tiny-r4"])
def env(request):
    kind, n, rate = request.param
    rng = np.random.default_rng(n + rate)
    g = (np.zeros(n, np.uint8) if kind == "zeros"
         else rng.integers(0, 4, n).astype(np.uint8))
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    return g, jfmi, to_port(jfmi), rng


def _patterns(g, rng, B=48):
    """Left-aligned (B, LP) patterns with their lengths: substrings,
    absent random reads, N-bearing reads, 1-char reads, length-0 reads
    and (where it fits) the whole genome."""
    n = len(g)
    pats = np.zeros((B, LP), np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 6
        ln = int(rng.integers(1, min(LP, n) + 1))
        if kind == 0:
            s = int(rng.integers(0, n - ln + 1))
            pats[b, :ln] = g[s:s + ln]
        elif kind == 1:
            pats[b, :ln] = rng.integers(0, 4, ln)
        elif kind == 2:
            s = int(rng.integers(0, n - ln + 1))
            pats[b, :ln] = g[s:s + ln]
            pats[b, rng.integers(0, ln, size=1 + ln // 8)] = 5
            if b % 12 == 2:
                pats[b, max(ln - 3, 0):ln] = 5  # trailing N run
            if b % 24 == 2:
                pats[b, :ln] = 5  # all N
        elif kind == 3:
            ln = 1
            pats[b, 0] = rng.integers(0, 4)
        elif kind == 4:
            ln = 0
        else:
            ln = min(n, LP)
            pats[b, :ln] = g[:ln]
        lens[b] = ln
    return pats, lens


def _eq(got, want):
    assert np.array_equal(np.asarray(got.cpu() if torch.is_tensor(got)
                                     else got), np.asarray(want))


@pytest.mark.parametrize("resolve_n", [False, True])
def test_backward_search_family(env, resolve_n):
    g, jfmi, tfmi, rng = env
    pats, lens = _patterns(g, rng)
    if not resolve_n:
        pats = np.where(pats == 5, 0, pats)
    want = jsearch.backward_search(jfmi, pats, lens, resolve_n=resolve_n)
    got = tsearch.backward_search(tfmi, pats, lens, resolve_n=resolve_n)
    for k in want:
        _eq(got[k], want[k])
    if not resolve_n:
        _eq(tsearch.reverse_search(tfmi, pats, lens),
            jsearch.reverse_search(jfmi, pats, lens))
        _eq(tsearch.count_matches(tfmi, pats, lens),
            jsearch.count_matches(jfmi, pats, lens))
        # a symbol absent from the genome starts its interval at row n+1,
        # past the SA; the unc_sa walk from there never reaches a sampled
        # row (in either package, as in the reference), so locate only
        # the lanes whose final interval starts on a real row
        real = np.asarray(want["start"]) <= len(g)
        _eq(tsearch.locate(tfmi, pats[real], lens[real]),
            jsearch.locate(jfmi, pats[real], lens[real]))
        for a, b in zip(tsearch.loc_search(tfmi, pats, lens),
                        jsearch.loc_search(jfmi, pats, lens)):
            _eq(a, b)


def test_mms_and_trailing_n(env):
    g, jfmi, tfmi, rng = env
    pats, lens = _patterns(g, rng)
    _eq(tsearch.trailing_n(torch.from_numpy(pats), torch.from_numpy(lens)),
        jsearch.trailing_n(pats, lens))
    for a, b in zip(tsearch.mms(tfmi, pats, lens),
                    jsearch.mms(jfmi, pats, lens)):
        _eq(a, b)


def test_mms_continue(env):
    g, jfmi, tfmi, rng = env
    pats, lens = _patterns(g, rng)
    n1 = len(g) + 1
    sp = rng.integers(0, n1, size=len(lens)).astype(np.int32)
    width = rng.integers(-1, 4, size=len(lens))  # incl. empty intervals
    ep = np.clip(sp + width, 0, n1).astype(np.int32)
    for a, b in zip(tsearch.mms_continue(tfmi, pats, lens, sp, ep),
                    jsearch.mms_continue(jfmi, pats, lens, sp, ep)):
        _eq(a, b)


def test_unc_sa_every_row(env):
    g, jfmi, tfmi, _ = env
    idx = np.arange(len(g) + 1, dtype=np.int32)
    got = tsearch.unc_sa(tfmi, idx)
    _eq(got, jsearch.unc_sa(jfmi, idx))
    # unc_sa inverts the ISA samples: the SA row of position 0 locates to 0
    assert int(tsearch.unc_sa(tfmi, [int(tfmi.endloc)])[0]) == 0
    if len(idx) > 64:
        _eq(tsearch.unc_sa(tfmi, idx[:64], max_steps=3),
            jsearch.unc_sa(jfmi, idx[:64], max_steps=3))


def test_isa_window(env):
    g, jfmi, tfmi, rng = env
    n = len(g)
    B = 64
    plo = rng.integers(-40, n + 40, size=B).astype(np.int32)
    wid = rng.integers(-2, 33, size=B).astype(np.int32)
    plo[:4] = [0, n - 5, n, -3]
    wid[:4] = [32, 32, 1, 10]
    _eq(tsearch.isa_window(tfmi, plo, wid), jsearch.isa_window(jfmi, plo, wid))
    # a window's rows are the ISA of its positions
    rows = tsearch.isa_window(tfmi, [0], [min(32, n + 1)])[0]
    back = tsearch.unc_sa(tfmi, rows[rows >= 0]).numpy()
    assert np.array_equal(back, np.arange(len(back)))


def test_rank_lf_out_of_range(env):
    g, jfmi, tfmi, rng = env
    n = len(g)
    edge = [-(1 << 31), -(10 ** 6), -200, -65, -64, -63, -1, 0, 1, 63, 64,
            n - 1, n, n + 1, n + 2, n + 64, n + 65, n + 200, 10 ** 6,
            (1 << 31) - 1]
    idx = np.concatenate([np.array(edge, np.int64),
                          rng.integers(0, n + 2, size=40)]).astype(np.int32)
    for c in range(6):
        cc = np.full_like(idx, c)
        _eq(trank.rank(tfmi.buckets, tfmi.endloc, cc, idx),
            jrank.rank(jfmi.buckets, jfmi.endloc, cc, idx))
    _eq(trank.lf(tfmi.buckets, tfmi.C, tfmi.endloc, torch.from_numpy(idx)),
        jrank.lf(jfmi.buckets, jfmi.C, jfmi.endloc, idx))
    _eq(trank.ranks_all4(tfmi.buckets, tfmi.endloc, torch.from_numpy(idx)),
        jrank.ranks_all4(jfmi.buckets, jfmi.endloc, idx))
    ok = idx[(idx >= 0) & (idx <= n) & (idx != int(tfmi.endloc))]
    _eq(trank.bwt_char(tfmi.buckets, tfmi.endloc, torch.from_numpy(ok)),
        jrank.bwt_char(jfmi.buckets, jfmi.endloc, ok))
    _eq(tfmi.rank(2, idx), jfmi.rank(2, idx))
