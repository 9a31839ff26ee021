"""The PyTorch port's rank/LF and FM-index queries held bit-equal against
bwt_tpu on the same index (CPU), with the verify-skill probes: absent
patterns, N-bearing reads, 1-character reads, reads the length of the
genome, a repetitive genome, and out-of-range rank indices; the seed
tables on test_seed.py's cases; and the port's own bound on the unc_sa
walk, where bwt_tpu walks forever."""

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.ops import rank as jrank
from bwt_tpu.ops import search as jsearch

import bwt_tpu_torch
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
    want = jsearch.isa_window(jfmi, plo, wid)
    _eq(tsearch.isa_window_plain(tfmi, plo, wid), want)
    launches = tsearch.ISA_LAUNCHES
    _eq(tsearch.isa_window(tfmi, plo, wid), want)  # a CPU index: the plain one
    assert tsearch.ISA_LAUNCHES == launches
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


# --------------------------------------------------------------------------
# seed tables (tests/test_seed.py's cases) and the unc_sa step bound
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [4, 8])
def test_seed_rows(env, k):
    _, jfmi, tfmi, _ = env
    want = jsearch._seed_rows(jfmi, k)
    _eq(tsearch._seed_rows_plain(tfmi, k), want)
    launches = tsearch.SEED_LAUNCHES
    _eq(tsearch.build_seed_table(tfmi, k=k).rows, want)
    assert tsearch.SEED_LAUNCHES == launches  # a CPU index launches nothing


_SEED_GENOMES = {}


def _seed_genome(kind, rate):
    """A bwt_tpu index and its port, once a module: a random genome of 4,096
    bases (64 whole buckets), an all-A genome (most keys die at their first
    step) and a random genome of 3,001 bases (not a multiple of 64)."""
    if (kind, rate) not in _SEED_GENOMES:
        n = {"rand": 4096, "zeros": 512, "odd": 3001}[kind]
        g = (np.zeros(n, np.uint8) if kind == "zeros" else
             np.random.default_rng(n).integers(0, 4, n).astype(np.uint8))
        jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
        _SEED_GENOMES[kind, rate] = (jfmi, to_port(jfmi))
    return _SEED_GENOMES[kind, rate]


@pytest.mark.parametrize("rate", [1, 4])
@pytest.mark.parametrize("kind", ["rand", "zeros", "odd"])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_seed_rows_level_order(kind, rate, k):
    """The plain build on K5's schedule (the first seed_prefix(k) characters
    key by key, then the last levels in place, a parent's four children
    from its two rows) against bwt_tpu's key-by-key fori_loop."""
    jfmi, tfmi = _seed_genome(kind, rate)
    assert tsearch.seed_prefix(k) == max(k - tsearch.SEED_FUSED, 1)
    _eq(tsearch._seed_rows_plain(tfmi, k), jsearch._seed_rows(jfmi, k))


def _seed_case(rng, codes, B=200, L=24, k=4):
    """test_seed.py's reads: lengths k..L, 70 % from the genome, 30 % with
    one substitution."""
    pats = np.zeros((B, L), np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        plen = int(rng.integers(k, L + 1))
        if rng.random() < 0.7:
            j = int(rng.integers(0, len(codes) - plen))
            p = list(codes[j:j + plen])
        else:
            p = list(rng.integers(0, 4, size=plen))
        if rng.random() < 0.3:
            p[int(rng.integers(0, plen))] ^= 3
        pats[b, :plen] = p
        lens[b] = plen
    return pats, lens


@pytest.fixture(scope="module")
def seed_env():
    rng = np.random.default_rng(1200)
    codes = rng.integers(0, 4, 1200).astype(np.uint8)
    jfmi = bwt_tpu.build_index(codes)
    return codes, jfmi, to_port(jfmi), rng


@pytest.mark.parametrize("k", [4, 8])
def test_seeded_search_family(seed_env, k):
    codes, jfmi, tfmi, rng = seed_env
    pats, lens = _seed_case(rng, codes, k=k)
    jt = jsearch.build_seed_table(jfmi, k=k)
    tt = tsearch.build_seed_table(tfmi, k=k)
    _eq(tt.rows, jt.rows)
    want = jsearch.backward_search_seeded(jfmi, jt, pats, lens)
    got = tsearch.backward_search_seeded(tfmi, tt, pats, lens)
    plain = tsearch.backward_search(tfmi, pats, lens)
    for key in want:
        _eq(got[key], want[key])
    for key in ("start", "end", "sp", "ep", "nmatched", "alive"):
        assert torch.equal(got[key], plain[key]), key
    for fn in ("locate", "reverse_search", "count_matches"):
        _eq(getattr(tsearch, fn)(tfmi, pats, lens, seed_table=tt),
            getattr(jsearch, fn)(jfmi, pats, lens, seed_table=jt))
        _eq(getattr(tsearch, fn)(tfmi, pats, lens, seed_table=tt),
            getattr(tsearch, fn)(tfmi, pats, lens))
    for a, b in zip(tsearch.loc_search(tfmi, pats, lens, seed_table=tt),
                    jsearch.loc_search(jfmi, pats, lens, seed_table=jt)):
        _eq(a, b)


def test_seeded_exact_k_lengths(seed_env):
    codes, jfmi, tfmi, rng = seed_env
    pats = np.stack([codes[j:j + 6] for j in rng.integers(0, 1194, 64)]
                    ).astype(np.int32)
    lens = np.full((64,), 6, np.int32)
    want = jsearch.backward_search_seeded(
        jfmi, jsearch.build_seed_table(jfmi, k=6), pats, lens)
    got = tsearch.backward_search_seeded(
        tfmi, tsearch.build_seed_table(tfmi, k=6), pats, lens)
    for key in want:
        _eq(got[key], want[key])


def test_seed_key_out_of_table(seed_env):
    """Reads that break the seed contract (N codes in the last k, shorter
    than k) read the table like jnp.take, in both packages."""
    codes, jfmi, tfmi, rng = seed_env
    pats, lens = _seed_case(rng, codes, B=40, k=4)
    pats[::3, 2] = 5
    lens[1::4] = rng.integers(0, 4, size=len(lens[1::4]))
    _eq(tsearch._seed_key(torch.from_numpy(pats), torch.from_numpy(lens), 4),
        jsearch._seed_key(pats, lens, 4))
    want = jsearch.backward_search_seeded(
        jfmi, jsearch.build_seed_table(jfmi, k=4), pats, lens)
    got = tsearch.backward_search_seeded(
        tfmi, tsearch.build_seed_table(tfmi, k=4), pats, lens)
    for key in want:
        _eq(got[key], want[key])


def test_unc_sa_bound_raises():
    """A row past the SA (C on an all-A genome starts at row n+1) walks
    forever in bwt_tpu; the port raises after length + 1 steps."""
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device="cpu")
    with pytest.raises(RuntimeError, match="row 65 .* length \\+ 1 = 65"):
        tsearch.locate(fmi, np.array([[1]], np.int32),
                       np.array([1], np.int32))
    with pytest.raises(RuntimeError, match="row 65"):
        tsearch.unc_sa_plain(fmi, [0, 65, 3])
    # a cap below the bound returns the partial walk, as before
    assert tsearch.unc_sa(fmi, [65], max_steps=10).shape == (1,)
    # real rows are unaffected
    assert sorted(tsearch.unc_sa(fmi, list(range(65))).tolist()) == list(
        range(65))


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
def test_locate_plain_matches_jax(env, seeded):
    """locate_plain (the plain version of the locate kernel), unseeded and
    with a k = 4 seed table, on absent patterns, N-bearing, 1-char and
    whole-genome-length reads, over the lanes whose walk starts on a real
    row; locate on a CPU index is that plain version."""
    g, jfmi, tfmi, rng = env
    pats, lens = _patterns(g, rng)
    if seeded:
        # the table's contract: length >= k (bwt_tpu reads it like jnp.take
        # outside that, which test_seed_key_out_of_table covers)
        keep = lens >= 4
        pats, lens = pats[keep], lens[keep]
    jt = jsearch.build_seed_table(jfmi, k=4) if seeded else None
    tt = tsearch.build_seed_table(tfmi, k=4) if seeded else None
    start = np.asarray(jsearch.loc_search(jfmi, pats, lens, seed_table=jt)[0])
    real = (start >= 0) & (start <= len(g))
    assert real.sum() >= len(real) // 2
    want = jsearch.locate(jfmi, pats[real], lens[real], seed_table=jt)
    got = tsearch.locate_plain(tfmi, pats[real], lens[real], seed_table=tt)
    _eq(got, want)
    assert (np.asarray(want) == -1).any() or len(g) < 100
    launches = tsearch.LOCATE_LAUNCHES
    _eq(tsearch.locate(tfmi, pats[real], lens[real], seed_table=tt), want)
    assert tsearch.LOCATE_LAUNCHES == launches


def test_wrappers_dispatch_by_device(env):
    """A CPU index runs the plain versions and launches nothing; another
    device type raises instead of falling back."""
    g, _, tfmi, rng = env
    pats, lens = _patterns(g, rng)
    pats = np.where(pats == 5, 0, pats)
    bs, unc = tsearch.BS_LAUNCHES, tsearch.UNC_LAUNCHES
    got = tsearch.backward_search(tfmi, pats, lens, resolve_n=True)
    want = tsearch.backward_search_plain(tfmi, pats, lens, resolve_n=True)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    tsearch.unc_sa(tfmi, [0, 1, 2])
    assert (tsearch.BS_LAUNCHES, tsearch.UNC_LAUNCHES) == (bs, unc)
    meta = tfmi.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.backward_search(meta, pats, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.unc_sa(meta, [1])
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.locate(meta, pats, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.isa_window(meta, [0], [4])
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.build_seed_table(meta, k=2)
