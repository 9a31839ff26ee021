"""The port's bucketed suffix sort (``ops/suffix.py``) against ``bwt_tpu``'s
suffix array and a brute-force sort of every suffix (CPU).

Lowering ``suffix.BUCKET`` forces the multi-bucket path that a genome
past one bucket takes on the card: round 0 split by ranges of the first
key (a counting sort by range, a bucket of positions at a time), later
rounds by slices of tied groups, groups larger than a bucket sorted whole;
it splits the key histogram and the BWT's scatter too.  ``suffix.LAST_SORT`` is read for the rounds
and buckets each sort made."""

import functools

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.ops import suffix as jsuffix

import bwt_tpu_torch
from bwt_tpu_torch.ops import suffix as tsuffix


def _genome(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "all-A":
        return np.zeros(n, np.uint8)
    if kind == "acgt":
        return np.tile(np.arange(4, dtype=np.uint8), n // 4 + 1)[:n]
    g = rng.integers(0, 4, n).astype(np.uint8)
    if kind == "repeats":  # a 300-base segment planted five times, and a
        # 40-base one back to back eight times
        seg = g[:300].copy()
        for at in (700, 1200, 2000, 2900, 3700):
            g[at:at + 300] = seg
        g[400:720] = np.tile(g[100:140], 8)
    return g


# (kind, length, whether a forced small bucket splits some round)
GENOMES = {
    "uniform-3001": ("uniform", 3001, True),
    "uniform-4097": ("uniform", 4097, True),
    "all-A-777": ("all-A", 777, False),
    "acgt-1024": ("acgt", 1024, True),
    "repeats-4097": ("repeats", 4097, True),
    "len-1": ("uniform", 1, False),
    "len-12": ("uniform", 12, False),
    "len-13": ("uniform", 13, False),
}


@functools.cache
def _want(name: str):
    """(bwt_tpu's SA, the brute-force SA, the unforced sort's record)."""
    kind, n, _ = GENOMES[name]
    g = _genome(kind, n)
    text = bytes((g + 1).tolist())  # a shorter suffix sorts first: the
    # sentinel is the smallest character
    brute = np.array(sorted(range(n + 1), key=lambda i: text[i:]), np.int64)
    jsa = np.asarray(jsuffix.suffix_array(g)).astype(np.int64)
    tsuffix.suffix_array_with_isa(torch.from_numpy(g))
    return jsa, brute, tsuffix.LAST_SORT


@pytest.mark.parametrize("form", ["packed", "two-key"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("bucket", [None, 512, 24],
                         ids=["one-bucket", "bucket-512", "bucket-24"])
@pytest.mark.parametrize("name", list(GENOMES))
def test_bucketed_suffix_array_matches_bwt_tpu(monkeypatch, name, bucket,
                                               dtype, form):
    """SA and ISA equal bwt_tpu's SA and a brute-force sort, whatever the
    bucket size, rank dtype and key packing; the rounds and what each left
    unresolved do not depend on the bucket, and a bucket splits a round
    only when forced."""
    kind, n, splits = GENOMES[name]
    jsa, brute, unforced = _want(name)
    assert np.array_equal(jsa, brute)
    if bucket is not None:
        monkeypatch.setattr(tsuffix, "BUCKET", bucket)
    if form == "two-key":
        monkeypatch.setattr(tsuffix, "PACKED_KEY_MAX", 0)
    codes = torch.from_numpy(_genome(kind, n))
    sa, isa = tsuffix.suffix_array_with_isa(codes, dtype=dtype)
    assert sa.dtype == isa.dtype == dtype
    assert np.array_equal(sa.numpy(), brute)
    assert torch.equal(isa[sa.long()], torch.arange(n + 1, dtype=dtype))
    rec = tsuffix.LAST_SORT
    assert rec.unresolved == unforced.unresolved and rec.unresolved[-1] == 0
    assert rec.rounds == len(unforced.buckets) >= 1
    if bucket is None:
        assert max(rec.buckets) == 1  # one sort a round
    elif splits:
        assert max(rec.buckets) > 1


@pytest.mark.parametrize("name", ["uniform-4097", "repeats-4097", "acgt-1024"])
def test_chunked_build_matches_bwt_tpu(monkeypatch, name):
    """The whole build with small buckets (the sort, the histogram, the
    BWT's scatter) equals bwt_tpu's index, int64 codes given to the
    sort as well as uint8."""
    kind, n, _ = GENOMES[name]
    g = _genome(kind, n)
    want = bwt_tpu.build_index(g, sa_sample_rate=4)
    monkeypatch.setattr(tsuffix, "BUCKET", 300)
    got = bwt_tpu_torch.build_index(g, sa_sample_rate=4, verify=True,
                                    device="cpu").to_numpy()
    for f in ("bwt_words", "buckets", "sa_samples", "C", "endloc",
              "isa_samples"):
        assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
    assert max(tsuffix.LAST_SORT.buckets) > 1
    sa, _ = tsuffix.suffix_array_with_isa(
        torch.from_numpy(g).to(torch.int64))
    assert np.array_equal(sa.numpy(),
                          np.asarray(jsuffix.suffix_array(g)))
