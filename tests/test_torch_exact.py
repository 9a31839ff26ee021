"""The port's exact-search model (models/exact.py) held bit-equal to
bwt_tpu.models.exact on the CPU: anchor_scan on the anchor-loop cases (N
runs, junk reads, first-trip anchors), forward and with reverse=True,
search_reads on uniform and ragged batches with paired reads and on a
uint8 code array, format_ref_output byte for byte, and the port's own
bounds where bwt_tpu's hunt never ends."""

import dataclasses

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu import codec as jcodec
from bwt_tpu.config import DEFAULT as JDEFAULT
from bwt_tpu.models import exact as jexact

import bwt_tpu_torch
from bwt_tpu_torch.config import DEFAULT as TDEFAULT
from bwt_tpu_torch.models import exact as texact

from test_torch_index import to_port

PLANTED = (200, 1500, 3000)  # reads here pair with a reversed copy 300 on


@pytest.fixture(scope="module")
def genome():
    """A 5 kb genome with a plain-reversed copy of each planted 60-mer
    300 bases after it, so that search_reads pairs those reads."""
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    for p in PLANTED:
        codes[p + 300:p + 360] = codes[p:p + 60][::-1]
    jfmi = bwt_tpu.build_index(codes, sa_sample_rate=8)
    return codes, jfmi, to_port(jfmi)


def _anchor_reads(rng, codes):
    """test_models.py's anchor-loop cases: clean and once-mutated 40-mers,
    trailing and inner N runs, all-junk reads, first-trip anchors."""
    reads = []
    for _ in range(15):
        j = int(rng.integers(0, 600 - 40))
        r = list(codes[j:j + 40])
        if rng.random() < 0.5:
            r[int(rng.integers(0, 40))] ^= 3
        reads.append(r)
    for _ in range(9):
        j = int(rng.integers(0, 600 - 40))
        r = list(codes[j:j + 40])
        style = int(rng.integers(0, 3))
        if style == 0:
            for k in range(int(rng.integers(1, 6))):
                r[39 - k] = 5
            r[int(rng.integers(0, 30))] = 5
        elif style == 1:
            r = [int(x) for x in rng.integers(0, 4, 40)]
        reads.append(r)
    return np.array(reads, np.int32)


@pytest.mark.parametrize("seed,min_anchor", [(0, 20), (1, 20), (2, 12)])
def test_anchor_scan_matches_jax(seed, min_anchor):
    rng = np.random.default_rng(seed)
    codes = jcodec.encode_genome(jcodec.random_genome(600, seed=seed))
    jfmi = bwt_tpu.build_index(codes)
    pat = _anchor_reads(rng, codes)
    lens = np.full((len(pat),), 40, np.int32)
    lens[::5] = rng.integers(1, 41, size=len(lens[::5]))  # ragged prefixes
    want = jexact.anchor_scan(jfmi, pat, lens, min_anchor=min_anchor)
    got = texact.anchor_scan(to_port(jfmi), pat, lens, min_anchor=min_anchor)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(want[0]) > 0).any() and (np.asarray(want[0]) == 0).any()


def _host_reverse(pat, lens):
    """bwt_tpu.models.exact.search_reads' flip: pattern[:len] reversed."""
    rev = np.zeros_like(pat)
    for b in range(pat.shape[0]):
        rev[b, :lens[b]] = pat[b, :lens[b]][::-1]
    return rev


@pytest.mark.parametrize("seed,min_anchor", [(0, 20), (1, 20), (2, 12)])
def test_anchor_scan_reverse_matches_jax(seed, min_anchor):
    """reverse=True hunts the plain-reversed read: equal to bwt_tpu's scan
    of the host-reversed patterns, for int32 and one-byte codes."""
    rng = np.random.default_rng(seed)
    codes = jcodec.encode_genome(jcodec.random_genome(600, seed=seed))
    jfmi = bwt_tpu.build_index(codes)
    pat = _host_reverse(_anchor_reads(rng, codes),
                        np.full((24,), 40, np.int32))  # anchors when flipped
    lens = np.full((len(pat),), 40, np.int32)
    lens[::5] = rng.integers(0, 41, size=len(lens[::5]))  # ragged prefixes
    pat = np.where(np.arange(40)[None, :] < lens[:, None], pat, 0)
    want = jexact.anchor_scan(jfmi, _host_reverse(pat, lens), lens,
                              min_anchor=min_anchor)
    tfmi = to_port(jfmi)
    for codes_in in (pat, pat.astype(np.uint8), pat.astype(np.int8)):
        got = texact.anchor_scan(tfmi, codes_in, lens, min_anchor=min_anchor,
                                 reverse=True)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(want[0]) > 0).any() and (np.asarray(want[0]) == 0).any()
    assert np.array_equal(
        texact._plain_reverse(torch.from_numpy(pat),
                              torch.from_numpy(lens)).numpy(),
        _host_reverse(pat, lens))


def test_anchor_scan_min_anchor_zero_matches_jax():
    """min_anchor = 0 ends when every trip consumes something: reads over
    the genome's own symbols, N's included (an all-N anchor takes the
    prefix length below zero)."""
    codes = np.zeros(64, np.uint8)
    jfmi = bwt_tpu.build_index(codes)
    pat = np.array([[0, 0, 0, 0, 0, 0], [0, 5, 0, 5, 5, 0], [5, 5, 5, 5, 5, 5],
                    [0, 0, 5, 5, 0, 0]], np.int32)
    lens = np.array([6, 5, 6, 0], np.int32)
    want = jexact.anchor_scan(jfmi, pat, lens, min_anchor=0)
    got = texact.anchor_scan(to_port(jfmi), pat, lens, min_anchor=0)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_anchor_scan_no_progress_raises():
    """An anchor that consumes nothing repeats forever in bwt_tpu's
    while_loop (min_anchor <= 0 and a last character absent from the
    genome: matched 0, skipped 0); the port raises."""
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device="cpu")
    pat = np.array([[0, 0, 0], [0, 1, 0]], np.int32)
    for reverse in (False, True):
        with pytest.raises(RuntimeError, match="read 1 .* never end"):
            texact.anchor_scan(fmi, pat, [3, 2 + reverse], min_anchor=0,
                               reverse=reverse)
    with pytest.raises(RuntimeError, match="never end"):
        texact.search_reads(fmi, ["AAAC"], min_anchor=-1)


def test_anchor_scan_walk_past_the_sa_raises():
    """An anchor made of trailing N's over an absent last character records
    the row C[c] = n + 1, past the suffix array: the walk's bound raises."""
    fmi = bwt_tpu_torch.build_index(np.zeros(64, np.uint8), device="cpu")
    pat = np.array([[1, 5, 5, 5]], np.int32)
    with pytest.raises(RuntimeError, match="row 65"):
        texact.anchor_scan(fmi, pat, [4], min_anchor=3)


def test_search_reads_uint8_code_array_matches_jax(genome):
    """A 2-D uint8 code array goes down one byte a code (no int32 copy on
    the host) and gives bwt_tpu's result on the same reads."""
    codes, jfmi, tfmi = genome
    rng = np.random.default_rng(21)
    starts = np.concatenate([np.array(PLANTED), rng.integers(0, 4900, 40)])
    reads = codes[np.add.outer(starts, np.arange(60))]
    reads[5, 7] = 5
    reads[6, -3:] = 5
    reads[7] = rng.integers(0, 4, 60)
    assert reads.dtype == np.uint8
    pat, lens = texact._encode_batch(reads, narrow=True)
    assert pat is reads and pat.dtype == np.uint8
    assert texact._encode_batch(reads)[0].dtype == np.int32
    ragged = texact._encode_batch(["ACGT", "AC"], narrow=True)[0]
    assert ragged.dtype == np.uint8
    jcfg = dataclasses.replace(JDEFAULT, search_batch=16)
    tcfg = dataclasses.replace(TDEFAULT, search_batch=16)
    want = jexact.search_reads(jfmi, reads, config=jcfg)
    got = texact.search_reads(tfmi, reads, config=tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["paired"][:len(PLANTED)].all()


def _batch(codes, rng, ragged: bool):
    """Reads as strings: clean reads, the planted (pairing) reads,
    mutated, N-bearing and junk reads; ragged lengths when asked."""
    text = jcodec.decode(codes)
    reads = [text[p:p + 60] for p in PLANTED]
    for k in range(45):
        ln = int(rng.integers(15, 121)) if ragged else 60
        j = int(rng.integers(0, len(text) - ln))
        r = list(text[j:j + ln])
        if k % 3 == 1:
            r[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        if k % 5 == 2:
            r[int(rng.integers(0, ln))] = "N"
            r[-2:] = "NN"
        if k % 9 == 4:
            r = list(jcodec.decode(rng.integers(0, 4, ln)))
        reads.append("".join(r))
    return reads


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_search_reads_matches_jax(genome, ragged):
    codes, jfmi, tfmi = genome
    rng = np.random.default_rng(5 + ragged)
    reads = _batch(codes, rng, ragged)
    jcfg = dataclasses.replace(JDEFAULT, search_batch=16)
    tcfg = dataclasses.replace(TDEFAULT, search_batch=16)
    want = jexact.search_reads(jfmi, reads, config=jcfg)
    got = texact.search_reads(tfmi, reads, config=tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["paired"][:len(PLANTED)].all()
    out = texact.format_ref_output(reads, got)
    assert out == jexact.format_ref_output(reads, want)
    assert out.count("\nRead ") >= len(PLANTED)


def test_search_reads_code_arrays_and_options(genome):
    codes, jfmi, tfmi = genome
    rng = np.random.default_rng(9)
    reads = [codes[p:p + 60] for p in PLANTED]
    reads += [codes[j:j + ln] for j, ln in
              zip(rng.integers(0, 4800, 20), rng.integers(20, 90, 20))]
    kw = dict(min_anchor=15, pair_window=400)
    want = jexact.search_reads(jfmi, reads, **kw)
    got = texact.search_reads(tfmi, reads, **kw)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert (texact.format_ref_output(reads, got)
            == jexact.format_ref_output(reads, want))


@pytest.mark.parametrize("reads", [
    ["ACGT", "AC", "", "GGNNT"],
    ["ACGTA"] * 4,
    [b"ACG", "TTN", np.array([0, 1, 2, 3, 5], np.uint8)],
    [np.array([1, 2], np.int64), np.array([3, 0, 1], np.int64)],
    [],
], ids=["ragged-str", "uniform-str", "mixed", "arrays", "empty"])
def test_encode_batch_matches_jax(reads):
    got = texact._encode_batch(reads)
    want = jexact._encode_batch(reads)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


def test_search_reads_unported_options(genome):
    _, _, tfmi = genome
    cfg = dataclasses.replace(TDEFAULT, elastic_fallback=True)
    with pytest.raises(NotImplementedError):
        texact.search_reads(tfmi, ["ACGT" * 10], config=cfg)
