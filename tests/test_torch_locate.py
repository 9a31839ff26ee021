"""The fused locate's plain version on the CPU.

``search.locate_plain`` (what the locate kernel is held to on the card)
against ``bwt_tpu``'s ``locate``: absent patterns, 1-character reads,
reads the length of the genome, N-bearing reads, genome substrings, and
seeded searches whose reads are shorter than k, on a random genome at
sa_rate 4 and 32 and on an ``np.zeros`` genome; reads ending in a symbol
absent from the genome raise naming the first such read's row, in the
caller's order; on the wide index, the shifted-samples one (positions past
int32) and the shifted-counts one, against ``bwt_tpu``'s x64 run.  The
host counts of ``chip_smoke.py --locate-times`` (``locate_counts``) and
its presorted order (``locate_order``) are pinned on hand-made inputs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.ops import search as jsearch

import bwt_tpu_torch
from bwt_tpu_torch.ops import search as tsearch

from test_torch_index import to_port
from test_torch_wide import SEED_K as WIDE_K
from test_torch_wide import port, want  # noqa: F401  (fixtures)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

GENOMES = {"rand-r4": ("rand", 3000, 4), "rand-r32": ("rand", 3000, 32),
           "zeros-r8": ("zeros", 500, 8)}
KINDS = ("substrings", "absent", "one-char", "whole-genome", "n-bearing",
         "shorter-than-k")


@pytest.fixture(scope="module")
def indexes():
    out = {}
    for name, (kind, n, rate) in GENOMES.items():
        g = (np.zeros(n, np.uint8) if kind == "zeros" else
             np.random.default_rng(n + rate).integers(0, 4, n).astype(np.uint8))
        jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
        out[name] = g, jfmi, to_port(jfmi)
    return out


def _reads(kind, g, rng, B=40, L=40):
    """(pats, lens, k) of one kind: k the seed table's (0: unseeded)."""
    n = len(g)
    if kind == "whole-genome":
        return g[None, :].astype(np.int32).repeat(3, 0), np.array(
            [n, n - 1, n // 2], np.int32), 0
    pats = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        ln = {"one-char": 1, "shorter-than-k": int(rng.integers(0, 8))}.get(
            kind, int(rng.integers(2, L + 1)))
        s = int(rng.integers(0, n - ln + 1))
        if kind == "absent":  # half end in a symbol of the genome
            pats[b, :ln] = rng.integers(0, 4, ln)
            if b % 2:
                pats[b, ln - 1] = g[s + ln - 1]
        else:
            pats[b, :ln] = g[s:s + ln]
        if kind == "n-bearing":
            pats[b, rng.integers(0, ln, size=1 + ln // 8)] = 5
        lens[b] = ln
    return pats, lens, 8 if kind == "shorter-than-k" else 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", GENOMES)
def test_locate_plain_matches_bwt_tpu(indexes, name, kind):
    """locate_plain equals bwt_tpu's locate on the reads whose walk starts
    on a real row; where some walks start past the suffix array, it
    raises naming the first such read's row."""
    g, jfmi, tfmi = indexes[name]
    rng = np.random.default_rng(len(kind) * 100 + len(g))
    pats, lens, k = _reads(kind, g, rng)
    jt = jsearch.build_seed_table(jfmi, k=k) if k else None
    tt = tsearch.build_seed_table(tfmi, k=k) if k else None
    start = np.asarray(jsearch.loc_search(jfmi, pats, lens, seed_table=jt)[0])
    real = (start >= 0) & (start <= len(g))
    if not real.all():  # the others' walks start past the suffix array
        r = tsearch.backward_search_plain(tfmi, pats, lens, seed_table=tt)
        pos, over = tsearch.unc_sa_flagged(tfmi, r["start"])
        first = int(over.nonzero()[0, 0])
        with pytest.raises(RuntimeError, match=f"row {int(pos[first])} "):
            tsearch.locate_plain(tfmi, pats, lens, seed_table=tt)
    if not real.any():
        assert (name, kind) == ("zeros-r8", "absent")
        return
    pats, lens = pats[real], lens[real]
    want = np.asarray(jsearch.locate(jfmi, pats, lens, seed_table=jt))
    got = tsearch.locate_plain(tfmi, pats, lens, seed_table=tt)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
def test_overrun_names_the_first_read_in_the_callers_order(seeded):
    """Reads ending in C on an all-A genome start past the suffix array:
    the plain version raises naming the first such read's row (read 7,
    whose walk is the longest of the three), and every other read equals
    bwt_tpu's locate."""
    g = np.zeros(64, np.uint8)
    jfmi = bwt_tpu.build_index(g)
    fmi = bwt_tpu_torch.build_index(g, device="cpu")
    B = 40
    pats = np.zeros((B, 6), np.int32)
    lens = np.full(B, 6, np.int32)
    lens[::3] = np.arange(1, 7).repeat(3)[:len(lens[::3])]
    # read 7 searches five A's before its C empties the interval, read 11
    # is a lone C, read 30 ends in C two characters in
    over = [7, 11, 30]
    pats[7], lens[7] = [1, 0, 0, 0, 0, 0], 6
    pats[11], lens[11] = [1, 0, 0, 0, 0, 0], 1
    pats[30], lens[30] = [0, 0, 1, 0, 0, 0], 3
    table = tsearch.build_seed_table(fmi, k=3) if seeded else None
    r = tsearch.backward_search_plain(fmi, pats, lens, seed_table=table)
    _, flagged = tsearch.unc_sa_flagged(fmi, r["start"])
    assert flagged.nonzero().flatten().tolist() == over
    row = int(r["start"][over[0]])
    with pytest.raises(RuntimeError, match=f"row {row} "):
        tsearch.locate_plain(fmi, pats, lens, seed_table=table)
    ok = np.setdiff1d(np.arange(B), over)
    jt = jsearch.build_seed_table(jfmi, k=3) if seeded else None
    want = np.asarray(jsearch.locate(jfmi, pats[ok], lens[ok], seed_table=jt))
    assert np.array_equal(tsearch.locate_plain(
        fmi, pats[ok], lens[ok], seed_table=table).numpy(), want)


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
@pytest.mark.parametrize("index", ["wide", "shifted", "counts"])
def test_wide_locate_matches_bwt_tpu(port, want, index, seeded):  # noqa: F811
    """locate_plain on the wide index, the shifted-samples one (positions
    past int32) and the shifted-counts one equals bwt_tpu's x64 locate."""
    fmi = port[index]
    st = tsearch.build_seed_table(fmi, k=WIDE_K) if seeded else None
    got = tsearch.locate_plain(fmi, torch.from_numpy(want["pats"]),
                               torch.from_numpy(want["lens"]), seed_table=st)
    key = f"{index}/locate{'_seeded' if seeded else ''}/out"
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want[key])
    if index == "shifted" and not seeded:
        assert (got > np.iinfo(np.int32).max).any()


def test_counts_by_hand():
    """Two reads: read 0 steps on rows 0 and 8 and walks one step on row
    16; read 1 steps on rows 0 and 9 and is sampled at once.  A warp of
    the two in lockstep touches 4 rows in 3 lines (8 and 9 share one) and
    asks 6 L1 requests (two a line a step) in 3 rounds (the longest search
    and the longest walk), 5 of its 64 lane-rounds stepping."""
    tr = dict(rs=torch.tensor([[0, 8], [0, 9]]),
              re=torch.zeros((2, 2), dtype=torch.int64),
              ms=torch.ones((2, 2), dtype=torch.bool),
              me=torch.zeros((2, 2), dtype=torch.bool),
              wr=torch.tensor([[16], [0]]), wm=torch.tensor([[True], [False]]),
              over=torch.tensor([False, False]),
              emptied=torch.tensor([False, False]))
    tr["search"] = tr["ms"].sum(1)
    tr["walk"] = tr["wm"].sum(1)
    c = chip_smoke.locate_counts(tr)
    assert (c["row_fetches"], c["walk_steps"], c["walk_longest"],
            c["samples"]) == (5, 1, 1, 2)
    assert {k: c[k] for k in ("sectors", "lines", "requests", "rounds")} == \
        dict(sectors=4, lines=3, requests=6, rounds=3)
    assert c["utilization"] == 5 / (32 * 3)
    assert chip_smoke.locate_counts(tr, [1, 0])["sectors"] == 4


def test_order_matches_lexsort():
    """The order by reversed codes is np.lexsort of the reads read from
    their last character, shorter reads before longer ones that end with
    them; the inverse puts each read back."""
    rng = np.random.default_rng(9)
    pats = rng.integers(0, 4, (300, 12)).astype(np.int32)
    pats[100:150] = pats[:50]  # ties keep the reads' order
    lens = np.full(300, 12, np.int32)
    order, inverse = chip_smoke.locate_order(pats, lens)
    assert np.array_equal(order, np.lexsort(pats.T))
    assert np.array_equal(order[inverse], np.arange(300))
    lens = rng.integers(0, 13, 300).astype(np.int32)
    order, inverse = chip_smoke.locate_order(pats, lens)
    key = [tuple(pats[b, :lens[b]][::-1]) for b in range(300)]
    assert np.array_equal(order, sorted(range(300), key=lambda b: key[b]))
    assert np.array_equal(inverse[order], np.arange(300))
