"""The inverse-SA window (K6) on the CPU: the port's plain version
``isa_window_plain`` held bit-equal to ``bwt_tpu.ops.search.isa_window``
at sample rates 4 and 32, on a genome whose length is a multiple of the
rate and on one whose length is not (the tail row 0 at ``length``), with
widths past W (bwt_tpu's cap of rate - 1 + W steps leaves the columns
below its line at -1), plo and width at the int32 edges, and W = 8, 30,
32 and 64 (chip_smoke.isa_windows); and the tile kernel's schedule (chip_smoke.isa_plan: each
window's emitted columns cut into ISA sample segments, each chained from
its own anchor) replayed with the plain index's samples and LF steps,
equal to the plain version, and counted by hand on small windows."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bwt_tpu
from bwt_tpu.ops import search as jsearch

from bwt_tpu_torch.ops import search as tsearch

from test_torch_index import to_port

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from chip_smoke import I32_MAX  # noqa: E402


@pytest.fixture(scope="module", params=[(2048, 4), (2001, 4), (2048, 32),
                                        (2001, 32)],
                ids=["n2048-r4", "n2001-r4", "n2048-r32", "n2001-r32"])
def env(request):
    n, rate = request.param
    rng = np.random.default_rng(n * rate)
    g = rng.integers(0, 4, n).astype(np.uint8)
    jfmi = bwt_tpu.build_index(g, sa_sample_rate=rate)
    return jfmi, to_port(jfmi), rng


def _rows_of_plan(tfmi, plo, width, W, tile, chunk):
    """The rows the tile kernel computes, from its schedule: each segment
    from its own anchor (the sample, or row 0 at the tail), one LF step a
    position down to its floor, the rows of [floor, top] kept."""
    n, rate = tfmi.length, tfmi.sa_rate
    plan = chip_smoke.isa_plan(n, rate, plo, width, W=W, tile=tile,
                               chunk=chunk)
    out = torch.full((len(plo), W), -1, dtype=torch.int32)
    lanes = torch.arange(len(plo))
    plo64 = torch.from_numpy(plo.astype(np.int64))
    nisa = tfmi.isa_samples.shape[0]
    for s in plan["segs"]:
        live = torch.from_numpy(s["live"])
        a = torch.from_numpy(np.where(s["live"], s["anchor"], 0))
        bot, top = torch.from_numpy(s["bot"]), torch.from_numpy(s["top"])
        assert bool((a - bot < rate)[live].all())  # a chain of <= rate loads
        row = tfmi.sample_at(tfmi.isa_samples,
                             (a >> (rate.bit_length() - 1)).clamp(0, nisa - 1))
        if n % rate:
            row = torch.where(a == n, 0, row)
        for t in range(rate):
            p = a - t
            emit = live & (p >= bot) & (p <= top)
            out[lanes[emit], (p - plo64)[emit]] = row[emit].int()
            row = torch.where(p > bot, tfmi.lf(row), row)
    return out, plan


@pytest.mark.parametrize("kind", chip_smoke.ISA_KINDS)
def test_isa_window_plain_matches_bwt_tpu(env, kind):
    jfmi, tfmi, rng = env
    n, rate = tfmi.length, tfmi.sa_rate
    plo, wid, W = chip_smoke.isa_windows(kind, n, rng)
    want = np.asarray(jsearch.isa_window(jfmi, plo, wid, W=W))
    got = tsearch.isa_window_plain(tfmi, plo, wid, W=W)
    assert got.shape == (len(plo), W)
    assert np.array_equal(got.numpy(), want)
    for tile, chunk in ((1, None), (tsearch.isa_tile(rate, W), None),
                        (4, 8 if W > 8 else None)):
        rows, plan = _rows_of_plan(tfmi, plo, wid, W, tile, chunk)
        assert torch.equal(rows, got), (tile, chunk)
    if kind == "random":
        assert (got >= 0).any() and (got == -1).any()
    if kind == "int32-edges":  # only plo in 1 - W..n with a width >= 1 emits
        emits = (got >= 0).any(1).numpy()
        assert not emits[(plo < 1 - W) | (plo > n) | (wid <= 0)].any()
        assert emits[(plo == 0) & (wid >= 1) & (wid <= W)].all()
        # a width near 2^31 at plo 0: the cap's line lies past column W
        assert not emits[(plo == 0) & (wid > 1 << 30)].any()
    if kind == "past-W":
        # the columns of [max(plo, 0), plo + width - 1] inside the genome
        # and the row are -1 exactly below the cap's line
        p_hi = np.minimum(plo.astype(np.int64) + wid - 1, n)
        anchor = np.clip((p_hi + rate - 1) // rate * rate, 0, n)
        line = anchor - (rate - 2 + W)
        j = np.arange(W)[None, :]
        p = plo[:, None].astype(np.int64) + j
        inside = (p >= 0) & (p <= p_hi[:, None])
        assert np.array_equal((got.numpy() == -1)[inside],
                              (p < line[:, None])[inside])
        # the issue's example: plo 0, width 40
        cap = {4: 6, 32: 2}[rate]
        assert (got[0, :cap] == -1).all() and (got[0, cap:] >= 0).all()
        assert (got.numpy() == -1)[inside].any()


def test_isa_plan_by_hand():
    """Windows whose segments and chains are counted by hand."""
    n = 100
    # rate 4, [10, 17]: segments 5 (17..20), 4 (13..16), 3 (9..12); the
    # first form chains 20 down to 10 (11 loads)
    plan = chip_smoke.isa_plan(n, 4, [10], [8], W=32, tile=4)
    segs = [(int(s["m"][0]), int(s["anchor"][0]), int(s["bot"][0]),
             int(s["top"][0])) for s in plan["segs"]]
    assert segs == [(5, 20, 17, 17), (4, 16, 13, 16), (3, 12, 10, 12)]
    got = chip_smoke.isa_counts(plan)
    assert got["old"] == dict(steps=10, loads=11, longest=11)
    assert got["new"] == dict(steps=8, loads=11, longest=4)
    assert got["segments"] == 3 and got["windows"] == 1
    assert chip_smoke.isa_counts(chip_smoke.isa_plan(
        n, 4, [10], [8], tile=2))["new"]["longest"] == 7  # 5 and 3
    assert chip_smoke.isa_counts(chip_smoke.isa_plan(
        n, 4, [10], [8], tile=1))["new"]["longest"] == 11
    # rate 32, plo 0, width 40 past W = 32: the cap (63 loads from 64)
    # leaves columns 0 and 1; one segment, 32 down to 2
    plan = chip_smoke.isa_plan(n, 32, [0], [40], W=32, tile=2)
    assert (int(plan["jlo"][0]), int(plan["jhi"][0])) == (2, 31)
    got = chip_smoke.isa_counts(plan)
    assert got["old"] == dict(steps=62, loads=63, longest=63)
    assert got["new"] == dict(steps=30, loads=31, longest=31)
    # rate 4, length 37 (not a multiple): [30, 37]; the tail segment is
    # position 37 alone, anchored at row 0
    plan = chip_smoke.isa_plan(37, 4, [30], [32], W=32, tile=4)
    segs = [(int(s["m"][0]), int(s["anchor"][0]), int(s["bot"][0]),
             int(s["top"][0])) for s in plan["segs"]]
    assert segs == [(10, 37, 37, 37), (9, 36, 33, 36), (8, 32, 30, 32)]
    got = chip_smoke.isa_counts(plan)
    assert got["old"]["loads"] == 8 and got["new"]["longest"] == 4
    assert got["new"] == dict(steps=5, loads=8, longest=4)
    # position 0 is a segment of its own; empty windows have none
    plan = chip_smoke.isa_plan(n, 4, [0, 5, 200, I32_MAX, -40],
                               [3, 0, 4, I32_MAX, 8], W=32, tile=4)
    got = chip_smoke.isa_counts(plan)
    assert got["windows"] == 1 and got["segments"] == 2
    assert got["new"] == dict(steps=3, loads=5, longest=4)
    # the first form loads the sample at 0 for [-40, -33] too
    assert list(plan["old_loads"]) == [5, 0, 0, 0, 1]
    assert got["old"]["steps"] == chip_smoke._window_steps(
        SimpleNamespace(length=n, sa_rate=4),
        torch.tensor([0, 5, 200, I32_MAX, -40], dtype=torch.int32),
        torch.tensor([3, 0, 4, I32_MAX, 8], dtype=torch.int32)) == 4


def test_isa_tile():
    """The tile: the most segments W positions touch (3, 9, 17 at rate 4
    and W = 8, 32, 64; 2, 3 at rate 32 and W = 32, 64, as isa_plan counts
    them over every alignment), rounded down to a power of two, at most
    32."""
    for rate, W, most in ((4, 8, 3), (4, 32, 9), (4, 64, 17), (32, 32, 2),
                          (32, 64, 3)):
        plo = np.arange(-W, 200)
        got = chip_smoke.isa_counts(chip_smoke.isa_plan(
            1000, rate, plo, np.full(len(plo), W), W=W))
        assert got["max_segments"] == most
    assert [tsearch.isa_tile(4, W) for W in (1, 8, 32, 64, 128)] == [1, 2, 8,
                                                                     16, 32]
    assert [tsearch.isa_tile(32, W) for W in (8, 32, 64)] == [2, 2, 2]
