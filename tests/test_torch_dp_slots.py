"""Part A's counters (chip_smoke.dp_slots, chip_smoke.seed_loads) on inputs
whose counts are known by hand or by a direct count, on the CPU.

dp_slots counts the cell slots, chains, walks and block entries of each
form of the log stitch K11a on one bucket; seed_loads the bucket rows the
seed-table build K5 loads under each schedule."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bwt_tpu_torch
from bwt_tpu_torch.ops import rank as rank_ops
from bwt_tpu_torch.ops import search

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _bucket():
    """Four jobs of a 32 x 32 bucket: the end row is row 0; no matrix (glen
    < 0); a 3 x 3 matrix; the whole 33 x 33 padding."""
    t = lambda xs: torch.tensor(xs, dtype=torch.int64)  # noqa: E731
    return dict(i0=t([0, 3, 2, 32]), jmax=t([5, -1, 2, 32]),
                walk=t([0, 0, 2, 40]), bl=t([0, 1, 3, 41]),
                flip=torch.tensor([True, False, True, False]))


def test_dp_slots_by_hand():
    b = _bucket()
    got = chip_smoke.dp_slots(b["i0"], b["jmax"], b["walk"], b["bl"],
                              b["flip"], 32, 32, runs=40, strip=4,
                              thread_cells=128)
    # cells 1 x 6 + 0 + 3 x 3 + 33 x 33; diagonals 6, 0, 5, 65
    assert got["cells"] == 1104 and got["walk_steps"] == 42
    assert got["warp"]["slots"] == 32 * 2 * 76 and got["warp"]["chain"] == 65
    assert got["warp"]["warps"] == 4
    # the one flipped block of three entries swaps two after reading them
    assert got["warp"]["entries"] == 4 * 42 + 2
    assert got["warp"]["read_back"] == 2
    assert got["warp1"]["slots"] == 32 * 76 and got["warp1"]["read_back"] == 0
    # one warp of threads runs as long as its largest job
    assert got["thread"]["slots"] == 32 * 1089
    assert got["thread"]["chain"] == 1089 and got["thread"]["warps"] == 1
    assert got["thread"]["walk_chain"] == 40
    assert got["thread"]["walk_issued"] == 32 * 40
    # strips: job 2 one strip of 2 + 3 steps, job 3 eight of 32 + 3; slots
    # jmax + 1 border cells and four a step
    assert got["strip"]["chain"] == 280
    assert got["strip"]["slots"] == 32 * (33 + 4 * 280)
    # tiles of 4: job 3 holds 9 stripes of its 33 rows over 65 diagonals
    assert got["tile4"]["slots"] == 32 * 9 * 65
    assert got["tile4"]["chain"] == 65 and got["tile4"]["warps"] == 1
    assert got["tile8"]["slots"] == 32 * 5 * 65
    # the split: job 3 (1,089 cells) in the warp form without row 0, the
    # other three a thread each, one warp of them
    assert got["split"]["big"] == 1 and got["split"]["warps"] == 2
    assert got["split"]["slots"] == 32 * 65 + 32 * (3 + 4 * 5)
    assert got["split"]["chain"] == 65
    for form in ("thread", "strip", "tile4", "split"):
        assert got[form]["entries"] == 4 * 42 and got[form]["read_back"] == 0


def test_dp_slots_sorted_order():
    """Sorting a bucket's jobs by cells puts the large ones in one warp: 33
    jobs, one large one at each end, in a warp of their own once sorted."""
    i0 = torch.full((64,), 1, dtype=torch.int64)
    jmax = torch.full((64,), 1, dtype=torch.int64)
    i0[0] = i0[63] = 20
    jmax[0] = jmax[63] = 20
    z = torch.zeros(64, dtype=torch.int64)
    got = chip_smoke.dp_slots(i0, jmax, z, z, z.bool(), 32, 32)
    assert got["thread"]["slots"] == 2 * 32 * 441  # both warps wait
    assert got["thread_sorted"]["slots"] == 32 * (441 + 4)


def _direct_loads(fmi, k):
    """Per-key loads by running each key's search step by step."""
    C = fmi.C.tolist()
    endloc = int(fmi.endloc)
    total = 0
    for key in range(4 ** k):
        c0 = key & 3
        start, end = C[c0], C[c0 + 1]
        alive = end > start
        for t in range(1, k):
            if not alive:
                break
            ia = start - (start > endloc)
            ib = end - (end > endloc)
            total += 1 if ia >> 6 == ib >> 6 else 2
            c = (key >> (2 * t)) & 3
            ns, ne = search._step(fmi, torch.tensor([c]),
                                  torch.tensor([start], dtype=torch.int32),
                                  torch.tensor([end], dtype=torch.int32))
            start, end = int(ns), int(ne)
            alive = end > start
    return total


@pytest.mark.parametrize("kind", ["rand", "zeros"])
def test_seed_loads_against_a_direct_count(kind):
    n = 700
    g = (np.zeros(n, np.uint8) if kind == "zeros" else
         np.random.default_rng(7).integers(0, 4, n).astype(np.uint8))
    fmi = bwt_tpu_torch.build_index(g, sa_sample_rate=4, device="cpu")
    k = 4
    got = chip_smoke.seed_loads(fmi, k, fused=2)
    assert got["per_key"]["loads"] == _direct_loads(fmi, k)
    # the level order loads each live parent once: the states of levels
    # 0..k-2, which the key-by-key tables of depth 1..k-1 list in full
    level = parents = 0
    for t in range(1, k):
        rows = search._seed_rows_plain(fmi, t)
        alive = rows[:, 5] != 0
        ia = rank_ops._adjust(fmi.endloc, rows[:, 0]) >> 6
        ib = rank_ops._adjust(fmi.endloc, rows[:, 1]) >> 6
        level += int(torch.where(alive, 1 + (ia != ib).long(), 0).sum())
        parents += int(alive.sum())
    assert got["level"]["loads"] == level and got["parents"] == parents
    # the subtree form at fused = 2: prefixes of P = 2 characters key by
    # key (each of the 4 level-0 states for its 4 keys), then the levels
    assert got["prefix"] == 2
    rows1 = search._seed_rows_plain(fmi, 1)
    ia = rank_ops._adjust(fmi.endloc, rows1[:, 0]) >> 6
    ib = rank_ops._adjust(fmi.endloc, rows1[:, 1]) >> 6
    first = int(torch.where(rows1[:, 5] != 0, 1 + (ia != ib).long(), 0).sum())
    assert got["subtree"]["loads"] == level - first + 4 * first
    assert got["per_key"]["written"] == got["subtree"]["written"] == 24 * 4 ** k
    assert got["level"]["written"] == 24 * (4 ** k + 4 + 16 + 64)
    if kind == "zeros":  # only the all-A keys live: one state a level
        assert parents == k - 1
