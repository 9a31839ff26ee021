"""The plain reference against a brute-force scan of every suffix."""

import random

import pytest
import torch

from reference import fm_plain


def brute_answers(genome, patterns):
    """Sorts every suffix of genome + '$' as a tuple (codes + 1, '$' = 0)
    and answers each pattern by the reference's rule."""
    text = [c + 1 for c in genome] + [0]
    n = len(genome)
    order = sorted(range(n + 1), key=lambda i: text[i:])
    as_str = "".join("ACGT"[c] for c in genome)
    out = []
    for p in patterns:
        tail = "".join("ACGT"[c] for c in p[1:])
        if len(p) >= 2 and tail not in as_str:
            out.append(-1)
            continue
        want = [c + 1 for c in p]
        below = sum(1 for i in order if text[i:i + len(p)] < want)
        out.append(order[below] if below <= n else fm_plain.PAST_END)
    return order, out


def tiny_case(seed, n, repeat):
    rnd = random.Random(seed)
    genome = [rnd.randrange(4) for _ in range(n)]
    if repeat:  # a planted repeat family, so first-match order matters
        unit = genome[:23]
        for at in range(40, n - 30, 61):
            genome[at:at + 23] = unit
    pats = []
    for _ in range(160):
        m = rnd.choice([2, 5, 12, 30])
        kind = rnd.randrange(4)
        if kind == 0:  # random: usually absent
            p = [rnd.randrange(4) for _ in range(m)]
        else:  # a substring, sometimes with one base changed
            at = rnd.randrange(n - m + 1)
            p = genome[at:at + m]
            if kind == 2:
                j = rnd.randrange(m)
                p[j] = (p[j] + rnd.randrange(1, 4)) % 4
        pats.append(p)
    pats.append([3] * 12)  # likely past every suffix
    return genome, pats


@pytest.mark.parametrize("seed,n,repeat", [(1, 300, False), (2, 257, True),
                                           (3, 64, False), (4, 500, True)])
def test_reference_matches_brute_force(seed, n, repeat):
    genome, pats = tiny_case(seed, n, repeat)
    order, want = brute_answers(genome, pats)
    codes = torch.tensor(genome, dtype=torch.uint8)
    t = fm_plain.tables(codes)
    assert t.sa.tolist() == order
    L = max(len(p) for p in pats)
    P = torch.zeros(len(pats), L, dtype=torch.int32)
    for i, p in enumerate(pats):
        P[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in pats], dtype=torch.int32)
    got = fm_plain.first_match(t, P, lens)
    assert got.tolist() == want


def test_suffix_array_needs_doubling():
    # a run longer than PACK forces doubling rounds
    genome = [0] * 100 + [1, 2, 3] * 20 + [0] * 70
    order, _ = brute_answers(genome, [])
    assert fm_plain.suffix_array(torch.tensor(genome)).tolist() == order


def test_search_steps_and_walks():
    rnd = random.Random(7)
    genome = [rnd.randrange(4) for _ in range(400)]
    t = fm_plain.tables(torch.tensor(genome, dtype=torch.uint8))
    text = "".join("ACGT"[c] for c in genome)
    pats = [genome[10:40], genome[100:130], [3, 3, 0, 1, 2, 2] * 5]
    P = torch.tensor(pats, dtype=torch.int32)
    lens = torch.tensor([len(p) for p in pats])
    _, steps = fm_plain.first_match(t, P, lens, with_steps=True)
    for p, s in zip(pats, steps.tolist()):
        # the longest suffix of p that occurs, j: j steps, or m - 1 if whole
        m = len(p)
        j = max(k for k in range(m + 1)
                if "".join("ACGT"[c] for c in p[m - k:]) in text)
        assert s == (m - 1 if j == m else j)
    # walk lengths by stepping position by position through the ranks
    rate = 8
    isa = torch.empty_like(t.sa)
    isa[t.sa] = torch.arange(t.sa.numel())
    pos = torch.arange(len(genome) + 1)
    got = fm_plain.walk_steps(t, pos, rate)
    for p in range(len(genome) + 1):
        k, q = 0, p
        while int(isa[q]) % rate:
            q = q - 1 if q > 0 else len(genome)
            k += 1
        assert int(got[p]) == k
