"""The genome maker and the traffic generator, found by name, repeat
exactly from a seed, and the generator gives the stated strand and
substitution shares."""

import pytest
import torch

import cell

uniform = cell.find("genomes", "uniform")
reads = cell.find("generators", "reads")

MIX = {"batch": 4096, "length": 150, "pool_batches": 2,
       "minus_strand_share": 0.5, "substitution_rate": 0.001}


def genome(n=50000, seed=11):
    return uniform.make({"genome_length": n}, seed, torch.device("cpu"))


def test_repeats_from_a_seed():
    g = genome()
    assert torch.equal(g, genome())
    a = reads.make_pool(g, MIX, 2 ** 31 + 5)
    b = reads.make_pool(g, MIX, 2 ** 31 + 5)
    c = reads.make_pool(g, MIX, 2 ** 31 + 6)
    for x, y in zip(a.patterns, b.patterns):
        assert torch.equal(x, y)
    assert not torch.equal(a.patterns[0], c.patterns[0])
    assert not torch.equal(a.patterns[0], a.patterns[1])
    assert a.patterns[0].dtype == torch.int32
    assert a.patterns[0].shape == (4096, 150)
    assert torch.equal(a.lengths[0], torch.full((4096,), 150,
                                                dtype=torch.int32))


def _sd(n, p):
    return (n * p * (1 - p)) ** 0.5


def test_shares():
    pool = reads.make_pool(genome(), MIX, 3)
    n = MIX["batch"] * MIX["pool_batches"]
    st = pool.stats
    assert abs(st["minus_strand"] - n / 2) < 5 * _sd(n, 0.5)
    subs = st["bases"] * MIX["substitution_rate"]
    assert abs(st["substitutions"] - subs) < 5 * _sd(st["bases"], 0.001)
    hit = 1 - (1 - MIX["substitution_rate"]) ** MIX["length"]
    assert abs(st["with_substitution"] - n * hit) < 5 * _sd(n, hit)


def test_reads_are_cut_from_the_genome():
    g = genome(20000)
    text = "".join("ACGT"[c] for c in g.tolist())
    mix = dict(MIX, batch=64, pool_batches=1, substitution_rate=0.0)
    pool = reads.make_pool(g, mix, 9)
    plus = minus = 0
    for r in pool.patterns[0].tolist():
        s = "".join("ACGT"[c] for c in r)
        rc = "".join("TGCA"[c] for c in reversed(r))
        if s in text:
            plus += 1
        else:
            assert rc in text  # a minus-strand read, reverse-complemented
            minus += 1
    assert plus and minus and plus + minus == 64


def test_kmers_match_exactly():
    g = genome(20000)
    text = "".join("ACGT"[c] for c in g.tolist())
    mix = {"batch": 256, "length": 30, "pool_batches": 1,
           "minus_strand_share": 0.0, "substitution_rate": 0.0}
    pool = reads.make_pool(g, mix, 4)
    st = pool.stats
    assert st["minus_strand"] == st["substitutions"] == st["lifted"] == 0
    for r in pool.patterns[0].tolist():
        assert "".join("ACGT"[c] for c in r) in text


@pytest.mark.parametrize("share,rate", [(1.0, 0.0), (0.0, 0.5)])
def test_a_read_that_could_sort_last_is_lifted(share, rate):
    # a genome whose longest run of T is 2, and reads that start TTT
    g = torch.tensor([3, 3, 0, 1, 2] * 40, dtype=torch.uint8)
    assert reads.longest_t_run(g) == 2
    mix = {"batch": 500, "length": 6, "pool_batches": 1,
           "minus_strand_share": share, "substitution_rate": rate}
    pool = reads.make_pool(g, mix, 1)
    got = pool.patterns[0]
    lead = torch.cumprod((got == 3).to(torch.int32), 1).sum(1)
    assert int((lead >= 2).sum()) == 0 or pool.stats["lifted"] > 0
    assert int((lead > 2).sum()) == 0  # nothing sorts past the last suffix
