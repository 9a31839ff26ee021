"""Traffic generator ``reads``: a pool of batches of reads cut from the genome.

A mix that names it (``"generator": "reads"``) gives these keys:

* ``batch``: reads a batch; ``length``: bases a read; ``pool_batches``:
  distinct batches made in set-up, which the window cycles through;
* ``minus_strand_share``: the share of reads cut from the minus strand,
  reverse-complemented (the program searches the orientation it is given);
* ``substitution_rate``: the chance that a base is replaced by one of the
  other three, uniformly.

Everything is drawn from the seed on the genome's device, in a few large
calls, so one seed gives the same pool on every run.
"""

from __future__ import annotations

import torch

import draw


def longest_t_run(codes: torch.Tensor) -> int:
    """The longest run of T (code 3) in the genome."""
    n = codes.numel()
    other = torch.nonzero(codes != 3).flatten()
    edges = torch.cat([other.new_tensor([-1]), other, other.new_tensor([n])])
    return int((edges[1:] - edges[:-1]).max()) - 1


def make_pool(codes: torch.Tensor, mix: dict, seed: int) -> draw.Pool:
    """The mix's pool of batches, cut from ``codes`` at uniform random
    positions.

    A read that is not a plain substring of the genome (a minus-strand or
    substituted read) and begins with at least as many T as the genome's
    longest run of T may sort after every suffix, a row the program's SA
    walk cannot start from (it refuses it with an error, as the reference
    aligner would walk forever); the generator sets the first base of such
    a read to A.  About one read in 4^15 is lifted so, and the count is
    reported."""
    dev = codes.device
    n = codes.numel()
    B, L = int(mix["batch"]), int(mix["length"])
    minus_share = float(mix["minus_strand_share"])
    rate = float(mix["substitution_rate"])
    if not 0 < L <= n:
        raise ValueError(f"reads of {L} bases from a genome of {n}")
    g = draw.rng(dev, seed, draw.TRAFFIC_STREAM)
    t_run = longest_t_run(codes)
    span = torch.arange(L, device=dev)
    pool = draw.Pool([], [])
    stats = dict.fromkeys(("minus_strand", "with_substitution",
                           "substitutions", "bases", "lifted"), 0)
    for _ in range(int(mix["pool_batches"])):
        at = torch.randint(0, n - L + 1, (B,), generator=g, device=dev)
        reads = codes[at[:, None] + span]
        risky = torch.zeros(B, dtype=torch.bool, device=dev)
        if minus_share > 0:
            minus = torch.rand(B, generator=g, device=dev) < minus_share
            reads = torch.where(minus[:, None], 3 - reads.flip(1), reads)
            risky |= minus
            stats["minus_strand"] += int(minus.sum())
        if rate > 0:
            hit = torch.rand(B, L, generator=g, device=dev) < rate
            shift = torch.randint(1, 4, (B, L), generator=g, device=dev,
                                  dtype=torch.uint8)
            reads = torch.where(hit, (reads + shift) % 4, reads)
            risky |= hit.any(1)
            stats["with_substitution"] += int(hit.any(1).sum())
            stats["substitutions"] += int(hit.sum())
        lead = torch.cumprod((reads == 3).to(torch.int32), 1).sum(1)
        lift = risky & (lead >= t_run)
        reads[:, 0] = torch.where(lift, 0, reads[:, 0])
        stats["lifted"] += int(lift.sum())
        pool.patterns.append(reads.to(torch.int32))
        pool.lengths.append(torch.full((B,), L, dtype=torch.int32,
                                       device=dev))
        stats["bases"] += B * L
    pool.stats = stats
    return pool
