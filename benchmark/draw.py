"""What genome makers and traffic generators share: seeded random streams
on the device, and the pool of batches a generator hands the harness."""

from __future__ import annotations

import dataclasses

import torch

GENOME_STREAM = 0
TRAFFIC_STREAM = 0x9E3779B9  # keeps the traffic's stream apart from the genome's


def rng(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``stream``; any
    whole seed, however large, gives its own stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) % (1 << 63))
    return g


@dataclasses.dataclass
class Pool:
    """The batches the window cycles through, made in set-up."""

    patterns: list  # one (batch, length) int32 tensor a batch
    lengths: list  # one (batch,) int32 tensor a batch
    stats: dict = dataclasses.field(default_factory=dict)  # printed on stderr
