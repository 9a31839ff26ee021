"""Genome ``uniform``: ``genome_length`` codes 0..3 (A, C, G, T), each drawn
uniformly and independently from the seed, on the device."""

from __future__ import annotations

import torch

import draw


def make(config: dict, seed: int, device: torch.device) -> torch.Tensor:
    return torch.randint(0, 4, (int(config["genome_length"]),),
                         generator=draw.rng(device, seed, draw.GENOME_STREAM),
                         device=device, dtype=torch.uint8)
