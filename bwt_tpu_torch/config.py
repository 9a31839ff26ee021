"""Configuration: every tunable the reference hardcodes, with its
defaults (the same fields and defaults as ``bwt_tpu.config``).

Parity-sensitive fields (index layout, DP scoring) reproduce the
reference's output only at their defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # index layout
    sa_sample_rate: int = 32       # seqindex.c:173-176
    rank_blocksize: int = 16       # structural: bases per packed word

    # alignment drivers
    anchor_len: int = 12           # single_align.c:483
    min_anchor: int = 20           # search_reads.c:115,119
    pair_window: int = 10_000      # search_reads.c:154
    chain_thresh: int = 10         # single_align.c:482
    max_read_len: int = 65_536     # single_align.c:369

    # DP scoring (smw.c:41-54)
    match: int = 0
    mismatch: int = -6
    gap_open: int = -5
    gap_extend: int = -3

    # spliced alignment (rnaseqtest.c)
    rnaseq_anchor_cutoff: int = 14
    rnaseq_cont_cutoff: int = 10

    # execution
    search_batch: int = 1 << 15
    automaton_seed_k: int = 12
    gen_seq_default_len: int = 100_000  # gen_seq.c:17
    spec_depth: int = 1        # anchor-hunt retries issued per round
    rnaseq_spec_depth: int = 24
    isa_spec_depth: int = 1    # curgap hypotheses issued per round
    elastic_fallback: bool = False  # not supported by this package:
    # the drivers raise NotImplementedError when it is set

    @property
    def dp_scoring(self) -> tuple[int, int, int, int]:
        """(match, mismatch, gap_open, gap_extend) for every DP fill."""
        return (self.match, self.mismatch, self.gap_open, self.gap_extend)


DEFAULT = Config()
