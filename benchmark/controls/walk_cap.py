"""Control ``walk_cap``: the plain reference put in the program's place,
with one guarantee broken, the shortcut a faster ``locate`` could be
tempted by: every SA walk is cut at twice the sampling rate, and a read
whose walk is longer answers -1 (a warp no longer waits for its longest
walk).  The configuration guarantees a position for every read whose
pattern occurs, so ``check`` has to find this control wrong.

It is run by ``run.py --control walk_cap``, never by the benchmark's own
runs.  Its answers for the pool are made in set-up; a call hands back the
batch's answers.
"""

from __future__ import annotations

import torch

from reference import fm_plain


class Program:
    def __init__(self, config: dict, codes: torch.Tensor, pool, spans: dict):
        rate = int(config["sa_sample_rate"])
        cap = 2 * rate
        t = fm_plain.tables(codes)
        self.answers = []
        for pats, lens in zip(pool.patterns, pool.lengths):
            pos = fm_plain.first_match(t, pats, lens)
            hit = pos >= 0
            walk = torch.zeros_like(pos)
            walk[hit] = fm_plain.walk_steps(t, pos[hit], rate)
            self.answers.append(torch.where(walk > cap, -1, pos)
                                .to(torch.int32))
        self.samples = t.sa[::rate].to(torch.int32)
        del t

    def call(self, b: int, patterns: torch.Tensor, lengths: torch.Tensor):
        return self.answers[b]

    def products(self) -> dict:
        return {"sa_samples": self.samples}

    def close(self) -> None:
        self.answers = []
