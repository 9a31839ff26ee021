"""Entry ``locate``: ``bwt_tpu_torch.ops.search.locate(fmi, patterns,
lengths)`` over one batch, on an index that ``build_index`` builds in
set-up from the genome.

An entry file gives ``Program`` (the system under test: built in set-up,
called once a batch in the window, asked after the window for what it
made, then closed) and ``check`` (the comparison with the plain
reference that decides ``correct``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import fm_plain

class Program:
    def __init__(self, config: dict, codes: torch.Tensor, pool, spans: dict):
        import bwt_tpu_torch
        from bwt_tpu_torch.ops import search

        self._search = search
        dev = codes.device
        host = codes.cpu().numpy()
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            spans["pre_build_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        self.fmi = bwt_tpu_torch.build_index(
            host, sa_sample_rate=int(config["sa_sample_rate"]), device=dev,
            index_dtype=np.dtype(config["index_dtype"]))
        if on_card:
            torch.cuda.synchronize()
            spans["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        spans["index_build_s"] = time.perf_counter() - t0

    def call(self, b: int, patterns: torch.Tensor, lengths: torch.Tensor):
        return self._search.locate(self.fmi, patterns, lengths)

    def products(self) -> dict:
        """What the program made that the check judges besides the
        answers: the index's suffix-array samples."""
        return {"sa_samples": self.fmi.sa_samples.clone()}

    def close(self) -> None:
        del self.fmi


def check(config: dict, codes: torch.Tensor, pool, kept: list,
          products: dict, *, count_work: bool) -> dict:
    """Compares every answer of the kept calls, and the index's samples,
    with the plain reference.  ``kept`` holds ``(pool index, answers)``
    of timed calls.  Returns the numbers compared with their limits and,
    with ``count_work``, each pool batch's work for the roofline."""
    rate = int(config["sa_sample_rate"])
    t = fm_plain.tables(codes)
    want = {}
    for b, _ in kept:
        if b not in want:
            want[b] = fm_plain.first_match(t, pool.patterns[b],
                                           pool.lengths[b])
    wrong = missing = checked = 0
    for b, got in kept:
        ref = want[b]
        got = got.reshape(-1)
        k = min(got.numel(), ref.numel())
        missing += ref.numel() - k
        wrong += int((got[:k].to(torch.int64) != ref[:k]).sum())
        wrong += max(got.numel() - ref.numel(), 0)
        checked += ref.numel()
    samples = products["sa_samples"].to(torch.int64)
    ref_samples = t.sa[::rate]
    bad = abs(samples.numel() - ref_samples.numel())
    k = min(samples.numel(), ref_samples.numel())
    bad += int((samples[:k] != ref_samples[:k]).sum())
    out = {
        "checks": {"wrong_answers": (wrong, 0),
                   "missing_answers": (missing, 0),
                   "wrong_sa_samples": (bad, 0)},
        "checked": checked,
        "calls": len(kept),
        "past_end": sum(int((w == fm_plain.PAST_END).sum())
                        for w in want.values()),
    }
    if count_work:
        work = []
        for b in range(len(pool.patterns)):
            pos, steps = fm_plain.first_match(
                t, pool.patterns[b], pool.lengths[b], with_steps=True)
            hit = pos >= 0
            walks = fm_plain.walk_steps(t, pos[hit], rate)
            work.append({"reads": int(pos.numel()),
                         "length": int(pool.patterns[b].shape[1]),
                         "search_steps": int(steps.sum()),
                         "walks": int(hit.sum()),
                         "walk_steps": int(walks.sum())})
        out["work"] = work
    return out
