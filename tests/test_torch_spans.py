"""The port's spans (CPU): a shared no-op with nothing to record into, host
events on a recording profiler's timeline around ``locate`` and the index
build's stages, and the build's stage record ``index.LAST_BUILD``."""

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

import bwt_tpu_torch
from bwt_tpu_torch import index
from bwt_tpu_torch.ops import search
from bwt_tpu_torch.utils import profiling as tprof

BUILD = ("build.upload", "build.sort", "build.bwt", "build.rows")


def _genome(n=3000, seed=11):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _reads(codes, n=64, length=20, seed=3):
    rng = np.random.default_rng(seed)
    at = rng.integers(0, len(codes) - length, n)
    pats = np.stack([codes[a:a + length] for a in at]).astype(np.int32)
    pats[: n // 4, 0] = 3 - pats[: n // 4, 0]  # some miss or move
    return pats, np.full(n, length, np.int32)


def _host_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of the profiler's host events."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_one_shared_noop_with_nothing_recording(monkeypatch):
    """No profiler and ACTIVE None: the same no-op for every name, and no
    record_function made."""
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} while idle")

    monkeypatch.setattr(tprof, "_RANGE", refuse)
    assert tprof.ACTIVE is None
    assert not autograd_profiler._is_profiler_enabled
    assert tprof.span("search.locate") is tprof.span("build.sort")
    with tprof.span("search.locate"):
        pass


def test_locate_and_build_mark_the_profilers_timeline():
    """Under a CPU profiler a build and a locate emit their spans as host
    events, nested in the caller's range and around their own operations,
    and give the same index and answers as without the profiler."""
    codes = _genome()
    pats, lens = map(torch.from_numpy, _reads(codes))
    want_fmi = bwt_tpu_torch.build_index(codes, device="cpu")
    want = search.locate(want_fmi, pats, lens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.build"):
            fmi = bwt_tpu_torch.build_index(codes, device="cpu")
        with record_function("test.locate"):
            got = search.locate(fmi, pats, lens)
    assert torch.equal(got, want)
    for name in ("bwt_words", "buckets", "sa_samples", "C", "endloc",
                 "isa_samples"):
        assert torch.equal(getattr(fmi, name), getattr(want_fmi, name)), name

    events = _host_events(prof)
    by = {}
    for e in events:
        by.setdefault(e[0], []).append(e)
    assert [len(by.get(n, ())) for n in BUILD + ("search.locate",)] == [
        1] * 5
    assert "search.locate.launch" not in by  # the CPU runs no kernel
    stages = [by[n][0] for n in BUILD]
    for s in stages:
        assert _inside(s, by["test.build"][0]), s[0]
    for a, b in zip(stages, stages[1:]):  # in order, one after another
        assert a[2] <= b[1], (a[0], b[0])
    loc = by["search.locate"][0]
    assert _inside(loc, by["test.locate"][0])
    # the plain search's operations run inside the span
    ops = [e for e in events if e[0].startswith("aten::")
           and _inside(e, by["test.locate"][0])]
    assert ops and all(_inside(e, loc) for e in ops)


def test_spans_time_into_active_and_mark_the_timeline_together(monkeypatch):
    """With a Phases in ACTIVE and a profiler recording, a span does both."""
    ph = tprof.Phases()
    monkeypatch.setattr(tprof, "ACTIVE", ph)
    fmi = bwt_tpu_torch.build_index(_genome(800), device="cpu")
    pats, lens = _reads(_genome(800), n=8, length=12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search.locate(fmi, torch.from_numpy(pats), torch.from_numpy(lens))
    assert ph.counts["search.locate"] == 1
    assert ph.counts["build.sort"] == 1  # the build timed into ACTIVE too
    assert [e[0] for e in _host_events(prof)].count("search.locate") == 1


@pytest.mark.parametrize("given_sa", [False, True])
def test_last_build_holds_each_stage_once(given_sa):
    """Each build replaces LAST_BUILD with its stages, each once, with
    seconds and (on the CPU) no allocator peak; a given SA's ISA scatter
    stands where the sort would."""
    codes = _genome(2000, seed=4)
    first = bwt_tpu_torch.build_index(codes, device="cpu")
    sa = None
    if given_sa:
        from bwt_tpu_torch.ops import suffix

        sa, _ = suffix.suffix_array_with_isa(
            torch.from_numpy(codes).to(torch.int64))
    before = index.LAST_BUILD
    fmi = bwt_tpu_torch.build_index(codes, device="cpu", sa=sa)
    record = index.LAST_BUILD
    assert record is not before
    want = (("build.upload", "build.isa", "build.bwt", "build.rows")
            if given_sa else BUILD)
    assert list(record.totals) == list(want)
    assert record.counts == dict.fromkeys(want, 1)
    assert record.peaks == dict.fromkeys(want)
    assert all(record.totals[n] > 0 for n in want)
    assert torch.equal(fmi.buckets, first.buckets)


def test_phases_with_a_device_keeps_the_peak():
    """A phase given a device records its end's allocator peak: None on
    the CPU; without a device no peak, as bwt_tpu's Phases."""
    ph = tprof.Phases()
    with ph("plain"):
        pass
    with ph("staged", torch.device("cpu")):
        pass
    assert ph.peaks == {"staged": None}
    assert ph.counts == {"plain": 1, "staged": 1}
