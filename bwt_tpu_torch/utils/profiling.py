"""Wall-clock phase timers and a device trace.

The reference's only instrumentation is an rdtsc macro around its build
and query phases, converted at a hardcoded 2.5 GHz (rdtscll.h:16-18,
fmitest.c:143-149).  Here:

  * :class:`Phases`, accumulating wall-clock timers with derived rates;
  * :data:`ACTIVE` and :func:`span`: the device engines' host stages, and
    ``locate``'s call and launch, run inside ``span(name)``, which times
    them against ``ACTIVE`` when a caller has set it to a :class:`Phases`,
    and marks them on the timeline of a ``torch.profiler`` that is
    recording (``record_function``'s C++ range: a host event beside the
    trace's device intervals, casting none among them); with neither, it
    is one shared no-op (no clock, no synchronisation, no profiler call);
  * :func:`stage`: a stage of a job that runs once (the index build,
    ``index.LAST_BUILD``), always timed into its own :class:`Phases`, with
    the card's allocator peak at its end, and marked as a span;
  * :func:`device_trace`, a ``torch.profiler`` window that writes a Chrome
    trace (``chrome://tracing``, ui.perfetto.dev) under a log directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler


class Phases:
    """Accumulating wall-clock phase timers.

    >>> ph = Phases()
    >>> with ph("build"):
    ...     build()
    >>> ph.rate("build", genome_len)   # bases/s
    >>> print(ph.report())

    Given a ``device``, a phase ends in a synchronise on a card and keeps
    in ``peaks[name]`` the allocator's peak at its end
    (``torch.cuda.max_memory_allocated``, never reset here; None on the
    CPU).
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.peaks: dict[str, int | None] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, device: torch.device | None = None):
        t0 = time.perf_counter()
        try:
            yield self
            if device is not None:
                peak = None
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    peak = torch.cuda.max_memory_allocated(device)
                self.peaks[name] = peak
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def seconds(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def rate(self, name: str, units: float) -> float:
        """Units a second in phase ``name`` (0 if it never ran)."""
        dt = self.totals.get(name, 0.0)
        return units / dt if dt else 0.0

    def report(self) -> str:
        width = max((len(n) for n in self.totals), default=0)
        return "\n".join(
            f"{n:<{width}}  {self.totals[n] * 1e3:10.2f} ms  x{self.counts[n]}"
            for n in self.totals)


# the process-wide collector the instrumented stages time against; None
# (the default) leaves the spans to the profiler alone
ACTIVE: Phases | None = None


class _Idle:
    """The shared no-op span.  Its enter and exit are ``"".format``, a C
    function that takes any arguments and returns ``""``, which is false,
    so an exception passes through: about half the cost of
    ``contextlib.nullcontext``'s two Python methods, on a path that every
    ``locate`` call takes twice."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NOOP = _Idle()

# a range on the profiler's timeline: the C++ context manager behind
# ``record_function``'s Python one, where this torch has it (1-2 against
# 13-14 us a range with a profiler recording, on an H100's host; and it
# leaves less of a ``locate`` call outside every host event)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 _autograd_profiler.record_function)


@contextlib.contextmanager
def _marked(name: str, phases: Phases):
    with _RANGE(name), phases(name):
        yield


def span(name: str):
    """A context for stage ``name``: timed against :data:`ACTIVE`, and a
    range on the timeline while a profiler records.  Names never start
    with ``bench.`` (a benchmark's own spans)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP if ACTIVE is None else ACTIVE(name)
    if ACTIVE is None:
        return _RANGE(name)
    return _marked(name, ACTIVE)


@contextlib.contextmanager
def stage(record: Phases, name: str, device: torch.device):
    """Stage ``name`` of a job that runs once: timed into ``record`` with
    its end synchronised and its allocator peak (:class:`Phases` with a
    device), inside ``span(name)``."""
    with span(name), record(name, device):
        yield


@contextlib.contextmanager
def device_trace(logdir):
    """A ``torch.profiler`` window over the region, CPU and (with a card)
    CUDA activity; on exit the Chrome trace is written to
    ``logdir/trace_<pid>_<ns>.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        str(logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"))
