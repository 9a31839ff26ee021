"""Reading a ``torch.profiler`` window: device intervals, host spans, the
union of device time, and idle gaps named by what the host was doing.

Device time is the union of the device intervals on the timeline, so an
operation that overlaps another (a copy beside a kernel) is counted once.
"""

from __future__ import annotations

import bisect
import dataclasses

HARNESS = "bench."  # prefix of the harness's own spans (record_function)
WINDOW = "bench.window"
SCAN = 64  # host events looked back through for those open over a gap


@dataclasses.dataclass
class Trace:
    device: list  # (name, start_s, end_s), sorted by start
    host: list  # (name, start_s, end_s), sorted by start
    window: tuple  # (start_s, end_s) of the harness's window span

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_s_by_name(self) -> dict:
        out = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def device_s_matching(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(b - a for name, a, b in self.device if part in name)

    def busy_intervals(self) -> list:
        """The union of device intervals inside the window."""
        lo, hi = self.window
        merged = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list:
        """``(start_s, end_s)`` of each stretch of the window in which no
        device operation runs."""
        lo, hi = self.window
        gaps, at = [], lo
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def idle_by_host(self) -> dict:
        """Idle device seconds by what the host was doing: each gap is cut
        at the edges of the host operations inside it, and each piece is
        named by the harness span and the innermost operation open over
        it (``"bench.call > cudaMemcpyAsync"``; ``"bench.window"`` where
        the harness's loop runs between calls)."""
        starts = [s for _, s, _ in self.host]
        out = {}
        for g0, g1 in self.idle_gaps():
            i = bisect.bisect_left(starts, g1)
            near = [h for h in self.host[max(i - SCAN, 0):i]
                    if h[2] > g0 and h[0] != WINDOW]
            cuts = sorted({g0, g1} | {t for _, a, b in near for t in (a, b)
                                      if g0 < t < g1})
            for a, b in zip(cuts, cuts[1:]):
                label = _label([h for h in near if h[1] <= a and h[2] >= b])
                out[label] = out.get(label, 0.0) + (b - a)
        return out


def _label(open_ops: list) -> str:
    """The harness span and the innermost operation among ``open_ops``
    (all open over one stretch), latest start innermost."""
    if not open_ops:
        return WINDOW
    inner = max(open_ops, key=lambda h: h[1])[0]
    outer = [h for h in open_ops if h[0].startswith(HARNESS)]
    if not outer:
        return inner
    span = max(outer, key=lambda h: h[1])[0]
    return span if span == inner else f"{span} > {inner}"


def _events(prof):
    """``(name, is_device, start_s, end_s)`` of every event."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue  # a host span's shadow on the device timeline
        yield e.name(), dev, e.start_ns() / 1e9, e.end_ns() / 1e9


def read(prof) -> Trace | None:
    """The profiler's window as a :class:`Trace`; None without the
    harness's window span."""
    device, host, window = [], [], None
    for name, dev, a, b in _events(prof):
        if dev:
            if not name.startswith(HARNESS):
                device.append((name, a, b))
        else:
            host.append((name, a, b))
            if name == WINDOW:
                window = (a, b)
    if window is None:
        return None
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Trace(device, host, window)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (summed over gaps), each at most ``top``."""
    ops = sorted(trace.device_s_by_name().items(), key=lambda x: -x[1])
    gaps = sorted(trace.idle_by_host().items(), key=lambda x: -x[1])
    return {"device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
