"""The readers of the program's spans: ``locate_head_ms``,
``locate_launch_ms`` and ``locate_tail_ms`` on a hand-built trace,
``build_sort_s`` and ``build_sort_peak_gib`` on a stub record; and, on the
card, a traced ``locate`` whose kernels the readers place inside their
spans and whose spans cast no shadow among the device operations."""

import types

import pytest

import cell
import trace_read

KERNEL = "void (anonymous namespace)::locate_kernel<true, false, false, int>"


def _trace(calls, launch_s=None, drop=None, shift=None):
    """A trace of ``calls``: each ``(span start, kernel start, kernel end,
    span end)`` in seconds, with the harness's span around each, a launch
    span of ``launch_s`` (or none) around the launch call, the host's copy
    call that waits for the kernel, the flag's copy on the device, the span
    of call ``drop`` left out, and the device times of call ``shift[0]``
    moved by ``shift[1]`` (the profiler's clock offset)."""
    host, device = [], []
    for i, (a, k0, k1, b) in enumerate(calls):
        host.append(("bench.call", a - 0.5, b + 0.25))
        if i != drop:
            host.append(("search.locate", a, b))
        if launch_s is not None:
            host.append(("search.locate.launch", a + 1, a + 1 + launch_s))
        host.append(("cudaLaunchKernel", a + 0.5, a + 0.625))  # the fill's
        host.append(("cudaLaunchKernel", a + 1.5, a + 2))
        host.append(("cudaMemcpyAsync", k1 - 0.25, k1 + 1.25))
        d = shift[1] if shift and shift[0] == i else 0.0
        device.append(("Memset (Device)", a + 0.75 + d, a + 0.875 + d))
        device.append((KERNEL, k0 + d, k1 + d))
        device.append(("Memcpy DtoH (Device -> Pageable)", k1 + 0.5 + d,
                       k1 + 1 + d))
    host.sort(key=lambda h: h[1])
    device.sort(key=lambda h: h[1])
    window = (calls[0][0] - 1, calls[-1][3] + 1)
    return trace_read.Trace(device, host, window)


CALLS = [(10.0, 13.0, 20.0, 22.0), (30.0, 32.0, 40.0, 41.5),
         (50.0, 54.0, 55.0, 58.0)]


def _run(trace, calls=len(CALLS)):
    return cell.Run(config={}, peak=None, setup_s=1.0, calls=calls,
                    trace=trace)


def _read(name, run):
    return cell.find("metrics", name).read(run)


def test_head_launch_and_tail_from_known_intervals():
    run = _run(_trace(CALLS, launch_s=1.25))
    assert _read("locate_head_ms", run) == pytest.approx(
        (3.0 + 2.0 + 4.0) / 3 * 1e3, rel=1e-12)
    assert _read("locate_tail_ms", run) == pytest.approx(
        (2.0 + 1.5 + 3.0) / 3 * 1e3, rel=1e-12)
    assert _read("locate_launch_ms", run) == pytest.approx(1250.0, rel=1e-12)


@pytest.mark.parametrize("shift, head, tail", [
    (-5.0, 1.5, 2.0),  # before its launch call: moved to the call's start
    (5.0, 3.25, 0.25),  # past the end of the copy call: moved back to it
    (0.25, 2.25, 1.25),  # inside the window: kept where the trace has it
])
def test_a_kernel_off_the_host_clock_is_placed_by_causality(shift, head,
                                                            tail):
    """The second call's device times moved by the profiler's offset: its
    kernel (32 to 40 s; launch call from 31.5 s, copy call to 41.25 s, span
    30 to 41.5 s) is kept inside the window the host's calls allow."""
    run = _run(_trace(CALLS, launch_s=1.25, shift=(1, shift)))
    assert _read("locate_head_ms", run) == pytest.approx(
        (3.0 + head + 4.0) / 3 * 1e3, rel=1e-12)
    assert _read("locate_tail_ms", run) == pytest.approx(
        (2.0 + tail + 3.0) / 3 * 1e3, rel=1e-12)


@pytest.mark.parametrize("name", ["locate_head_ms", "locate_launch_ms",
                                  "locate_tail_ms"])
def test_locate_readers_give_none_without_one_span_a_call(name):
    assert _read(name, _run(None)) is None
    assert _read(name, _run(_trace(CALLS, 1.25), calls=4)) is None
    assert _read(name, _run(_trace(CALLS, 1.25), calls=2)) is None
    if name != "locate_launch_ms":
        assert _read(name, _run(_trace(CALLS, 1.25, drop=1))) is None


def test_launch_reader_needs_the_launch_span():
    assert _read("locate_launch_ms", _run(_trace(CALLS))) is None


@pytest.mark.parametrize("lose", [KERNEL, "cudaLaunchKernel",
                                  "cudaMemcpyAsync"])
def test_head_and_tail_need_each_calls_kernel_and_host_calls(lose):
    """One call's kernel, or its host calls, missing: nothing to read."""
    t = _trace(CALLS, 1.25)
    t.device = [d for d in t.device if not (d[0] == lose and d[1] == 32.0)]
    t.host = [h for h in t.host if not (h[0] == lose and 30 < h[1] < 41.5)]
    assert _read("locate_head_ms", _run(t)) is None
    assert _read("locate_tail_ms", _run(t)) is None


def test_build_readers_read_the_programs_record(monkeypatch):
    from bwt_tpu_torch import index

    stub = types.SimpleNamespace(
        totals={"build.upload": 0.5, "build.sort": 1.25, "build.bwt": 0.25},
        peaks={"build.upload": 2 ** 30, "build.sort": 3 * 2 ** 30,
               "build.bwt": None})
    monkeypatch.setattr(index, "LAST_BUILD", stub, raising=False)
    run = _run(None)
    assert _read("build_sort_s", run) == 1.25
    assert _read("build_sort_peak_gib", run) == 3.0
    stub.peaks["build.sort"] = None  # a build on the CPU keeps no peak
    assert _read("build_sort_s", run) is None
    assert _read("build_sort_peak_gib", run) is None
    del stub.totals["build.sort"], stub.peaks["build.sort"]
    assert _read("build_sort_s", run) is None
    assert _read("build_sort_peak_gib", run) is None
    monkeypatch.setattr(index, "LAST_BUILD", None)  # no build yet
    assert _read("build_sort_s", run) is None
    assert _read("build_sort_peak_gib", run) is None
    monkeypatch.delattr(index, "LAST_BUILD")  # a program without the record
    assert _read("build_sort_s", run) is None
    assert _read("build_sort_peak_gib", run) is None


@pytest.mark.cuda
def test_traced_locate_on_the_card_lies_inside_its_span():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import bwt_tpu_torch
    from bwt_tpu_torch import index
    from bwt_tpu_torch.ops import _kernels, search

    _kernels.library()  # built or loaded before the trace
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 4, (1 << 20,), generator=g, dtype=torch.uint8)
    at = torch.randint(0, (1 << 20) - 30, (1 << 14,), generator=g)
    pats = codes[at[:, None] + torch.arange(30)].to(torch.int32).cuda()
    lens = torch.full((1 << 14,), 30, dtype=torch.int32, device="cuda")
    calls = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace_read.WINDOW):
            fmi = bwt_tpu_torch.build_index(codes.numpy(), device="cuda")
            want = search.locate(fmi, pats, lens)
            for _ in range(calls - 1):
                assert torch.equal(search.locate(fmi, pats, lens), want)
    trace = trace_read.read(prof)
    names = {n for n, _, _ in trace.device}
    assert any("locate_kernel" in n for n in names)
    assert not [n for n in names if n.startswith(("search.", "build."))]
    host = [n for n, _, _ in trace.host]
    assert host.count("search.locate") == calls
    assert host.count("search.locate.launch") == calls
    assert all(host.count(s) == 1 for s in index.LAST_BUILD.totals)
    run = _run(trace, calls=calls)
    placed = cell.find("metrics", "locate_head_ms").calls(run)
    assert placed and all(a <= k0 < k1 <= b for a, b, k0, k1 in placed)
    head = _read("locate_head_ms", run)
    launch = _read("locate_launch_ms", run)
    tail = _read("locate_tail_ms", run)
    assert head is not None and tail is not None and 0 < launch < head
    assert _read("build_sort_s", run) > 0
    peak = _read("build_sort_peak_gib", run)
    assert 0 < peak <= torch.cuda.max_memory_allocated() / 2 ** 30
