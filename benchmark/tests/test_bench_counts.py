"""The roofline's arithmetic: the least work of a batch and its share."""

import importlib.util
import json
import types

import pytest
from conftest import BENCH

import trace_read


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


counts = _load(BENCH / "counts" / "locate.py", "counts_locate")
PEAK = {"hbm_bytes_per_s": 3.35e12, "int_ops_per_s": 16.72704e12,
        "popc_per_s": 4.18176e12}


def test_constants():
    assert (counts.RANK_OPS, counts.RANK_POPC) == (25, 4)
    assert (counts.SEARCH_STEP_OPS, counts.SEARCH_STEP_POPC) == (54, 8)
    assert (counts.WALK_STEP_OPS, counts.WALK_STEP_POPC) == (31, 4)


def test_peaks_are_the_h100s_integer_rates():
    peak = json.loads((BENCH / "peaks.json").read_text())
    h100 = peak["NVIDIA H100 80GB HBM3"]
    # 132 SMs at 1.98 GHz; 64 integer results and 16 popcounts an SM a clock
    assert h100["int_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9)
    assert h100["popc_per_s"] == pytest.approx(132 * 16 * 1.98e9)
    assert h100["hbm_bytes_per_s"] == pytest.approx(3.35e12)


def test_table_bytes():
    rows, samples = counts.table_bytes(248956422, 32)
    assert rows == 32 * ((248956423 + 63) // 64 + 1)  # about 124 MB
    assert samples == 4 * (248956422 // 32 + 1)  # about 31 MB
    assert 124e6 < rows < 125e6 and 31e6 < samples < 31.2e6


def test_work_counts_each_table_at_most_once():
    B, L, n = 1 << 20, 30, 248956422
    nbytes, ops, popc = counts.work(reads=B, length=L, search_steps=29 * B,
                                    walk_steps=31 * B, walks=B, n=n,
                                    sa_rate=32)
    rows, samples = counts.table_bytes(n, 32)
    assert nbytes == 4 * B * L + 8 * B + rows + samples
    assert ops == 54 * 29 * B + 31 * 31 * B
    assert popc == 8 * 29 * B + 4 * 31 * B
    # chr1.kmer30's batch: bound by the integer operations, about 0.158 ms
    s, by = counts.least_seconds(nbytes, ops, popc, PEAK)
    assert by == "operations" and 0.155e-3 < s < 0.16e-3
    # few steps: the rows they fetch, not the whole table
    small, _, _ = counts.work(reads=4, length=30, search_steps=10,
                           walk_steps=3, walks=2, n=n, sa_rate=32)
    assert small == 4 * 4 * 30 + 8 * 4 + 32 * 23 + 32 * 2


def test_least_seconds_takes_the_largest_bound():
    s, by = counts.least_seconds(3.35e12, 16.72704e12 / 2, 1.0, PEAK)
    assert s == pytest.approx(1.0) and by == "bytes"
    s, by = counts.least_seconds(1.0, 16.72704e12 * 2, 1.0, PEAK)
    assert s == pytest.approx(2.0) and by == "operations"
    s, by = counts.least_seconds(1.0, 1.0, 4.18176e12 * 3, PEAK)
    assert s == pytest.approx(3.0) and by == "popcounts"


def _run(kernel_s, calls, work, per_batch):
    trace = trace_read.Trace(
        device=[("void locate_kernel<true>", 0.0, kernel_s),
                ("Memcpy DtoH", kernel_s, kernel_s + 1e-3)],
        host=[("bench.window", 0.0, 2 * kernel_s)],
        window=(0.0, 2 * kernel_s))
    return types.SimpleNamespace(
        trace=trace, work=work, calls_per_batch=per_batch, calls=calls,
        peak=PEAK, config={"genome_length": 1000, "sa_sample_rate": 32},
        host_call_s=1.5 * kernel_s, spans={})


def test_roofline_reader():
    reader = _load(BENCH / "metrics" / "locate_kernel_roofline_pct.py", "r")
    w = {"reads": 100, "length": 30, "search_steps": 2900,
         "walk_steps": 3100, "walks": 100}
    least = counts.least_seconds(*counts.work(n=1000, sa_rate=32, **w),
                                 PEAK)[0]
    run = _run(kernel_s=10 * least * 3, calls=3, work=[w, w],
               per_batch=[2, 1])
    assert reader.read(run) == pytest.approx(10.0)
    run.work = None  # nothing to read: no number, never 0
    assert reader.read(run) is None


def test_kernel_and_overhead_readers():
    ms = _load(BENCH / "metrics" / "locate_kernel_ms.py", "k")
    over = _load(BENCH / "metrics" / "locate_overhead_ms.py", "o")
    idle = _load(BENCH / "metrics" / "device_idle_pct.py", "i")
    run = _run(kernel_s=0.004, calls=4, work=None, per_batch=[4])
    assert ms.read(run) == pytest.approx(1.0)
    assert over.read(run) == pytest.approx(0.5)
    assert idle.read(run) == pytest.approx(100 * (1 - 0.005 / 0.008))
