"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json`` names a configuration (its file) and a traffic mix
(``traffic/<name>.json``); the configuration names the maker of its genome
(``genomes/<name>.py``, ``uniform`` if it names none); the mix names its
generator (``generators/<name>.py``) and the entry (``entries/<name>.py``)
whose program it drives; each metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import time
from pathlib import Path

import torch

import trace_read

BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str):
    """The file ``<kind>/<name>.py`` of this folder as a fresh module."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(BENCH.parent)}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    config: dict
    peak: dict | None  # the card's entry of peaks.json
    setup_s: float
    window_s: float = 0.0  # host clock, first call issued to last returned
    calls: int = 0
    queries: int = 0
    batch_ms: list = dataclasses.field(default_factory=list)
    host_call_s: float = 0.0  # the harness's spans around the calls, summed
    peak_bytes: int | None = None
    spans: dict = dataclasses.field(default_factory=dict)
    calls_per_batch: list = dataclasses.field(default_factory=list)
    work: list | None = None  # each pool batch's work (the entry's check)
    trace: trace_read.Trace | None = None


def _power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


@dataclasses.dataclass
class _Window:
    prof: object = None
    batch_ms: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
    calls: int = 0
    failed: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0


def _window(program, pool, seconds, dev, trace, keep, rng, t0) -> _Window:
    """The measured window: one caller, one batch in flight, cycling
    through the pool until ``seconds`` have passed; keeps a reservoir
    sample of ``keep`` calls' answers for the check.  Each call is timed
    by the host's clock from its issue to its return (it synchronises)."""
    w = _Window()
    n_pool = len(pool.patterns)
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        w.prof = profile(activities=acts)
    span = (torch.profiler.record_function if trace
            else lambda _name: contextlib.nullcontext())
    with w.prof if trace else contextlib.nullcontext():
        with span(trace_read.WINDOW):
            start = time.perf_counter()
            w.setup_s = start - t0
            deadline = start + seconds
            while True:
                b = w.calls % n_pool
                with span("bench.call"):
                    h0 = time.perf_counter()
                    try:
                        out = program.call(b, pool.patterns[b],
                                           pool.lengths[b])
                    except RuntimeError as err:  # the call never answers
                        out = None
                        w.failed += 1
                        if len(w.errors) < 3:
                            w.errors.append(str(err)[:300])
                    h1 = time.perf_counter()
                w.batch_ms.append((h1 - h0) * 1e3)
                w.calls += 1
                if out is not None:  # a reservoir sample of the calls
                    if len(w.kept) < keep:
                        w.kept.append((b, out))
                    else:
                        j = rng.randrange(w.calls)
                        if j < keep:
                            w.kept[j] = (b, out)
                if h1 >= deadline:
                    break
            w.window_s = time.perf_counter() - start
    return w


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def run_cell(manifest: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float,
             control: str | None = None,
             traffic_dir: Path = BENCH / "traffic") -> tuple:
    """Runs the cell once; returns the result and the lines that say
    what the run did.  A configuration's file is relative to the root of
    the checkout (or absolute); ``traffic_dir`` holds the mixes."""
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = load_json(BENCH.parent / conf["file"])
    mix = load_json(traffic_dir / f"{cell['traffic']}.json")
    genome = find("genomes", config.get("genome", "uniform"))
    generator = find("generators", mix["generator"])
    entry = find("entries", mix["entry"])
    maker = entry if control is None else find("controls", control)
    dev = torch.device(device)
    card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if card else None
    peak = load_json(BENCH / "peaks.json").get(kind) if card else None

    marks = [("imports", time.perf_counter())]

    def mark(label):
        if card:
            torch.cuda.synchronize()
        marks.append((label, time.perf_counter()))

    codes = genome.make(config, seed, dev)
    mark("genome (with the CUDA context)")
    pool = generator.make_pool(codes, mix, seed)
    mark("traffic pool")
    spans = {}
    program = maker.Program(config, codes, pool, spans)
    mark("program set-up (index build)")
    n_pool = len(pool.patterns)
    for b in range(n_pool):  # warm-up: every shape the window sends
        program.call(b, pool.patterns[b], pool.lengths[b])
    mark("warm-up (kernel library built or loaded)")

    window = _window(program, pool, seconds, dev, trace,
                     int(mix["check_batches"]), random.Random(seed), t0)
    calls, failed, kept = window.calls, window.failed, window.kept
    setup_s, window_s = window.setup_s, window.window_s
    prof = window.prof
    closed = time.perf_counter()
    batch_ms = window.batch_ms
    B = int(mix["batch"])
    run = Run(config=config, peak=peak, setup_s=setup_s, window_s=window_s,
              calls=calls, queries=B * (calls - failed), batch_ms=batch_ms,
              host_call_s=sum(batch_ms) / 1e3, spans=spans,
              calls_per_batch=[len(range(b, calls, n_pool))
                               for b in range(n_pool)])
    if card:
        torch.cuda.synchronize()
        run.peak_bytes = max(spans.get("pre_build_peak_bytes", 0),
                             torch.cuda.max_memory_allocated(dev))
    if prof is not None:
        run.trace = trace_read.read(prof)
        del prof, window.prof

    products = program.products()
    program.close()
    del program
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = entry.check(config, codes, pool, kept, products,
                          count_work=trace)
    t_done = time.perf_counter()
    run.work = verdict.get("work")
    del kept, window.kept, products
    checks = dict(verdict["checks"])
    checks["failed_calls"] = (failed, 0)
    correct = (verdict["checked"] > 0
               and all(v <= lim for v, lim in checks.values()))

    names = [m for m in manifest["per_layer" if trace else "end_to_end"]
             if _applies(m, workload)]
    metrics = {}
    for m in names:
        reader = find("metrics", m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if card else dev.type, "kind": kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": B * calls,
              "failed": B * failed, "metrics": metrics,
              "device": device_info}
    notes = [f"{calls} calls of {B} queries in {window_s:.6f} s "
             f"({failed} raised); set-up {setup_s:.6f} s; "
             f"{verdict['checked']} answers of {verdict['calls']} timed "
             f"calls checked; {verdict.get('past_end', 0)} answers past "
             f"the last row",
             f"pool: {len(pool.patterns)} batches; " + ", ".join(
                 f"{k} {v}" for k, v in pool.stats.items()),
             f"batch latency (issue to return, {len(batch_ms)} samples): "
             + _quantiles(batch_ms) + "; the harness's loop between calls "
             f"{(window_s - run.host_call_s) / max(calls, 1) * 1e6:.2f}"
             " us a call",
             "set-up: " + ", ".join(
                 f"{label} {b - a:.3f} s" for (_, a), (label, b)
                 in zip([("start", t0)] + marks, marks)),
             "batch latency medians of the window's tenths: "
             + _tenths(batch_ms),
             f"after the window: {t_check - closed:.3f} s to the check "
             f"(trace read, release), check {t_done - t_check:.3f} s"]
    notes += [f"call raised: {e}" for e in window.errors]
    if trace:
        if run.trace is not None:
            busy = run.trace.busy_s()
            device_info["busy_s"] = busy
            device_info["window_s"] = run.trace.window_s
            result["breakdown"] = trace_read.breakdown(run.trace)
            notes.append(f"traced window {run.trace.window_s:.6f} s, device "
                         f"busy {busy:.6f} s, "
                         f"{len(run.trace.device)} device operations")
        if run.work:
            notes.append("work per pool batch: " + json.dumps(run.work))
    if card:
        limit = _power_limit()
        notes.append(f"card: {limit}")
        result["card"] = limit
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, notes


def _tenths(ms: list) -> str:
    k = len(ms) // 10
    if not k:
        return "none"
    return ", ".join(f"{sorted(ms[i * k:(i + 1) * k])[k // 2]:.4f}"
                     for i in range(10)) + " ms"


def _quantiles(ms: list) -> str:
    if not ms:
        return "none"
    s = sorted(ms)

    def q(p):
        return s[min(len(s) - 1, int(p * (len(s) - 1) + 0.5))]

    return (f"min {s[0]:.6f}, median {q(0.5):.6f}, p95 {q(0.95):.6f}, "
            f"max {s[-1]:.6f} ms")
