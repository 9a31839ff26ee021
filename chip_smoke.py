#!/usr/bin/env python3
"""Drive bwt_tpu_torch's main path once on an NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, one output line each, every number beside the card's name and
power limit:
  0. the card (torch and nvidia-smi);
  1. the CUDA kernel build from csrc/ (nvcc);
  2. the DP kernel against its plain PyTorch twin on the card, at the
     stitch shapes the aligner uses: vals and ptrs must be bit-equal;
  3. index build of a 2^25-base random genome at sa_sample_rate 4,
     checked with verify_suffix_array;
  4. locate of 2^20 random 30-mers cut from the genome, every position
     checked against the genome;
  5. single_align (align_reads) on 4096 reads of 80 bp with one
     substitution each: the kernel must have been launched, every
     aligned CIGAR consumes its read, at least half the reads land at
     their true start, and a 256-read subset gives the same results
     through the plain twin;
  6. the CLI (build_index, then single_align) as subprocesses on a 1 Mb
     genome and 512 reads: stdout equals the same run in process.
Then one JSON line with the kernels, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed phase raises and
exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

DP_SHAPES = ((32, 32), (32, 64), (64, 64), (64, 96), (96, 128))
ALT_SCORING = (1, -2, -9, -1)
READ_LEN = 80


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def mutated_reads(rng, codes, n, length=READ_LEN):
    """``n`` reads cut at uniform starts, one substitution each."""
    import numpy as np

    starts = rng.integers(0, len(codes) - length, size=n)
    reads = codes[np.add.outer(starts, np.arange(length))].copy()
    mpos = rng.integers(0, length, size=n)
    reads[np.arange(n), mpos] ^= rng.integers(1, 4, size=n).astype(np.uint8)
    return starts, reads


def dp_jobs(rng, B, L1, L2):
    """Random stitch jobs as the executor pads them: random lengths,
    zero padding, a few N's in the reads."""
    import numpy as np

    reads = np.zeros((B, L1), np.int32)
    genomes = np.zeros((B, L2), np.int32)
    rl = rng.integers(1, L1 + 1, size=B)
    gl = rng.integers(1, L2 + 1, size=B)
    r = rng.integers(0, 4, size=(B, L1)).astype(np.int32)
    r[rng.random((B, L1)) < 0.02] = 5
    g = rng.integers(0, 4, size=(B, L2)).astype(np.int32)
    col1, col2 = np.arange(L1)[None, :], np.arange(L2)[None, :]
    reads[col1 < rl[:, None]] = r[col1 < rl[:, None]]
    genomes[col2 < gl[:, None]] = g[col2 < gl[:, None]]
    return reads, genomes


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel(rng, tag):
    """Phase 2: the DP kernel against its plain twin, bit-equal."""
    import torch

    from bwt_tpu_torch.ops import dp_wavefront as dw

    cases = [(B, L1, L2, None) for L1, L2 in DP_SHAPES for B in (8, 1024)]
    cases.append((1024, 32, 64, ALT_SCORING))
    rows = []
    for B, L1, L2, scoring in cases:
        r_np, g_np = dp_jobs(rng, B, L1, L2)
        r = torch.from_numpy(r_np).cuda()
        g = torch.from_numpy(g_np).cuda()
        vk, pk = dw.dp_fill_wavefront(r, g, scoring=scoring)
        vp, pp = dw.dp_fill_wavefront_plain(r, g, scoring=scoring)
        torch.cuda.synchronize()
        err = int((vk - vp).abs().max())
        require(torch.equal(vk, vp) and torch.equal(pk, pp),
                f"dp_wavefront kernel differs from its plain twin at "
                f"B={B} L1={L1} L2={L2} scoring={scoring}: max |dv| {err}")
        ms = cuda_ms(lambda: dw.dp_fill_wavefront(r, g, scoring=scoring), 20)
        plain_ms = cuda_ms(
            lambda: dw.dp_fill_wavefront_plain(r, g, scoring=scoring), 3)
        rows.append(dict(B=B, L1=L1, L2=L2, scoring=scoring or "default",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))
        print(f"phase 2 dp_wavefront B={B} L1={L1} L2={L2} "
              f"scoring={scoring or 'default'}: bit-equal (tolerance 0, "
              f"max |dv| {err}), kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms {tag}", flush=True)
    return rows


def phase_build(codes_np, device, tag):
    """Phase 3: the index build, timed, then built again with the
    suffix-array check (verify_suffix_array); returns the index."""
    import torch

    import bwt_tpu_torch

    n = len(codes_np)
    bwt_tpu_torch.build_index(codes_np[: 1 << 16], sa_sample_rate=4,
                              device=device)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=4, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del fmi
    t0 = time.perf_counter()
    fmi = bwt_tpu_torch.build_index(codes_np, sa_sample_rate=4, verify=True,
                                    device=device)  # raises if the SA is wrong
    torch.cuda.synchronize()
    dtv = time.perf_counter() - t0
    require(int(fmi.C[4]) == n + 1 and fmi.sa_samples.shape[0] == 1 + n // 4,
            "index C totals or sample count wrong")
    print(f"phase 3 build_index n={n} sa_rate=4: {dt:.3f} s "
          f"({n / dt / 1e6:.3f} Mb/s), peak device memory "
          f"{peak / 2**30:.3f} GiB; rebuilt with verify_suffix_array: SA "
          f"verified ({dtv:.3f} s with the check) {tag}", flush=True)
    return fmi, dict(n=n, build_s=dt, mbps=n / dt / 1e6,
                     peak_gib=peak / 2**30, build_verify_s=dtv)


def phase_locate(fmi, codes_np, rng, nq, tag, plen=30):
    """Phase 4: locate random k-mers; every position checked."""
    import numpy as np
    import torch

    from bwt_tpu_torch.ops import search

    dev = fmi.device
    starts = rng.integers(0, len(codes_np) - plen, size=nq)
    pats_np = codes_np[np.add.outer(starts, np.arange(plen))].astype(np.int32)
    pats = torch.from_numpy(pats_np).to(dev)
    lens = torch.full((nq,), plen, dtype=torch.int32, device=dev)
    search.locate(fmi, pats[:1024], lens[:1024])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos = search.locate(fmi, pats, lens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    g = torch.from_numpy(codes_np).to(dev).to(torch.int32)
    require(bool(((pos >= 0) & (pos <= len(codes_np) - plen)).all()),
            "locate returned a position outside the genome")
    win = g[(pos.long()[:, None] + torch.arange(plen, device=dev))]
    require(bool((win == pats).all()),
            "a located position does not hold its pattern")
    print(f"phase 4 locate {nq} x {plen}-mers: all positions checked, "
          f"{nq / dt:.1f} locates/s ({dt:.3f} s) {tag}", flush=True)
    return dict(n=nq, s=dt, per_s=nq / dt)


def _cigar_read_len(cig) -> int:
    return sum(c for op, c in cig.ops if op in "MI")


def phase_align(fmi, codes_np, rng, nreads, tag, subset=256):
    """Phase 5: single_align through align_reads."""
    import numpy as np

    from bwt_tpu_torch.models import aligner
    from bwt_tpu_torch.models.batch_exec import QueryService
    from bwt_tpu_torch.ops import dp_wavefront

    starts, reads = mutated_reads(rng, codes_np, nreads)
    svc = QueryService(fmi, codes_np)
    aligner.align_reads(fmi, codes_np, reads[:64], service=svc)  # warm-up
    dp_wavefront.LAUNCHES = 0
    t0 = time.perf_counter()
    res = aligner.align_reads(fmi, codes_np, reads, service=svc,
                              with_strand=True)
    dt = time.perf_counter() - t0
    launches = dp_wavefront.LAUNCHES
    require(launches > 0, "the DP kernel was not launched by single_align")
    aligned = [(k, r) for k, r in enumerate(res) if r[0]]
    for k, (_, cig, _) in aligned:
        require(_cigar_read_len(cig) == READ_LEN,
                f"read {k}: CIGAR {cig.render()} does not consume "
                f"{READ_LEN} read bases")
    at_true = sum(1 for k, r in aligned
                  if r[0] == starts[k] + 1 and not r[2])
    share = at_true / nreads
    require(share >= 0.5, f"only {share:.3f} of reads at their true start")
    sub = reads[:subset]
    with_kernel = aligner.align_reads(fmi, codes_np, sub, service=svc,
                                      with_strand=True)
    svc.dp_impl = "plain"
    with_plain = aligner.align_reads(fmi, codes_np, sub, service=svc,
                                     with_strand=True)
    svc.dp_impl = "kernel"

    def norm(rs):
        return [(p, c.render() if c else None, s) for p, c, s in rs]

    require(norm(with_kernel) == norm(with_plain),
            "single_align differs between the DP kernel and its plain twin")
    require(norm(with_kernel) == norm(res[:subset]),
            "single_align subset differs from the full run")
    print(f"phase 5 single_align {nreads} x {READ_LEN} bp: "
          f"{len(aligned)} aligned, {share:.4f} at true start, "
          f"{nreads / dt:.1f} reads/s ({dt:.3f} s), dp_wavefront launches "
          f"{launches}; {subset}-read subset equal through kernel and plain "
          f"twin {tag}", flush=True)
    return dict(n=nreads, s=dt, per_s=nreads / dt, at_true=share,
                aligned=len(aligned), launches=launches)


def phase_cli(rng, workdir: Path, tag, glen=1_000_000, nreads=512):
    """Phase 6: the CLI as subprocesses against the same run in process."""
    import numpy as np

    from bwt_tpu_torch import codec, io as bio
    from bwt_tpu_torch.models import aligner

    workdir.mkdir(parents=True, exist_ok=True)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    gtext = codec.decode(codes)
    _, reads = mutated_reads(rng, codes, nreads)
    texts = [codec.decode(r) for r in reads]
    gfile, ifile, rfile = (workdir / "genome.txt", workdir / "genome.idx",
                           workdir / "reads.txt")
    gfile.write_text(gtext)
    rfile.write_text("\n".join(texts) + "\n")
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "bwt_tpu_torch"]
    subprocess.run(cmd + ["build_index", str(gfile), str(ifile)], cwd=ROOT,
                   check=True, capture_output=True, text=True)
    res = subprocess.run(cmd + ["single_align", str(gfile), str(ifile),
                                str(rfile)],
                         cwd=ROOT, check=True, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    fmi = bio.read_ref_index(ifile)
    want = aligner.format_ref_output(aligner.align_reads(fmi, gtext, texts))
    require(res.stdout == want,
            "CLI single_align stdout differs from the in-process run")
    naligned = want.count("\n ")
    print(f"phase 6 CLI build_index + single_align on {glen} bases, "
          f"{nreads} reads: stdout equal to in-process ({naligned} aligned, "
          f"{len(res.stdout)} bytes), {dt:.3f} s for both subprocesses "
          f"{tag}", flush=True)
    return dict(s=dt, aligned=naligned)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the measurements as JSON to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bwt_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    tag = f"[{smi}]"
    print(f"phase 0 card: torch {torch.__version__} cuda "
          f"{torch.version.cuda}, {name}, {torch.cuda.device_count()} "
          f"device(s); nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    lib = _kernels.build(verbose=True)
    print(f"phase 1 nvcc build of {len(_kernels.sources())} source(s) -> "
          f"{lib.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s "
          f"{tag}", flush=True)

    rng = np.random.default_rng(args.seed)
    dp_rows = phase_kernel(rng, tag)
    report = dict(card=smi, dp=dp_rows)
    codes = rng.integers(0, 4, size=1 << 25).astype(np.uint8)
    fmi, report["build"] = phase_build(codes, dev, tag)
    report["locate"] = phase_locate(fmi, codes, rng, 1 << 20, tag)
    report["align"] = phase_align(fmi, codes, rng, 4096, tag)
    del fmi
    torch.cuda.empty_cache()
    report["cli"] = phase_cli(rng, ROOT / "build" / "chip_smoke", tag)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))

    at = next(r for r in dp_rows if (r["B"], r["L1"], r["L2"]) == (1024, 32, 32))
    print(json.dumps({"kernels": [{
        "name": "dp_wavefront",
        "route": "cuda",
        "source": "bwt_tpu_torch/csrc/dp_wavefront.cu",
        "replaces": "bwt_tpu/ops/pallas_align.py:44",
        "launches": report["align"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in dp_rows),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "shape": "B=1024 L1=32 L2=32",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
