"""Runs one cell of the benchmark once and prints its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control <name>]

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
window.  ``--control`` puts a control (``controls/<name>.py``) in the
program's place, to show that the check finds it wrong.  Without a CUDA
card, with fewer cards than the cell asks for, without the program in the
checkout, or with JAX or the JAX package loaded, it exits nonzero and
prints no result.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bwt_tpu"}  # whole top-level names


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its CUDA kernels into ``build/bwt_tpu_torch/``; a
    Triton or extension build, should the program come to have one, lands
    here too, since later changes may not edit this file."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    _caches()
    sys.path.insert(1, str(ROOT))
    marks = [("python and arguments", time.perf_counter())]
    import torch

    marks.append(("import torch", time.perf_counter()))

    chips = int(cells[args.workload]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); {found} found",
              file=sys.stderr)
        return 2
    marks.append(("CUDA driver", time.perf_counter()))
    import bwt_tpu_torch

    marks.append(("import bwt_tpu_torch", time.perf_counter()))

    if ROOT not in Path(bwt_tpu_torch.__file__).resolve().parents:
        print(f"bwt_tpu_torch comes from {bwt_tpu_torch.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    import cell

    result, notes = cell.run_cell(manifest, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda",
                                  T0, control=args.control)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    notes.insert(0, "imports: " + ", ".join(
        f"{label} {b - a:.3f} s" for (_, a), (label, b)
        in zip([("start", T0)] + marks, marks)))
    for line in notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
