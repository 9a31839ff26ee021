"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; a run without a card fails."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bwt_tpu"}
PROGRAM = "bwt_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PROGRAM not in set(_imports(path)), path
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r); from reference import fm_plain;"
         " print(sorted({m.split('.')[0] for m in sys.modules}))"
         % str(BENCH)], capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {PROGRAM})


REHEARSAL = """
import sys, time, tempfile
from pathlib import Path
sys.path[:0] = [%r, %r]
import conftest, cell
with tempfile.TemporaryDirectory() as tmp:
    manifest, traffic = conftest.tiny_manifest(Path(tmp))
    for w in ("chr1.kmer30", "chr1.reads150"):
        for trace in (False, True):
            res, _ = cell.run_cell(manifest, w, 2 ** 31 + 3, 0.2, trace,
                                   "cpu", time.perf_counter(),
                                   traffic_dir=traffic)
            assert res["correct"], res
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def test_rehearsal_loads_no_jax():
    code = REHEARSAL % (str(BENCH / "tests"), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN


def test_run_without_a_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ecoli.kmer30",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
