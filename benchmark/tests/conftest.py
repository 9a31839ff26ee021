"""Puts the benchmark's folder on the import path of its tests, and gives
them a CPU rehearsal of a run at a tiny size.

Run them from the root of the checkout: ``python -m pytest benchmark/tests``.
"""

import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(BENCH) else 1, p)

TINY_GENOME = {"grch38-chr1": 20000, "ecoli-k12-mg1655": 6000}


def tiny_manifest(tmp: Path) -> tuple[dict, Path]:
    """BENCHMARK.json with each configuration cut to a tiny genome and each
    mix to batches of 512, written under ``tmp``; returns the manifest and
    the folder of its mixes."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in manifest["configs"]:
        c = json.loads((ROOT / conf["file"]).read_text())
        c["genome_length"] = TINY_GENOME.get(conf["name"], 5000)
        path = tmp / f"{conf['name']}.json"
        path.write_text(json.dumps(c))
        conf["file"] = str(path)
    traffic = tmp / "traffic"
    traffic.mkdir()
    for mix in (BENCH / "traffic").glob("*.json"):
        m = json.loads(mix.read_text())
        m.update(batch=512, pool_batches=3, check_batches=2)
        (traffic / mix.name).write_text(json.dumps(m))
    return manifest, traffic


@pytest.fixture
def rehearse(tmp_path):
    """``rehearse(workload, trace=False, control=None, seed=...)`` runs the
    cell on the CPU at a tiny size, past the harness's look for a card."""
    import cell

    manifest, traffic = tiny_manifest(tmp_path)

    def run(workload, trace=False, control=None, seed=2 ** 31 + 77,
            seconds=0.3):
        return cell.run_cell(manifest, workload, seed, seconds, trace, "cpu",
                             time.perf_counter(), control=control,
                             traffic_dir=traffic)

    return run
