"""bwt_tpu_torch stands alone: importing every one of its modules (the
multi-device ones of ``bwt_tpu_torch.parallel`` among them, the tp view's
peer blocks too), and running its CLI, loads neither jax nor bwt_tpu."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import bwt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bwt_tpu_torch.__path__,
                                               "bwt_tpu_torch.")
         if m.name != "bwt_tpu_torch.__main__"]  # runs the CLI
for name in names:
    importlib.import_module(name)
from bwt_tpu_torch import native
from bwt_tpu_torch.utils import profiling, results, sam
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bwt_tpu"))
print(len(names), bad)
"""

# the host modules of the CLI, imported by name as well as by the walk
HOST = ("bwt_tpu_torch.native", "bwt_tpu_torch.native.loader",
        "bwt_tpu_torch.utils.sam", "bwt_tpu_torch.utils.results",
        "bwt_tpu_torch.utils.profiling")

# the multi-device modules, over torch.distributed, and the loader of a tp
# view's blocks between processes (csrc/peer.cu)
PARALLEL = ("bwt_tpu_torch.parallel", "bwt_tpu_torch.parallel.mesh",
            "bwt_tpu_torch.parallel.peer",
            "bwt_tpu_torch.parallel.suffix_dist")


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120,
                          check=True)


def test_port_imports_no_jax():
    out = _run(["-c", _PROBE]).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30  # every module of the slices was imported
    assert out[1].strip() == "[]"


def test_host_modules_are_in_the_walk():
    import pkgutil

    import bwt_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(bwt_tpu_torch.__path__,
                                                   "bwt_tpu_torch.")}
    assert set(HOST) <= names and set(PARALLEL) <= names


def test_cli_runs_without_jax():
    probe = ("import runpy, sys; sys.argv = ['bwt_tpu_torch', '--help'];\n"
             "try:\n    runpy.run_module('bwt_tpu_torch', run_name='__main__')\n"
             "except SystemExit:\n    pass\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'bwt_tpu')))")
    res = _run(["-c", probe])
    assert "single_align" in res.stdout and "build_index" in res.stdout
    assert res.stdout.strip().splitlines()[-1] == "[]"
