"""Build and load the package's CUDA kernels.

``csrc/*.cu`` (which include ``csrc/*.cuh``) compile with ``nvcc`` into
one shared library with a plain C interface, at first use, into
``build/bwt_tpu_torch/`` at the root of the checkout: one ``nvcc`` per
source, all started together, then one link.  The file name carries a
hash of the sources and flags, so the library rebuilds only when they
change.  It is loaded with ``ctypes``.  Importing this module needs no
``nvcc``; building does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bwt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()
LAST_REPORT = ""  # what the compiler said in the last build(verbose=True)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "bwt_tpu_torch CUDA kernels are built from csrc/ at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libbwt_tpu_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is already built.
    ``verbose`` adds ``-Xptxas -v``, echoes the compiler's report
    (registers, stack frame, spills) to stderr and keeps it in
    ``LAST_REPORT``.  Raises on failure."""
    global LAST_REPORT
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objdir = BUILD_DIR / f"obj.{os.getpid()}"
    objdir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.suffix == ".cu"]
    cmds = [[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", str(p),
             "-o", str(objdir / f"{p.stem}.o")] for p in cu]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *(str(objdir / f"{p.stem}.o") for p in cu)]
    try:
        for cmd, proc, so, se in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{so}{se}")
            if verbose:
                sys.stderr.write(se)
        if verbose:
            LAST_REPORT = "".join(se for *_, se in results)
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with exit code {res.returncode}:\n"
                f"{' '.join(link)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            LL = ctypes.POINTER(ctypes.c_longlong)
            PP = ctypes.POINTER(ctypes.c_void_p)
            IP = ctypes.POINTER(ctypes.c_int)
            IX, TB = [P, I, I, P, P], [P, I, I]
            for name, argtypes in (
                    ("dp_wavefront_launch", [P] * 4 + [I] * 7 + [P]),
                    ("dp_stitch_plan", [I, I, I, I, LL]),
                    ("dp_stitch_launch",
                     [P, I, I, P, I] + [P] * 8 + [I] * 9 + [P] * 4),
                    # the index as (table, rows, per, C, endloc) and a
                    # sample table as (table, rows, per): per > 0 is a tp
                    # view (search._index_args, search._sample_table)
                    ("backward_search_launch",
                     [P, P, I, I, I, I, I, P, P, P, I, I] + IX + [P, P]),
                    ("unc_sa_launch",
                     [P, I] + IX + TB + [I, I, I, I, P, P, P]),
                    ("anchor_scan_launch",
                     [P, I, P, I, I, I, I] + IX + TB + [I, I, P, P]),
                    ("locate_launch",
                     [P, P, I, I, P, I, I] + IX + TB + [I, I, P, P]),
                    ("service_launch",
                     [P, I, I, I] + [P] * 7 + [I] * 4 + [P, I, I] + IX + TB
                     + [I, I] + TB + [P, P]),
                    ("isa_window_launch",
                     [P, P, I, I] + IX + TB + [I, I, P, P]),
                    ("seed_rows_launch", [I] + IX + [P, P]),
                    ("rnaseq_automaton_launch",
                     [P, I, I, P, P, I, I, I, I, P, I, I] + IX + TB + [I, I]
                     + TB + [P, P]),
                    ("align_automaton_launch",
                     [P, I, I, P, P, I, I, I, I, P, I, I] + IX + TB + [I, I]
                     + TB + [P, P]),
                    ("dp_log_stitch_launch",
                     [P, I, P, I, P, I, P, P] + [I] * 9 + [P, P, P]),
                    ("compose_launch", [P, I, P, I, I, I, P, P]),
                    # csrc/peer.cu: a tp view's blocks between processes
                    ("peer_alloc", [I, ctypes.c_size_t, PP]),
                    ("peer_free", [P]),
                    ("peer_export", [P, P]),
                    ("peer_open", [I, P, PP]),
                    ("peer_close", [P]),
                    ("peer_bus_id", [I, ctypes.c_char_p, I]),
                    ("peer_device_of", [ctypes.c_char_p, IP]),
                    ("peer_can_access", [I, I, IP])):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
