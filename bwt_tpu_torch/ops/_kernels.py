"""Build and load the package's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain
C interface, at first use, into ``build/bwt_tpu_torch/`` at the root of
the checkout.  The file name carries a hash of the sources and flags,
so the library rebuilds only when they change.  It is loaded with
``ctypes``.  Importing this module needs no ``nvcc``; building does.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()


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
    ``verbose`` adds ``-Xptxas -v`` and echoes the compiler's report
    (registers, shared memory, spills) to stderr.  Raises on failure."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(p) for p in sources() if p.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if verbose:
        sys.stderr.write(res.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dp_wavefront_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib
