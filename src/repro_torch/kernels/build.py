"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled by `nvcc` from the sources in this
package into ``build/kernels/`` at the repository root, at first use, as
a shared library with a plain C interface that `ctypes` loads.  The file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused.  Only the machine with the card runs
this: importing the module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (loaded library, build record); a process-wide cache of loaded
# shared objects, like the dynamic loader's own
_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return path


def build_library(name: str, sources: list[Path]) -> tuple[Path, dict]:
    """Compile `sources` into ``build/kernels/lib<name>-<hash>.so`` unless
    that file exists (the hash covers the sources and the ``*.cuh`` headers
    beside them).  Returns the path and a record with the path, the
    build's wall time (0.0 when reused) and the compiler's `-Xptxas -v`
    report."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    # the headers beside the sources, which they include
    for header in sorted({hdr for src in sources
                          for hdr in Path(src).parent.glob("*.cuh")}):
        h.update(header.read_bytes())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    if so.exists():
        return so, dict(path=so, seconds=0.0, report=log.read_text()
                        if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, so)
    return so, dict(path=so, seconds=seconds, report=proc.stderr)


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    hit = _LOADED.get(name)
    if hit is None:
        so, record = build_library(name, sources)
        hit = _LOADED[name] = (ctypes.CDLL(str(so)), record)
    return hit[0]


def build_record(name: str) -> dict:
    """The build record of a loaded library (see `build_library`)."""
    return _LOADED[name][1]
