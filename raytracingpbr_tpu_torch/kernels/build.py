"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each source ``csrc/<name>.cu`` becomes a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), at
first use, in ``build/raytracingpbr_tpu_torch/`` under the checkout. The
file name carries a hash of the source, the headers beside it and the
flags, so a stale build is never loaded. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. ``-Xptxas -v`` is
on: the compiler's report (registers, shared memory and spills of every
kernel) is kept beside each library as ``<library>.log``.

The flags keep ``-fmad=false`` and no fast math, so the march kernels round
every add and multiply as the plain PyTorch march does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "raytracingpbr_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# march: K1a, K1b, K1c; march_mxu: K1d; speedlight: K2; rng: the counter RNG;
# normal: the analytic surface normal
SOURCES = ("march", "march_mxu", "speedlight", "rng", "normal")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives for this source,
    these headers and these flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no build yet, all at once.
    Raises with the compiler's output of each build that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    jobs = []
    for name, lib in out.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        log = open(f"{tmp}.log", "w")
        jobs.append((lib, tmp, cmd, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for lib, tmp, cmd, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                          + Path(f"{tmp}.log").read_text())
            os.unlink(f"{tmp}.log")
            continue
        os.replace(f"{tmp}.log", f"{lib}.log")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    return build_all((name,))[name]


def ptxas_report(name: str) -> str:
    """The compiler's ``-Xptxas -v`` report of the built library."""
    return Path(f"{library_path(name)}.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once a process)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
