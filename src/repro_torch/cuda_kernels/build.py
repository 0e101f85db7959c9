"""Build the port's CUDA sources into plain-C shared libraries, at first
use, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports ``extern "C"`` launchers and includes no
PyTorch header, so ``nvcc`` builds it in seconds.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of its
source, every other ``csrc/`` source (the shared headers, and a source
another includes) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is; the build's
nvcc/ptxas output is kept beside it.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuiltLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    log: str          # nvcc/ptxas output of the build (also an earlier one)
    seconds: float    # compile time (0.0 when loaded from an earlier build)


_LOADED: Dict[str, BuiltLibrary] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # every other source too: the headers, and any .cu a source includes
    others = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cu*")))
    digest = hashlib.sha256(src + others
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def load_library(name: str) -> BuiltLibrary:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name in _LOADED:
        return _LOADED[name]
    out = _target(name)
    log, seconds = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log, seconds = proc.stdout, time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    elif out.with_suffix(".log").exists():
        log = out.with_suffix(".log").read_text()
    built = BuiltLibrary(name, out, ctypes.CDLL(str(out)), log, seconds)
    _LOADED[name] = built
    return built


def ptxas_lines(log: str) -> List[str]:
    """The register / shared-memory / spill lines of a ``-Xptxas -v`` log."""
    keys = ("registers", "spill", "smem", "Compiling entry")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]
