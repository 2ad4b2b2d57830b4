"""Native libraries of the port, built from source at first use.

Every library (the CUDA kernels under ``csrc/``, the shared volume I/O runtime
``csrc/volio.cpp`` at the repository root) is compiled into ``_build/`` under
a name keyed by the source's hash, so an edited source never loads a stale
library, and is then loaded with ``ctypes`` through a plain C interface.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built from csrc/*.cu "
                       "with the CUDA toolkit")


def build_library(source: Path, stem: str, compiler: Sequence[str],
                  libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` with ``[*compiler, -o, lib, source, *libs]`` into
    ``_build/<stem>_<hash>.so`` unless that file exists; return its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([*compiler, "-o", tmp, str(source), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {source.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def build_cuda(source: Path, stem: str) -> Path:
    """Build a ``.cu`` file with ``nvcc`` for ``sm_90a``."""
    return build_library(source, stem, [nvcc(), *NVCC_FLAGS])
