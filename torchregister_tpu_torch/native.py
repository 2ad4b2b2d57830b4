"""Native libraries of the port, built from source at first use, and the
one launch path of its kernels.

Every library (the CUDA kernels under ``csrc/``, the shared volume I/O runtime
``csrc/volio.cpp`` at the repository root) is compiled into ``_build/`` under
a name keyed by the source's hash, so an edited source never loads a stale
library, and is then loaded with ``ctypes`` through a plain C interface.
Every kernel wrapper launches through :meth:`Library.launch`, and each
kernel module registers its launch counters (:func:`count_launches`), so that
the replays of a captured CUDA graph (``engines/graph.py``) add to them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import torch

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


class Library:
    """One CUDA source of the port, built for ``sm_90a`` at first use, and
    the one launch path of every kernel wrapper.

    ``entries`` maps each C entry point to ``(restype, argtypes)``; the
    ``ctypes`` functions are bound once, with pointers as ``c_void_p`` (without
    ``argtypes`` ctypes passes a pointer as a 32-bit int and cuts it). A
    launching entry takes the stream as its last argument (in its
    ``argtypes``; :meth:`launch` supplies it) and returns
    ``cudaGetLastError()`` after its launch.
    """

    def __init__(self, source: Path, stem: str, entries: dict):
        self.source, self.stem, self.entries = source, stem, entries
        self._fns: dict | None = None

    def build(self) -> Path:
        """Compile the source into ``_build/`` and return its path."""
        return build_cuda(self.source, self.stem)

    def fns(self) -> dict:
        """The bound entry points, building and loading the library first."""
        if self._fns is None:
            lib = ctypes.CDLL(str(self.build()))
            fns = {}
            for name, (restype, argtypes) in self.entries.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, list(argtypes)
                fns[name] = fn
            self._fns = fns
        return self._fns

    def launch(self, name: str, t: torch.Tensor, *args) -> None:
        """Call entry ``name`` with ``args`` and the current stream of
        ``t``'s device (a CUDA tensor the wrapper has checked), making that
        device current only when it is not; raise on a non-zero return."""
        fn = (self._fns or self.fns())[name]
        index = t.get_device()
        # Two private bindings, each cheaper on the card than its public
        # form (PERF.md, launch path): torch.cuda.current_device() without
        # its lazy-init check (a CUDA tensor exists, so CUDA is initialised),
        # and the raw handle of the device's current stream, which PyTorch's
        # own Triton launcher reads, where torch.cuda.current_stream(index)
        # .cuda_stream builds a Stream object. The stream is read on every
        # launch, never cached: a caller inside torch.cuda.stream(s) gets s.
        if index == torch._C._cuda_getDevice():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def check_operands(what: str, *operands) -> None:
    """Each ``(tensor, dtype)`` of ``operands`` of that dtype, contiguous, and
    on the first one's CUDA device, in that order of checks; each raises."""
    for t, dtype in operands:
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {dtype}, got {t.dtype}")
    for t, _ in operands:
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous tensors")
    index = operands[0][0].get_device()
    for t, _ in operands:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{what} needs its tensors on one CUDA device")


# module name -> the names of its launch counters: module-level ints, or
# dicts of ints (a count by kernel or form)
COUNTERS: dict = {}
# every change of a registered counter holds this lock (through ``bump``):
# a ``+=`` (a read, an add and a write) from threads that drive several
# devices at once (``parallel/data.run_shards``) would otherwise lose counts
COUNT_LOCK = threading.Lock()


def count_launches(module: str, *names: str) -> None:
    """Register ``module``'s launch counters by name (called once, at the
    module's import)."""
    COUNTERS[module] = names


def launch_counts() -> dict:
    """Every registered counter: ``{(module, name, key): n}``, ``key`` None
    for an int counter."""
    out = {}
    with COUNT_LOCK:
        for module, names in COUNTERS.items():
            mod = sys.modules[module]
            for name in names:
                value = getattr(mod, name)
                if isinstance(value, dict):
                    out.update({(module, name, key): n for key, n in value.items()})
                else:
                    out[(module, name, None)] = value
    return out


def _add(module: str, name: str, key, n: int) -> None:
    mod = sys.modules[module]
    if key is None:
        setattr(mod, name, getattr(mod, name) + n)
    else:
        getattr(mod, name)[key] += n


def bump(module: str, **adds) -> None:
    """Add to ``module``'s counters under :data:`COUNT_LOCK`: ``name=n`` to
    an int counter, ``name={key: n}`` to a dict counter's entries."""
    with COUNT_LOCK:
        for name, n in adds.items():
            if isinstance(n, dict):
                for key, m in n.items():
                    _add(module, name, key, m)
            else:
                _add(module, name, None, n)


def add_launch_counts(counts: dict, times: int) -> None:
    """Add ``times`` x each of ``counts`` (as :func:`launch_counts` gives
    them) to the registered counters: a graph's launches times its replays,
    or -1 times the launches its capture counted but never ran."""
    with COUNT_LOCK:
        for (module, name, key), n in counts.items():
            _add(module, name, key, n * times)


class _Once(torch.autograd.Function):
    """Its input's values; its backward raises."""

    @staticmethod
    def forward(ctx, x, name, *links):
        ctx.name = name
        return x.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(f"{ctx.name} is differentiable once: a second derivative through "
                           "its kernels is not implemented")


def differentiable_once(backward):
    """Mark a kernel Function's ``backward`` as differentiable once: under
    ``create_graph`` each gradient it returns passes through a node whose
    backward raises, linked to every cotangent and saved tensor that
    requires grad, so a second derivative through the kernels raises rather
    than miss their terms. (``torch.autograd.function.once_differentiable``
    links its error node to nothing, so ``torch.autograd.grad`` prunes it
    whenever another path reaches the inputs: a Hessian through it comes out
    without the kernel's terms, silently.) Without ``create_graph`` it costs
    nothing."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        with torch.no_grad():
            out = backward(ctx, *grads)
        if not torch.is_grad_enabled():
            return out
        links = [t for t in (*grads, *ctx.saved_tensors)
                 if isinstance(t, torch.Tensor) and t.requires_grad]
        if not links:
            return out
        name = backward.__qualname__.rsplit(".", 1)[0]
        one = not isinstance(out, tuple)
        outs = tuple(_Once.apply(o, name, *links) if isinstance(o, torch.Tensor) else o
                     for o in ((out,) if one else out))
        return outs[0] if one else outs

    return wrapper
