"""Device-code A/B of the port's kernels on one card: builds of one CUDA
source (this checkout's file, its ablations through ``-D`` defines or as
copies with a line changed, another checkout's file) compiled side by side, bound through one ``ctypes`` path
and timed in turns on outputs allocated beforehand, so that only the device
code differs. ``probes/profile_copies.py`` (the probe copies) and
``profile_warp.py`` (K2) drive it.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import native
from . import profile_sweep as ps
from .probes import time_ms


def build(stem: str, name: str, source: Path, defines) -> tuple[Path, str]:
    """Compile ``source`` with ``defines`` into ``_build/<stem>_ab_<name>.so``
    (always anew); return the library and ptxas's report."""
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = native.BUILD_DIR / f"{stem}_ab_{name}.so"
    proc = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", *defines,
                           "-o", str(lib), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} ({source}) failed:\n{proc.stderr}")
    return lib, proc.stderr


def build_all(stem: str, builds: dict) -> dict:
    """``{name: (source, defines)}`` -> ``{name: (library, report)}``, every
    ``nvcc`` run at once."""
    with ThreadPoolExecutor(len(builds)) as pool:
        return dict(zip(builds, pool.map(lambda n: build(stem, n, *builds[n]), builds)))


def resources(report: str, kernels) -> dict:
    """``{kernel: "N registers, S bytes spill"}`` for the entries of ptxas's
    report whose names hold ``<k>_kernel`` for a ``k`` of ``kernels``,
    demangled where ``c++filt`` is found."""
    got, entry, spill = {}, None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and any(k + "_kernel" in entry for k in kernels):
            got[entry] = f"{m.group(1)} registers, {spill} bytes spill"
    if shutil.which("c++filt") and got:
        names = subprocess.run(["c++filt"], input="\n".join(got), capture_output=True,
                               text=True).stdout.split("\n")
        got = dict(zip(names, got.values()))
    return got


def bind(lib: Path, entries: dict) -> dict:
    """The entry points ``{name: (restype, argtypes)}`` of ``lib``."""
    handle = ctypes.CDLL(str(lib))
    fns = {}
    for name, (restype, argtypes) in entries.items():
        fn = getattr(handle, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
        fns[name] = fn
    return fns


def in_turns(calls: dict, order) -> dict:
    """``calls``: ``{(case, build): (call, name)}``, each call one launch
    (of one kernel or of a few in sequence). Every call timed with CUDA
    events (``ms``, host included) and then with ``torch.profiler``
    (``device_ms``: the spans of the kernels whose names hold ``name``,
    summed a call), each pass over the builds in ``order`` and then
    reversed, so each gets two readings; every event timing comes before any
    profiler session (a session slows later launches on the host).
    Returns ``{case: {"ms": {build: [a, b]}, "device_ms": {...}}}``."""
    dev = torch.device("cuda")
    turns = list(order) + list(order)[::-1]
    rows = {case: {"ms": {n: [] for n in order}, "device_ms": {n: [] for n in order}}
            for case, _ in calls}
    for name in turns:
        for (case, n), (call, _) in calls.items():
            if n == name:
                rows[case]["ms"][name].append(time_ms(call, dev))
    for name in turns:
        for (case, n), (call, kernel) in calls.items():
            if n == name:
                rows[case]["device_ms"][name].append(ps.device_ms(call, name=kernel))
    return rows
