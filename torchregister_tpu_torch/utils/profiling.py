"""Tracing and profiling helpers (counterpart of
``torchregister_tpu/utils/profiling.py``).

:func:`trace` names a region for ``torch.profiler`` (a ``record_function``
span) and, where CUDA is available, for NVTX; :func:`device_trace` records
one ``torch.profiler`` session, with the card's activity where there is a
card, into a Chrome trace; :class:`Throughput` keeps the benchmark's
accounting in its units (registrations/min, voxel-resamples/sec).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """Annotate a region for the profiler (and NVTX on a CUDA machine)."""
    nvtx = torch.cuda.is_available()  # a CPU build raises on any NVTX call
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where available) and write its
    Chrome trace into ``log_dir`` as ``trace_<pid>_<ns>.json``; yields the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class Throughput:
    """Accumulates wall time + work counters for benchmark reporting."""

    voxels_resampled: int = 0
    registrations: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, voxels: int = 0, registrations: int = 0) -> None:
        self.voxels_resampled += voxels
        self.registrations += registrations

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> dict:
        s = max(self.seconds, 1e-9)
        return {
            "seconds": round(s, 4),
            "registrations_per_min": round(60.0 * self.registrations / s, 3),
            "voxel_resamples_per_sec": round(self.voxels_resampled / s, 1),
        }
