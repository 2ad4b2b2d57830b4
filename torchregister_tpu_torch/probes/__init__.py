"""The benchmark probes' kernels on the card, with ports of the functions of
the JAX probe scripts (``benchmarks/probe_hatgather.py``,
``benchmarks/probe_roi_stages.py``):

    python -m torchregister_tpu_torch.probes.hatgather [p1 p2 p3 p4 p5]
    python -m torchregister_tpu_torch.probes.roi_stages

Each probe function runs on the card unless it is given ``device='cpu'``,
where the kernels' plain versions run; a failed check raises. This module holds what
the two share: the host check of the index data and the timer.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


def checked_index(idx, cols: Sequence[int], highs: Sequence[int], what: str,
                  device: torch.device) -> torch.Tensor:
    """Host index data (numpy, a list or a CPU tensor of int32 values; a 1-D
    array is one column) checked column by column, ``0 <= idx[:, c] <=
    high`` for each ``(c, high)`` of ``cols`` and ``highs``, then put on
    ``device`` as contiguous int32. The kernels read what they are given, so
    an index out of range raises here."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        raise ValueError(f"{what} are host data: pass numpy or a CPU tensor")
    host = np.asarray(idx.numpy() if isinstance(idx, torch.Tensor) else idx)
    if host.ndim == 1:
        host = host[:, None]
    if not np.issubdtype(host.dtype, np.integer) or host.ndim != 2:
        raise TypeError(f"{what} must be a 1-D or 2-D integer array, got {host.dtype} "
                        f"{host.shape}")
    for c, high in zip(cols, highs):
        col = host[:, c]
        if col.size and (col.min() < 0 or col.max() > high):
            raise ValueError(f"{what}: column {c} leaves [0, {high}] "
                             f"(min {col.min()}, max {col.max()})")
    return torch.from_numpy(np.ascontiguousarray(host, dtype=np.int32)).to(device)


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``: CUDA events on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def clock_name(device: torch.device) -> str:
    return "CUDA events" if device.type == "cuda" else "CPU, host clock"
