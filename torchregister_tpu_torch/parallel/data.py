"""The ``data`` axis: a cohort's pairs split into shards over a mesh, each
shard's pairs registered on its device by the batched loops, the results put
back in pair order (``register_cohort(mesh=)``,
``make_cascade_batch_fn(mesh=)``); on a ``data x space`` mesh each data
position's row of slabs (:func:`run_rows`, ``make_cascade_batch_fn(mesh=,
spatial_axis=)``).

Pairs are independent, so shards exchange nothing. Each pair of a shard
equals its single run to the bit (the batched loops' rule), so each pair of
a sharded call equals the unsharded call's. One host thread runs each
distinct device's shards, one after another; shards that share a device (a
mesh that names one card, or the CPU, more than once) run in the caller's
thread when no other device is in the mesh.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .mesh import Mesh, batch_sharding


def shard_devices(mesh: Mesh, axis: str = "data") -> list:
    """The devices of the mesh's ``axis``, in order (the other axes at their
    first position: a batch sharding holds one copy along them)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"Resource axis: {axis} of PartitionSpec('{axis}',) is not found in "
                         f"mesh: {mesh.axis_names}.")
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(grid.reshape(grid.shape[0], -1)[:, 0])


def concat(results: Sequence, device: torch.device):
    """Results of the shards (each with a leading pair axis) as one, in pair
    order on ``device``: tensors concatenated, lists joined, dicts and named
    tuples field by field; None stays None."""
    first = results[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([r.to(device) for r in results])
    if isinstance(first, list):
        return [x for r in results for x in r]
    if isinstance(first, dict):
        return {k: concat([r[k] for r in results], device) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(concat([getattr(r, f) for r in results], device)
                             for f in first._fields))
    raise TypeError(f"cannot join shard results of type {type(first).__name__}")


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_rows(rows: Sequence, job: Callable[[int], object]) -> list:
    """``job(r)`` for each row ``r`` of a ``data x space`` mesh (``rows``:
    each data position's 1-D space mesh), the results in row order: rows
    whose devices are disjoint from every other row's run in threads of
    their own (each with its first device current), rows that share a
    device one after another in one thread."""
    keys = [tuple(m.device_list) for m in rows]
    sets = [set(k) for k in dict.fromkeys(keys)]
    shared = any(a & b for i, a in enumerate(sets) for b in sets[i + 1:])
    return run_shards([keys[0][0] if shared else k[0] for k in keys], job)


def run_shards(devices: Sequence[torch.device], job: Callable[[int], object]) -> list:
    """``job(k)`` for each shard k (on ``devices[k]``), one host thread a
    distinct device running its shards in order; the results in shard
    order. One distinct device runs in the caller's thread."""
    groups: dict = {}
    for k, d in enumerate(devices):
        groups.setdefault(d, []).append(k)
    out: list = [None] * len(devices)

    def run(device):
        with _on(device):
            for k in groups[device]:
                out[k] = job(k)

    if len(groups) == 1:
        run(next(iter(groups)))
        return out
    with ThreadPoolExecutor(len(groups)) as pool:
        for f in [pool.submit(run, d) for d in groups]:
            f.result()
    return out


class Shards(NamedTuple):
    """A cohort split over a mesh's ``data`` axis: each shard's device and
    its pairs' indices."""

    devices: list
    pairs: list

    @classmethod
    def of(cls, mesh: Mesh, B: int, axis: str = "data") -> "Shards":
        devices = shard_devices(mesh, axis)
        n = len(devices)
        if B % n:
            raise ValueError(
                f"One of device_put args was given the sharding of {batch_sharding(mesh, axis)}, "
                f"which implies that the global size of its dimension 0 should be divisible "
                f"by {n}, but it is equal to {B}")
        m = B // n
        return cls(devices, [list(range(k * m, (k + 1) * m)) for k in range(n)])
