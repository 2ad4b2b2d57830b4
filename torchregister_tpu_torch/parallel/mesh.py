"""Device meshes, placements and sharded tensors (counterpart of
``torchregister_tpu/parallel/mesh.py``).

One Python process drives every shard, as one JAX controller drives its
mesh: a :class:`Mesh` is a grid of ``torch.device`` s with named axes, a
:class:`NamedSharding` says which tensor dims split over which mesh axes,
and :func:`shard` (``jax.device_put``) lays a tensor out as a
:class:`Sharded`, one block a mesh position, each block a tensor on its
position's device. :func:`gather` reads the whole tensor back. There is no
``torch.distributed``: a copy between shards is a copy between devices (on
one card, a copy within it).

A mesh may name one device more than once: that device then holds several
shards (one card, or the CPU in the tests, stands for many, as the JAX
tests' forced CPU devices do). Two axes are used: ``data`` splits the pairs
of a cohort (``parallel/cohort.py``, ``make_cascade_batch_fn``), which need
no copies between shards; ``space`` splits one spatial dim of a volume into
slabs, whose sweeps and filters read halos from their neighbours
(``parallel/halo.py``). As in JAX, a dim splits only into equal blocks.

This module imports nothing else of the package, so that the ops can look
for a :class:`Sharded` without an import cycle.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``):
    ``devices`` an object array of ``torch.device`` s of the mesh's shape,
    ``shape`` a dict of each axis's size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} axes needs as many names, got "
                             f"{tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must differ, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The devices in mesh order (row-major)."""
        return list(self.devices.flat)

    @property
    def distinct_devices(self) -> list:
        """Each device once, in order of first appearance."""
        return list(dict.fromkeys(self.device_list))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n!r}: {s}" for n, s in self.shape.items())
        return f"Mesh({axes}, devices={[str(d) for d in self.device_list]})"


def make_mesh(shape: Sequence[int] | None = None, axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; none raises, and
    there is no fallback to the CPU). Default shape: a 1-D ``data`` mesh
    over all of them. A shape smaller than the device list takes its first
    devices; a device may appear more than once."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass devices=, e.g. ['cpu'] * 8, "
                               "to lay a mesh over the CPU)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"mesh shape {shape} and axis names {tuple(axis_names)} differ in "
                         "length")
    size = math.prod(shape)
    if size < 1 or size > len(devices):
        raise ValueError(f"a mesh of shape {shape} needs {size} devices, got "
                         f"{len(devices)}")
    grid = np.empty(size, dtype=object)
    for i, d in enumerate(devices[:size]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


class NamedSharding:
    """A placement (``jax.sharding.NamedSharding``): ``spec[i]`` names the
    mesh axis that tensor dim ``i`` splits over, or None; dims past the spec
    are whole. Mesh axes no dim names hold a copy of the block."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        spec = tuple(spec)
        for a in spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"Resource axis: {a} of PartitionSpec{spec} is not found "
                                 f"in mesh: {mesh.axis_names}.")
        named = [a for a in spec if a is not None]
        if len(set(named)) != len(named):
            raise ValueError(f"a mesh axis splits one dim at most, got {spec}")
        self.mesh, self.spec = mesh, spec

    def sharded_dims(self) -> list:
        return [i for i, a in enumerate(self.spec) if a is not None]

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec})"


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """The leading (batch) axis split over ``axis``."""
    return NamedSharding(mesh, (axis,))


def cohort_sharding(mesh: Mesh, ndim: int = 3, spatial_axis: int | None = None,
                    data_axis: str = "data", space_axis: str = "space") -> NamedSharding:
    """A batched ``[B, C, *S]`` cohort: the batch over ``data_axis`` and,
    optionally, spatial dim ``spatial_axis`` over ``space_axis`` (the
    ``data x space`` layout of a 2-D mesh)."""
    spec = [data_axis, None] + [None] * ndim
    if spatial_axis is not None:
        spec[2 + spatial_axis] = space_axis
    return NamedSharding(mesh, spec)


def volume_sharding(mesh: Mesh, spatial_axis: int = 0, mesh_axis: str = "space",
                    ndim: int = 3) -> NamedSharding:
    """One ``[N, C, *S]`` volume with spatial dim ``spatial_axis`` split into
    slabs over ``mesh_axis``."""
    spec = [None, None] + [None] * ndim
    spec[2 + spatial_axis] = mesh_axis
    return NamedSharding(mesh, spec)


class Sharded:
    """A tensor laid out over a mesh (a sharded ``jax.Array``): ``blocks``
    an object array of the mesh's shape, each entry the block of that mesh
    position, a tensor on its device. ``shape`` is the whole tensor's."""

    def __init__(self, blocks: np.ndarray, sharding: NamedSharding, shape: Sequence[int]):
        self.blocks, self.sharding = blocks, sharding
        self.shape = torch.Size(shape)
        first = blocks.flat[0]
        self.dtype = first.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where the parameters of a sharded
        optimization live)."""
        return self.mesh.device_list[0]

    @property
    def shards(self) -> list:
        """The blocks in mesh order."""
        return list(self.blocks.flat)

    def numel(self) -> int:
        return math.prod(self.shape)

    def map(self, fn) -> "Sharded":
        """``fn`` of every block (each block's shape and place kept)."""
        out = np.empty(self.blocks.shape, dtype=object)
        for idx in np.ndindex(self.blocks.shape):
            out[idx] = fn(self.blocks[idx])
        return Sharded(out, self.sharding, self.shape)

    def to(self, dtype: torch.dtype) -> "Sharded":
        """Every block cast to ``dtype`` (each on its device)."""
        return self if dtype == self.dtype else self.map(lambda b: b.to(dtype))

    def chunk(self, pairs: int) -> tuple:
        """``torch.chunk`` along the leading (pair) axis, which must be
        whole in every block: ``pairs`` tensors laid out as this one, each
        block a view of this one's. Each block is split by one
        ``torch.chunk``, one pair too, as ``losses.pair_slices`` splits a
        tensor: the pairs' gradients then reach each block through one node
        a call, so a pair's criteria add into it in the same order in a batch
        as alone."""
        if self.sharding.spec and self.sharding.spec[0] is not None:
            raise ValueError(f"chunk splits a whole leading axis, got {self.sharding}")
        parts = [torch.chunk(t, pairs) for t in self.shards]
        shape = (self.shape[0] // pairs, *self.shape[1:])
        return tuple(from_blocks([p[b] for p in parts], self.sharding, shape)
                     for b in range(pairs))

    def slab_axis(self) -> tuple[int, str]:
        """``(dim, mesh_axis)`` of the one dim this tensor splits over a
        1-D mesh axis; raises for any other layout."""
        dims = self.sharding.sharded_dims()
        if len(dims) != 1 or any(s > 1 for a, s in self.mesh.shape.items()
                                 if a != self.sharding.spec[dims[0]]):
            raise ValueError(f"expected a tensor split along one dim over the mesh, got "
                             f"{self.sharding}")
        return dims[0], self.sharding.spec[dims[0]]

    def ordered_blocks(self) -> list:
        """The blocks in the order a sum over the whole tensor adds them: a
        tensor split along one dim over a 1-D mesh axis gives its slabs in
        order; a batch split over one mesh axis and a spatial dim over the
        other (``cohort_sharding`` with a spatial axis) gives them
        batch-axis-major, then slab. Raises for any other layout."""
        dims = self.sharding.sharded_dims()
        if len(dims) != 2 or dims[0] != 0 or len(self.mesh.axis_names) != 2:
            self.slab_axis()
            return self.shards
        grid = self.blocks
        if self.mesh.axis_names.index(self.sharding.spec[0]) == 1:
            grid = grid.T
        return list(grid.flat)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"sharding={self.sharding!r})")


def _block_index(shape, sharding: NamedSharding, idx: tuple) -> list:
    """``(dim, start, size)`` of each split dim of the block at mesh
    position ``idx``; raises as ``jax.device_put`` does for a dim that does
    not split evenly."""
    mesh = sharding.mesh
    out = []
    for dim in sharding.sharded_dims():
        axis = sharding.spec[dim]
        n = mesh.shape[axis]
        if dim >= len(shape):
            raise ValueError(f"{sharding} splits dim {dim} of a {len(shape)}-D tensor")
        if shape[dim] % n:
            raise ValueError(
                f"One of device_put args was given the sharding of {sharding}, which implies "
                f"that the global size of its dimension {dim} should be divisible by {n}, but "
                f"it is equal to {shape[dim]} (full shape: {tuple(shape)})")
        size = shape[dim] // n
        out.append((dim, idx[mesh.axis_names.index(axis)] * size, size))
    return out


def shard(x, sharding: NamedSharding) -> Sharded:
    """Lay ``x`` (a tensor or an array) out as ``sharding`` says: each block
    copied to its mesh position's device (``jax.device_put``)."""
    if isinstance(x, Sharded):
        x = gather(x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        part = x
        for dim, start, size in _block_index(x.shape, sharding, idx):
            part = part.narrow(dim, start, size)
        dev = mesh.devices[idx]
        block = torch.empty(part.shape, dtype=part.dtype, device=dev)
        blocks[idx] = block.copy_(part)
    return Sharded(blocks, sharding, x.shape)


def from_blocks(blocks: Sequence[torch.Tensor], sharding: NamedSharding,
                shape: Sequence[int] | None = None) -> Sharded:
    """A :class:`Sharded` of existing blocks in mesh order (each already on
    its device); ``shape`` defaults to the blocks' along the split dims."""
    grid = np.empty(sharding.mesh.devices.shape, dtype=object)
    for i, b in enumerate(blocks):
        grid.flat[i] = b
    if shape is None:
        shape = list(blocks[0].shape)
        for dim in sharding.sharded_dims():
            shape[dim] *= sharding.mesh.shape[sharding.spec[dim]]
    return Sharded(grid, sharding, shape)


def gather(xs, device=None) -> torch.Tensor:
    """The whole tensor of ``xs`` (a :class:`Sharded`) on ``device`` (default
    the mesh's first device), its blocks put back in place; a tensor is
    returned as it is."""
    if isinstance(xs, torch.Tensor):
        return xs if device is None else xs.to(device)
    device = xs.device if device is None else torch.device(device)
    out = torch.empty(xs.shape, dtype=xs.dtype, device=device)
    mesh = xs.sharding.mesh
    for idx in np.ndindex(mesh.devices.shape):
        view = out
        for dim, start, size in _block_index(xs.shape, xs.sharding, idx):
            view = view.narrow(dim, start, size)
        view.copy_(xs.blocks[idx])
    return out


def row_meshes(mesh: Mesh, data_axis: str = "data", space_axis: str = "space") -> list:
    """The 1-D ``space_axis`` mesh of each position of ``data_axis`` of a
    ``data x space`` mesh, in order: the devices of that row of slabs."""
    for a in (data_axis, space_axis):
        if a not in mesh.axis_names:
            raise ValueError(f"Resource axis: {a} is not found in mesh: {mesh.axis_names}.")
    if len(mesh.axis_names) != 2:
        raise ValueError(f"a data x space mesh has two axes, got {mesh.axis_names}")
    grid = mesh.devices
    if mesh.axis_names.index(data_axis) == 1:
        grid = grid.T
    return [Mesh(row.copy(), (space_axis,)) for row in grid]


def space_rows(xs: Sharded, rows: Sequence[Mesh]) -> list:
    """Each ``data`` position's row of slabs of ``xs`` (laid out by
    :func:`cohort_sharding` with a spatial axis over ``rows``' mesh): a
    ``Sharded`` of that position's pairs over its row's 1-D ``space`` mesh,
    split along the same dim (the blocks are ``xs``'s)."""
    spec = xs.sharding.spec
    data_axis, space_axis = spec[0], rows[0].axis_names[0]
    if data_axis is None or space_axis not in spec:
        raise ValueError(f"space_rows needs the pairs over a data axis and a spatial dim over "
                         f"{space_axis!r}, got {xs.sharding}")
    dim = spec.index(space_axis)
    grid = xs.blocks
    if xs.mesh.axis_names.index(data_axis) == 1:
        grid = grid.T
    shape = (xs.shape[0] // len(rows), *xs.shape[1:])
    row_spec = tuple(space_axis if i == dim else None for i in range(len(spec)))
    return [Sharded(grid[r].copy(), NamedSharding(rows[r], row_spec), shape)
            for r in range(len(rows))]


def join_rows(parts: Sequence[Sharded], mesh: Mesh, data_axis: str = "data") -> Sharded:
    """The inverse of :func:`space_rows`: rows of slabs (each a ``Sharded``
    of one data position's pairs over its 1-D space mesh) as one tensor over
    ``mesh``, its pairs split over ``data_axis`` in row order."""
    first = parts[0]
    dim, space_axis = first.slab_axis()
    grid = np.stack([p.blocks for p in parts])
    if mesh.axis_names.index(data_axis) == 1:
        grid = grid.T
    spec = [data_axis] + [None] * (first.ndim - 1)
    spec[dim] = space_axis
    shape = (first.shape[0] * len(parts), *first.shape[1:])
    return Sharded(grid.copy(), NamedSharding(mesh, spec), shape)


def ordered_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``parts`` (one a shard) added in their order on ``device``: the
    shards' partial sums reduced in a fixed order on the mesh's first
    device."""
    total = parts[0].to(device)
    for t in parts[1:]:
        total = total + t.to(device)
    return total
