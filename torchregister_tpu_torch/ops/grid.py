"""Coordinate grids (counterpart of ``torchregister_tpu/ops/grid.py``).

* *Normalized* coordinates live in ``[-1, 1]`` per axis, with the torch pixel
  centre conventions: index ``i`` of an axis of size ``S`` sits at
  ``(2i + 1) / S - 1`` (``align_corners=False``) or ``2i / (S - 1) - 1``
  (``align_corners=True``).
* In a *grid tensor* (``[..., d]``) the last axis is ordered innermost-first
  (``x`` = last spatial dim), as ``F.affine_grid`` and ``F.grid_sample`` take
  it.
* *Index* coordinates are plain array indices, outermost-first.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _axis_coords(size: int, align_corners: bool, dtype=torch.float32,
                 device=None, rows: tuple | None = None) -> torch.Tensor:
    """The normalized coordinates of an axis of ``size`` voxels (``rows =
    (start, count)``: of those voxels only, each the whole axis's value)."""
    start, count = (0, size) if rows is None else rows
    i = torch.arange(start, start + count, dtype=dtype, device=device)
    if align_corners:
        if size == 1:
            return torch.zeros((count,), dtype=dtype, device=device)
        return 2.0 * i / (size - 1) - 1.0
    return (2.0 * i + 1.0) / size - 1.0


def normalized_grid(spatial: Sequence[int], align_corners: bool = False,
                    dtype=torch.float32, device=None, box=None) -> torch.Tensor:
    """Identity grid of normalized coordinates ``[*spatial, d]``, last axis
    innermost-first; ``box`` (``(start, count)`` an axis, or None for the
    whole axis) takes a box of the grid, each value the whole grid's."""
    box = (None,) * len(spatial) if box is None else box
    axes = [_axis_coords(s, align_corners, dtype, device, r) for s, r in zip(spatial, box)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(mesh[::-1], dim=-1)


def affine_grid(theta: torch.Tensor, spatial: Sequence[int], align_corners: bool = False,
                dtype=torch.float32, box=None) -> torch.Tensor:
    """``F.affine_grid`` semantics: ``theta [N, d, d+1]`` -> grid
    ``[N, *spatial, d]``. Row ``r`` of theta maps the homogeneous normalized
    output coordinate ``(x, y[, z], 1)`` to source coordinate ``r``; computed
    as explicit multiply-adds in the JAX package's order. ``box``: a box of
    the grid (:func:`normalized_grid`), each value the whole grid's."""
    d = len(spatial)
    base = normalized_grid(spatial, align_corners, dtype, theta.device, box)  # [*S, d]
    theta = theta.to(dtype)
    bcast = theta.reshape(theta.shape[:1] + (1,) * d + theta.shape[1:])
    out = bcast[..., :, d]  # translation column [N, 1...1, d]
    for k in range(d):
        out = out + bcast[..., :, k] * base[..., k][None, ..., None]
    return out


def identity_index_grid(spatial: Sequence[int], dtype=torch.float32,
                        device=None, box=None) -> torch.Tensor:
    """Identity grid in index coordinates ``[d, *spatial]``, channel ``i``
    holding the index along spatial dim ``i`` (the layout of flow fields);
    ``box`` as :func:`normalized_grid`'s."""
    box = (None,) * len(spatial) if box is None else box
    axes = [torch.arange(*((0, s) if r is None else (r[0], r[0] + r[1])), dtype=dtype,
                         device=device) for s, r in zip(spatial, box)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def normalized_to_index(coords: torch.Tensor, spatial: Sequence[int],
                        align_corners: bool) -> torch.Tensor:
    """Grid-convention normalized coordinates ``[..., d]`` (x first) -> index
    coordinates ``[..., d]`` (outermost first), ``grid_sample``'s
    denormalization."""
    idx_order = torch.flip(coords, dims=(-1,))
    sizes = torch.tensor(list(spatial), dtype=coords.dtype, device=coords.device)
    if align_corners:
        return (idx_order + 1.0) / 2.0 * (sizes - 1.0)
    return ((idx_order + 1.0) * sizes - 1.0) / 2.0
