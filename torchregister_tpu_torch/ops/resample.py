"""Exact multilinear resampling (``grid_sample`` semantics, zeros padding).

Counterpart of ``torchregister_tpu/ops/resample.py`` (plain XLA there, not a
Pallas kernel): differentiable plain PyTorch on ``F.grid_sample``, with the
same values as the JAX package's ``multilinear_sample`` (out-of-range corners
contribute 0), which :func:`multilinear_sample` is here too. It serves the engines' in-loop ``method='exact'``, the
synthetic pair generators and the degenerate-theta path of
``warp_affine_separable``. The forward-only exact warps of the user surface
run on kernel K2 (``ops/blocked.py``).

:func:`warp_affine` and :func:`warp_flow` also take a volume split into
slabs (``parallel.mesh.Sharded``, the ``space`` axis), as the JAX package's
take a sharded array: each slab fetches the whole volume (every row, as
GSPMD's all-gather does; ``halo.copied_bytes`` counts the rows it copies)
and samples its own outputs from it at the volume's coordinates, so each
output equals the unsharded call's to the bit. In the engines' loops the
transform moves every step, so no smaller buffer is known ahead; the
fetch's backward hands each row's gradient to its owner in ascending slab
order. The result is split as the source.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid import affine_grid, identity_index_grid
from .transforms import as_matrix


def grid_sample(src: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear/trilinear sample of ``src [N, C, *S]`` at the normalized grid
    ``[N, *Sout, d]`` (x first), zeros padding. Coordinates are f32."""
    return F.grid_sample(src, grid.to(torch.float32), mode="bilinear",
                         padding_mode="zeros", align_corners=align_corners)


def warp_affine(theta: torch.Tensor, moving: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Resample ``moving [N, C, *S]`` through the affine grid of ``theta``
    (``[N, d, d+1]`` or flat)."""
    theta = as_matrix(theta).to(torch.float32)
    if not isinstance(moving, torch.Tensor):
        from ..parallel.rows import replicate

        # a copy a slab, its gradient the copies' summed in ascending slab order
        thetas = replicate(theta, [b.device for b in moving.shards])
        return _on_slabs(moving, lambda buf, k, box: grid_sample(
            buf, affine_grid(thetas[k], moving.shape[2:], align_corners, box=box),
            align_corners))
    grid = affine_grid(theta, moving.shape[2:], align_corners)
    return grid_sample(moving, grid, align_corners)


def _on_slabs(src, fn):
    """``fn(buffer, k, box)`` of each slab ``k`` of ``src`` (split along a
    spatial dim): ``buffer`` the whole volume fetched onto the slab's device,
    ``box`` the slab's rows as a grid box; the outputs split as ``src``."""
    from ..parallel import halo
    from ..parallel.mesh import from_blocks

    dim, _ = src.slab_axis()
    S, n = src.shape[dim], len(src.shards)
    parts = halo.equal(S, n)
    bufs = halo.fetch_rows(src.shards, parts, dim, [(0, S)] * n)
    outs = []
    for k, (lo, hi) in enumerate(parts):
        box = tuple((lo, hi - lo) if 2 + a == dim else None for a in range(src.ndim - 2))
        outs.append(fn(bufs[k], k, box))
    return from_blocks(outs, src.sharding, (outs[0].shape[0], *src.shape[1:]))


def multilinear_sample(src: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Multilinear sample of ``src [N, C, *S]`` at the index coordinates
    ``coords [N, *Sout, d]`` (outermost axis first), zeros padding: ``[N, C,
    *Sout]`` (counterpart of ``torchregister_tpu/ops/resample.py:
    multilinear_sample``)."""
    sizes = torch.tensor(list(src.shape[2:]), dtype=torch.float32, device=coords.device)
    norm = (2.0 * coords.to(torch.float32) + 1.0) / sizes - 1.0
    return grid_sample(src, torch.flip(norm, dims=(-1,)), align_corners=False)  # x first


def warp_flow(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``src`` at ``identity + flow`` (``flow [N, d, *S]`` in voxels,
    channel ``i`` along spatial dim ``i``), zeros padding. ``src`` and
    ``flow`` split alike into slabs give the warp split alike."""
    if not isinstance(src, torch.Tensor) or not isinstance(flow, torch.Tensor):
        if isinstance(src, torch.Tensor) or isinstance(flow, torch.Tensor) or (
                src.sharding.spec[2:] != flow.sharding.spec[2:] or src.mesh is not flow.mesh):
            raise ValueError("warp_flow on slabs needs the volume and the field split alike")
        flows = flow.shards
        return _on_slabs(src, lambda buf, k, box: multilinear_sample(buf, torch.movedim(
            identity_index_grid(src.shape[2:], device=buf.device, box=box)[None]
            + flows[k].to(torch.float32), 1, -1)))
    coords = identity_index_grid(src.shape[2:], device=flow.device)[None] + flow.to(
        torch.float32)
    return multilinear_sample(src, torch.movedim(coords, 1, -1))
