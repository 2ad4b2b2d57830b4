"""Exact multilinear resampling (``grid_sample`` semantics, zeros padding).

Counterpart of ``torchregister_tpu/ops/resample.py`` (plain XLA there, not a
Pallas kernel): differentiable plain PyTorch on ``F.grid_sample``, with the
same values as the JAX package's ``multilinear_sample`` (out-of-range corners
contribute 0), which :func:`multilinear_sample` is here too. It serves the engines' in-loop ``method='exact'``, the
synthetic pair generators and the degenerate-theta path of
``warp_affine_separable``. The forward-only exact warps of the user surface
run on kernel K2 (``ops/blocked.py``).
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
    grid = affine_grid(theta, moving.shape[2:], align_corners)
    return grid_sample(moving, grid, align_corners)


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
    channel ``i`` along spatial dim ``i``), zeros padding."""
    coords = identity_index_grid(src.shape[2:], device=flow.device)[None] + flow.to(
        torch.float32)
    return multilinear_sample(src, torch.movedim(coords, 1, -1))
