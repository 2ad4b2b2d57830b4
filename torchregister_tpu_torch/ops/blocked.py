"""The user-facing exact warps on kernel K2 (counterpart of
``warp_affine_fast`` and ``warp_flow_fast`` in ``torchregister_tpu/ops/
blocked.py``).

The JAX module tiles the output, sizes gather blocks from the transform and
falls back to the element gather where a block would not fit: all of it
avoids XLA's slow gathers on a TPU. K2 reads each voxel's 8 corners
directly, so here every transform and size is one launch per batch element,
with the JAX batch rules: one theta for many volumes folds the batch into
channels, per-element transforms loop.

Forward only, f32 images (K2 raises ``TypeError`` on any other dtype).
"""
from __future__ import annotations

import torch

from .cuda import warp as k2
from .separable import affine_to_index_map
from .transforms import as_matrix


def warp_affine_fast(theta: torch.Tensor, moving: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Exact affine warp of ``moving [N, C, *S]`` (``grid_sample`` parity)
    by ``theta`` (``[1 or N, d, d+1]`` or flat). The index map is computed
    on ``theta``'s device and handed to the kernel there: no host sync."""
    theta = as_matrix(theta)
    spatial = tuple(moving.shape[2:])
    N = moving.shape[0]
    if theta.shape[0] not in (1, N):
        raise ValueError(f"warp_affine_fast: {theta.shape[0]} thetas for a batch of {N}")
    if N > 1:
        if theta.shape[0] == 1:
            # one transform, many volumes: the batch is extra channels
            folded = moving.reshape((1, -1) + spatial)
            return warp_affine_fast(theta, folded, align_corners).reshape(moving.shape)
        return torch.cat([warp_affine_fast(theta[i:i + 1], moving[i:i + 1], align_corners)
                          for i in range(N)])
    M, t = affine_to_index_map(theta[0].to(torch.float32), spatial, align_corners)
    return k2.warp(moving[0], mt=k2.pack_affine(M, t))[None]


def warp_flow_fast(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Exact flow warp of ``src [N, C, *S]`` by ``flow [N, d, *S]`` (voxels,
    channel ``i`` along spatial dim ``i``; cast to f32)."""
    if flow.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_flow_fast: src batch {src.shape[0]} != flow batch "
            f"{flow.shape[0]} (one flow field per source element)")
    if src.shape[0] > 1:
        return torch.cat([warp_flow_fast(src[i:i + 1], flow[i:i + 1])
                          for i in range(src.shape[0])])
    return k2.warp(src[0], flow=flow[0].to(torch.float32))[None]
