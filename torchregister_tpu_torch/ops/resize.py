"""Resizing ops (counterpart of ``torchregister_tpu/ops/resize.py``): torch
``'nearest'`` resizing for the NMI loss and the attention gates, average-pool
downsampling for the pyramid, and max pooling."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def axis_nearest_resize(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Nearest resize of one axis with torch-'nearest' indices
    ``(i * in) // out``; keeps the dtype. (The JAX package writes it as a
    one-hot matmul to keep gathers off the TPU.)"""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx = (torch.arange(out_size, device=x.device) * in_size) // out_size
    return torch.index_select(x, axis, idx)


def nearest_resize(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize of ``x [N, C, *S]`` to ``out_spatial`` (torch
    ``'nearest'``: ``src = (i * in) // out``); keeps the dtype."""
    spatial = tuple(x.shape[2:])
    if len(out_spatial) != len(spatial):
        raise ValueError(
            f"nearest_resize: out_spatial {tuple(out_spatial)} has {len(out_spatial)} "
            f"dims for input spatial shape {spatial} ({len(spatial)} dims)")
    for axis, s_out in enumerate(out_spatial):
        x = axis_nearest_resize(x, 2 + axis, int(s_out))
    return x


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool ``x [N, C, *S]`` by ``factor`` per spatial dim; trailing
    remainder voxels are dropped (floor), like the JAX ``reduce_window``."""
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=factor, stride=factor)


def max_pool(x: torch.Tensor, k: int = 2, stride: int | None = None) -> torch.Tensor:
    """Max pool over the spatial dims of ``x [N, C, *S]`` (floor mode, like
    torch ``MaxPoolNd`` and the JAX ``reduce_window``)."""
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=k, stride=k if stride is None else stride)
