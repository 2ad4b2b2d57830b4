"""Average-pool downsampling for the pyramid and the attention gates' nearest
resize (counterparts of ``torchregister_tpu/ops/resize.py:downsample_avg``
and ``axis_nearest_resize``)."""
from __future__ import annotations

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


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool ``x [N, C, *S]`` by ``factor`` per spatial dim; trailing
    remainder voxels are dropped (floor), like the JAX ``reduce_window``."""
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=factor, stride=factor)
