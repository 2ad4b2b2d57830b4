"""Multi-resolution pyramid utilities (counterpart of
``torchregister_tpu/utils/pyramid.py``)."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ops.resample import warp_flow
from ..ops.resize import downsample_avg
from ..ops.separable import warp_flow_separable


def build_pyramid(x: torch.Tensor, levels: int, factor: int = 2) -> List[torch.Tensor]:
    """``[coarsest, ..., full-res]`` of ``x [N, C, *S]`` by repeated average
    pooling."""
    out = [x]
    for _ in range(levels - 1):
        out.append(downsample_avg(out[-1], factor))
    return out[::-1]


def upsample_flow(flow: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Upsample a voxel-unit flow ``[N, d, *S]`` to ``out_spatial`` (linear,
    half-pixel centres, edges clamped — ``jax.image.resize(..., 'linear')``
    when upsampling) and scale each component by its axis' zoom."""
    in_spatial = flow.shape[2:]
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(out_spatial)]
    out = F.interpolate(flow, size=tuple(out_spatial), mode=mode, align_corners=False)
    scale = torch.tensor([o / i for o, i in zip(out_spatial, in_spatial)],
                         dtype=flow.dtype, device=flow.device)
    return out * scale.view((1, -1) + (1,) * len(out_spatial))


def compose_flows(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Flow equal to applying ``first`` then ``second`` (both ``[N, d, *S]``,
    voxels): ``second(x) + first(x + second(x))``, with ``first`` resampled
    by the exact ``ops/resample.warp_flow``."""
    return second + warp_flow(first, second)


def compose_flows_separable(first: torch.Tensor, second: torch.Tensor,
                            max_disp: int) -> torch.Tensor:
    """Flow equal to applying ``first`` then ``second``:
    ``second(x) + first(x + second(x))``, with ``first`` resampled by the
    separable sweep (``max_disp`` bounds ``second``'s magnitude)."""
    return second + warp_flow_separable(first, second, max_disp=max_disp)
