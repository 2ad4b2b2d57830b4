"""Multi-resolution pyramid utilities (counterpart of
``torchregister_tpu/utils/pyramid.py``)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
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
    when upsampling) and scale each component by its axis' zoom. A flow
    split into slabs (a ``parallel.mesh.Sharded``) gives one split alike
    (:func:`_upsample_slabs`)."""
    from ..parallel.mesh import Sharded

    if isinstance(flow, Sharded):
        return _upsample_slabs(flow, tuple(out_spatial))
    in_spatial = flow.shape[2:]
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(out_spatial)]
    out = F.interpolate(flow, size=tuple(out_spatial), mode=mode, align_corners=False)
    return out * _zoom(out_spatial, in_spatial, out)


def _zoom(out_spatial, in_spatial, like: torch.Tensor) -> torch.Tensor:
    scale = torch.tensor([o / i for o, i in zip(out_spatial, in_spatial)],
                         dtype=like.dtype, device=like.device)
    return scale.view((1, -1) + (1,) * len(out_spatial))


def _upsample_slabs(flow, out_spatial):
    """:func:`upsample_flow` of a flow split into equal slabs along a
    spatial dim, each output slab on its slab's device: across the split dim
    ``F.interpolate`` on the slab, along it a linear blend at the volume's
    half-pixel coordinates with the edge clamp (``F.interpolate`` on a slab
    would map coordinates by the slab's own size), from a buffer of the
    input rows its outputs read (``halo.fetch_rows`` in ``'edge'`` mode).
    Within f32 rounding of the unsharded call (the two blends round apart)."""
    from ..parallel import halo
    from ..parallel.mesh import from_blocks

    dim, _ = flow.slab_axis()
    a = dim - 2
    n = len(flow.shards)
    S_in, S_out = flow.shape[dim], out_spatial[a]
    if S_out % n:
        raise ValueError(f"upsample_flow on {n} slabs needs an output extent that splits "
                         f"evenly, got {S_out}")
    scale = np.float32(S_in / S_out)
    wants, taps = [], []
    for lo, hi in halo.equal(S_out, n):
        real = np.maximum(scale * (np.arange(lo, hi, dtype=np.float32) + np.float32(0.5))
                          - np.float32(0.5), np.float32(0.0))
        i0 = np.minimum(np.floor(real).astype(np.int64), S_in - 1)
        i1 = np.minimum(i0 + 1, S_in - 1)
        first = int(i0[0])
        wants.append((first, int(i1[-1]) + 1))
        taps.append((i0 - first, i1 - first, (real - i0).astype(np.float32)))
    bufs = halo.fetch_rows(flow.shards, halo.equal(S_in, n), dim, wants, mode="edge")
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(out_spatial)]
    view = tuple(-1 if i == dim else 1 for i in range(flow.ndim))
    outs = []
    for buf, (i0, i1, lam) in zip(bufs, taps):
        across = tuple(buf.shape[dim] if i == a else s for i, s in enumerate(out_spatial))
        if across != tuple(buf.shape[2:]):
            buf = F.interpolate(buf, size=across, mode=mode, align_corners=False)
        w = torch.as_tensor(lam, device=buf.device).view(view).to(buf.dtype)
        lo_rows = torch.index_select(buf, dim, torch.as_tensor(i0, device=buf.device))
        hi_rows = torch.index_select(buf, dim, torch.as_tensor(i1, device=buf.device))
        out = lo_rows * (1.0 - w) + hi_rows * w
        outs.append(out * _zoom(out_spatial, flow.shape[2:], out))
    return from_blocks(outs, flow.sharding, (*flow.shape[:2], *out_spatial))


def _plus(a, b):
    """``a + b`` of two tensors, or of two alike split into slabs (block by
    block)."""
    if isinstance(a, torch.Tensor):
        return a + b
    from ..parallel.mesh import from_blocks

    return from_blocks([x + y for x, y in zip(a.shards, b.shards)], a.sharding, a.shape)


def compose_flows(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Flow equal to applying ``first`` then ``second`` (both ``[N, d, *S]``,
    voxels, or both alike split into slabs): ``second(x) + first(x +
    second(x))``, with ``first`` resampled by the exact
    ``ops/resample.warp_flow``."""
    return _plus(second, warp_flow(first, second))


def compose_flows_separable(first: torch.Tensor, second: torch.Tensor,
                            max_disp: int) -> torch.Tensor:
    """Flow equal to applying ``first`` then ``second``:
    ``second(x) + first(x + second(x))``, with ``first`` resampled by the
    separable sweep (``max_disp`` bounds ``second``'s magnitude); both may
    be alike split into slabs."""
    return _plus(second, warp_flow_separable(first, second, max_disp=max_disp))
