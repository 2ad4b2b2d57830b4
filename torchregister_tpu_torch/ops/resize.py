"""Resizing ops (counterpart of ``torchregister_tpu/ops/resize.py``): torch
``'nearest'`` resizing for the NMI loss and the attention gates, average-pool
downsampling for the pyramid, and max pooling."""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F


class _NearestAxis(torch.autograd.Function):
    """``index_select`` of ``x`` along ``axis`` at the non-decreasing ``idx``,
    whose backward sums each source position's run of outputs in a fixed
    order. ``index_select``'s own backward adds with atomics on the card, in
    an order that changes from run to run wherever the resize repeats a
    position, so an upsampling resize would not repeat to the bit."""

    @staticmethod
    def forward(ctx, x, axis, idx, runs):
        ctx.axis = axis
        ctx.save_for_backward(runs)
        return torch.index_select(x, axis, idx)

    @staticmethod
    def backward(ctx, g):
        (runs,) = ctx.saved_tensors
        axis = ctx.axis
        # slot out_size (past the end) is a zero: a run shorter than the longest
        pad = [0, 0] * (g.ndim - 1 - axis) + [0, 1]
        parts = torch.index_select(F.pad(g, pad), axis, runs.flatten())
        return parts.unflatten(axis, tuple(runs.shape)).sum(axis + 1), None, None, None


def axis_nearest_resize(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Nearest resize of one axis with torch-'nearest' indices
    ``(i * in) // out``; keeps the dtype. (The JAX package writes it as a
    one-hot matmul to keep gathers off the TPU.) Differentiable, with a
    backward that repeats to the bit (:class:`_NearestAxis`)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    return _NearestAxis.apply(x, axis, *_nearest_maps(in_size, out_size, x.device))


@functools.lru_cache(maxsize=64)
def _nearest_maps(in_size: int, out_size: int, device: torch.device):
    """The source index of each output, and each source's run of outputs
    ``[in, ceil(out/in)]`` padded with ``out`` (a zero slot); made once per
    size pair and device (the U-Net resizes the same few pairs every step)."""
    idx = (torch.arange(out_size, device=device) * in_size) // out_size
    # source j feeds outputs [start_j, start_{j+1}), start_j = ceil(j*out/in)
    start = (torch.arange(in_size + 1, device=device) * out_size + in_size - 1) // in_size
    runs = start[:-1, None] + torch.arange(-(-out_size // in_size), device=device)
    return idx, torch.where(runs < start[1:, None], runs, out_size)


def axis_take(x: torch.Tensor, axis: int, idx: Sequence[int]) -> torch.Tensor:
    """``x``'s rows ``idx`` (non-decreasing) along ``axis``, with
    :class:`_NearestAxis`'s backward (each source row sums its run of
    outputs in a fixed order): a slab's share of a nearest resize
    (``parallel/rows.resize``)."""
    idx = list(idx)
    n_in, n_out = x.shape[axis], len(idx)
    if n_out == 0:
        return x.narrow(axis, 0, 0)
    outs: list = [[] for _ in range(n_in)]
    for i, j in enumerate(idx):
        outs[j].append(i)
    width = max(len(o) for o in outs)
    runs = [o + [n_out] * (width - len(o)) for o in outs]
    return _NearestAxis.apply(x, axis, torch.as_tensor(idx, device=x.device),
                              torch.as_tensor(runs, device=x.device))


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
    remainder voxels are dropped (floor), like the JAX ``reduce_window``. A
    volume split into slabs (``parallel.mesh.Sharded``) gives one split
    alike (:func:`_downsample_slabs`)."""
    if not isinstance(x, torch.Tensor):
        return _downsample_slabs(x, factor)
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=factor, stride=factor)


def _downsample_slabs(x, factor: int):
    """:func:`downsample_avg` of a volume split into equal slabs along a
    spatial dim, each output slab on its slab's device and equal to the
    unsharded pool's rows to the bit (each window is pooled alone). Output
    slab ``k`` takes the equal ``k``-th share of the pooled rows; its windows
    read input rows ``[factor lo, factor hi)``, the slab's own where its
    rows divide by ``factor`` (no copy), else fetched from the neighbours
    that hold them (``halo.fetch_rows``), as GSPMD's halo does. A pooled
    extent that does not split evenly over the slabs raises
    ``ValueError``."""
    from ..parallel import halo
    from ..parallel.mesh import from_blocks

    dim, _ = x.slab_axis()
    n = len(x.shards)
    S = x.shape[dim]
    out_rows = S // factor
    if out_rows % n:
        raise ValueError(f"downsample_avg on {n} slabs of a dim of {S}: the {out_rows} pooled "
                         f"rows do not split evenly over the slabs")
    m = S // n
    blocks = x.shards
    if m % factor:
        parts = halo.equal(out_rows, n)
        blocks = halo.fetch_rows(blocks, halo.equal(S, n), dim,
                                 [(factor * lo, factor * hi) for lo, hi in parts])
    out = [downsample_avg(b, factor) for b in blocks]
    shape = [s // factor if i >= 2 else s for i, s in enumerate(x.shape)]
    return from_blocks(out, x.sharding, shape)


def max_pool(x: torch.Tensor, k: int = 2, stride: int | None = None) -> torch.Tensor:
    """Max pool over the spatial dims of ``x [N, C, *S]`` (floor mode, like
    torch ``MaxPoolNd`` and the JAX ``reduce_window``)."""
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=k, stride=k if stride is None else stride)
