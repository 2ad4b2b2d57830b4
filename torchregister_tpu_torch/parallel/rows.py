"""A tensor split into slabs by a row partition along one dim, and the
row maps a layer of the U-Net applies to it (``models/attention_unet.py``'s
forward on a volume split over the ``space`` axis).

A :class:`Rows` holds one block a slab, each on its slab's device, and the
partition: slab ``k`` holds the global rows ``[lo_k, hi_k)`` of ``dim``
(``parallel/halo.py``'s partitions: ascending, any slab possibly empty).
The U-Net's convolutions are valid and its poolings, strides and resizes
change the extent, so each layer derives its output partition from its
input's: output row ``r`` of a layer that reads input rows from ``s r`` on
(a convolution, ``s = 1``; a max pooling, ``s = 2``; the gates' stride-3
subsample, ``s = 3``) belongs to the slab that owns input row ``s r``
(:func:`window`, :func:`stride`); a layer that maps each row to rows
``2i, 2i + 1`` (the transposed convolution) keeps its slab's rows
(:func:`local`). A row shift (the centre pad or crop along the split dim),
a nearest resize and a change of partition read any global rows into a
given partition (:func:`shift`, :func:`resize`). Rows from other slabs come
through ``halo.fetch_rows``, whose backward hands each row's gradient to
its owner in ascending slab order.

Reductions over the volume (:func:`total`) add each slab's f32 partial sum
in ascending slab order on the first slab's device, and :func:`replicate`
gives each slab a copy of a weight whose gradient is the copies' gradients
summed in ascending slab order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from . import halo


class Rows(NamedTuple):
    """A tensor of ``extent`` rows along ``dim`` split into ``blocks`` by
    ``parts`` (each slab's ``(lo, hi)``)."""

    blocks: list
    parts: tuple
    dim: int

    @property
    def extent(self) -> int:
        return self.parts[-1][1]

    def shape(self) -> tuple:
        """The whole tensor's shape."""
        ref = next((b for b in self.blocks if b.shape[self.dim]), self.blocks[0])
        return tuple(self.extent if i == self.dim else s for i, s in enumerate(ref.shape))

    def map(self, fn: Callable) -> "Rows":
        """``fn(k, block)`` of each slab ``k``'s block, which keeps its rows
        along ``dim``."""
        return self._replace(blocks=[fn(k, b) for k, b in enumerate(self.blocks)])


def _apply(buffers: list, fn: Callable, rows: Sequence[int], dim: int) -> list:
    """``fn(k, buffer)`` of each slab ``k`` that gives rows; an empty output
    of the right shape (from a slab that gives rows) for the others."""
    outs = [fn(k, b) if n else None for k, (b, n) in enumerate(zip(buffers, rows))]
    ref = next(o for o in outs if o is not None)
    empty = list(ref.shape)
    empty[dim] = 0
    return [torch.zeros(empty, dtype=ref.dtype, device=b.device) if o is None else o
            for o, b in zip(outs, buffers)]


def window(x: Rows, fn: Callable, width: int, step: int, out_extent: int) -> Rows:
    """A layer whose output row ``r`` reads input rows ``[step r, step r +
    width)`` (``out_extent`` rows): each slab's output rows are those whose
    first input row it owns, ``fn(k, buffer)`` of the buffer of the rows
    they read."""
    parts, wants = [], []
    for lo, hi in x.parts:
        a = min(-(-lo // step), out_extent)
        b = min(-(-hi // step), out_extent)
        parts.append((a, b))
        wants.append((step * a, step * (b - 1) + width) if b > a else (step * a, step * a))
    bufs = halo.fetch_rows(x.blocks, x.parts, x.dim, wants)
    return Rows(_apply(bufs, fn, [b - a for a, b in parts], x.dim), tuple(parts), x.dim)


def stride(x: Rows, step: int, start: int = 0) -> Rows:
    """Every ``step``-th row from ``start`` (``x[..., start::step, ...]``
    along ``dim``), each row kept by the slab that owns it."""
    parts, blocks = [], []
    n = -(-(x.extent - start) // step)
    for blk, (lo, hi) in zip(x.blocks, x.parts):
        a = min(max(-(-(lo - start) // step), 0), n)
        b = min(max(-(-(hi - start) // step), 0), n)
        parts.append((a, b))
        first = start + step * a - lo
        blocks.append(blk.narrow(x.dim, 0, 0) if b == a else
                      blk.narrow(x.dim, first, step * (b - a - 1) + 1)[
                          (slice(None),) * x.dim + (slice(None, None, step),)])
    return Rows(blocks, tuple(parts), x.dim)


def local(x: Rows, fn: Callable, factor: int) -> Rows:
    """A layer that maps each input row to ``factor`` output rows of its own
    (the transposed convolution of stride 2): ``fn(k, block)`` of each
    slab's block."""
    parts = tuple((factor * lo, factor * hi) for lo, hi in x.parts)
    return Rows(_apply(x.blocks, fn, [hi - lo for lo, hi in x.parts], x.dim), parts, x.dim)


def shift(x: Rows, offset: int, parts: Sequence) -> Rows:
    """The tensor whose row ``r`` is ``x``'s row ``r + offset`` (zero past
    ``x``'s rows) laid out by ``parts``: a centre crop (``offset > 0``) or
    pad (``offset < 0``) along ``dim``, or a change of partition."""
    parts = tuple(parts)
    wants = [(lo + offset, hi + offset) for lo, hi in parts]
    return Rows(halo.fetch_rows(x.blocks, x.parts, x.dim, wants), parts, x.dim)


def resize(x: Rows, parts: Sequence, take: Callable) -> Rows:
    """A nearest resize of ``x``'s rows to ``parts[-1][1]`` rows laid out by
    ``parts``: output row ``i`` reads input row ``(i * in) // out``. Each
    slab fetches the input rows its outputs read and ``take(buffer, idx)``
    picks them (``idx`` the non-decreasing rows of the buffer)."""
    parts = tuple(parts)
    n_in, n_out = x.extent, parts[-1][1]
    wants, idxs = [], []
    for lo, hi in parts:
        src = [(i * n_in) // n_out for i in range(lo, hi)]
        a = src[0] if src else 0
        wants.append((a, src[-1] + 1) if src else (a, a))
        idxs.append([s - a for s in src])
    bufs = halo.fetch_rows(x.blocks, x.parts, x.dim, wants)
    return Rows([take(b, i) for b, i in zip(bufs, idxs)], parts, x.dim)


def total(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each slab's partial sum added in ascending slab order on the first
    slab's device."""
    from .mesh import ordered_sum

    return ordered_sum(list(parts), parts[0].device)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, devices):
        ctx.device = w.device
        return tuple(w.to(d) if d != w.device else w.clone() for d in devices)

    @staticmethod
    def backward(ctx, *gs):
        from .mesh import ordered_sum

        gs = [g for g in gs if g is not None]
        return (ordered_sum(gs, ctx.device) if gs else None), None


def replicate(w: torch.Tensor, devices: Sequence) -> tuple:
    """A copy of ``w`` a slab (on its device), differentiable: ``w``'s
    gradient is the copies' gradients summed in ascending slab order."""
    return _Replicate.apply(w, tuple(devices))
