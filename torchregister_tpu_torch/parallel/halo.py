"""Halos of slabs: each slab of a volume split along one dim, widened by
rows of its neighbours (the counterpart of the halo exchanges that XLA's
GSPMD inserts for the JAX package's ``space`` axis).

A volume of ``S`` rows along ``dim`` is split into slabs by a row
partition: slab ``k`` holds the global rows ``[lo_k, hi_k)``, the ranges in
ascending order, each starting where the last ended, any of them empty. A
``Sharded`` volume's partition is equal (:func:`equal`, slabs of ``S / n``
rows); the U-Net's layers on slabs (``models/attention_unet.py``) make
uneven ones, down to slabs with no rows.

:func:`fetch_rows` gives each slab ``k`` the buffer of any global rows
``[a_k, b_k)`` it asks for, on its device: its own rows copied from itself,
the others from the slabs that own them, rows past the volume zero
(``mode='zeros'``, the sweeps'), mirrored about the edge row
(``'reflect'``, the edge filter's reflect padding) or the edge row repeated
(``'edge'``, ``upsample_flow``'s clamp). A buffer may span any number of
neighbours (slabs of one row under a window of several). Rows that come
from another slab are copies between devices (on one device, copies within
it); ``copied_bytes`` counts their bytes and ``calls`` the fetches, so the
halo cost of a run is visible (:func:`reset_counts` zeroes them).

The fetch is differentiable: its backward hands each buffer row's gradient
to the slab that owns the row, each owner's row summing its buffer rows'
gradients in ascending buffer (slab) order, and within a buffer in
ascending row order, so a run repeats to the bit. :func:`fetch` is the
fetch of equal slabs with ``before`` / ``after`` rows around each.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import native

copied_bytes = 0
calls = 0

MODES = ("zeros", "reflect", "edge")


def reset_counts() -> None:
    global copied_bytes, calls
    copied_bytes = 0
    calls = 0


def equal(S: int, n: int) -> tuple:
    """The partition of ``S`` rows into ``n`` equal slabs."""
    m = S // n
    return tuple((k * m, (k + 1) * m) for k in range(n))


def _source(r: int, S: int, mode: str):
    """The global row that row ``r`` of a buffer reads, or None for a zero
    row."""
    if 0 <= r < S:
        return r
    if mode == "zeros":
        return None
    if mode == "edge":
        return min(max(r, 0), S - 1)
    if mode == "reflect":
        m = -r if r < 0 else 2 * (S - 1) - r
        if not 0 <= m < S:
            raise ValueError(f"a reflect halo reaches row {r} of a dim of {S}")
        return m
    raise ValueError(f"halo mode must be one of {MODES}, got {mode!r}")


def _owner(r: int, parts: tuple) -> tuple:
    """``(slab, row within it)`` of global row ``r``."""
    for j, (lo, hi) in enumerate(parts):
        if lo <= r < hi:
            return j, r - lo
    raise ValueError(f"no slab of {parts} holds row {r}")


@functools.lru_cache(maxsize=1024)
def pieces(parts: tuple, a: int, b: int, mode: str = "zeros") -> tuple:
    """The pieces of the buffer of global rows ``[a, b)`` of a volume split
    by ``parts``, in order: ``(slab, start, length)`` of each run of
    ascending rows read from one slab, or ``(None, 0, length)`` for a run of
    zero rows (reflected and clamped rows make runs of their own)."""
    S = parts[-1][1]
    out: list = []
    for r in range(a, b):
        src = _source(r, S, mode)
        piece = (None, 0, 1) if src is None else (*_owner(src, parts), 1)
        if out:
            j, start, length = out[-1]
            if j == piece[0] and (j is None or piece[1] == start + length):
                out[-1] = (j, start, length + 1)
                continue
        out.append(piece)
    return tuple(out)


def _check(slabs, parts, dim, wants, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"halo mode must be one of {MODES}, got {mode!r}")
    if len(parts) != len(slabs) or len(wants) != len(slabs):
        raise ValueError(f"halo: {len(slabs)} slabs, {len(parts)} ranges and {len(wants)} "
                         "buffers")
    end = 0
    for s, (lo, hi) in zip(slabs, parts):
        if lo != end or hi < lo or s.shape[dim] != hi - lo:
            raise ValueError(f"halo: slabs of {[s.shape[dim] for s in slabs]} rows are not "
                             f"the partition {parts}")
        end = hi
    for a, b in wants:
        if b < a:
            raise ValueError(f"halo: a buffer of rows [{a}, {b})")


def _gather(slabs, parts, dim, wants, mode) -> list:
    out, moved = [], 0
    for k, (a, b) in enumerate(wants):
        own = slabs[k]
        shape = list(own.shape)
        shape[dim] = b - a
        buf = torch.empty(shape, dtype=own.dtype, device=own.device)
        at = 0
        for j, start, length in pieces(parts, a, b, mode):
            dst = buf.narrow(dim, at, length)
            at += length
            if j is None:
                dst.zero_()
                continue
            dst.copy_(slabs[j].narrow(dim, start, length))
            if j != k:
                moved += dst.numel() * dst.element_size()
        out.append(buf)
    native.bump(__name__, calls=1, copied_bytes=moved)
    return out


def _scatter(gs, specs, parts, dim, wants, mode) -> list:
    """The adjoint of :func:`_gather`: each slab's rows (``specs``: each
    slab's shape, dtype and device) the sum of the buffer rows that read
    them, in ascending buffer order (a buffer of no gradient, None, adds
    nothing)."""
    grads = [torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in specs]
    for k, (a, b) in enumerate(wants):
        if gs[k] is None:
            continue
        at = 0
        for j, start, length in pieces(parts, a, b, mode):
            if j is not None:
                dst = grads[j].narrow(dim, start, length)
                dst.add_(gs[k].narrow(dim, at, length).to(dst.device))
            at += length
    return grads


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, dim, wants, mode, *slabs):
        ctx.meta = (parts, dim, wants, mode)
        ctx.specs = [(s.shape, s.dtype, s.device) for s in slabs]
        ctx.set_materialize_grads(False)
        return tuple(_gather(slabs, parts, dim, wants, mode))

    @staticmethod
    def backward(ctx, *gs):
        parts, dim, wants, mode = ctx.meta
        return (None, None, None, None, *_scatter(gs, ctx.specs, parts, dim, wants, mode))


def fetch_rows(slabs: Sequence[torch.Tensor], parts: Sequence, dim: int, wants: Sequence,
               mode: str = "zeros") -> list:
    """Slab ``k``'s buffer of the global rows ``wants[k] = (a, b)`` along
    ``dim`` of the volume that ``slabs`` split by ``parts`` (each slab's
    ``(lo, hi)``), on slab ``k``'s device (see the module note);
    differentiable in the slabs."""
    parts = tuple((int(lo), int(hi)) for lo, hi in parts)
    wants = tuple((int(a), int(b)) for a, b in wants)
    _check(slabs, parts, dim, wants, mode)
    if torch.is_grad_enabled() and any(s.requires_grad for s in slabs):
        return list(_Fetch.apply(parts, dim, wants, mode, *slabs))
    return _gather(slabs, parts, dim, wants, mode)


def fetch(slabs: Sequence[torch.Tensor], dim: int, before: int, after: int,
          mode: str = "zeros") -> list:
    """Each slab's buffer of its rows and ``before`` / ``after`` rows of
    the volume around them along ``dim``, on the slab's device; the slabs
    are equal, in order along ``dim``."""
    n, m = len(slabs), slabs[0].shape[dim]
    if any(s.shape != slabs[0].shape for s in slabs):
        raise ValueError("halo.fetch needs equal slabs")
    if before < 0 or after < 0:
        raise ValueError(f"halo widths must be >= 0, got {before}, {after}")
    parts = equal(n * m, n)
    return fetch_rows(slabs, parts, dim, [(lo - before, hi + after) for lo, hi in parts], mode)


def bytes_of(shape: Sequence[int], dim: int, n: int, before: int, after: int,
             element_size: int, mode: str = "zeros") -> int:
    """The bytes :func:`fetch` copies between slabs for ``n`` slabs of
    ``shape`` (one slab's) along ``dim``: the rows each buffer reads from
    another slab."""
    m = shape[dim]
    row = element_size
    for i, s in enumerate(shape):
        if i != dim:
            row *= s
    parts = equal(n * m, n)
    total = 0
    for k, (lo, hi) in enumerate(parts):
        total += sum(length for j, _, length in pieces(parts, lo - before, hi + after, mode)
                     if j is not None and j != k) * row
    return total
