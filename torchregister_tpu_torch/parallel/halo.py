"""Halos of slabs: each slab of a volume split along one dim, widened by
rows of its neighbours (the counterpart of the halo exchanges that XLA's
GSPMD inserts for the JAX package's ``space`` axis).

A volume of ``S`` rows along ``dim`` split into ``n`` equal slabs of ``m``
rows: slab ``k`` holds global rows ``[k m, (k+1) m)``. :func:`fetch` gives
each slab the buffer of global rows ``[k m - before, (k+1) m + after)`` on
the slab's device, rows past the volume zero (``mode='zeros'``, the
sweeps') or mirrored about the edge row (``mode='reflect'``, the edge
filter's reflect padding). A halo may span several neighbours (slabs of one
row under a window of several). Rows that come from another slab are
copies between devices (on one device, copies within it); ``copied_bytes``
counts their bytes and ``calls`` the fetches, so the halo cost of a run is
visible (:func:`reset_counts` zeroes them).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

copied_bytes = 0
calls = 0


def reset_counts() -> None:
    global copied_bytes, calls
    copied_bytes = 0
    calls = 0


def _source(r: int, S: int, mode: str):
    """The global row that row ``r`` of a buffer reads, or None for a zero
    row."""
    if 0 <= r < S:
        return r
    if mode == "zeros":
        return None
    if mode == "reflect":
        m = -r if r < 0 else 2 * (S - 1) - r
        if not 0 <= m < S:
            raise ValueError(f"a reflect halo reaches row {r} of a dim of {S}")
        return m
    raise ValueError(f"halo mode must be 'zeros' or 'reflect', got {mode!r}")


@functools.lru_cache(maxsize=256)
def runs(k: int, m: int, n: int, before: int, after: int, mode: str = "zeros") -> tuple:
    """The pieces of slab ``k``'s buffer, in order: ``(slab, start, length)``
    of each run of rows read from one slab (ascending rows), or ``(None, 0,
    length)`` for a run of zero rows (reflected rows descend, so each is a
    run of its own)."""
    S = n * m
    pieces: list = []
    for r in range(k * m - before, (k + 1) * m + after):
        src = _source(r, S, mode)
        piece = (None, 0, 1) if src is None else (src // m, src % m, 1)
        if pieces:
            j, start, length = pieces[-1]
            if j == piece[0] and (j is None or piece[1] == start + length):
                pieces[-1] = (j, start, length + 1)
                continue
        pieces.append(piece)
    return tuple(pieces)


def fetch(slabs: Sequence[torch.Tensor], dim: int, before: int, after: int,
          mode: str = "zeros") -> list:
    """Each slab's buffer of its rows and ``before`` / ``after`` rows of
    the volume around them along ``dim`` (see the module note), on the
    slab's device; the slabs are equal, in order along ``dim``."""
    global copied_bytes, calls
    n, m = len(slabs), slabs[0].shape[dim]
    if any(s.shape != slabs[0].shape for s in slabs):
        raise ValueError("halo.fetch needs equal slabs")
    if before < 0 or after < 0:
        raise ValueError(f"halo widths must be >= 0, got {before}, {after}")
    calls += 1
    out = []
    for k, own in enumerate(slabs):
        shape = list(own.shape)
        shape[dim] = m + before + after
        buf = torch.empty(shape, dtype=own.dtype, device=own.device)
        at = 0
        for j, start, length in runs(k, m, n, before, after, mode):
            dst = buf.narrow(dim, at, length)
            at += length
            if j is None:
                dst.zero_()
                continue
            dst.copy_(slabs[j].narrow(dim, start, length))
            if j != k:
                copied_bytes += dst.numel() * dst.element_size()
        out.append(buf)
    return out


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
    total = 0
    for k in range(n):
        total += sum(length for j, _, length in runs(k, m, n, before, after, mode)
                     if j is not None and j != k) * row
    return total
