"""Center pad/crop (counterpart of ``torchregister_tpu/ops/pad.py``, the
reference's ``padNd``, utils.py:271-277).

Every spatial dim gets ``floor(delta/2)`` on the leading side and
``ceil(delta/2)`` on the trailing side; a negative delta crops with the same
split, so ``ceil(|delta|/2)`` goes from the leading side (torch's negative
``F.pad``). ``mode`` takes ``jnp.pad``'s names for ``F.pad``'s modes:
``'constant'`` (with ``value``), ``'edge'``, ``'reflect'`` (the Sobel
filter's, ``ops/edge.py``) and ``'wrap'``. The other modes gather along each
padded axis through an index map, so a pad may exceed the axis, as in numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_MODES = ("constant", "edge", "reflect", "wrap")


def _pad_index(size: int, lead: int, trail: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis padded by ``(lead, trail)``."""
    j = np.arange(-lead, size + trail)
    if mode == "edge":
        return np.clip(j, 0, size - 1)
    if mode == "wrap":
        return j % size
    if size == 1:  # reflect
        return np.zeros_like(j)
    j = j % (2 * (size - 1))
    return np.where(j < size, j, 2 * (size - 1) - j)


def pad_spatial(x: torch.Tensor, target_spatial: Sequence[int], first_axis: int,
                mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Center pad/crop ``len(target_spatial)`` consecutive axes of ``x``
    starting at ``first_axis``."""
    if mode not in _MODES:
        raise ValueError(f"pad mode must be one of {_MODES}, got {mode!r}")
    nd = len(target_spatial)
    spatial = x.shape[first_axis:first_axis + nd]
    slices = [slice(None)] * x.ndim
    pads = [(0, 0)] * x.ndim
    for axis, (s, t) in enumerate(zip(spatial, target_spatial)):
        delta = t - s
        if delta >= 0:
            pads[first_axis + axis] = (delta // 2, delta - delta // 2)
        else:
            c = -delta
            lead = (c + 1) // 2
            slices[first_axis + axis] = slice(lead, s - (c - lead))
    x = x[tuple(slices)]
    if mode == "constant":
        if any(p != (0, 0) for p in pads):
            flat = [v for p in reversed(pads) for v in p]  # F.pad: last dim first
            x = F.pad(x, flat, mode="constant", value=value)
        return x
    for axis, (lead, trail) in enumerate(pads):
        if lead or trail:
            idx = _pad_index(x.shape[axis], lead, trail, mode)
            x = torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))
    return x


def pad_nd(x: torch.Tensor, target_spatial: Sequence[int], mode: str = "constant",
           value: float = 0.0) -> torch.Tensor:
    """Center pad/crop the spatial dims of ``x [N, C, *S]`` to ``target_spatial``."""
    if x.ndim - 2 != len(target_spatial):
        raise ValueError(f"pad_nd: {tuple(target_spatial)} for spatial shape "
                         f"{tuple(x.shape[2:])}")
    return pad_spatial(x, target_spatial, first_axis=2, mode=mode, value=value)


def pad_like(x: torch.Tensor, target: torch.Tensor, mode: str = "constant",
             value: float = 0.0) -> torch.Tensor:
    """Pad/crop ``x`` to ``target``'s spatial shape (``padNd(input_, target)``)."""
    return pad_nd(x, target.shape[2:], mode=mode, value=value)
