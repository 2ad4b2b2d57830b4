"""Center pad/crop (counterpart of ``torchregister_tpu/ops/pad.py``, the
reference's ``padNd``, utils.py:271-277).

Every spatial dim gets ``floor(delta/2)`` on the leading side and
``ceil(delta/2)`` on the trailing side; a negative delta crops with the same
split, so ``ceil(|delta|/2)`` goes from the leading side (torch's negative
``F.pad``). Constant padding only: the U-Net is its one user (the JAX
package's other modes serve the edge filter, not ported yet).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def pad_spatial(x: torch.Tensor, target_spatial: Sequence[int], first_axis: int,
                value: float = 0.0) -> torch.Tensor:
    """Center pad/crop ``len(target_spatial)`` consecutive axes of ``x``
    starting at ``first_axis``."""
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
    if any(p != (0, 0) for p in pads):
        flat = [v for p in reversed(pads) for v in p]  # F.pad: last dim first
        x = F.pad(x, flat, mode="constant", value=value)
    return x


def pad_nd(x: torch.Tensor, target_spatial: Sequence[int], value: float = 0.0) -> torch.Tensor:
    """Center pad/crop the spatial dims of ``x [N, C, *S]`` to ``target_spatial``."""
    if x.ndim - 2 != len(target_spatial):
        raise ValueError(f"pad_nd: {tuple(target_spatial)} for spatial shape "
                         f"{tuple(x.shape[2:])}")
    return pad_spatial(x, target_spatial, first_axis=2, value=value)


def pad_like(x: torch.Tensor, target: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Pad/crop ``x`` to ``target``'s spatial shape (``padNd(input_, target)``)."""
    return pad_nd(x, target.shape[2:], value=value)
