"""K2b: the compact ROI gather (``csrc/roigather.cu``) and its plain version.

Counterpart of ``torchregister_tpu/ops/pallas/roigather.py:_kernel`` (its
``roigather``). :func:`roigather` takes a volume ``[Z, Y, X]`` (f32) and one
row of int32 scalars ``(zq, yq, zr, yr, ox)`` per output tile, and returns
``[T, CW, AW*BW]`` with

    out[t, c, ab] = vol[QB*zq + zr + ab // BW, QB*yq + yr + ab % BW, ox + c]

and 0 where an index leaves the volume. The JAX kernel takes a volume padded
so that its quantized block fetches stay inside; here the window is read
directly, so any volume works, and the padded one gives the same values.
Forward only, f32 only, as the JAX kernel is.

Dispatch is by device only: a CPU tensor takes :func:`roigather_plain`, a
CUDA tensor launches the kernel (built from the package's own source at first
use) or raises. ``launches`` counts kernel launches; :func:`reset_counts`
zeroes it.
"""
from __future__ import annotations

import ctypes

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "roigather.cu"

QB = 8  # quantization block of the (zq, yq) scalars
AW = 16  # z extent of a window (the a of column ab)
BW = 16  # y extent (the b of column ab)
CW = 16  # x extent (the output row c)

launches = 0
native.count_launches(__name__, "launches")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "roigather", {"roigather": (_I, [_P, _P, _P] + [_I] * 4 + [_P])})


def reset_counts() -> None:
    global launches
    launches = 0


def _validate(vol: torch.Tensor, scalars: torch.Tensor) -> None:
    if vol.dtype != torch.float32:
        raise TypeError(f"K2b takes a float32 volume, got {vol.dtype}")
    if scalars.dtype != torch.int32:
        raise TypeError(f"K2b takes int32 scalars, got {scalars.dtype}")
    if vol.ndim != 3:
        raise ValueError(f"K2b takes a volume [Z, Y, X], got {tuple(vol.shape)}")
    if scalars.ndim != 2 or scalars.shape[1] != 5:
        raise ValueError(f"K2b takes scalars [T, 5], got {tuple(scalars.shape)}")


def roigather_launch(vol: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA ``vol [Z, Y, X]`` (f32) with
    ``scalars [T, 5]`` (int32, same device)."""
    global launches
    _validate(vol, scalars)
    if not (vol.is_cuda and scalars.is_cuda and vol.device == scalars.device):
        raise ValueError("K2b needs the volume and the scalars on the same CUDA device")
    if not (vol.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("K2b needs a contiguous volume and contiguous scalars")
    T = scalars.shape[0]
    Z, Y, X = vol.shape
    out = torch.empty((T, CW, AW * BW), dtype=torch.float32, device=vol.device)
    LIB.launch("roigather", vol, vol.data_ptr(), scalars.data_ptr(), out.data_ptr(), T, Z, Y, X)
    launches += 1
    return out


def roigather_plain(vol: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2b: one advanced-indexing gather of the
    contract, 0 outside the volume."""
    _validate(vol, scalars)
    Z, Y, X = vol.shape
    s = scalars.to(torch.int64)
    ab = torch.arange(AW * BW, device=vol.device)
    z = (QB * s[:, 0] + s[:, 2])[:, None, None] + (ab // BW)[None, None, :]
    y = (QB * s[:, 1] + s[:, 3])[:, None, None] + (ab % BW)[None, None, :]
    x = s[:, 4][:, None, None] + torch.arange(CW, device=vol.device)[None, :, None]
    inside = (z >= 0) & (z < Z) & (y >= 0) & (y < Y) & (x >= 0) & (x < X)
    val = vol[z.clamp(0, Z - 1), y.clamp(0, Y - 1), x.clamp(0, X - 1)]
    return torch.where(inside, val, torch.zeros((), dtype=vol.dtype, device=vol.device))


def roigather(vol: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Compact per-tile windows ``[T, CW, AW*BW]`` of ``vol [Z, Y, X]``."""
    if vol.is_cuda:
        return roigather_launch(vol.contiguous(), scalars.contiguous())
    if vol.device.type == "cpu":
        return roigather_plain(vol, scalars)
    raise RuntimeError(f"K2b has no path for device {vol.device}")
