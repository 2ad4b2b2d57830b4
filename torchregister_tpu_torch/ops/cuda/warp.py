"""K2: the exact trilinear warp kernel (``csrc/warp.cu``) and its plain version.

Counterpart of ``torchregister_tpu/ops/pallas/roigather.py:_warp_kernel``.
:func:`warp` samples ``src [C, *S]`` (2D or 3D, f32) at each output voxel's
source coordinate with ``grid_sample`` semantics (trilinear, zeros padding),
the coordinate coming either from an affine index map ``(M, t)`` (packed by
:func:`pack_affine`) or from identity plus a voxel-unit displacement field.
Forward only: the Pallas kernel has no VJP, and the exact warps that must be
differentiable (``ops/resample.py``) stay plain PyTorch.

Dispatch is by device only: a CPU tensor takes :func:`warp_plain`, a CUDA
tensor launches the kernel (built from the package's own source at first
use) or raises. There is no fallback from the kernel to the plain version.

``affine_launches`` and ``flow_launches`` count kernel launches, so a run can
show that its path went through the kernel; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "warp.cu"

affine_launches = 0
flow_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "warp", {
    name: (_I, [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P])
    for name in ("warp_affine", "warp_flow")})


def reset_counts() -> None:
    global affine_launches, flow_launches
    affine_launches = 0
    flow_launches = 0


def pack_affine(M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The kernel's 12 floats from an index map ``s = M o + t`` (array axis
    order): row ``s`` of ``M`` followed by ``t[s]``. A 2D map is embedded as
    a volume with one z plane and ``q_z = 0``. Stays on ``M``'s device."""
    d = M.shape[0]
    rows = torch.cat([M.to(torch.float32), t.to(torch.float32)[:, None]], dim=1)
    if d == 3:
        return rows.reshape(12).contiguous()
    if d != 2:
        raise ValueError(f"K2 warps 2D or 3D images, got an index map of size {d}")
    mt = torch.zeros((3, 4), dtype=torch.float32, device=M.device)
    mt[1:, 1:] = rows
    return mt.reshape(12)


def _validate(src: torch.Tensor, aux: torch.Tensor, what: str, shape) -> None:
    if src.dtype != torch.float32 or aux.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 images and {what}, got {src.dtype} and "
                        f"{aux.dtype}")
    if src.ndim != 4:
        raise ValueError(f"K2 takes src [C, Z, Y, X], got {tuple(src.shape)}")
    if tuple(aux.shape) != tuple(shape):
        raise ValueError(f"K2 needs {what} of shape {tuple(shape)}, got "
                         f"{tuple(aux.shape)}")
    if not (src.is_cuda and aux.is_cuda and src.device == aux.device):
        raise ValueError(f"K2 needs src and {what} on the same CUDA device")
    if not (src.is_contiguous() and aux.is_contiguous()):
        raise ValueError(f"K2 needs contiguous src and {what}")


def _launch(name: str, src: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    C, Z, Y, X = src.shape
    out = torch.empty_like(src)
    LIB.launch(name, src, src.data_ptr(), out.data_ptr(), aux.data_ptr(), C, Z, Y, X)
    return out


def warp_affine_launch(src: torch.Tensor, mt: torch.Tensor) -> torch.Tensor:
    """Launch the affine mode on ``src [C, Z, Y, X]`` with the 12 floats of
    :func:`pack_affine`."""
    global affine_launches
    _validate(src, mt, "mt", (12,))
    out = _launch("warp_affine", src, mt)
    affine_launches += 1
    return out


def warp_flow_launch(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the flow mode on ``src [C, Z, Y, X]`` with ``flow [3, Z, Y, X]``
    (voxels, channel ``s`` along axis ``s``)."""
    global flow_launches
    _validate(src, flow, "flow", (3,) + tuple(src.shape[1:]))
    out = _launch("warp_flow", src, flow)
    flow_launches += 1
    return out


def warp_plain(src: torch.Tensor, mt: torch.Tensor | None = None,
               flow: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2 on ``src [C, Z, Y, X]``: the 8-corner
    gather of the JAX package's ``multilinear_sample``, with the kernel's
    operations in the kernel's order (so the two agree to the bit)."""
    C, Z, Y, X = src.shape
    sizes = (Z, Y, X)
    p = [torch.arange(s, dtype=torch.float32, device=src.device).view(
        [s if a == b else 1 for b in range(3)]) for a, s in enumerate(sizes)]
    if flow is None:
        q = [mt[4 * s] * p[0] + mt[4 * s + 1] * p[1] + mt[4 * s + 2] * p[2] + mt[4 * s + 3]
             for s in range(3)]
    else:
        q = [p[s] + flow[s] for s in range(3)]
    w, idx, ok = [], [], []
    for s in range(3):
        qs = q[s].expand(sizes)
        f = torch.floor(qs)
        fr = qs - f
        w.append((1.0 - fr, fr))
        corners = (f, f + 1.0)
        ok.append([(c >= 0.0) & (c <= sizes[s] - 1.0) for c in corners])
        idx.append([torch.where(k, c, 0.0).long() for c, k in zip(corners, ok[s])])
    flat = src.reshape(C, -1)
    out = torch.zeros_like(flat)
    for i in range(2):
        for j in range(2):
            for k in range(2):
                wc = (w[0][i] * w[1][j]) * w[2][k]
                inside = ok[0][i] & ok[1][j] & ok[2][k]
                off = (idx[0][i] * Y + idx[1][j]) * X + idx[2][k]
                val = torch.where(inside.reshape(-1), flat[:, off.reshape(-1)], 0.0)
                out = out + val * wc.reshape(-1)
    return out.reshape(src.shape)


def warp(src: torch.Tensor, mt: torch.Tensor | None = None,
         flow: torch.Tensor | None = None) -> torch.Tensor:
    """Exact trilinear warp of ``src [C, *S]`` (f32, 2D or 3D), affine mode
    with ``mt`` (:func:`pack_affine`) or flow mode with ``flow [d, *S]`` (f32
    voxels). Returns ``[C, *S]``."""
    if (mt is None) == (flow is None):
        raise ValueError("K2 takes exactly one of mt (affine) and flow")
    if src.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 images, got {src.dtype}")
    d = src.ndim - 1
    if d not in (2, 3):
        raise ValueError(f"K2 warps 2D or 3D images [C, *S], got {tuple(src.shape)}")
    src3 = src.contiguous() if d == 3 else src.contiguous()[:, None]
    if flow is not None:
        if flow.dtype != torch.float32:
            raise TypeError(f"K2 takes a float32 flow, got {flow.dtype}")
        if tuple(flow.shape) != (d,) + tuple(src.shape[1:]):
            raise ValueError(f"K2 needs flow [{d}, *S] for src {tuple(src.shape)}, got "
                             f"{tuple(flow.shape)}")
        flow = flow.contiguous() if d == 3 else torch.cat(
            [torch.zeros_like(flow[:1]), flow])[:, None].contiguous()
    if src.is_cuda:
        out = (warp_affine_launch(src3, mt.contiguous()) if flow is None
               else warp_flow_launch(src3, flow))
    elif src.device.type == "cpu":
        out = warp_plain(src3, mt, flow)
    else:
        raise RuntimeError(f"K2 has no path for device {src.device}")
    return out if d == 3 else out[:, 0]
