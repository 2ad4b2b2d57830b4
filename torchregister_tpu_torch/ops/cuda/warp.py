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
show that its path went through the kernel; ``tiles_launched`` counts the
blocks (output tiles) those launches ran, and :func:`staged_blocks` reads how
many of them staged their source box in shared memory (a device counter: the
read syncs, so nothing on the main path calls it); :func:`reset_counts`
zeroes all of them. :func:`tile_boxes` is the plain mirror of the kernel's
tiles, boxes and routes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "warp.cu"

# the kernel's compile-time tiles (csrc/warp.cu's kTile, kFlowTile, kBox,
# kFar): the affine mode's 3-D tiles, which stage their box (at most BOX) in
# shared memory; the flow mode's 3-D tiles and every 2-D (Z == 1) tile,
# which take the direct route everywhere
TILE_3D, TILE_FLOW, TILE_2D, BOX = (16, 16, 16), (8, 8, 32), (1, 8, 32), (24, 24, 24)
FAR = 2.0**13  # a staged box lies within +-FAR

affine_launches = 0
flow_launches = 0
tiles_launched = 0
native.count_launches(__name__, "affine_launches", "flow_launches", "tiles_launched")
_staged: dict = {}  # device index -> int32 [1], the kernel's count of staged blocks

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "warp", {
    name: (_I, [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _P])
    for name in ("warp_affine", "warp_flow")})


def reset_counts() -> None:
    global affine_launches, flow_launches, tiles_launched
    affine_launches = 0
    flow_launches = 0
    tiles_launched = 0
    for counter in _staged.values():
        counter.zero_()


def staged_blocks() -> int:
    """The blocks that took the staged route since :func:`reset_counts`, on
    every device (reads the device counters: syncs)."""
    return sum(int(counter.item()) for counter in _staged.values())


def tile_shape(Z: int, flow: bool = False) -> tuple:
    return TILE_2D if Z == 1 else TILE_FLOW if flow else TILE_3D


def _tiles(shape, flow: bool) -> int:
    return math.prod(-(-n // t) for n, t in zip(shape, tile_shape(shape[0], flow)))


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
    global tiles_launched
    C, Z, Y, X = src.shape
    out = torch.empty_like(src)
    index = src.get_device()
    counter = _staged.get(index)
    if counter is None:
        counter = _staged[index] = torch.zeros(1, dtype=torch.int32, device=src.device)
    LIB.launch(name, src, src.data_ptr(), out.data_ptr(), aux.data_ptr(), C, Z, Y, X,
               counter.data_ptr())
    tiles_launched += _tiles((Z, Y, X), name == "warp_flow")
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


def _coords(sizes, device, mt, flow) -> list:
    """Each output voxel's source coordinate per axis, ``[Z, Y, X]`` f32, in
    the kernel's order of operations."""
    p = [torch.arange(s, dtype=torch.float32, device=device).view(
        [s if a == b else 1 for b in range(3)]) for a, s in enumerate(sizes)]
    if flow is None:
        q = [mt[4 * s] * p[0] + mt[4 * s + 1] * p[1] + mt[4 * s + 2] * p[2] + mt[4 * s + 3]
             for s in range(3)]
    else:
        q = [p[s] + flow[s] for s in range(3)]
    return [qs.expand(sizes) for qs in q]


def tile_boxes(src_shape, mt: torch.Tensor | None = None,
               flow: torch.Tensor | None = None) -> dict:
    """The plain mirror of the kernel's box rule for ``src [C, Z, Y, X]``
    (the kernel's view: a 2D image is one z plane) with ``mt`` or ``flow
    [3, Z, Y, X]``, on their device. Per output tile (``tile_shape``, in
    a ``[nz, ny, nx]`` grid; ragged at the far faces): ``lo`` and ``hi``
    ``[nz, ny, nx, 3]`` (f32), the least floored coordinate per axis and the
    greatest plus one over the tile's voxels, NaN skipped (``lo > hi`` where
    every coordinate is NaN); ``staged`` ``[nz, ny, nx]``, the kernel's
    route: an affine 3-D tile whose box lies within +-``FAR`` and whose
    extent ``hi - lo + 1`` fits ``BOX`` (x with 3 to spare, for the shift to
    a 16-byte boundary). The card never calls it; tests and
    ``chip_smoke.py`` do."""
    Z, Y, X = (int(n) for n in src_shape[-3:])
    tile = tile_shape(Z, flow is not None)
    device = mt.device if flow is None else flow.device
    f = torch.stack([torch.floor(qs) for qs in _coords((Z, Y, X), device, mt, flow)], -1)
    n = [-(-size // t) for size, t in zip((Z, Y, X), tile)]
    pad = [0, 0] + [v for a in (2, 1, 0) for v in (0, n[a] * tile[a] - (Z, Y, X)[a])]
    f = torch.nn.functional.pad(f, pad, value=float("nan"))
    f = f.view(n[0], tile[0], n[1], tile[1], n[2], tile[2], 3)
    nan = torch.isnan(f)
    lo = torch.where(nan, torch.inf, f).amin(dim=(1, 3, 5))
    fmax = torch.where(nan, -torch.inf, f).amax(dim=(1, 3, 5))
    fits = ((lo <= fmax) & (lo >= -FAR) & (fmax < FAR)).all(-1)
    ext = torch.where(fits[..., None], fmax.double() - lo.double() + 2.0, 0.0)
    room = torch.tensor([BOX[0], BOX[1], BOX[2] - 3.0], dtype=torch.float64, device=device)
    staged = fits & (ext <= room).all(-1) & (flow is None and Z > 1)
    return {"tile": tile, "lo": lo, "hi": fmax + 1.0, "staged": staged}


def warp_plain(src: torch.Tensor, mt: torch.Tensor | None = None,
               flow: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2 on ``src [C, Z, Y, X]``: the 8-corner
    gather of the JAX package's ``multilinear_sample``, with the kernel's
    operations in the kernel's order (so the two agree to the bit)."""
    return sample_plain(src, _coords(src.shape[1:], src.device, mt, flow))


def sample_plain(src: torch.Tensor, q) -> torch.Tensor:
    """``src [C, Z, Y, X]`` sampled at the coordinates ``q`` (per axis, f32,
    one shape ``P``) as K2 samples them: ``[C, *P]``. A check of a few output
    planes computes their ``q`` and calls this."""
    C, Z, Y, X = src.shape
    sizes = (Z, Y, X)
    w, idx, ok = [], [], []
    for s in range(3):
        qs = q[s]
        f = torch.floor(qs)
        fr = qs - f
        w.append((1.0 - fr, fr))
        corners = (f, f + 1.0)
        ok.append([(c >= 0.0) & (c <= sizes[s] - 1.0) for c in corners])
        idx.append([torch.where(k, c, 0.0).long() for c, k in zip(corners, ok[s])])
    flat = src.reshape(C, -1)
    out = flat.new_zeros((C, q[0].numel()))
    for i in range(2):
        for j in range(2):
            for k in range(2):
                wc = (w[0][i] * w[1][j]) * w[2][k]
                inside = ok[0][i] & ok[1][j] & ok[2][k]
                off = (idx[0][i] * Y + idx[1][j]) * X + idx[2][k]
                val = torch.where(inside.reshape(-1), flat[:, off.reshape(-1)], 0.0)
                out = out + val * wc.reshape(-1)
    return out.reshape((C,) + tuple(q[0].shape))


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
