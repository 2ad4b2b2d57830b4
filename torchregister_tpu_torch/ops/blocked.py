"""The user-facing exact warps on kernel K2, and the ROI-gather route on K2b
(counterpart of ``warp_affine_fast``, ``warp_flow_fast`` and
``warp_affine_roi`` in ``torchregister_tpu/ops/blocked.py``).

The JAX module tiles the output, sizes gather blocks from the transform and
falls back to the element gather where a block would not fit: all of it
avoids XLA's slow gathers on a TPU. K2 reads each voxel's 8 corners
directly, so here every transform and size is one launch per batch element,
with the JAX batch rules: one theta for many volumes folds the batch into
channels, per-element transforms loop.

The ROI route is the JAX package's, with its two module-level settings and
their defaults: ``ROIGATHER_ENABLED`` (off) lets :func:`warp_affine_fast`
try the route first on a CUDA tensor, and ``ROIGATHER_FUSED`` (on) picks the
route's form. Fused, it is K2's affine mode, the counterpart of the fused
``_warp_kernel``, which :func:`warp_affine_fast` runs anyway; compact, it is
:func:`warp_affine_roi`: K2b's per-tile 16^3 windows
(``ops/cuda/roigather.py``) contracted with per-axis hat functions in torch
einsums (:func:`_roi_hat_contract`). The compact route is 3D, batch 1 and
at least 32 voxels a side, and declines (``None``) a transform whose 10^3
output tile needs more than a 16-wide source window; :func:`warp_affine_fast`
then runs K2 as usual.

Both exact warps also take a volume split into slabs
(``parallel.mesh.Sharded``, the ``space`` axis): each slab's outputs come
from K2's slab mode on a buffer of the source rows they reach, fetched from
the slabs that hold them (``parallel/halo.py``, which counts the bytes it
copies): for an affine warp the rows between the floors of the split axis's
coordinate at the slab's 8 output corners (K2's monotone-box argument; one
host read of the transform a call), for a flow warp the slab's rows widened
by the field's largest displacement along the split axis plus one (from
``max_disp`` when given, else one device reduction and a host read). Rows
outside the volume are not fetched (they read 0). Each output equals the
unsharded launch's to the bit.

Forward only, f32 images (K2 and K2b raise ``TypeError`` on any other dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda import roigather as k2b
from .cuda import warp as k2
from .separable import _index_map_np, affine_to_index_map
from .transforms import as_matrix

# the 8 corners of a box: (z, y, x), each 0 (first) or 1 (last)
_CORNERS = [(t >> 2 & 1, t >> 1 & 1, t & 1) for t in range(8)]

TILE = 10  # output tile edge of the ROI route
ROIGATHER_ENABLED = False  # warp_affine_fast tries warp_affine_roi first
ROIGATHER_FUSED = True  # the route is K2's affine mode, not K2b + hats


def _roi_supports(theta_np, spatial, align_corners):
    """Host-side per-tile window origins for K2b, or None when the
    transform's per-tile support exceeds the 16-wide windows. Returns
    (scalars [T, 5] int32, absolute origins [T, 3], grids, M, t)."""
    AW, BW, CW, QB = k2b.AW, k2b.BW, k2b.CW, k2b.QB
    M, t = _index_map_np(theta_np, spatial, align_corners)
    ext = (TILE - 1) * np.abs(M).sum(axis=1) + 3.0
    if (ext > np.asarray([AW, BW, CW], np.float64)).any():
        return None
    grids = [-(-s // TILE) for s in spatial]
    axes = [np.arange(g) * TILE for g in grids]
    og = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    corn = np.stack(
        np.meshgrid(*[np.asarray([0.0, TILE - 1.0])] * 3, indexing="ij"), -1
    ).reshape(8, 3)
    qc = (og[:, None, :] + corn[None]) @ M.T + t  # [T, 8, 3]
    qmin = np.floor(qc.min(axis=1)) - 1.0  # [T, 3]
    sizes = np.asarray(spatial, np.int64)
    org = np.clip(qmin.astype(np.int64), 0, sizes - (AW, BW, CW))
    zq, yq = org[:, 0] // QB, org[:, 1] // QB
    scal = np.stack(
        [zq, yq, org[:, 0] - QB * zq, org[:, 1] - QB * yq, org[:, 2]],
        axis=-1,
    ).astype(np.int32)
    return scal, org, grids, M, t


def _tile_grid(spatial, device):
    """Tile origins ``[T, 3]`` and in-tile offsets ``[V, 3]`` (f32) covering
    ``spatial`` padded up to TILE multiples, in the order of
    :func:`_roi_supports`."""
    grids = [-(-s // TILE) for s in spatial]
    axes = [torch.arange(g, device=device) * TILE for g in grids]
    tile_org = torch.stack([m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij")], -1)
    loc = torch.arange(TILE, device=device)
    loc = torch.stack([m.reshape(-1) for m in torch.meshgrid(loc, loc, loc, indexing="ij")], -1)
    return tile_org.to(torch.float32), loc.to(torch.float32)


def _untile(out_tv: torch.Tensor, grids, spatial) -> torch.Tensor:
    """``[T, TILE^3]`` tile-major values -> the volume ``spatial``."""
    out = out_tv.reshape(tuple(grids) + (TILE,) * 3).permute(0, 3, 1, 4, 2, 5)
    out = out.reshape(tuple(g * TILE for g in grids))
    return out[tuple(slice(0, s) for s in spatial)]


def _roi_hat_contract(blocks, orgs, M, t, grids, spatial, chunk: int = 216):
    """Exact trilinear values from K2b's windows ``blocks [T, CW, AW*BW]``
    fetched at ``orgs [T, 3]``: per-axis hat functions against absolute
    source positions, contracted in three einsums per chunk of tiles (the
    whole-T intermediate would be ~14 GB at 240^3). A corner outside the
    volume has no row in a window and gets no weight: ``grid_sample``'s zeros
    padding. f32 throughout (TF32 is off, ``ops/transforms.py``)."""
    AW, BW, CW = k2b.AW, k2b.BW, k2b.CW
    tile_org, loc = _tile_grid(spatial, blocks.device)
    orgs = orgs.to(torch.float32)
    T = blocks.shape[0]

    def hat(qs, org0, width):  # [ct, V], [ct] -> [ct, V, width]
        pos = org0[:, None] + torch.arange(width, dtype=torch.float32, device=qs.device)
        return torch.clamp(1.0 - torch.abs(qs[:, :, None] - pos[:, None, :]), min=0.0)

    out = torch.empty((T, TILE**3), dtype=torch.float32, device=blocks.device)
    for s0 in range(0, T, chunk):
        blk4 = blocks[s0:s0 + chunk].reshape(-1, CW, AW, BW)
        oc = tile_org[s0:s0 + chunk, None, :] + loc[None]  # [ct, V, 3]
        orgc = orgs[s0:s0 + chunk]
        q = [M[s, 0] * oc[..., 0] + M[s, 1] * oc[..., 1] + M[s, 2] * oc[..., 2] + t[s]
             for s in range(3)]
        u1 = torch.einsum("tva,tcab->tvcb", hat(q[0], orgc[:, 0], AW), blk4)
        u2 = torch.einsum("tvb,tvcb->tvc", hat(q[1], orgc[:, 1], BW), u1)
        out[s0:s0 + chunk] = torch.einsum("tvc,tvc->tv", hat(q[2], orgc[:, 2], CW), u2)
    return _untile(out, grids, spatial)


def warp_affine_roi(theta: torch.Tensor, moving: torch.Tensor,
                    align_corners: bool = False) -> torch.Tensor | None:
    """Exact affine warp of ``moving [1, C, Z, Y, X]`` by ``theta`` through
    the compact ROI route, K2b and the hats (``grid_sample`` parity), or
    None where the route does not apply: not 3D, a batch, an edge under 32,
    or a transform outside the 16-wide windows. Reads theta on the host (12
    floats): the windows and the index map of the warp come from it in
    float64, as in the JAX package, and the map is rounded once to f32 for
    the device."""
    theta = as_matrix(theta)
    spatial = tuple(moving.shape[2:])
    if len(spatial) != 3 or min(spatial) < 4 * k2b.QB or moving.shape[0] != 1:
        return None
    sup = _roi_supports(theta[0].detach().cpu().double().numpy(), spatial, align_corners)
    if sup is None:
        return None
    scal, org, grids, M, t = sup
    dev = moving.device
    M = torch.from_numpy(M).to(dev, torch.float32)
    t = torch.from_numpy(t).to(dev, torch.float32)
    scal = torch.from_numpy(scal).to(dev)
    org = torch.from_numpy(org).to(dev)
    vols = [_roi_hat_contract(k2b.roigather(moving[0, c], scal), org, M, t, grids, spatial)
            for c in range(moving.shape[1])]
    return torch.stack(vols)[None]


def warp_affine_fast(theta: torch.Tensor, moving: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Exact affine warp of ``moving [N, C, *S]`` (``grid_sample`` parity)
    by ``theta`` (``[1 or N, d, d+1]`` or flat). The index map is computed
    on ``theta``'s device and handed to the kernel there: no host sync
    (unless ``ROIGATHER_ENABLED`` with ``ROIGATHER_FUSED`` off sends a CUDA
    tensor to the compact ROI route)."""
    theta = as_matrix(theta)
    spatial = tuple(moving.shape[2:])
    N = moving.shape[0]
    if theta.shape[0] not in (1, N):
        raise ValueError(f"warp_affine_fast: {theta.shape[0]} thetas for a batch of {N}")
    if not isinstance(moving, torch.Tensor):
        return _affine_slabs(theta, moving, align_corners)
    if N > 1:
        if theta.shape[0] == 1:
            # one transform, many volumes: the batch is extra channels
            folded = moving.reshape((1, -1) + spatial)
            return warp_affine_fast(theta, folded, align_corners).reshape(moving.shape)
        return torch.cat([warp_affine_fast(theta[i:i + 1], moving[i:i + 1], align_corners)
                          for i in range(N)])
    if ROIGATHER_ENABLED and not ROIGATHER_FUSED and moving.is_cuda:
        out = warp_affine_roi(theta, moving, align_corners)
        if out is not None:
            return out
    M, t = affine_to_index_map(theta[0].to(torch.float32), spatial, align_corners)
    return k2.warp(moving[0], mt=k2.pack_affine(M, t))[None]


def warp_flow_fast(src: torch.Tensor, flow: torch.Tensor,
                   max_disp: float | None = None) -> torch.Tensor:
    """Exact flow warp of ``src [N, C, *S]`` by ``flow [N, d, *S]`` (voxels,
    channel ``i`` along spatial dim ``i``; cast to f32). ``max_disp`` is the
    JAX package's static bound on the displacement, from which it sizes its
    gather blocks; K2 reads each voxel's corners directly and needs no block
    bound, so the argument is accepted and changes nothing, on slabs too
    (there the rows to fetch come from the field itself)."""
    if flow.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_flow_fast: src batch {src.shape[0]} != flow batch "
            f"{flow.shape[0]} (one flow field per source element)")
    if not isinstance(src, torch.Tensor) or not isinstance(flow, torch.Tensor):
        return _flow_slabs(src, flow)
    if src.shape[0] > 1:
        return torch.cat([warp_flow_fast(src[i:i + 1], flow[i:i + 1], max_disp)
                          for i in range(src.shape[0])])
    return k2.warp(src[0], flow=flow[0].to(torch.float32))[None]


# ------------------------------------------------------------------- slabs


def _slab_layout(src):
    """``(dim, parts)`` of a volume split into slabs: the split dim and each
    slab's rows along it."""
    from ..parallel import halo

    dim, _ = src.slab_axis()
    if dim < 2:
        raise ValueError(f"K2's slab mode splits a spatial dim, got a split along dim {dim}")
    return dim, halo.equal(src.shape[dim], len(src.shards))


def _slab_origin(spatial, dim, lo) -> tuple:
    return tuple(lo if 2 + a == dim else 0 for a in range(len(spatial)))


def _affine_rows(mt: np.ndarray, spatial, dim, lo, hi) -> tuple:
    """The source rows ``[a, b)`` along ``dim`` that an affine block's
    outputs (rows ``[lo, hi)`` of the split dim) reach: the floors of that
    axis's coordinate at the block's 8 corners, computed as K2 computes it
    (f32, round to nearest, in its order), bound every output's corners;
    clamped to the volume (the whole volume for a non-finite map)."""
    d = len(spatial)
    view = (1,) * (3 - d) + tuple(spatial)
    box = [(0, n - 1) for n in view]
    kd = dim - 2 + (3 - d)  # the split axis in the kernel's (z, y, x) view
    box[kd] = (lo, hi - 1)
    m = mt.astype(np.float32).reshape(3, 4)
    f32 = np.float32
    qs = []
    for corner in _CORNERS:
        c = [f32(box[a][corner[a]]) for a in range(3)]
        qs.append(f32(f32(f32(m[kd, 0] * c[0]) + f32(m[kd, 1] * c[1])) + f32(m[kd, 2] * c[2]))
                  + m[kd, 3])
    S = spatial[dim - 2]
    if not all(np.isfinite(q) for q in qs):
        return 0, S
    a = int(np.floor(min(qs)))
    b = int(np.floor(max(qs))) + 2
    a, b = max(a, 0), min(b, S)
    return (a, b) if a < b else (0, 0)


def _affine_slabs(theta, moving, align_corners):
    """:func:`warp_affine_fast` of a volume split into slabs: each item's
    packed map read on the host once, each slab's source rows fetched and
    its block warped by K2's slab mode on its device."""
    from ..parallel import halo
    from ..parallel.mesh import from_blocks

    spatial = tuple(moving.shape[2:])
    dim, parts = _slab_layout(moving)
    maps = [k2.pack_affine(*affine_to_index_map(th.to(torch.float32), spatial, align_corners))
            for th in theta]
    host = torch.stack(maps).cpu().numpy()  # the one host read
    N = moving.shape[0]
    items = range(N) if len(maps) == N else [None]
    outs: list = [[] for _ in parts]
    for n in items:
        blocks = [b if n is None else b[n:n + 1] for b in moving.shards]
        mt, mt_np = maps[0 if n is None else n], host[0 if n is None else n]
        wants = [_affine_rows(mt_np, spatial, dim, lo, hi) for lo, hi in parts]
        bufs = halo.fetch_rows(blocks, parts, dim, wants)
        for k, ((lo, hi), (a, _), buf) in enumerate(zip(parts, wants, bufs)):
            flat = buf.reshape((1, -1) + tuple(buf.shape[2:]))[0]
            out = k2.warp_slab(flat, tuple(blocks[k].shape[2:]), _slab_origin(spatial, dim, lo),
                               _slab_origin(spatial, dim, a), spatial,
                               mt=mt.to(buf.device))
            outs[k].append(out.reshape(blocks[k].shape))
    return from_blocks([torch.cat(o) for o in outs], moving.sharding, moving.shape)


def _flow_slabs(src, flow):
    """:func:`warp_flow_fast` of a volume and a field split alike into
    slabs: each slab's rows widened by the item's largest displacement
    along the split axis plus one (one device reduction, read on the host
    once: a caller's bound could be short and leave rows unread), fetched,
    and its block warped by K2's slab mode on its device."""
    import math

    from ..parallel import halo
    from ..parallel.mesh import Sharded, from_blocks

    if not (isinstance(src, Sharded) and isinstance(flow, Sharded)) or (
            src.sharding.spec[2:] != flow.sharding.spec[2:] or src.mesh is not flow.mesh):
        raise ValueError("warp_flow_fast on slabs needs the volume and the field split alike")
    spatial = tuple(src.shape[2:])
    dim, parts = _slab_layout(src)
    S, N, a = spatial[dim - 2], src.shape[0], dim - 2
    reach = torch.stack([torch.stack([torch.max(torch.abs(f[n, a])).to(src.device)
                                      for f in flow.shards]).max()
                         for n in range(N)]).tolist()  # the one host read
    outs: list = [[] for _ in parts]
    for n in range(N):
        D = math.ceil(reach[n]) + 1 if math.isfinite(reach[n]) else S
        wants = [(max(lo - D, 0), min(hi + D, S)) for lo, hi in parts]
        bufs = halo.fetch_rows([b[n:n + 1] for b in src.shards], parts, dim, wants)
        for k, ((lo, hi), (w0, _), buf) in enumerate(zip(parts, wants, bufs)):
            f = flow.shards[k][n].to(torch.float32)
            outs[k].append(k2.warp_slab(buf[0], tuple(f.shape[1:]),
                                        _slab_origin(spatial, dim, lo),
                                        _slab_origin(spatial, dim, w0), spatial, flow=f)[None])
    return from_blocks([torch.cat(o) for o in outs], src.sharding, src.shape)
