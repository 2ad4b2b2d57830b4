"""Closed-form inits for the matrix stages (counterpart of
``torchregister_tpu/ops/moments.py``): centre of mass, and principal axes.

theta maps output normalized coords to source normalized coords, rows ordered
(x, y, z) = reversed array axes. For ``warped(x) = moving(x + t)``, matching
mass centres needs ``t = com(moving) - com(target)``.

Principal axes: for ``t(x) = m(R x + b)`` the weighted coordinate moments
transform as ``com_t = R^T (com_m - b)`` and ``C_t = R^T C_m R``, so with
eigenframes ``C = F diag(lam) F^T`` (ascending) ``R = F_m F_t^T`` and
``b = com_m - R com_t``. Eigenvector signs are fixed by the third central
moment along each axis, handedness by flipping the least-skewed axis. Near
isotropic or symmetric volumes make the frame unobservable; the init then
keeps the CoM translation with zero rotation. No host branching.
"""
from __future__ import annotations

import torch

from .grid import _axis_coords


def _pieces(img) -> tuple:
    """``(pieces, device)``: each piece ``(w, starts)`` of ``img [1, 1, *S]``,
    ``w = |img|`` in f32 and its first voxel's global index per axis; one
    piece for a tensor, one a slab (in ascending order) for a volume split
    into slabs (``parallel.mesh.Sharded``), whose sums the moments add in
    ascending slab order on the mesh's first device."""
    if isinstance(img, torch.Tensor):
        w = torch.abs(img[0, 0]).to(torch.float32)
        return [(w, (0,) * w.ndim)], w.device
    dim, _ = img.slab_axis()
    out = []
    for k, b in enumerate(img.shards):
        w = torch.abs(b[0, 0]).to(torch.float32)
        out.append((w, tuple(k * w.shape[a] if a == dim - 2 else 0 for a in range(w.ndim))))
    return out, img.device


def _total(pieces, device, fn) -> torch.Tensor:
    """``fn(w, starts)``'s sum over the volume: each piece's f32 sum, the
    pieces' sums added in their order on ``device``."""
    from ..parallel.mesh import ordered_sum

    return ordered_sum([torch.sum(fn(w, starts)) for w, starts in pieces], device)


def center_of_mass(img: torch.Tensor) -> torch.Tensor:
    """``|img|``-weighted centre of mass of ``img [1,1,*S]`` in index space,
    per array axis (f32, ``[d]``); a volume split into slabs sums each
    slab's mass and moments at global coordinates (:func:`_pieces`)."""
    pieces, device = _pieces(img)
    total = _total(pieces, device, lambda w, _: w) + 1e-12
    d = pieces[0][0].ndim

    def moment(a):
        def fn(w, starts):
            idx = torch.arange(starts[a], starts[a] + w.shape[a], dtype=torch.float32,
                               device=w.device)
            return torch.sum(w, dim=tuple(i for i in range(d) if i != a)) * idx
        return fn

    return torch.stack([_total(pieces, device, moment(a)) / total for a in range(d)])


def com_translation(moving: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Normalized translation ``[d]`` (theta row order, x first) moving
    ``moving``'s centre of mass onto ``target``'s."""
    spatial = torch.tensor(list(moving.shape[2:]), dtype=torch.float32,
                           device=moving.device)
    t_idx = center_of_mass(moving) - center_of_mass(target)
    return torch.flip(2.0 * t_idx / spatial, dims=(0,))


def com_rigid_params(moving: torch.Tensor, target: torch.Tensor,
                     max_translate: float = 0.25) -> torch.Tensor:
    """Raw rigid params with zero rotation and the CoM translation (3D
    translations inverted through ``max_translate * tanh``, clipped)."""
    ndim = moving.ndim - 2
    t = com_translation(moving, target)
    zeros = torch.zeros((3 if ndim == 3 else 1,), dtype=torch.float32, device=t.device)
    if ndim == 3:
        return torch.cat([zeros, torch.atanh(torch.clamp(t / max_translate, -0.96, 0.96))])
    return torch.cat([zeros, t])


def coordinate_moments(img: torch.Tensor):
    """``(com [d], cov [d, d], frame [d, d], lam [d], skew [d])`` of ``img
    [1, 1, *S]`` (or its slabs, :func:`_pieces`) in normalized coordinates,
    theta row order (x first).
    ``frame`` columns are covariance eigenvectors (ascending ``lam``), each
    sign-fixed so its third central moment ``skew`` is non-negative, with a
    right-handed frame restored by flipping the least-skewed axis."""
    pieces, device = _pieces(img)
    total = _total(pieces, device, lambda w, _: w) + 1e-12
    d = pieces[0][0].ndim
    sizes = img.shape[2:]

    def bcast(a, axis):
        shape = [1] * d
        shape[axis] = -1
        return a.reshape(shape)

    def coords(w, starts):  # the global normalized coordinates of a piece's voxels
        return [bcast(_axis_coords(sizes[a], False, device=w.device).narrow(
            0, starts[a], w.shape[a]), a) for a in range(d)]

    com = torch.stack([_total(pieces, device, lambda w, st, a=a: w * coords(w, st)[a])
                       / total for a in range(d)])

    def centered(w, starts):
        c = coords(w, starts)
        return [c[a] - com[a].to(w.device) for a in range(d)]

    cov = torch.stack([torch.stack([
        _total(pieces, device, lambda w, st, a=a, b=b: w * centered(w, st)[a]
               * centered(w, st)[b]) / total for b in range(d)]) for a in range(d)])
    lam, F = torch.linalg.eigh(cov)  # ascending; columns are eigenvectors
    skew = torch.stack([
        _total(pieces, device, lambda w, st, j=j: w * sum(
            c * F[a, j].to(w.device) for a, c in enumerate(centered(w, st))) ** 3) / total
        for j in range(d)])
    F = F * torch.where(skew < 0, -1.0, 1.0)[None, :]
    skew = torch.abs(skew)
    det = torch.linalg.det(F)
    least = torch.arange(d, device=device) == torch.argmin(skew)
    F = F * torch.where((det < 0) & least, -1.0, 1.0)[None, :]
    # array order (z, y, x) -> theta order (x, y, z): reverse the axes
    return (torch.flip(com, (0,)), torch.flip(cov, (0, 1)), torch.flip(F, (0,)), lam,
            skew)


def pa_rigid_params(moving: torch.Tensor, target: torch.Tensor,
                    max_translate: float = 0.25, gap_tol: float = 0.08,
                    skew_tol: float = 0.05) -> torch.Tensor:
    """Raw rigid params from principal axes and centres of mass; zero
    rotation (the CoM init) when either volume's relative eigengaps are below
    ``gap_tol`` or an axis' skewness is below ``skew_tol`` of its
    ``lam^1.5``. Euler angles as :func:`ops.transforms.rigid_theta_3d`
    builds them."""
    ndim = moving.ndim - 2
    com_m, _, F_m, lam_m, skew_m = coordinate_moments(moving)
    com_t, _, F_t, lam_t, skew_t = coordinate_moments(target)

    def reliable(lam, skew):
        lam = torch.clamp(lam, min=0.0)  # PSD up to eigh noise
        gaps = torch.diff(lam) / (lam[-1] + 1e-12)
        norm_skew = skew / (lam ** 1.5 + 1e-12)
        return torch.all(gaps > gap_tol) & torch.all(norm_skew > skew_tol)

    ok = reliable(lam_m, skew_m) & reliable(lam_t, skew_t)
    eye = torch.eye(ndim, dtype=torch.float32, device=F_m.device)
    R = torch.where(ok, F_m @ F_t.T, eye)
    b = com_m - R @ com_t
    if ndim == 3:
        psi = torch.asin(-torch.clamp(R[2, 0], -1.0, 1.0))
        th = torch.atan2(R[1, 0], R[0, 0])
        phi = torch.atan2(R[2, 1], R[2, 2])
        raw_t = torch.atanh(torch.clamp(b / max_translate, -0.96, 0.96))
        return torch.cat([torch.stack([psi, th, phi]), raw_t])
    return torch.cat([torch.atan2(R[1, 0], R[0, 0])[None], b])
