"""Separable resampling: affine and flow warps as chains of 1-D sweeps.

Counterpart of ``torchregister_tpu/ops/separable.py``. The normalized affine
theta becomes an index-space map ``s = M o + t``, ``M`` is factored into
per-axis elementary passes (x-pass first), and each pass resamples one axis
at ``q = coef . o + offset`` inside a static window ``[-K, K+1]``.
Displacements beyond the window contribute zero; out-of-volume reads are
zero, as in ``grid_sample``. Dense flow warps are one pass per component.

Every pass goes through kernel K1 (``ops/cuda/sweep.py``): on the card a
whole warp is one autograd Function whose kernels compute each pass's
coordinates themselves (from the pass's (coef, offset) or the flow's
channel); on the CPU each pass builds its coordinate grid and takes K1's
plain version. An affine warp of a volume split into slabs over a mesh
(``parallel/mesh.py``'s ``space`` axis) runs each slab's passes in K1's slab
mode, the halo fetched before the pass along the split axis wherever the
factorization puts it; the warp is the unsharded one to the bit. The JAX package's three forms of the sweep (unrolled,
``fori`` and Pallas) and their routing thresholds exist for the TPU and have
no counterpart here.
"""
from __future__ import annotations

import functools
import warnings
from typing import Sequence

import numpy as np
import torch

from .cuda.sweep import _axis_coord_grid  # noqa: F401  (the JAX module's name)
from .cuda.sweep import sweep, sweep_affine_passes, sweep_flow_passes
from .transforms import as_matrix

# --------------------------------------------------------------------- maps


@functools.lru_cache(maxsize=64)
def _scales(spatial: tuple, align_corners: bool, device: torch.device):
    """``(scale_out, off_out, scale_in, off_in)`` of a grid, made once per
    shape and device: an in-loop warp then makes no host-to-device copy,
    which would wait for the work queued before it."""
    sizes = torch.tensor(list(spatial), dtype=torch.float32, device=device)
    if align_corners:
        return 2.0 / (sizes - 1.0), -torch.ones_like(sizes), (sizes - 1.0) / 2.0, (
            sizes - 1.0) / 2.0
    return 2.0 / sizes, 1.0 / sizes - 1.0, sizes / 2.0, sizes / 2.0 - 0.5


def affine_to_index_map(theta: torch.Tensor, spatial: Sequence[int],
                        align_corners: bool = False):
    """Normalized theta ``[d, d+1]`` -> index map ``s = M @ o + t`` (array
    axis order, z first); thetas ``[B, d, d+1]`` give ``M [B, d, d]`` and
    ``t [B, d]``."""
    d = len(spatial)
    # theta rows/cols are ordered (x, y, z); array axes are (z, y, x)
    A = torch.flip(theta[..., :d], dims=(-2, -1))
    b = torch.flip(theta[..., d], dims=(-1,))
    scale_out, off_out, scale_in, off_in = _scales(tuple(spatial), bool(align_corners),
                                                   theta.device)
    M = A * scale_in[:, None] * scale_out[None, :]
    # a batch's products one pair at a time, each the single-pair product
    Ao = (A @ off_out if A.ndim == 2
          else torch.stack([a @ off_out for a in torch.unbind(A)]))
    t = scale_in * (Ao + b) + off_in
    return M, t


_PIVOT_EPS = 1e-4  # absolute clamp on factorization divisors
_PIVOT_REL = 0.15  # scaled-minor threshold below which the factorization is
# degenerate (rotation near 90 deg); the checked wrapper uses the exact warp


def _safe_div_den(den: torch.Tensor) -> torch.Tensor:
    """Clamp a factorization divisor away from zero, keeping its sign."""
    mag = torch.clamp(torch.abs(den), min=_PIVOT_EPS)
    return torch.where(den < 0, -mag, mag)


def factor_passes(M: torch.Tensor, t: torch.Tensor):
    """Factor ``s = M o + t`` into per-axis passes, x-pass first: a list of
    ``(axis, (coef [d], offset))``; a batch ``M [B, d, d]``, ``t [B, d]``
    gives ``coef [B, d]`` and ``offset [B]``."""
    d = M.shape[-1]

    def m(r, c):
        return M[..., r, c]

    if d == 2:
        g = (M[..., 0, :], t[..., 0])
        e0 = m(1, 0) / _safe_div_den(m(0, 0))
        e1 = m(1, 1) - e0 * m(0, 1)
        et = t[..., 1] - e0 * t[..., 0]
        return [(1, (torch.stack([e0, e1], dim=-1), et)), (0, g)]
    if d == 3:
        g = (M[..., 0, :], t[..., 0])
        f0 = m(1, 0) / _safe_div_den(m(0, 0))
        f1 = m(1, 1) - f0 * m(0, 1)
        f2 = m(1, 2) - f0 * m(0, 2)
        ft = t[..., 1] - f0 * t[..., 0]
        f = (torch.stack([f0, f1, f2], dim=-1), ft)
        det = _safe_div_den(m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0))
        e0 = (m(2, 0) * m(1, 1) - m(2, 1) * m(1, 0)) / det
        e1 = (m(2, 1) * m(0, 0) - m(2, 0) * m(0, 1)) / det
        e2 = m(2, 2) - e0 * m(0, 2) - e1 * m(1, 2)
        et = t[..., 2] - e0 * t[..., 0] - e1 * t[..., 1]
        return [(2, (torch.stack([e0, e1, e2], dim=-1), et)), (1, f), (0, g)]
    raise ValueError(f"only 2D/3D supported, got d={d}")


def _index_map_np(theta: np.ndarray, spatial, align_corners: bool):
    """Host (numpy, f64) mirror of :func:`affine_to_index_map`."""
    d = len(spatial)
    sizes = np.asarray(spatial, np.float64)
    A = np.asarray(theta, np.float64)[:, :d][::-1, ::-1]
    b = np.asarray(theta, np.float64)[:, d][::-1]
    if align_corners:
        scale_out = 2.0 / (sizes - 1.0)
        off_out = -np.ones_like(sizes)
        scale_in = (sizes - 1.0) / 2.0
        off_in = (sizes - 1.0) / 2.0
    else:
        scale_out = 2.0 / sizes
        off_out = 1.0 / sizes - 1.0
        scale_in = sizes / 2.0
        off_in = sizes / 2.0 - 0.5
    M = A * scale_in[:, None] * scale_out[None, :]
    # a batch's products one pair at a time, each the single-pair product
    Ao = (A @ off_out if A.ndim == 2
          else torch.stack([a @ off_out for a in torch.unbind(A)]))
    t = scale_in * (Ao + b) + off_in
    return M, t


def _factor_passes_np(M: np.ndarray, t: np.ndarray):
    """Host mirror of :func:`factor_passes` (same elimination order)."""
    d = M.shape[0]
    if d == 2:
        g = (M[0].copy(), float(t[0]))
        e0 = M[1, 0] / M[0, 0]
        e = (np.array([e0, M[1, 1] - e0 * M[0, 1]]), float(t[1] - e0 * t[0]))
        return [(1, e), (0, g)]
    g = (M[0].copy(), float(t[0]))
    f0 = M[1, 0] / M[0, 0]
    f = (
        np.array([f0, M[1, 1] - f0 * M[0, 1], M[1, 2] - f0 * M[0, 2]]),
        float(t[1] - f0 * t[0]),
    )
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    e0 = (M[2, 0] * M[1, 1] - M[2, 1] * M[1, 0]) / det
    e1 = (M[2, 1] * M[0, 0] - M[2, 0] * M[0, 1]) / det
    e = (
        np.array([e0, e1, M[2, 2] - e0 * M[0, 2] - e1 * M[1, 2]]),
        float(t[2] - e0 * t[0] - e1 * t[1]),
    )
    return [(2, e), (1, f), (0, g)]


def _theta_np(theta, spatial) -> np.ndarray:
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    theta = np.asarray(theta, np.float64)
    if theta.ndim == 3:
        theta = theta[0]
    d = len(spatial)
    if theta.ndim == 1:
        theta = theta.reshape(d, d + 1)
    return theta


def min_scaled_pivot(theta, spatial, align_corners: bool = False) -> float:
    """Smallest scale-normalized leading principal minor of the index map
    (host numpy); below ``_PIVOT_REL`` the factorization is degenerate."""
    theta = _theta_np(theta, spatial)
    d = len(spatial)
    M, _ = _index_map_np(theta, spatial, align_corners)
    s = max(float(np.max(np.abs(M))), 1e-30)
    p1 = abs(float(M[0, 0])) / s
    if d == 2:
        return p1
    det2 = float(M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0])
    return min(p1, abs(det2) / (s * s))


def required_windows(theta, spatial, align_corners: bool = False) -> tuple[int, ...]:
    """Per-pass sweep windows (x-pass first) a concrete theta needs so no
    support is lost: the max of ``|q - o_a|`` over the output box."""
    theta = _theta_np(theta, spatial)
    d = len(spatial)
    M, t = _index_map_np(theta, spatial, align_corners)
    if min_scaled_pivot(theta, spatial, align_corners) < _PIVOT_REL:
        return tuple(int(spatial[a]) for a in range(d - 1, -1, -1))
    out = []
    for axis, (coef, offset) in _factor_passes_np(M, t):
        disp = np.asarray(coef, np.float64).copy()
        disp[axis] -= 1.0
        lo = hi = offset
        for b in range(d):
            ext = disp[b] * (spatial[b] - 1)
            lo += min(0.0, ext)
            hi += max(0.0, ext)
        ext_max = max(abs(lo), abs(hi))
        out.append(int(np.ceil(min(ext_max, float(spatial[axis])))))
    return tuple(out)


# -------------------------------------------------------------------- sweeps


def sweep_resample_axis(src: torch.Tensor, q: torch.Tensor, axis: int,
                        max_shift: int) -> torch.Tensor:
    """Linearly resample ``src [N, C, *S]`` along spatial ``axis`` at
    coordinates ``q`` (broadcastable to ``src``), window
    ``[-max_shift, max_shift+1]``. Output in ``src``'s dtype."""
    return sweep(src, q, axis + 2, int(max_shift))


def _warp_affine_separable(theta: torch.Tensor, moving: torch.Tensor,
                           align_corners: bool = False,
                           max_shift: int | Sequence[int] | None = None,
                           twice: bool = False) -> torch.Tensor:
    """Separable affine warp without the conditioning check (the engines'
    thetas stay near identity). One theta warps every item of ``moving``;
    thetas ``[N, d, d+1]`` warp each of its N items by its own (on the card
    one launch a pass over a table per item). ``twice=True``: differentiable
    twice on the card too (the LM engines' Hessian)."""
    theta = as_matrix(theta)
    if theta.shape[0] not in (1, moving.shape[0]):
        raise ValueError(f"separable path takes one theta or one per item, got "
                         f"{theta.shape[0]} for {moving.shape[0]} items")
    spatial = tuple(moving.shape[2:])
    d = len(spatial)
    theta = theta[0] if theta.shape[0] == 1 else theta
    M, t = affine_to_index_map(theta.to(torch.float32), spatial, align_corners)
    passes = factor_passes(M, t)
    if max_shift is None:
        shifts = [max(8, -(-spatial[axis] // 4)) for axis, _ in passes]
    elif isinstance(max_shift, int):
        shifts = [max_shift] * d
    else:
        shifts = list(max_shift)
    return sweep_affine_passes(moving, passes, shifts, twice)


def warp_affine_separable(theta: torch.Tensor, moving: torch.Tensor,
                          align_corners: bool = False,
                          max_shift: int | Sequence[int] | None = None
                          ) -> torch.Tensor:
    """Affine warp by per-axis sweeps. A theta whose factorization is
    degenerate (e.g. a near-90-degree rotation) goes to the exact resampler
    with a RuntimeWarning (one host read of theta)."""
    spatial = tuple(moving.shape[2:])
    pivot = min_scaled_pivot(theta, spatial, align_corners)
    if pivot < _PIVOT_REL:
        from .resample import warp_affine

        warnings.warn(
            f"warp_affine_separable: theta's per-axis factorization is "
            f"degenerate (scaled pivot {pivot:.3g} < {_PIVOT_REL}) — using the "
            "exact resampler.",
            RuntimeWarning,
            stacklevel=2,
        )
        return warp_affine(theta, moving, align_corners)
    return _warp_affine_separable(theta, moving, align_corners, max_shift)


def warp_flow_separable(src: torch.Tensor, flow: torch.Tensor,
                        max_disp: int = 8) -> torch.Tensor:
    """Dense-flow warp by per-component sweeps, x-pass first; pass ``a``
    samples axis ``a`` at ``o_a + flow_a(o)`` (``flow [N, d, *S]``, voxels)."""
    return sweep_flow_passes(src, flow, max_disp)
