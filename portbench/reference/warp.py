"""Plain-torch geometry and separable warps, written from their definitions.

A theta ``[d, d+1]`` follows ``F.affine_grid``: row r maps the homogeneous
normalized output coordinate ``(x, y, z, 1)`` to source coordinate r. In
index space (array axes z, y, x; half-pixel centres) it is ``s = M o + t``.
A separable warp factors ``M`` into one 1-D pass an axis, x first; each pass
resamples its axis linearly at ``q(o)`` and counts only the two taps that lie
inside the volume and inside the window ``[o - K, o + K + 1]``. A flow warp
is one pass a component, x first, pass a at ``o_a + flow_a(o)``.

Every function here is autograd-differentiable (to the source, the
coordinates, theta and the field). ``dtype`` rounds each pass's output to a
lower precision, as a warp of images held in that dtype does.
"""
from __future__ import annotations

import torch

_PIVOT_EPS = 1e-4  # the factorization's clamp on its divisors (the algorithm's)


def rigid_theta(params: torch.Tensor, max_translate: float = 0.25) -> torch.Tensor:
    """``[..., 6]`` raw rigid parameters ``(psi, theta, phi, t0, t1, t2)``
    to ``[..., 3, 4]``: a ZYX Euler rotation and translations
    ``max_translate * tanh(t)``."""
    psi, th, phi = params[..., 0], params[..., 1], params[..., 2]
    sp, cp = torch.sin(psi), torch.cos(psi)
    st, ct = torch.sin(th), torch.cos(th)
    sf, cf = torch.sin(phi), torch.cos(phi)
    t = max_translate * torch.tanh(params[..., 3:6])
    rows = [
        [cp * ct, sf * sp * ct - cf * st, cf * sp * ct + sf * st, t[..., 0]],
        [cp * st, sf * sp * st + cf * ct, cf * sp * st - sf * ct, t[..., 1]],
        [-sp, sf * cp, cf * cp, t[..., 2]],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def index_map(theta: torch.Tensor, spatial) -> tuple:
    """``(M [d, d], t [d])`` of ``theta [d, d+1]`` in index space."""
    d = len(spatial)
    sizes = torch.tensor(list(spatial), dtype=torch.float32, device=theta.device)
    A = torch.flip(theta[:, :d], dims=(0, 1))
    b = torch.flip(theta[:, d], dims=(0,))
    scale_out, off_out = 2.0 / sizes, 1.0 / sizes - 1.0
    scale_in, off_in = sizes / 2.0, sizes / 2.0 - 0.5
    M = A * scale_in[:, None] * scale_out[None, :]
    t = scale_in * (A @ off_out + b) + off_in
    return M, t


def _den(x: torch.Tensor) -> torch.Tensor:
    mag = torch.clamp(torch.abs(x), min=_PIVOT_EPS)
    return torch.where(x < 0, -mag, mag)


def factor_passes(M: torch.Tensor, t: torch.Tensor) -> list:
    """``s = M o + t`` as three passes ``(axis, coef [3], offset)``, x
    first: the x pass reads the source's x at its final value, the y pass
    solves y given the x already resampled, the z pass z given both."""
    m = lambda r, c: M[r, c]  # noqa: E731
    f0 = m(1, 0) / _den(m(0, 0))
    f = torch.stack([f0, m(1, 1) - f0 * m(0, 1), m(1, 2) - f0 * m(0, 2)])
    ft = t[1] - f0 * t[0]
    det = _den(m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0))
    e0 = (m(2, 0) * m(1, 1) - m(2, 1) * m(1, 0)) / det
    e1 = (m(2, 1) * m(0, 0) - m(2, 0) * m(0, 1)) / det
    e = torch.stack([e0, e1, m(2, 2) - e0 * m(0, 2) - e1 * m(1, 2)])
    et = t[2] - e0 * t[0] - e1 * t[1]
    return [(2, e, et), (1, f, ft), (0, M[0], t[0])]


def sweep(src: torch.Tensor, q: torch.Tensor, axis: int, K: int) -> torch.Tensor:
    """``src [N, C, *S]`` resampled linearly along spatial ``axis`` at
    ``q`` (broadcast to ``src``), window ``K``; computed in f32."""
    dim = axis + 2
    src = src.to(torch.float32)
    q = q.to(torch.float32).expand(src.shape)
    X = src.shape[dim]
    view = [1] * src.ndim
    view[dim] = X
    o = torch.arange(X, device=src.device).view(view)
    q0 = torch.floor(q)
    fr = q - q0
    jf = q0.to(torch.int64)
    out = 0.0
    for j, w in ((jf, 1.0 - fr), (jf + 1, fr)):
        inside = (j >= 0) & (j < X) & (j - o >= -K) & (j - o <= K + 1)
        v = torch.gather(src, dim, torch.clamp(j, 0, X - 1))
        out = out + torch.where(inside, v * w, 0.0)
    return out


def _grid(coef: torch.Tensor, offset: torch.Tensor, spatial) -> torch.Tensor:
    q = offset
    for b, s in enumerate(spatial):
        shape = [1] * len(spatial)
        shape[b] = s
        q = q + coef[b] * torch.arange(s, dtype=torch.float32, device=coef.device).view(shape)
    return q[None, None]


def hold(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` held in ``dtype`` (None: as it is). An 8-bit float has no
    arithmetic in torch: its values come back in bfloat16."""
    if dtype is None:
        return x
    if torch.finfo(dtype).bits == 8:
        return x.to(dtype).to(torch.bfloat16)
    return x.to(dtype)


def affine_warp(src: torch.Tensor, theta: torch.Tensor, K, dtype=None) -> torch.Tensor:
    """``src [1, C, *S]`` warped by ``theta [d, d+1]``, each pass within
    its window (``K`` an int, or one a pass, x first); f32 out, or each
    pass rounded to ``dtype``."""
    spatial = tuple(src.shape[2:])
    M, t = index_map(theta.to(torch.float32), spatial)
    Ks = [K] * 3 if isinstance(K, int) else list(K)
    out = hold(src, dtype)
    for (axis, coef, offset), k in zip(factor_passes(M, t), Ks):
        out = hold(sweep(out, _grid(coef, offset, spatial), axis, k), dtype)
    return out


def flow_warp(src: torch.Tensor, flow: torch.Tensor, K: int, dtype=None) -> torch.Tensor:
    """``src [1, C, *S]`` warped by the voxel field ``flow [1, d, *S]``,
    x pass first, each within ``K``; f32 out, or each pass rounded to
    ``dtype``."""
    d = flow.shape[1]
    out = hold(src, dtype)
    for axis in range(d - 1, -1, -1):
        S = src.shape[2 + axis]
        shape = [1] * d
        shape[axis] = S
        o = torch.arange(S, dtype=torch.float32, device=src.device).view(shape)
        q = (flow[:, axis].to(torch.float32) + o)[:, None]
        out = hold(sweep(out, q, axis, K), dtype)
    return out

