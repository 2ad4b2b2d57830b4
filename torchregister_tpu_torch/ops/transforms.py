"""Rigid-transform parameterizations: raw parameters -> affine matrices.

Counterpart of ``torchregister_tpu/ops/transforms.py`` (same conventions):

- 3D params ``[psi, theta, phi, t0, t1, t2]``: ZYX-style Euler rotation and
  translations bounded by ``max_translate * tanh(t)``;
- 2D params ``[theta, t0, t1]`` with raw, unbounded translations;
- a matrix ``theta [d, d+1]`` follows ``F.affine_grid``: row ``r`` maps the
  homogeneous normalized output coordinate ``(x, y[, z], 1)`` to source
  coordinate ``r``.
"""
from __future__ import annotations

import numpy as np
import torch

# Theta composition feeds coordinate math: keep f32 products in full f32 on
# the card (the JAX side forces Precision.HIGHEST for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False


def rigid_theta_3d(params: torch.Tensor, max_translate: float = 0.25) -> torch.Tensor:
    """6 raw rigid params -> ``[3, 4]`` affine matrix (``[..., 6]`` ->
    ``[..., 3, 4]``)."""
    psi, th, phi = params[..., 0], params[..., 1], params[..., 2]
    sp, cp = torch.sin(psi), torch.cos(psi)
    st, ct = torch.sin(th), torch.cos(th)
    sf, cf = torch.sin(phi), torch.cos(phi)
    t = max_translate * torch.tanh(params[..., 3:6])
    row0 = torch.stack([cp * ct, sf * sp * ct - cf * st, cf * sp * ct + sf * st, t[..., 0]],
                       dim=-1)
    row1 = torch.stack([cp * st, sf * sp * st + cf * ct, cf * sp * st - sf * ct, t[..., 1]],
                       dim=-1)
    row2 = torch.stack([-sp, sf * cp, cf * cp, t[..., 2]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rigid_theta_2d(params: torch.Tensor) -> torch.Tensor:
    """3 raw rigid params ``[theta, t0, t1]`` -> ``[2, 3]`` affine matrix
    (``[..., 3]`` -> ``[..., 2, 3]``)."""
    th = params[..., 0]
    s, c = torch.sin(th), torch.cos(th)
    return torch.stack([torch.stack([c, -s, params[..., 1]], dim=-1),
                        torch.stack([s, c, params[..., 2]], dim=-1)], dim=-2)


def rigid_theta(params: torch.Tensor, max_translate: float = 0.25) -> torch.Tensor:
    """Dispatch on parameter count: 6 -> 3D ``[3,4]``, 3 -> 2D ``[2,3]``
    (leading axes of ``params`` kept)."""
    if params.shape[-1] == 6:
        return rigid_theta_3d(params, max_translate)
    if params.shape[-1] == 3:
        return rigid_theta_2d(params)
    raise ValueError(f"rigid params must have 3 or 6 elements, got {tuple(params.shape)}")


def rigid_theta_np(params, max_translate: float = 0.25) -> np.ndarray:
    """Host (numpy, f64) mirror of :func:`rigid_theta` for window sizing."""
    if isinstance(params, torch.Tensor):
        params = params.detach().cpu().numpy()
    p = np.asarray(params, np.float64)
    if p.shape[-1] == 3:
        th, t0, t1 = p
        s, c = np.sin(th), np.cos(th)
        return np.array([[c, -s, t0], [s, c, t1]])
    psi, th, phi = p[0], p[1], p[2]
    sp, cp = np.sin(psi), np.cos(psi)
    st, ct = np.sin(th), np.cos(th)
    sf, cf = np.sin(phi), np.cos(phi)
    t = max_translate * np.tanh(p[3:6])
    return np.array(
        [
            [cp * ct, sf * sp * ct - cf * st, cf * sp * ct + sf * st, t[0]],
            [cp * st, sf * sp * st + cf * ct, cf * sp * st - sf * ct, t[1]],
            [-sp, sf * cp, cf * cp, t[2]],
        ]
    )


def identity_theta(ndim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity affine matrix ``[ndim, ndim+1]``."""
    return torch.cat(
        [torch.eye(ndim, dtype=dtype, device=device),
         torch.zeros((ndim, 1), dtype=dtype, device=device)], dim=1
    )


def as_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Normalize a theta to ``[N, d, d+1]`` (accepts ``[d, d+1]``, flat
    ``[6]``/``[12]``, ``[N, 6]``/``[N, 12]`` or batched matrices)."""
    if theta.ndim == 1:
        theta = theta[None]
    if theta.ndim == 2:
        n, m = theta.shape
        if (n, m) in ((2, 3), (3, 4)):
            theta = theta[None]
        elif m == 6:
            theta = theta.reshape(n, 2, 3)
        elif m == 12:
            theta = theta.reshape(n, 3, 4)
        else:
            raise ValueError(f"cannot interpret theta of shape {tuple(theta.shape)}")
    return theta


def compose_theta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ∘ b`` as coordinate maps (``x -> a(b(x))``), ``[N, d, d+1]``."""
    a = as_matrix(a)
    b = as_matrix(b)
    d = a.shape[-2]
    last = torch.zeros((b.shape[0], 1, d + 1), dtype=a.dtype, device=a.device)
    last[..., d] = 1.0
    bh = torch.cat([b.to(a.dtype), last], dim=-2)
    return torch.matmul(a, bh)
