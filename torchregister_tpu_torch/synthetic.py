"""Synthetic registration pairs, their scoring and the cascade recipe.

Counterparts of ``bench.py``'s ``make_pair``, ``make_flow_truth_pair``,
``total_sampling_map``, ``flow_truth_metrics``, ``RECIPE`` and the U-Net
control's recipe (same values, same seeds: the volumes come from the same
numpy draws).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.grid import identity_index_grid
from .ops.resample import warp_affine, warp_flow
from .ops.separable import affine_to_index_map
from .ops.transforms import rigid_theta

# The JAX package's measured cascade recipe (bench.py:RECIPE), value for value.
RECIPE = dict(
    stages=("rigid", "affine", "flow"),
    levels=3,
    rigid_epochs=500,
    rigid_lr=3e-3,
    affine_epochs=200,
    affine_lr=1e-3,
    flow_lr=0.3,
    criterions=("mse", "ncc"),
    optimizer="adam",
    n=8,
    flow_dtype="float32",
    level_decay=3.5,
    matrix_dtype="bfloat16",
    matrix_stop_rel=1e-3,
    matrix_patience=10,
    matrix_levels=2,
    moment_init=True,
    flow_model="field",
    flow_smooth=(0.5, 0.5, 0.25),
    residual_shift=6,
    flow_max_size=256,
    flow_levels=3,
    flow_epochs=450,
    flow_stop_rel=1e-3,
    flow_patience=25,
)

# The U-Net parity control (bench.py:run_cascade_unet): RECIPE with the
# reference's flow model on the half-resolution, 2-level, 300-epoch geometry.
RECIPE_UNET = {**RECIPE, "flow_model": "unet", "flow_smooth": None,
               "flow_max_size": 160, "flow_levels": 2, "flow_epochs": 300}


def make_pair(shape=(240, 240, 240), seed=0, device="cpu"):
    """A sum of 8 random Gaussian blobs and its image under a known rigid
    transform: ``(moving, target)``, each ``[1, 1, *shape]`` f32."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(
        *[np.linspace(-1, 1, s, dtype=np.float32) for s in shape], indexing="ij"
    )
    vol = np.zeros(shape, np.float32)
    for _ in range(8):
        c = rng.uniform(-0.5, 0.5, 3)
        w = rng.uniform(0.1, 0.35)
        vol += np.exp(
            -sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2)
        ).astype(np.float32)
    moving = torch.from_numpy(vol[None, None]).to(device)
    true = rigid_theta(torch.tensor([0.06, -0.04, 0.05, 0.2, -0.15, 0.1],
                                    dtype=torch.float32, device=device))
    return moving, warp_affine(true[None], moving)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in, out]`` weights of a cubic upsample with half-pixel centres,
    renormalized over the taps inside the input (``jax.image.resize(...,
    'cubic')`` when upsampling: no antialias scaling of the kernel)."""
    inv_scale = in_size / out_size
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None])
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def cubic_resize(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """Separable tricubic resize of the trailing ``len(out_spatial)`` dims of
    ``x`` (computed in f64, returned in ``x``'s dtype)."""
    d = len(out_spatial)
    y = x.to(torch.float64)
    for a, out in enumerate(out_spatial):
        dim = x.ndim - d + a
        if y.shape[dim] == out:
            continue
        w = torch.from_numpy(cubic_weights(y.shape[dim], out)).to(y.device)
        y = torch.movedim(torch.movedim(y, dim, -1) @ w, -1, dim)
    return y.to(x.dtype)


def make_flow_truth_pair(shape=(240, 240, 240), seed=1, max_disp=7.0,
                         rigid=(0.05, -0.03, 0.04, 0.12, -0.1, 0.08), device="cpu"):
    """Deformable ground-truth pair ``(moving, target, theta_true, flow_true)``
    with ``target(x) = moving(A_true(x + f_true(x)))``: a band-limited field
    (cubic upsample of a 6³ normal draw, scaled to ``max_disp`` voxels)
    composed with a known rigid theta."""
    moving, _ = make_pair(shape, seed=seed, device=device)
    rng = np.random.default_rng(seed + 17)
    coarse = torch.from_numpy(rng.normal(size=(3, 6, 6, 6)).astype(np.float32))
    flow = cubic_resize(coarse.to(device), shape)
    flow = flow * (max_disp / torch.max(torch.abs(flow)))
    flow_true = flow[None]
    theta_true = rigid_theta(torch.tensor(rigid, dtype=torch.float32, device=device))[None]
    target = warp_flow(warp_affine(theta_true, moving), flow_true)
    return moving, target, theta_true, flow_true


def total_sampling_map(theta, flow, spatial) -> torch.Tensor:
    """``phi(x) = A(x + f(x))`` in index space, ``[d, *S]``."""
    d = len(spatial)
    ident = identity_index_grid(spatial, device=theta.device)
    y = ident if flow is None else ident + flow[0]
    M, t = affine_to_index_map(theta[0].to(torch.float32), spatial, align_corners=False)
    return torch.einsum("ij,j...->i...", M, y) + t.reshape((d,) + (1,) * d)


def flow_truth_metrics(res, moving, target, theta_true, flow_true):
    """``(rmse_reduction_pct, field_err_vox, field_err_observable_vox)``:
    image RMSE reduction, and the foreground-mean total-map error and its
    component along the target's intensity gradient."""
    spatial = tuple(moving.shape[2:])
    e = (total_sampling_map(res.theta, res.flow, spatial)
         - total_sampling_map(theta_true, flow_true, spatial))
    fg = target[0, 0] > 0.1 * float(torch.max(target))
    err = torch.linalg.vector_norm(e, dim=0)
    g = torch.stack(torch.gradient(target[0, 0]))
    gn = g / (torch.linalg.vector_norm(g, dim=0, keepdim=True) + 1e-8)
    e_par = torch.abs(torch.sum(e * gn, dim=0))
    n_fg = torch.sum(fg)
    field_err = float(torch.sum(torch.where(fg, err, 0.0)) / n_fg)
    field_err_obs = float(torch.sum(torch.where(fg, e_par, 0.0)) / n_fg)
    return rmse_reduction_pct(res.warped, moving, target), field_err, field_err_obs


def rmse_reduction_pct(warped, moving, target) -> float:
    """``100 * (1 - rmse(warped, target) / rmse(moving, target))``."""
    r0 = float(torch.sqrt(torch.mean((moving - target) ** 2)))
    r1 = float(torch.sqrt(torch.mean((warped - target) ** 2)))
    return 100.0 * (1.0 - r1 / max(r0, 1e-12))
