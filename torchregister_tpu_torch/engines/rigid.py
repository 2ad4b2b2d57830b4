"""Rigid (SE(2)/SE(3)) registration engine (counterpart of
``torchregister_tpu/engines/rigid.py``): a 6-vector (3D) or 3-vector (2D) of
raw parameters mapped by :func:`rigid_theta` and optimized through the
separable warp (``method='separable'``) or the exact resampler (any other
``method``, as in the JAX package). ``grad_edges=True`` (the default)
registers the Sobel edge masks of both images (``ops/edge.py``) instead of
the images, and the returned image is the warped mask, as in the JAX
package."""
from __future__ import annotations

import torch

from ..losses import resolve_criteria, weighted_loss
from ..ops.blocked import warp_affine_fast
from ..ops.edge import edge_filter
from ..ops.resample import warp_affine
from ..ops.separable import _warp_affine_separable
from ..ops.transforms import rigid_theta, rigid_theta_np
from .common import (
    RegistrationResult,
    check_sweep_windows,
    optimize_scan,
    resolve_sweep_windows,
)


def init_rigid_params(ndim: int, generator: torch.Generator | None = None,
                      init: str = "random", device=None) -> torch.Tensor:
    """Zero params (``'identity'``) or ``torch.rand`` draws (``'random'``)."""
    n = 6 if ndim == 3 else 3
    if init == "identity":
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return torch.rand((n,), generator=generator, dtype=torch.float32, device=device)


def rigid_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-5,
    epochs: int = 1000,
    criterions=None,
    weights=None,
    grad_edges: bool = True,
    optimizer: str = "sgd",
    init: str = "random",
    generator: torch.Generator | None = None,
    init_params: torch.Tensor | None = None,
    method: str = "separable",
    max_shift=None,
    check_window: bool = True,
    stop_rel: float | None = None,
    patience: int = 25,
    progress_every: int | None = None,
) -> tuple[torch.Tensor, RegistrationResult]:
    """Register ``moving [1,1,*S]`` onto ``target`` with a rigid transform;
    returns ``(warped_best, result)``. ``max_shift`` bounds the sweep;
    by default the windows cover the concrete init theta. Under
    ``method='exact'`` the loop warps with ``ops/resample.warp_affine`` and
    ``warped_best`` comes from K2 (``warp_affine_fast``).
    ``progress_every=N`` prints progress every N steps."""
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    loss = weighted_loss(criteria, w)
    ndim = moving.ndim - 2
    spatial = tuple(moving.shape[2:])
    if init_params is None:
        init_params = init_rigid_params(ndim, generator, init, moving.device)
    separable = method == "separable"
    windows = (resolve_sweep_windows(rigid_theta_np(init_params), spatial, max_shift)
               if separable else None)

    def loss_fn(params):
        theta = rigid_theta(params)[None]
        warped = (_warp_affine_separable(theta, moving, max_shift=windows) if separable
                  else warp_affine(theta, moving))
        return loss(target, warped)

    final_params, best_params, best_loss, losses, hist, steps = optimize_scan(
        loss_fn, init_params, optimizer, lr, epochs, stop_rel, patience,
        progress_every, "rigid_register")
    result = RegistrationResult(
        final_theta=rigid_theta(final_params)[None],
        best_theta=rigid_theta(best_params)[None],
        final_params=final_params, best_params=best_params, losses=losses,
        best_loss=best_loss, param_history=hist, steps=steps,
    )
    if not separable:
        return warp_affine_fast(result.best_theta, moving), result
    with torch.no_grad():
        warped_best = _warp_affine_separable(result.best_theta, moving,
                                             max_shift=windows)
    if check_window:
        check_sweep_windows(result.best_theta, spatial, windows, "rigid_register")
    return warped_best, result
