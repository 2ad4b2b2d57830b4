"""Affine registration engine (counterpart of
``torchregister_tpu/engines/affine.py``): the parameters are theta itself, a
flat identity-initialized ``[d*(d+1)]`` vector. ``grad_edges`` as in
``engines/rigid.py``."""
from __future__ import annotations

import torch

from ..losses import resolve_criteria, weighted_loss
from ..ops.blocked import warp_affine_fast
from ..ops.edge import edge_filter
from ..ops.resample import warp_affine
from ..ops.separable import _warp_affine_separable
from ..ops.transforms import identity_theta
from .common import (
    RegistrationResult,
    check_sweep_windows,
    optimize_scan,
    resolve_sweep_windows,
)


def affine_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-5,
    epochs: int = 1000,
    criterions=None,
    weights=None,
    grad_edges: bool = True,
    optimizer: str = "sgd",
    init_theta: torch.Tensor | None = None,
    method: str = "separable",
    max_shift=None,
    check_window: bool = True,
    stop_rel: float | None = None,
    patience: int = 25,
    progress_every: int | None = None,
) -> tuple[torch.Tensor, RegistrationResult]:
    """Register ``moving [1,1,*S]`` onto ``target`` with a full affine
    matrix; returns ``(warped_best, result)``. ``init_theta`` (``[1, d,
    d+1]`` or flat) warm-starts, identity by default. ``method`` and
    ``progress_every`` as in :func:`rigid_register`."""
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    loss = weighted_loss(criteria, w)
    ndim = moving.ndim - 2
    spatial = tuple(moving.shape[2:])
    if init_theta is None:
        params0 = identity_theta(ndim, device=moving.device).reshape(-1)
    else:
        params0 = init_theta.to(torch.float32).reshape(-1)
    separable = method == "separable"
    windows = resolve_sweep_windows(
        params0.detach().cpu().double().numpy().reshape(ndim, ndim + 1), spatial,
        max_shift) if separable else None

    def loss_fn(params):
        theta = params.reshape(1, ndim, ndim + 1)
        warped = (_warp_affine_separable(theta, moving, max_shift=windows) if separable
                  else warp_affine(theta, moving))
        return loss(target, warped)

    final_params, best_params, best_loss, losses, hist, steps = optimize_scan(
        loss_fn, params0, optimizer, lr, epochs, stop_rel, patience,
        progress_every, "affine_register")
    result = RegistrationResult(
        final_theta=final_params.reshape(1, ndim, ndim + 1),
        best_theta=best_params.reshape(1, ndim, ndim + 1),
        final_params=final_params, best_params=best_params, losses=losses,
        best_loss=best_loss, param_history=hist, steps=steps,
    )
    if not separable:
        return warp_affine_fast(result.best_theta, moving), result
    with torch.no_grad():
        warped_best = _warp_affine_separable(result.best_theta, moving,
                                             max_shift=windows)
    if check_window:
        check_sweep_windows(result.best_theta, spatial, windows, "affine_register")
    return warped_best, result
