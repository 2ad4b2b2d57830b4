"""Affine registration engine (counterpart of
``torchregister_tpu/engines/affine.py``): the parameters are theta itself, a
flat identity-initialized ``[d*(d+1)]`` vector. ``grad_edges`` as in
``engines/rigid.py``."""
from __future__ import annotations

import torch

from ..losses import resolve_criteria
from ..ops.edge import edge_filter
from ..ops.transforms import identity_theta
from .common import (RegistrationResult, finish_matrix, first_pair, fit_matrix,
                     resolve_sweep_windows)


def affine_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-5,
    epochs: int = 1000,
    per: float = 0.1,
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
    ``progress_every`` as in :func:`rigid_register`; ``per`` is accepted and
    unused, as there. The loop is ``engines/common.fit_matrix`` on one
    pair; space-sharded volumes as in :func:`rigid_register`."""
    del per
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    ndim = moving.ndim - 2
    spatial = tuple(moving.shape[2:])
    if init_theta is None:
        params0 = identity_theta(ndim, device=moving.device).reshape(-1)
    else:
        params0 = init_theta.to(torch.float32).reshape(-1)
    separable = method == "separable"
    # the init theta is read on the host only to size windows not given
    windows = resolve_sweep_windows(
        None if max_shift is not None
        else params0.detach().cpu().double().numpy().reshape(ndim, ndim + 1), spatial,
        max_shift) if separable else None
    result = first_pair(fit_matrix(moving, target, params0[None], affine_theta, criteria, w,
                                   optimizer, lr, epochs, windows, separable, stop_rel,
                                   patience, progress_every, "affine_register"))
    return finish_matrix(result, moving, spatial, windows, separable, check_window,
                         "affine_register")


def affine_theta(params: torch.Tensor) -> torch.Tensor:
    """The affine engine's parameters ``[..., d*(d+1)]`` as thetas ``[...,
    d, d+1]``."""
    d = 3 if params.shape[-1] == 12 else 2
    return params.reshape(params.shape[:-1] + (d, d + 1))
