"""Dense flow-field registration engine, direct-field mode (counterpart of
``torchregister_tpu/engines/flow.py`` with ``flow_model='field'``).

The parameters ARE the displacement field ``[1, d, *S]`` (voxels), optimized
against the similarity stack plus a diffusion regularizer. The loop stops
when the recorded loss is ``<= stop_crit``, after ``max_epochs``, or (with
``stop_rel``) after ``patience`` steps in which the step's loss did not
improve on the reference loss by ``stop_rel`` — the step's loss, not the
best loss as in the matrix engines. ``method='separable'`` warps by sweeps
inside ``max_disp``; any other ``method`` warps with the exact
``ops/resample.warp_flow``, in the loop and for the returned image, as in the
JAX package. The U-Net mode is not ported yet.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..losses import resolve_criteria, weighted_loss
from ..ops.resample import warp_flow
from ..ops.separable import warp_flow_separable
from .common import make_optimizer
from .rigid import check_engine_options


class FlowResult(NamedTuple):
    flow: torch.Tensor  # [1, d, *S] voxel-unit displacement field
    losses: torch.Tensor  # [max_epochs], NaN beyond the executed steps
    steps: int  # optimizer steps executed
    converged: bool  # stopped by stop_crit
    params: torch.Tensor  # the field itself
    max_disp: torch.Tensor | None = None  # max |flow| (scalar)


def _diffusion_energy(flow: torch.Tensor) -> torch.Tensor:
    """Sum over axes of the mean squared forward difference of ``flow``."""
    f = flow.to(torch.float32)
    total = 0.0
    for a in range(2, flow.ndim):
        d = torch.diff(f, dim=a)
        total = total + torch.mean(d * d)
    return total


def flow_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-3,
    max_epochs: int = 2000,
    stop_crit: float = 1e-4,
    criterions=None,
    weights=None,
    grad_edges: bool = False,
    optimizer: str = "sgd",
    method: str = "separable",
    max_disp: int = 8,
    dtype: str = "float32",
    init_params: torch.Tensor | None = None,
    check_disp: bool = True,
    flow_model: str = "unet",
    smooth: float = 0.0,
    stop_rel: float | None = None,
    patience: int = 25,
) -> tuple[torch.Tensor, FlowResult]:
    """Deformable registration of ``moving [1, C, *S]`` onto ``target``;
    returns ``(warped, FlowResult)``.

    ``dtype`` sets the image side of each step (sweeps and loss inputs); the
    field, the optimizer state and the returned final warp stay f32.
    ``init_params`` warm-starts the field (upsample it with
    ``utils.pyramid.upsample_flow`` across resolutions). With ``check_disp``
    a RuntimeWarning fires when the field outgrows ``max_disp``.
    """
    if flow_model != "field":
        raise NotImplementedError(
            f"flow_model={flow_model!r} is not ported yet: ROADMAP queue 1 item 11 "
            "(U-Net parity mode, kernel K3)")
    check_engine_options(grad_edges)
    criteria, w = resolve_criteria(criterions, weights)
    loss = weighted_loss(criteria, w)
    ndim = moving.ndim - 2
    if optimizer == "sgd" and lr <= 1e-2:
        warnings.warn(
            f"flow_register(flow_model='field') with optimizer='sgd' and lr={lr:g}: "
            "SGD at unet-scale learning rates barely moves a direct field. Use "
            "optimizer='adam' with lr~0.3, or raise lr substantially.",
            RuntimeWarning,
            stacklevel=2,
        )
    img_dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def warp(src, flow):
        if method == "separable":
            return warp_flow_separable(src, flow, max_disp=max_disp)
        return warp_flow(src, flow)

    mov_s, tgt_s = moving.to(img_dt), target.to(img_dt)
    if init_params is None:
        init_params = torch.zeros((moving.shape[0], ndim) + tuple(moving.shape[2:]),
                                  dtype=torch.float32, device=moving.device)
    params = init_params.detach().to(torch.float32).clone().requires_grad_(True)
    opt = make_optimizer(optimizer, [params], lr)
    losses = np.full((max_epochs,), np.nan, np.float32)
    last = ref = np.float32(np.inf)
    factor = None if stop_rel is None else np.float32(1.0 - stop_rel)
    since = 0
    i = 0
    while i < max_epochs and last > stop_crit and (factor is None or since < patience):
        opt.zero_grad(set_to_none=True)
        sim = loss(tgt_s, warp(mov_s, params))
        total = sim + smooth * _diffusion_energy(params) if smooth > 0.0 else sim
        total.backward()
        loss_val = np.float32(total.item())
        opt.step()
        losses[i] = loss_val
        if factor is not None:
            if loss_val < ref * factor:
                ref, since = loss_val, 0
            else:
                since += 1
        last = loss_val
        i += 1
    flow = params.detach()
    with torch.no_grad():
        warped = warp(moving, flow)  # method-consistent final warp
    maxd = torch.max(torch.abs(flow))
    if check_disp and method == "separable":
        maxd_host = float(maxd)
        if maxd_host > max_disp:
            warnings.warn(
                f"flow_register: recovered flow reaches {maxd_host:.1f} voxels but "
                f"the separable sweep window is max_disp={max_disp}; displacements "
                "beyond it contribute zero. Raise max_disp.",
                RuntimeWarning,
                stacklevel=2,
            )
    return warped, FlowResult(
        flow=flow, losses=torch.from_numpy(losses).to(moving.device), steps=i,
        converged=bool(last <= stop_crit), params=flow, max_disp=maxd)
