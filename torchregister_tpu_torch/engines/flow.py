"""Dense flow-field registration engine (counterpart of
``torchregister_tpu/engines/flow.py``), in both modes:

- ``flow_model='unet'``: an Attention U-Net (``models/attention_unet.py``,
  every 3D 3x3x3 convolution on kernel K3) predicts the displacement field of
  one pair and its weights are optimized (reference ``flow_register``,
  warpings.py:178-242);
- ``flow_model='field'``: the parameters ARE the field ``[1, d, *S]``
  (voxels), optimized against the similarity stack plus a diffusion
  regularizer.

The loop stops when the recorded loss is ``<= stop_crit``, after
``max_epochs``, or (with ``stop_rel``) after ``patience`` steps in which the
step's loss did not improve on the reference loss by ``stop_rel`` — the
step's loss, not the best loss as in the matrix engines. ``method='separable'``
warps by sweeps inside ``max_disp``; any other ``method`` warps with the exact
``ops/resample.warp_flow``, in the loop and for the returned image, as in the
JAX package. The returned flow is the post-update model's (or field's).
"""
from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses import resolve_criteria, weighted_loss
from ..models.attention_unet import AttentionUNet, max_depth_for
from ..ops.edge import edge_filter
from ..ops.resample import warp_flow
from ..ops.separable import warp_flow_separable
from .common import make_optimizer


class FlowResult(NamedTuple):
    flow: torch.Tensor  # [1, d, *S] voxel-unit displacement field
    losses: torch.Tensor  # [max_epochs], NaN beyond the executed steps
    steps: int  # optimizer steps executed
    converged: bool  # stopped by stop_crit
    params: Any  # the U-Net's state dict, or the field itself
    max_disp: torch.Tensor | None = None  # max |flow| (scalar)


def _diffusion_energy(flow: torch.Tensor) -> torch.Tensor:
    """Sum over axes of the mean squared forward difference of ``flow``."""
    f = flow.to(torch.float32)
    total = 0.0
    for a in range(2, flow.ndim):
        d = torch.diff(f, dim=a)
        total = total + torch.mean(d * d)
    return total


def _unet(moving, n, in_c, depth, use_attention, use_norm, dt, init_params, zero_head,
          generator) -> AttentionUNet:
    """The U-Net for ``moving``: ``init_params`` loaded, or fresh flax-style
    weights from ``generator`` (seed 0 without one), the flow head zeroed
    under ``zero_head``."""
    spatial = tuple(moving.shape[2:])
    if depth is None:
        depth = max_depth_for(spatial)
        if depth == 0:
            raise ValueError(f"volume {spatial} too small for the U-Net")
    model = AttentionUNet(ndim=len(spatial), in_c=in_c, n=n, depth=depth,
                          use_attention=use_attention, use_norm=use_norm,
                          dtype=dt).to(moving.device)
    if init_params is not None:
        model.load_state_dict(init_params)
        return model
    model.reset_parameters(torch.Generator().manual_seed(0) if generator is None
                           else generator)
    if zero_head:
        # the net predicts an exactly-zero field at step 0, so a residual
        # level starts from the alignment it is handed
        with torch.no_grad():
            model.out_kernel.zero_()
            model.out_bias.zero_()
    return model


def flow_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-3,
    max_epochs: int = 2000,
    stop_crit: float = 1e-4,
    n: float = 1,
    in_c: int = 1,
    criterions=None,
    weights=None,
    grad_edges: bool = False,
    optimizer: str = "sgd",
    depth: int | None = None,
    generator: torch.Generator | None = None,
    method: str = "separable",
    max_disp: int = 8,
    dtype: str = "float32",
    init_params=None,
    remat: bool = False,
    check_disp: bool = True,
    use_attention: bool = True,
    use_norm: bool = True,
    flow_model: str = "unet",
    smooth: float = 0.0,
    stop_rel: float | None = None,
    patience: int = 25,
    zero_head: bool = False,
    progress_every: int | None = None,
) -> tuple[torch.Tensor, FlowResult]:
    """Deformable registration of ``moving [1, in_c, *S]`` onto ``target``;
    returns ``(warped, FlowResult)``.

    U-Net mode: ``n`` divides the widths (64/n at the top level), ``depth``
    defaults to ``max_depth_for`` the volume, ``dtype`` is the network's
    compute dtype (its parameters and the flow head stay f32), ``remat``
    recomputes the forward in the backward (``torch.utils.checkpoint``), and
    ``init_params`` (a ``FlowResult.params`` state dict) warm-starts the
    weights; otherwise they are drawn from ``generator``. ``zero_head``
    zeroes the fresh flow head.

    Field mode: ``dtype`` sets the image side of each step (sweeps and loss
    inputs); the field, the optimizer state and the returned final warp stay
    f32. ``init_params`` warm-starts the field (upsample it with
    ``utils.pyramid.upsample_flow`` across resolutions).

    With ``check_disp`` a RuntimeWarning fires when the field outgrows
    ``max_disp``. ``grad_edges=True`` registers the images' Sobel edge
    masks (``ops/edge.py``). ``progress_every=N`` prints the loss every N
    steps and the cause of an early stop.
    """
    if flow_model not in ("unet", "field"):
        raise ValueError(f"flow_model must be unet|field, got {flow_model!r}")
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    loss = weighted_loss(criteria, w)
    ndim = moving.ndim - 2
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def warp(src, flow):
        if method == "separable":
            return warp_flow_separable(src, flow, max_disp=max_disp)
        return warp_flow(src, flow)

    if flow_model == "unet":
        model = _unet(moving, n, in_c, depth, use_attention, use_norm, dt, init_params,
                      zero_head, generator)
        trainable = list(model.parameters())
        mov_s, tgt_s = moving, target  # the model's own dtype reduces compute

        def predict(x):
            return checkpoint(model, x, use_reentrant=False) if remat else model(x)
    else:
        if optimizer == "sgd" and lr <= 1e-2:
            warnings.warn(
                f"flow_register(flow_model='field') with optimizer='sgd' and lr={lr:g}: "
                "SGD at unet-scale learning rates barely moves a direct field. Use "
                "optimizer='adam' with lr~0.3, or raise lr substantially.",
                RuntimeWarning,
                stacklevel=2,
            )
        mov_s, tgt_s = moving.to(dt), target.to(dt)
        if init_params is None:
            init_params = torch.zeros((moving.shape[0], ndim) + tuple(moving.shape[2:]),
                                      dtype=torch.float32, device=moving.device)
        field = init_params.detach().to(torch.float32).clone().requires_grad_(True)
        trainable = [field]

        def predict(x):
            return field

    opt = make_optimizer(optimizer, trainable, lr)
    losses = np.full((max_epochs,), np.nan, np.float32)
    last = ref = np.float32(np.inf)
    factor = None if stop_rel is None else np.float32(1.0 - stop_rel)
    since = 0
    i = 0
    while i < max_epochs and last > stop_crit and (factor is None or since < patience):
        opt.zero_grad(set_to_none=True)
        flow = predict(mov_s)
        sim = loss(tgt_s, warp(mov_s, flow))
        total = sim + smooth * _diffusion_energy(flow) if smooth > 0.0 else sim
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
        if progress_every and (i % progress_every == 0 or i == max_epochs):
            print(f"[flow_register] epoch {i}/{max_epochs} loss={last:.6g}", flush=True)
    if progress_every and i < max_epochs:
        if i % progress_every:
            print(f"[flow_register] epoch {i}/{max_epochs} loss={last:.6g}", flush=True)
        cause = (f"loss <= {stop_crit:g}" if last <= stop_crit
                 else f"plateau (stop_rel={stop_rel}, patience={patience})")
        print(f"[flow_register] stopped at epoch {i} ({cause})", flush=True)
    with torch.no_grad():
        flow = predict(moving).detach()
        warped = warp(moving, flow)  # method-consistent final warp
    params = ({k: v.detach().clone() for k, v in model.state_dict().items()}
              if flow_model == "unet" else flow)
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
        converged=bool(last <= stop_crit), params=params, max_disp=maxd)
