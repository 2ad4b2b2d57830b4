"""Cohort registration (counterpart of
``torchregister_tpu/parallel/cohort.py``): ``B`` pairs ``[B, 1, *S]``,
each registered on its own, in one loop on one GPU.

In JAX a cohort is ``vmap`` over one engine's ``while_loop``. Here it is
the engines' loops run on the batch (``engines/common.fit_matrix``,
``engines/flow.flow_pairs``): one step warps every pair by its own transform
(kernel K1 reads one table per pair), reduces each pair's criteria on its
own, and keeps each pair's stop state, so every pair stops at the step it
would stop at alone and its steps after that are masked, as under ``vmap``.
The single-pair engines run the same loops on one pair.

Window safety matches the single-pair engines: the sweep windows cover the
worst-case init over the batch (:func:`_cohort_windows`), and the recovered
transforms are checked after the run with one host read
(``engines/common.check_sweep_windows_batch``). The JAX package's ``mesh``
(a cohort sharded over a device mesh) has no counterpart on one card and
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engines.affine import affine_theta
from ..engines.common import check_sweep_windows_batch, fit_matrix, resolve_sweep_windows
from ..engines.flow import FlowResult, flow_pairs
from ..engines.rigid import init_rigid_params
from ..losses import resolve_criteria
from ..ops.edge import edge_filter
from ..ops.transforms import identity_theta, rigid_theta, rigid_theta_np


def _cohort_windows(init_thetas_np, spatial, max_shift):
    """Sweep windows covering the worst-case init over the batch: the
    elementwise max of each pair's ``required_windows``, quantized as the
    single-pair engines quantize theirs."""
    return resolve_sweep_windows(list(init_thetas_np), spatial, max_shift)


def register_cohort(
    movings: torch.Tensor,
    targets: torch.Tensor,
    mode: str = "rigid",
    mesh=None,
    lr: float | None = None,
    epochs: int = 1000,
    criterions=None,
    weights=None,
    grad_edges: bool = False,
    optimizer: str | None = None,
    init: str = "identity",
    seed: int | torch.Generator = 0,
    n: float = 32,
    depth: int | None = None,
    stop_crit: float = 1e-4,
    method: str = "separable",
    max_shift=None,
    max_disp: int = 8,
    stop_rel: float | None = None,
    patience: int = 25,
    check_window: bool = True,
    flow_model: str = "field",
    smooth: float | None = None,
    dtype: str = "float32",
):
    """Register ``movings [B, 1, *S]`` onto ``targets [B, 1, *S]`` pairwise.

    Returns the engine's result with a leading pair axis: for ``'rigid'``
    and ``'affine'`` a ``RegistrationResult`` (thetas ``[B, 1, d, d+1]``,
    ``steps`` a list), for ``'flow'`` a ``FlowResult`` (``flow [B, 1, d,
    *S]``). Options and defaults as in the JAX package: ``flow_model``
    defaults to ``'field'``, and ``optimizer`` / ``lr`` / ``smooth`` left
    as ``None`` resolve to ``adam`` / ``0.3`` / ``0.5`` for field-mode flow
    and to ``sgd`` / ``1e-5`` / ``0.0`` for every other mode. ``seed`` (an
    int or a ``torch.Generator``) draws ``init='random'`` rigid params.

    Inputs that are not tensors (numpy arrays, as the JAX package takes)
    go to the card, and raise without one, as ``Register(device=None)``
    does; tensors stay on their device (a CPU tensor runs on the CPU).
    ``grad_edges`` filters each pair on its own. ``mesh`` raises
    ``ValueError`` (one GPU); ``flow_model='unet'`` with more than one pair
    raises ``NotImplementedError`` (ROADMAP queue 1 item 17)."""
    if mesh is not None:
        raise ValueError(
            "register_cohort: mesh is not supported by the PyTorch port, which runs a "
            "cohort as one batched loop on one GPU (the JAX package's parallel/mesh.py "
            "has no counterpart); pass mesh=None")
    is_field_flow = mode == "flow" and flow_model == "field"
    if init not in ("identity", "random"):
        raise ValueError(f"init must be 'identity' or 'random' (got {init!r})")
    if init == "random" and mode != "rigid":
        raise ValueError(
            "init='random' is only meaningful for mode='rigid' (the reference's "
            "torch.rand regressor init, utils.py:316-321); affine starts at identity and "
            "flow at a zero field")
    if optimizer is None:
        optimizer = "adam" if is_field_flow else "sgd"
    if lr is None:
        lr = 0.3 if is_field_flow else 1e-5
    if smooth is None:
        smooth = 0.5 if is_field_flow else 0.0
    if isinstance(movings, torch.Tensor):
        device = movings.device
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("register_cohort runs arrays that are not tensors on the card: "
                           "no CUDA device (pass CPU tensors, torch.from_numpy, to run on "
                           "the CPU)")
    movings, targets = (torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                                        dtype=torch.float32, device=device)
                        for x in (movings, targets))
    if movings.shape != targets.shape or movings.shape[1] != 1:
        raise ValueError(f"register_cohort needs movings and targets [B, 1, *S] of one "
                         f"shape, got {tuple(movings.shape)} and {tuple(targets.shape)}")
    B = movings.shape[0]
    ndim = movings.ndim - 2
    spatial = tuple(movings.shape[2:])
    separable = method == "separable"
    srel = None if stop_rel is None else float(stop_rel)
    if mode not in ("rigid", "affine", "flow"):
        raise ValueError(f"unknown mode {mode!r}")

    if mode != "flow":
        if grad_edges:  # the edge filter normalizes each pair on its own
            movings, targets = edge_filter(movings), edge_filter(targets)
        if mode == "rigid":
            generator = (seed if isinstance(seed, torch.Generator)
                         else torch.Generator(device=movings.device).manual_seed(int(seed)))
            params0 = init_rigid_params(ndim, generator, init, movings.device, B)
            theta_of, inits = rigid_theta, [rigid_theta_np(p) for p in params0]
        else:
            identity = identity_theta(ndim, device=movings.device)
            params0 = identity.reshape(1, -1).repeat(B, 1)
            theta_of, inits = affine_theta, [identity.cpu().double().numpy()]
        windows = _cohort_windows(inits, spatial, max_shift) if separable else None
        criteria, w = resolve_criteria(criterions, weights)
        out = fit_matrix(movings, targets, params0, theta_of, criteria, w, optimizer,
                         float(lr), int(epochs), windows, separable, srel, int(patience),
                         None, f"{mode}_register")
        if check_window and separable:
            check_sweep_windows_batch(out.best_theta, spatial, windows,
                                      f"register_cohort ({mode})")
        return out
    _, res = flow_pairs(
        movings, targets, lr=float(lr), max_epochs=int(epochs), stop_crit=float(stop_crit),
        n=float(n), criterions=criterions, weights=weights, grad_edges=grad_edges,
        optimizer=optimizer, depth=depth, method=method, max_disp=int(max_disp), dtype=dtype,
        check_disp=check_window, flow_model=str(flow_model), smooth=float(smooth),
        stop_rel=srel, patience=int(patience))
    if flow_model == "field":
        flow = res.flow[:, None]
        return FlowResult(flow=flow, losses=res.losses, steps=res.steps,
                          converged=res.converged, params=flow, max_disp=res.max_disp)
    return res._replace(flow=res.flow[:, None])
