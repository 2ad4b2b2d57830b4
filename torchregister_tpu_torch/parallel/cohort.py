"""Cohort registration (counterpart of
``torchregister_tpu/parallel/cohort.py``): ``B`` pairs ``[B, 1, *S]``,
each registered on its own, in one loop on one GPU or split over a mesh.

In JAX a cohort is ``vmap`` over one engine's ``while_loop``. Here it is
the engines' loops run on the batch (``engines/common.fit_matrix``,
``engines/flow.flow_pairs``): one step warps every pair by its own transform
(kernel K1 reads one table per pair), reduces each pair's criteria on its
own, and keeps each pair's stop state, so every pair stops at the step it
would stop at alone and its steps after that are masked, as under ``vmap``.
The single-pair engines run the same loops on one pair.

With a ``mesh`` (``parallel/mesh.py``) the batch splits over its ``data``
axis, as JAX's ``batch_sharding``: each shard's pairs run that loop on the
shard's device (``parallel/data.py``) and the results come back in pair
order on the mesh's first device. What depends on the whole batch is made
first, as the unsharded call makes it: the edge filter, the random inits,
the windows of the worst-case init, the U-Net weights drawn pair after pair.
So each pair of a sharded call equals the unsharded call's to the bit.

Window safety matches the single-pair engines: the sweep windows cover the
worst-case init over the batch (:func:`_cohort_windows`), and the recovered
transforms are checked after the run with one host read
(``engines/common.check_sweep_windows_batch``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..engines.affine import affine_theta
from ..engines.common import (check_sweep_windows_batch, defaults_of, fit_matrix,
                              resolve_sweep_windows)
from ..engines.flow import FlowResult, _unet, flow_pairs, flow_register
from ..engines.rigid import init_rigid_params
from ..losses import resolve_criteria
from ..ops.edge import edge_filter
from ..ops.transforms import identity_theta, rigid_theta, rigid_theta_np
from .data import Shards, concat, run_shards


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
    int or a ``torch.Generator``) draws ``init='random'`` rigid params, and
    with ``flow_model='unet'`` each pair's initial U-Net weights, one pair
    after another, pair 0 first (a CPU generator; the counterpart of JAX's
    ``split(key, B)``): each pair trains its own net, and ``params`` is one
    state dict whose tensors carry a leading pair axis.

    Inputs that are not tensors (numpy arrays, as the JAX package takes)
    go to the card, and raise without one, as ``Register(device=None)``
    does; tensors stay on their device (a CPU tensor runs on the CPU).
    ``grad_edges`` filters each pair on its own.

    ``mesh`` splits the batch over the mesh's ``data`` axis (a batch that
    does not split evenly raises ``ValueError``, as JAX's ``device_put``
    does): inputs go to the mesh's first device, each shard runs on its own,
    and the result is gathered in pair order there, each pair equal to the
    unsharded call's to the bit."""
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
    if mesh is not None:
        device = mesh.device_list[0]
    elif isinstance(movings, torch.Tensor):
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
    shards = Shards.of(mesh, B) if mesh is not None else None

    def sharded(run, *batch):
        """``run`` on the whole batch, or on each shard's pairs of ``batch``
        (tensors with a leading pair axis, or state dicts of them) on its
        device, joined in pair order."""
        if shards is None:
            return run(*batch)

        def job(k):
            lo, hi = shards.pairs[k][0], shards.pairs[k][-1] + 1
            return run(*(_take(x, lo, hi, B, shards.devices[k]) for x in batch))

        return concat(run_shards(shards.devices, job), device)

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

        def fit(mov, tgt, p0):
            return fit_matrix(mov, tgt, p0, theta_of, criteria, w, optimizer, float(lr),
                              int(epochs), windows, separable, srel, int(patience), None,
                              f"{mode}_register")

        out = sharded(fit, movings, targets, params0)
        if check_window and separable:
            check_sweep_windows_batch(out.best_theta, spatial, windows,
                                      f"register_cohort ({mode})")
        return out
    generator = (seed if isinstance(seed, torch.Generator)
                 else torch.Generator().manual_seed(int(seed)))
    options = dict(lr=float(lr), max_epochs=int(epochs), stop_crit=float(stop_crit), n=float(n),
                   criterions=criterions, weights=weights, grad_edges=grad_edges,
                   optimizer=optimizer, depth=depth, generator=generator, method=method,
                   max_disp=int(max_disp), dtype=dtype, check_disp=check_window,
                   flow_model=str(flow_model), smooth=float(smooth), stop_rel=srel,
                   patience=int(patience))

    def flow_run(mov, tgt, init=None):
        _, res = flow_pairs(mov, tgt, **options,
                            **({} if init is None else {"init_params": init}))
        if flow_model == "field":
            flow = res.flow[:, None]
            return FlowResult(flow=flow, losses=res.losses, steps=res.steps,
                              converged=res.converged, params=flow, max_disp=res.max_disp)
        params = (res.params if mov.shape[0] > 1
                  else {k: v[None] for k, v in res.params.items()})
        return res._replace(flow=res.flow[:, None], params=params)

    if shards is None:
        return flow_run(movings, targets)
    if grad_edges:  # the whole batch filtered once, as the unsharded call filters it
        movings, targets = edge_filter(movings), edge_filter(targets)
        options["grad_edges"] = False
    if flow_model != "unet":
        return sharded(flow_run, movings, targets)
    # every pair's weights drawn first, pair after pair, as one call draws them
    opts = defaults_of(flow_register)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    net = _unet(movings, float(n), opts["in_c"], depth, opts["use_attention"],
                opts["use_norm"], dt, None, opts["zero_head"], generator, B if B > 1 else None)
    init = {k: v.detach() for k, v in net.state_dict().items()}
    return sharded(flow_run, movings, targets, init)


def _take(x, lo: int, hi: int, B: int, device: torch.device):
    """Pairs ``[lo, hi)`` of ``x`` (a tensor with a leading pair axis, or a
    state dict of them; one pair's without its pair axis) on ``device``."""
    if isinstance(x, dict):
        if B == 1:
            return {k: v.to(device) for k, v in x.items()}
        return {k: (v[lo:hi] if hi - lo > 1 else v[lo]).to(device) for k, v in x.items()}
    return x[lo:hi].to(device)
