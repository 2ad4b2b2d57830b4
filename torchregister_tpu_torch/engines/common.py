"""Shared machinery for the registration engines (counterpart of
``torchregister_tpu/engines/common.py``).

The JAX engines run their loop on the device (``lax.scan`` or a
``lax.while_loop`` with the plateau test). Here the loop is a Python loop
with the same rules: best tracking by strict ``<`` on the pre-update
parameters, NaN-padded ``losses`` and ``param_history``, and the plateau
stop. Reading each step's loss is one host sync per step.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class RegistrationResult(NamedTuple):
    """Outcome of a rigid/affine registration; thetas are ``[1, d, d+1]``,
    ``losses`` and ``param_history`` are NaN past ``steps``."""

    final_theta: torch.Tensor
    best_theta: torch.Tensor
    final_params: Any
    best_params: Any
    losses: torch.Tensor
    best_loss: torch.Tensor
    param_history: Any = None
    steps: Any = None


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    """'sgd' or 'adam' over ``params`` (optax defaults: plain SGD, Adam with
    betas (0.9, 0.999) and eps 1e-8)."""
    name = name.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "lm":
        raise NotImplementedError(
            "optimizer 'lm' is not ported yet: ROADMAP queue 1 item 14 "
            "(engines/second_order.py)")
    raise ValueError(f"unknown optimizer {name!r} (use 'sgd' or 'adam')")


def _print_progress(label: str, i: int, epochs: int, best_loss, params) -> None:
    ptxt = np.array2string(params.detach().cpu().numpy().ravel(), precision=4,
                           separator=", ")
    print(f"[{label}] epoch {i}/{epochs} best_loss={float(best_loss):.6g} params={ptxt}",
          flush=True)


def optimize_scan(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                  params0: torch.Tensor, optimizer: str, lr: float, epochs: int,
                  stop_rel: float | None = None, patience: int = 25,
                  progress_every: int | None = None, label: str = "optimize_scan"):
    """Run up to ``epochs`` optimizer steps of ``loss_fn`` on one flat
    parameter tensor.

    Returns ``(final_params, best_params, best_loss, losses, param_history,
    steps)``. The pre-update parameters of the lowest-loss step win (strict
    ``<``). With ``stop_rel`` the loop stops once the best loss has not
    improved on the reference loss by ``stop_rel`` (relative) for
    ``patience`` steps; the reference resets to the best loss whenever it
    does. Host comparisons run in float32, like the JAX carry.

    ``progress_every=N`` prints the epoch, the best loss and the current
    parameters every N steps and where the plateau stop fires (the JAX
    package's ``run_with_progress`` lines).
    """
    device = params0.device
    params = params0.detach().to(torch.float32).clone().requires_grad_(True)
    opt = make_optimizer(optimizer, [params], lr)
    losses = np.full((epochs,), np.nan, np.float32)
    hist = torch.full((epochs, params.numel()), float("nan"), device=device)
    best_loss = np.float32(np.inf)
    best_params = params.detach().clone()
    ref_loss = np.float32(np.inf)
    factor = None if stop_rel is None else np.float32(1.0 - stop_rel)
    since = 0
    i = 0
    while i < epochs:
        if factor is not None and since >= patience and best_loss > ref_loss * factor:
            if progress_every:
                if i % progress_every:
                    _print_progress(label, i, epochs, best_loss, params)
                print(f"[{label}] plateau early-stop at epoch {i}", flush=True)
            break
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        pre = params.detach().clone()
        loss_val = np.float32(loss.item())
        opt.step()
        if loss_val < best_loss:
            best_loss, best_params = loss_val, pre
        losses[i] = loss_val
        hist[i] = pre.reshape(-1)
        if factor is not None:
            if best_loss < ref_loss * factor:
                ref_loss, since = best_loss, 0
            else:
                since += 1
        i += 1
        if progress_every and (i % progress_every == 0 or i == epochs):
            _print_progress(label, i, epochs, best_loss, params)
    return (params.detach(), best_params, torch.tensor(best_loss, device=device),
            torch.from_numpy(losses).to(device), hist, i)


def windows_from_required(req, spatial) -> tuple[int, ...] | None:
    """Sweep windows covering a per-pass requirement: the default
    ``max(8, S/4)`` where it has 2 voxels of margin, otherwise required+4
    rounded up to a multiple of 8 (capped at the axis size). ``None`` when
    no pass needed a bump."""
    axes = list(range(len(spatial)))[::-1]
    default = [max(8, -(-spatial[a] // 4)) for a in axes]
    out = []
    bumped = False
    for d, r, a in zip(default, req, axes):
        k = d if r + 2 <= d else min(int(spatial[a]), -(-(r + 4) // 8) * 8)
        bumped |= k != d
        out.append(k)
    return tuple(out) if bumped else None


def resolve_sweep_windows(init_theta_np, spatial, max_shift):
    """Static sweep windows for a separable engine: an explicit ``max_shift``
    wins, otherwise the default windows bumped to cover the init theta."""
    if max_shift is not None:
        return max_shift if isinstance(max_shift, int) else tuple(max_shift)
    from ..ops.separable import required_windows

    return windows_from_required(required_windows(init_theta_np, spatial), spatial)


def check_sweep_windows(theta, spatial, used, label: str) -> None:
    """Warn when a recovered theta needs larger sweep windows than the ones
    it was optimized with (its support was partially zeroed)."""
    from ..ops.separable import required_windows

    axes = list(range(len(spatial)))[::-1]
    if used is None:
        used = [max(8, -(-spatial[a] // 4)) for a in axes]
    elif isinstance(used, int):
        used = [used] * len(spatial)
    req = required_windows(theta, spatial)
    if any(r > u for r, u in zip(req, used)):
        warnings.warn(
            f"{label}: recovered transform needs sweep windows {req} but the "
            f"engine used {list(used)}; displacements beyond the window "
            "contribute zero. Pass a larger max_shift.",
            RuntimeWarning,
            stacklevel=3,
        )
