"""Shared machinery for the registration engines (counterpart of
``torchregister_tpu/engines/common.py``).

The JAX engines run their loop on the device (``lax.scan``, or a
``lax.while_loop`` with the plateau test) with no host sync. Here the loop
is a Python loop whose state lives on the device: the parameters, the
optimizer's state, the best pick, the plateau window and the records, all
tensors that every step updates in place. The host reads the stop state
only when a stop could fire (:func:`_next_read`), so it runs ahead of the
card between reads; a step after a stop is masked and changes nothing, so
the results equal those of a loop that reads after every step. Each step
runs through ``engines/graph.session()``: as it comes, or replayed from a
CUDA graph inside ``make_cascade_fn``'s calls.

``host_reads`` counts the loops' reads of their stop state by engine label
(progress lines read more); :func:`reset_counts` zeroes it.
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import graph

# most steps between two reads of the stop state of a loop that has a stop
# to watch: a stop that needs no plateau (flow's stop_crit) is seen within
# this many steps, and the steps after it are masked
READ_EVERY = 64

host_reads: dict = {}


def reset_counts() -> None:
    host_reads.clear()


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


class SGD:
    """Plain SGD on one f32 tensor, ``torch.optim.SGD``'s update ``p +=
    -lr * g``; a step whose ``active`` is False leaves ``p`` as it was."""

    def __init__(self, param: torch.Tensor, lr: float, steps: int):
        self.param, self.lr = param, lr
        self.state: dict = {}

    def step(self, grad: torch.Tensor, active: torch.Tensor) -> None:
        self.param.add_(torch.where(active, grad, 0.0), alpha=-self.lr)


@functools.lru_cache(maxsize=64)
def _adam_tables(lr: float, steps: int, betas: tuple, device: torch.device):
    """Adam's per-step scalars ``[steps + 1, 2]``: row t holds
    ``-lr / (1 - b1^t)`` and ``(1 - b2^t) ** 0.5``, computed in f64 on the
    host as ``torch.optim.Adam`` computes them and rounded to f32; row 0, a
    masked step's, holds 0 and 1. Then ``[2, 2]``: a masked step's (row 0)
    and an active step's (row 1) lerp weight of ``m`` and decay of ``v``."""
    b1, b2 = betas
    rows = [(0.0, 1.0)] + [(-(lr / (1 - b1 ** float(t))), (1 - b2 ** float(t)) ** 0.5)
                           for t in range(1, steps + 1)]
    table = torch.tensor(rows, dtype=torch.float32, device=device)
    keep = torch.tensor([(0.0, 1.0), (1 - b1, b2)], dtype=torch.float32, device=device)
    return table, keep


class Adam:
    """Adam on one f32 tensor with ``torch.optim.Adam``'s arithmetic, op for
    op (optax's defaults: betas (0.9, 0.999), eps 1e-8). Its state is
    tensors on the parameter's device: ``m``, ``v``, the step count ``t``
    and the tables of :func:`_adam_tables`, read at ``t``, so a step makes
    no host read and a CUDA graph can capture it. A step whose ``active`` is
    False takes row 0 of the tables and a zero gradient: ``m`` and ``v`` and
    ``p`` keep their values and ``t`` its count.

    On the CPU the update equals ``torch.optim.Adam(foreach=False)`` to the
    bit. ``torch.optim``'s default on the card (foreach) computes the last
    op as ``p + s * (m / d)`` in one fused kernel; here it is ``p + (s * m)
    / d``, as the single-tensor form on the CPU computes it, so the card's
    results differ from the foreach form in the last bits.
    """

    def __init__(self, param: torch.Tensor, lr: float, steps: int,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8):
        self.param, self.eps, self.b2c = param, eps, 1 - betas[1]
        table, keep = _adam_tables(float(lr), int(steps), tuple(betas), param.device)
        self.state = {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                      "t": torch.zeros((), dtype=torch.int64, device=param.device),
                      "table": table, "keep": keep}

    def step(self, grad: torch.Tensor, active: torch.Tensor) -> None:
        s = self.state
        a = active.long()
        s["t"].add_(a)
        row = s["table"].index_select(0, (s["t"] * a).view(1))
        keep = s["keep"].index_select(0, a.view(1))
        g = torch.where(active, grad, 0.0)
        s["m"].lerp_(g, keep[:, 0])
        s["v"].mul_(keep[:, 1]).addcmul_(g, g, value=self.b2c)
        denom = (s["v"].sqrt() / row[:, 1]).add_(self.eps)
        self.param.addcdiv_(s["m"] * row[:, 0], denom)


def make_optimizer(name: str, param: torch.Tensor, lr: float, steps: int):
    """'sgd' or 'adam' over the f32 tensor ``param`` for up to ``steps``
    steps (optax defaults: plain SGD, Adam with betas (0.9, 0.999) and eps
    1e-8)."""
    name = name.lower()
    if name == "sgd":
        return SGD(param, lr, steps)
    if name == "adam":
        return Adam(param, lr, steps)
    if name == "lm":
        raise NotImplementedError(
            "optimizer 'lm' is not ported yet: ROADMAP queue 1 item 14 "
            "(engines/second_order.py)")
    raise ValueError(f"unknown optimizer {name!r} (use 'sgd' or 'adam')")


def _next_read(i: int, since: int, epochs: int, patience: int | None,
               every: int | None, progress_every: int | None) -> int:
    """The step count at which a loop that has run ``i`` steps, with plateau
    counter ``since``, next reads its stop state: the first step at which a
    plateau stop could fire (``since`` grows by at most one a step), capped
    by ``every`` steps and by the next progress line, and at most
    ``epochs``."""
    nxt = epochs
    if patience is not None:
        nxt = min(nxt, i + max(1, patience - since))
    if every:
        nxt = min(nxt, i + every)
    if progress_every:
        nxt = min(nxt, (i // progress_every + 1) * progress_every)
    return nxt


def read_stop(label: str, *values: torch.Tensor) -> list:
    """One host read of the loop's 0-dim stop state (ints and bools)."""
    host_reads[label] = host_reads.get(label, 0) + 1
    return torch.stack([v.long() for v in values]).tolist()


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
    does. Comparisons run in f32 on the device, like the JAX carry. Without
    ``stop_rel`` the loop reads the host once, at the end; with it, at the
    steps where the plateau stop could first fire (:func:`_next_read`).

    ``progress_every=N`` prints the epoch, the best loss and the current
    parameters every N steps and where the plateau stop fires (the JAX
    package's ``run_with_progress`` lines).
    """
    sess = graph.session()
    device = params0.device
    factor = None if stop_rel is None else float(np.float32(1.0 - stop_rel))
    p0 = params0.detach().to(torch.float32).clone()
    params = sess.static("params", p0.clone()).requires_grad_(True)
    opt = make_optimizer(optimizer, params, lr, epochs)
    opt.state = sess.statics(opt.state, "opt.")
    f32 = dict(dtype=torch.float32, device=device)
    st = sess.statics({
        "best_loss": torch.full((), float("inf"), **f32), "best_params": p0,
        "ref": torch.full((), float("inf"), **f32),
        "since": torch.zeros((), dtype=torch.int64, device=device),
        "i": torch.zeros((), dtype=torch.int64, device=device),
        "stopped": torch.full((), epochs <= 0, dtype=torch.bool, device=device),
        "losses": torch.full((epochs + 1,), float("nan"), **f32),  # [epochs]: masked steps'
        "hist": torch.full((epochs + 1, p0.numel()), float("nan"), **f32)})

    def step():
        loss = loss_fn(params)
        (grad,) = torch.autograd.grad(loss, params)
        with torch.no_grad():
            active = ~st["stopped"]
            val = loss.detach().to(torch.float32)
            better = active & (val < st["best_loss"])
            st["best_params"].copy_(torch.where(better, params, st["best_params"]))
            st["best_loss"].copy_(torch.where(better, val, st["best_loss"]))
            at = torch.where(active, st["i"], epochs).view(1)
            st["losses"].index_copy_(0, at, val.view(1))
            st["hist"].index_copy_(0, at, params.detach().view(1, -1))
            opt.step(grad, active)
            halt = st["i"].add_(active.long()) >= epochs
            if factor is not None:
                improved = st["best_loss"] < st["ref"] * factor
                st["ref"].copy_(torch.where(active & improved, st["best_loss"], st["ref"]))
                st["since"].copy_(torch.where(active, torch.where(improved, 0, st["since"] + 1),
                                              st["since"]))
                halt |= (st["since"] >= patience) & (st["best_loss"] > st["ref"] * factor)
            st["stopped"].logical_or_(halt)

    i = since = 0
    stopped = epochs <= 0
    while not stopped:
        nxt = _next_read(i, since, epochs, None if factor is None else patience,
                         None if factor is None else READ_EVERY, progress_every)
        sess.run(step, nxt - i)
        i, since, stopped = read_stop(label, st["i"], st["since"], st["stopped"])
        if progress_every and (i % progress_every == 0 or i == epochs or stopped):
            _print_progress(label, i, epochs, st["best_loss"], params)
        if progress_every and stopped and i < epochs:
            print(f"[{label}] plateau early-stop at epoch {i}", flush=True)
    return (params.detach().clone(), st["best_params"].clone(), st["best_loss"].clone(),
            st["losses"][:epochs].clone(), st["hist"][:epochs].clone(), i)


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
