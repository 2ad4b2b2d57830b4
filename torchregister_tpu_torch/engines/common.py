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

The loop runs B independent pairs at once (``pairs``): the parameters
carry a leading pair axis, every piece of the stop state is one per pair,
and each pair's steps after its own stop are masked, as JAX's ``vmap`` of
a ``while_loop`` masks them. So each pair stops at its own step and follows
its own trajectory, and the loop ends when every pair has stopped. A
single-pair engine runs it with one pair (``pairs=1``) and takes the pair
axis off the result; a cohort (``parallel/cohort.py``,
``make_cascade_batch_fn``) runs it on its B pairs.

``host_reads`` counts the loops' reads of their stop state by engine label
(progress lines read more); :func:`reset_counts` zeroes it.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import graph
from .second_order import LM, lm_improved, val_grad_hess

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


@functools.lru_cache(maxsize=None)
def defaults_of(fn) -> dict:
    """The defaults of ``fn``'s keyword parameters (to call an engine's core
    with the options of its public signature)."""
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def pair_mask(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A mask with one entry a pair (``[B]``, or 0-dim for one pair) shaped
    to broadcast over ``t``, whose leading axis holds the B pairs (or one
    pair whole)."""
    return mask.reshape((-1,) + (1,) * (t.ndim - 1))


class SGD:
    """Plain SGD on one f32 tensor, ``torch.optim.SGD``'s update ``p +=
    -lr * g``; a step whose ``active`` is False leaves ``p`` as it was
    (``active [B]``: each pair of ``p`` its own)."""

    def __init__(self, param: torch.Tensor, lr: float, steps: int):
        self.param, self.lr = param, lr
        self.state: dict = {}

    def step(self, grad: torch.Tensor, active: torch.Tensor) -> None:
        self.param.add_(torch.where(pair_mask(active, grad), grad, 0.0), alpha=-self.lr)


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
    (one a pair) and the tables of :func:`_adam_tables`, read at ``t``, so a
    step makes no host read and a CUDA graph can capture it. ``param``
    holds ``pairs`` pairs along its leading axis (one pair: the whole
    tensor), and ``active`` has one entry a pair: each pair reads its own
    rows of the tables, indexed on the device. An inactive pair takes row 0
    of the tables and a zero gradient: its ``p``, ``m`` and ``v`` keep their
    values and ``t`` its count.

    On the CPU the update equals ``torch.optim.Adam(foreach=False)`` to the
    bit. ``torch.optim``'s default on the card (foreach) computes the last
    op as ``p + s * (m / d)`` in one fused kernel; here it is ``p + (s * m)
    / d``, as the single-tensor form on the CPU computes it, so the card's
    results differ from the foreach form in the last bits.
    """

    def __init__(self, param: torch.Tensor, lr: float, steps: int,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8, pairs: int = 1):
        self.param, self.eps, self.b2c = param, eps, 1 - betas[1]
        table, keep = _adam_tables(float(lr), int(steps), tuple(betas), param.device)
        self.state = {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                      "t": torch.zeros((pairs,), dtype=torch.int64, device=param.device),
                      "table": table, "keep": keep}

    def step(self, grad: torch.Tensor, active: torch.Tensor) -> None:
        s = self.state
        a = active.long().reshape(-1)
        s["t"].add_(a)
        row = s["table"].index_select(0, s["t"] * a)  # [B, 2]
        keep = s["keep"].index_select(0, a)

        def col(t, k):  # a pair's column broadcast over its params
            return pair_mask(t[:, k], grad)

        g = torch.where(pair_mask(active, grad), grad, 0.0)
        s["m"].lerp_(g, col(keep, 0))
        s["v"].mul_(col(keep, 1)).addcmul_(g, g, value=self.b2c)
        denom = (s["v"].sqrt() / col(row, 1)).add_(self.eps)
        self.param.addcdiv_(s["m"] * col(row, 0), denom)


def make_optimizer(name: str, param: torch.Tensor, lr: float, steps: int, pairs: int = 1,
                   second_order: bool = True, lam0: float = 1.0):
    """'sgd' or 'adam' over the f32 tensor ``param`` for up to ``steps``
    steps (optax defaults: plain SGD, Adam with betas (0.9, 0.999) and eps
    1e-8), or 'lm', Levenberg-Marquardt (``engines/second_order.LM``, damping
    from ``lam0``; ``lr`` unused); ``param`` holds ``pairs`` pairs'
    parameters along its leading axis, each stepped on its own. With
    ``second_order=False`` (the flow engine) 'lm' raises ``ValueError``, as
    the JAX package's ``make_optimizer`` does."""
    name = name.lower()
    if name == "sgd":
        return SGD(param, lr, steps)
    if name == "adam":
        return Adam(param, lr, steps, pairs=pairs)
    if name == "lm" and second_order:
        return LM(param, pairs, lam0)
    raise ValueError(f"unknown optimizer {name!r} (use 'sgd' or 'adam'"
                     f"{', or lm for the rigid and affine engines' if second_order else ''})")


class SlabOptimizer:
    """An optimizer of one parameter split into slabs (the flow engine's
    field on a volume split over the ``space`` axis; ``pairs`` pairs along
    its leading axis): one of :func:`make_optimizer`'s a slab, its state on the slab's device, all
    stepped with the same ``active`` mask. The update is elementwise, so
    each slab's is the unsharded update's of its entries given the same
    gradient."""

    def __init__(self, name: str, params: list, lr: float, steps: int, pairs: int = 1):
        self.opts = [make_optimizer(name, p, lr, steps, pairs, second_order=False)
                     for p in params]

    def step(self, grads: list, active: torch.Tensor) -> None:
        for opt, g in zip(self.opts, grads):
            opt.step(g, active.to(g.device))


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
    """One host read of the loop's stop state (ints and bools, one a
    pair)."""
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
                  progress_every: int | None = None, label: str = "optimize_scan",
                  lam0: float = 1.0):
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

    ``optimizer='lm'`` runs Levenberg-Marquardt (``engines/second_order``,
    damping from ``lam0``; ``lr`` unused): a step is one LM iteration, the
    pre-step loss and parameters are recorded, an accepted trial that beats
    the best loss is the best, and the plateau test is LM's
    (``second_order.lm_improved``: an absolute floor of 1e-8 beside
    ``stop_rel``; the loop stops after ``patience`` iterations without an
    improvement), as the JAX package's ``make_chunked_lm``.

    ``params0 [n]`` is one pair's: ``loss_fn`` maps ``[n]`` to a scalar.
    ``params0 [B, n]`` runs B pairs: ``loss_fn`` maps ``[B, n]`` to each
    pair's loss ``[B]``, every result gains the pair axis (``steps`` a list
    of B ints), and each pair stops on its own; the host reads where any
    running pair's stop could first fire. ``progress_every=N`` (one pair
    only) prints the epoch, the best loss and the current parameters every N
    steps and where the plateau stop fires (the JAX package's
    ``run_with_progress`` lines).
    """
    if params0.ndim == 1:  # one pair: the pair axis on, and off the results
        out = optimize_scan(lambda p: torch.reshape(loss_fn(p[0]), (1,)), params0[None],
                            optimizer, lr, epochs, stop_rel, patience, progress_every, label,
                            lam0)
        return tuple(x[0] for x in out)
    sess = graph.session()
    device = params0.device
    factor = None if stop_rel is None else float(np.float32(1.0 - stop_rel))
    p0 = params0.detach().to(torch.float32).clone()
    B, n = p0.shape
    if progress_every and B > 1:
        raise ValueError("progress_every prints one pair's progress")
    params = sess.static("params", p0.clone()).requires_grad_(True)
    opt = make_optimizer(optimizer, params, lr, epochs, B, lam0=lam0)
    opt.state = sess.statics(opt.state, "opt.")
    lm = isinstance(opt, LM)
    f32 = dict(dtype=torch.float32, device=device)
    st = sess.statics({
        "best_loss": torch.full((B,), float("inf"), **f32), "best_params": p0,
        "ref": torch.full((B,), float("inf"), **f32),
        "since": torch.zeros((B,), dtype=torch.int64, device=device),
        "i": torch.zeros((B,), dtype=torch.int64, device=device),
        "stopped": torch.full((B,), epochs <= 0, dtype=torch.bool, device=device),
        # [:, epochs]: masked steps'
        "losses": torch.full((B, epochs + 1), float("nan"), **f32),
        "hist": torch.full((B, epochs + 1, n), float("nan"), **f32)})

    def step():
        if lm:
            val, grad, hess = val_grad_hess(loss_fn, params)
        else:
            loss = loss_fn(params)
            (grad,) = torch.autograd.grad(loss.sum(), params)
            val = loss.detach()
        with torch.no_grad():
            active = ~st["stopped"]
            val = val.to(torch.float32)
            better = active & (val < st["best_loss"])
            st["best_params"].copy_(torch.where(better[:, None], params, st["best_params"]))
            st["best_loss"].copy_(torch.where(better, val, st["best_loss"]))
            at = torch.where(active, st["i"], epochs)
            st["losses"].scatter_(1, at[:, None], val[:, None])
            st["hist"].scatter_(1, at[:, None, None].expand(-1, 1, n), params.detach()[:, None])
            if lm:
                trial, val_new, accept = opt.step(loss_fn, val, grad, hess, active)
                better = accept & (val_new < st["best_loss"])
                st["best_params"].copy_(torch.where(better[:, None], trial,
                                                    st["best_params"]))
                st["best_loss"].copy_(torch.where(better, val_new, st["best_loss"]))
            else:
                opt.step(grad, active)
            halt = st["i"].add_(active.long()) >= epochs
            if factor is not None:
                improved = (lm_improved(st["best_loss"], st["ref"], stop_rel) if lm
                            else st["best_loss"] < st["ref"] * factor)
                st["ref"].copy_(torch.where(active & improved, st["best_loss"], st["ref"]))
                st["since"].copy_(torch.where(active, torch.where(improved, 0, st["since"] + 1),
                                              st["since"]))
                plateau = st["since"] >= patience
                halt |= plateau if lm else plateau & (st["best_loss"] > st["ref"] * factor)
            st["stopped"].logical_or_(halt)

    def report(i, stopped, _):
        if i % progress_every == 0 or i == epochs or stopped:
            _print_progress(label, i, epochs, st["best_loss"], params)
        if stopped and i < epochs:
            print(f"[{label}] plateau early-stop at epoch {i}", flush=True)

    steps, _ = run_pairs(sess, step, st, epochs, None if factor is None else patience,
                         None if factor is None else READ_EVERY, label,
                         progress_every=progress_every, report=report)
    return (params.detach().clone(), st["best_params"].clone(), st["best_loss"].clone(),
            st["losses"][:, :epochs].clone(), st["hist"][:, :epochs].clone(), steps)


def run_pairs(sess, step, st: dict, epochs: int, patience: int | None, every, label: str,
              extra=None, progress_every: int | None = None, report=None):
    """The engines' loop: run ``step`` until every pair has stopped, reading
    ``st``'s ``i``, ``since`` and ``stopped`` (one a pair, and the tensors
    that ``extra()`` gives after them) where the first running pair's stop
    could fire (:func:`_next_read`; ``every`` may be a function of the steps
    run), and at each multiple of ``progress_every``. After each read
    ``report(steps, all_stopped, extra_values)`` (for one pair) prints.
    Returns each pair's steps and the list of ``extra``'s values."""
    B = st["i"].shape[0]
    ran = 0
    i, since = [0] * B, [0] * B
    stopped = [epochs <= 0] * B
    rest: list = [[0] * B for _ in extra()] if extra else []
    while not all(stopped):
        # the running pairs have taken every step run; the one nearest its
        # plateau stop sets the next read
        near = max(s for s, done in zip(since, stopped) if not done)
        nxt = _next_read(ran, near, epochs, patience,
                         every(ran) if callable(every) else every, progress_every)
        sess.run(step, nxt - ran)
        ran = nxt
        i, since, stopped, *rest = read_stop(label, st["i"], st["since"], st["stopped"],
                                             *(extra() if extra else ()))
        stopped = [bool(x) for x in stopped]
        if progress_every:
            report(max(i), all(stopped), [r[0] for r in rest])
    return i, rest


def first_pair(result: RegistrationResult) -> RegistrationResult:
    """A one-pair result with its pair axis taken off."""
    return RegistrationResult(*(x[0] for x in result))


def fit_matrix(moving: torch.Tensor, target: torch.Tensor, params0: torch.Tensor,
               theta_of: Callable, criteria, weights, optimizer: str, lr: float,
               epochs: int, windows, separable: bool, stop_rel: float | None,
               patience: int, progress_every: int | None, label: str) -> RegistrationResult:
    """The loop of a matrix engine on prepared images, over the B pairs of
    ``params0 [B, n]``: ``theta_of`` maps the parameters ``[B, n]`` to
    thetas ``[B, d, d+1]``, each step warps each pair's slice of ``moving``
    by its own theta (the separable sweep within ``windows``, or the exact
    resampler) and scores it against its slice of ``target``, each pair's
    loss and stop its own. One pair's slice is the whole of ``moving``
    (``[N, C, *S]``, one theta for its N items); B > 1 pairs take one item
    each (``[B, 1, *S]``). Thetas ``[B, 1, d, d+1]``.

    ``moving`` and ``target`` may be split alike into slabs over a mesh
    (``parallel/mesh.py``'s ``Sharded``, the ``space`` axis; a row of a
    ``data x space`` mesh holds B pairs): the warp runs K1's slab mode (a
    table per pair) or the exact resampler on slabs, each pair's criteria
    add its own slabs' partial sums in ascending slab order, and the
    parameters and the optimizer's state stay on the mesh's first device.
    Such a loop runs eagerly (one CUDA graph cannot span devices)."""
    from ..losses import pair_loss
    from ..ops.resample import warp_affine
    from ..ops.separable import _warp_affine_separable
    from ..parallel.mesh import Sharded

    sharded = isinstance(moving, Sharded)
    loss = pair_loss(criteria, weights, params0.shape[0])
    if sharded:
        moving_s, target_s = moving, target
    else:
        sess = graph.session()
        moving_s, target_s = sess.static("moving", moving), sess.static("target", target)
    # LM's Hessian differentiates the warp twice: K1's chain of passes
    twice = optimizer.lower() == "lm"

    def loss_fn(params):
        theta = theta_of(params)
        warped = (_warp_affine_separable(theta, moving_s, max_shift=windows, twice=twice)
                  if separable else warp_affine(theta, moving_s))
        return loss(target_s, warped)

    with graph.eager() if sharded else contextlib.nullcontext():
        final_params, best_params, best_loss, losses, hist, steps = optimize_scan(
            loss_fn, params0, optimizer, lr, epochs, stop_rel, patience, progress_every, label)
    return RegistrationResult(
        final_theta=theta_of(final_params)[:, None], best_theta=theta_of(best_params)[:, None],
        final_params=final_params, best_params=best_params, losses=losses,
        best_loss=best_loss, param_history=hist, steps=steps)


def finish_matrix(result: RegistrationResult, moving: torch.Tensor, spatial, windows,
                  separable: bool, check_window: bool, label: str):
    """``(warped_best, result)`` of a single-pair matrix engine: ``moving``
    warped by the best theta (K2 under the exact method), and the window
    check of the separable one."""
    from ..ops.blocked import warp_affine_fast
    from ..ops.separable import _warp_affine_separable

    if not separable:
        return warp_affine_fast(result.best_theta, moving), result
    with torch.no_grad():
        warped_best = _warp_affine_separable(result.best_theta, moving, max_shift=windows)
    if check_window:
        check_sweep_windows(result.best_theta, spatial, windows, label)
    return warped_best, result


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
    wins, otherwise the default windows bumped to cover the init theta (a
    list of thetas: the worst case over them, a cohort's windows, as the
    JAX package's ``parallel/cohort._cohort_windows``)."""
    if max_shift is not None:
        return max_shift if isinstance(max_shift, int) else tuple(max_shift)
    from ..ops.separable import required_windows

    if isinstance(init_theta_np, list):
        reqs = [required_windows(t, spatial) for t in init_theta_np]
        return windows_from_required(tuple(map(max, zip(*reqs))), spatial)
    return windows_from_required(required_windows(init_theta_np, spatial), spatial)


def _windows_used(spatial, used) -> list:
    axes = list(range(len(spatial)))[::-1]
    if used is None:
        return [max(8, -(-spatial[a] // 4)) for a in axes]
    if isinstance(used, int):
        return [used] * len(spatial)
    return list(used)


def check_sweep_windows_batch(thetas, spatial, used, label: str) -> None:
    """Warn when recovered thetas need larger sweep windows than the ones
    they were optimized with (their support was partially zeroed): one host
    read of every pair's theta (``[B, 1, d, d+1]``, ``[B, d, d+1]``, or one
    pair's ``[1, d, d+1]``) and one warning naming each pair that outgrew
    the windows."""
    from ..ops.separable import required_windows

    used = _windows_used(spatial, used)
    d = len(spatial)
    if isinstance(thetas, torch.Tensor):
        thetas = thetas.detach().cpu().double().numpy()
    thetas_np = np.asarray(thetas, np.float64).reshape(-1, d, d + 1)
    bad = []
    for b in range(thetas_np.shape[0]):
        req = required_windows(thetas_np[b], spatial)
        if any(r > u for r, u in zip(req, used)):
            bad.append((b, req))
    if not bad:
        return
    if len(thetas_np) == 1:
        what = f"recovered transform needs sweep windows {bad[0][1]} but the engine used {used}"
    else:
        shown = ", ".join(f"#{b} needs {list(r)}" for b, r in bad[:5])
        more = f" (+{len(bad) - 5} more)" if len(bad) > 5 else ""
        what = (f"{len(bad)} of {len(thetas_np)} recovered transforms outgrew the sweep "
                f"windows {used}: {shown}{more}")
    warnings.warn(
        f"{label}: {what}; displacements beyond the window contribute zero. Pass a larger "
        "max_shift or method='exact'.",
        RuntimeWarning,
        stacklevel=3,
    )


check_sweep_windows = check_sweep_windows_batch
