"""Levenberg-Marquardt (damped Newton) for the matrix engines (counterpart of
``torchregister_tpu/engines/second_order.py``).

The rigid and affine engines optimize 6 or 12 parameters, so a full damped
Newton step costs little beside the gradient: the loss and its gradient from
one forward and backward pass that keeps its graph (``create_graph=True``),
the dense Hessian from n <= 12 backward passes through that graph (reverse
over reverse: ``F.grid_sample`` has a double backward but no forward-mode
rule, and K1's affine form is differentiable twice through its own kernels,
``ops/cuda/sweep.py`` ``_AffinePass``), and an ``n x n`` Cholesky solve. The
pairs of a batch are independent, so the gradient of ``g[:, i].sum()`` is
row i of every pair's Hessian at once: n passes for any number of pairs.

Each iteration takes Marquardt's step: ``(H + lam D) delta = -g`` with
``D`` the Hessian's diagonal (floored), the trial loss evaluated, the step
accepted only on a finite decrease; ``lam`` shrinks by 3 on acceptance and
grows by 4 on rejection, within [1e-8, 1e8]. A non-positive-definite system
gives NaN in the Cholesky, the trial evaluates non-finite or no lower, and
rejects itself with more damping.

:class:`LM` is the optimizer ``engines/common.make_optimizer('lm')`` gives,
and ``engines/common.optimize_scan`` runs it in the engines' one loop over B
pairs: the pre-step loss and parameters recorded, the best tracked on the
pre-step and on the trial loss, and LM's plateau stop (relative, with an
absolute floor of 1e-8) on each pair. :func:`optimize_lm` is the JAX
package's one-shot entry point. The Cholesky and its solve are column loops
of elementwise torch ops on ``[B, n]``, so each pair's bits are its own (a
batched LAPACK or cuSOLVER call may take another routine for another batch
size), a CUDA graph captures them, and a non-PD system gives NaN as JAX's
``cho_factor`` does (``torch.linalg.cholesky_ex`` returns a partial factor
and an error code instead).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

LAM_MIN, LAM_MAX = 1e-8, 1e8
LAM_DOWN, LAM_UP = 1.0 / 3.0, 4.0


def val_grad_hess(loss_fn: Callable[[torch.Tensor], torch.Tensor], params: torch.Tensor):
    """``(loss [B], gradient [B, n], Hessian [B, n, n])`` of ``loss_fn`` at
    ``params [B, n]`` (each pair's loss depends on its own row only): one
    forward and backward pass that keeps its graph, then one backward pass
    through it per parameter; ``H[:, i]`` is the gradient of ``g[:, i]``."""
    loss = loss_fn(params)
    (g,) = torch.autograd.grad(loss.sum(), params, create_graph=True)
    n = params.shape[-1]
    rows = []
    for i in range(n):
        (h,) = torch.autograd.grad(g[:, i].sum(), params, retain_graph=i < n - 1,
                                   allow_unused=True)
        rows.append(torch.zeros_like(params) if h is None else h)
    return loss.detach(), g.detach(), torch.stack(rows, dim=1)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of each ``[n, n]`` of ``A [B, n, n]``, from
    its lower triangle, column by column in elementwise ops (each sum in
    ascending order); a matrix that is not positive definite gives NaN (or
    an infinity) from its first failing column on."""
    n = A.shape[-1]
    below = torch.arange(n, device=A.device)[None, :]
    cols = []
    for j in range(n):
        s = A[:, :, j]
        for k in range(j):
            s = s - cols[k] * cols[k][:, j:j + 1]
        d = torch.sqrt(s[:, j:j + 1])
        cols.append(torch.where(below > j, s / d, torch.where(below == j, d, 0.0)))
    return torch.stack(cols, dim=2)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` with ``L L^T x = b`` for each pair (``L [B, n, n]`` lower,
    ``b [B, n]``): forward then back substitution, each row's terms taken
    in order."""
    n = b.shape[-1]
    r, ys = b, []
    for i in range(n):
        y = r[:, i:i + 1] / L[:, i, i:i + 1]
        r = r - L[:, :, i] * y
        ys.append(y)
    r, xs = torch.cat(ys, dim=1), [None] * n
    for i in range(n - 1, -1, -1):
        x = r[:, i:i + 1] / L[:, i, i:i + 1]
        r = r - L[:, i, :] * x
        xs[i] = x
    return torch.cat(xs, dim=1)


class LM:
    """Levenberg-Marquardt on one f32 tensor ``param [B, n]`` of B pairs: its
    state is the damping ``lam`` (one a pair, on the device). :meth:`step`
    takes the pre-step loss, gradient and Hessian, evaluates the trial and
    updates the parameters and ``lam`` of each active pair in place."""

    def __init__(self, param: torch.Tensor, pairs: int = 1, lam0: float = 1.0):
        self.param = param
        self.state = {"lam": torch.full((pairs,), float(lam0), dtype=torch.float32,
                                        device=param.device)}

    def step(self, loss_fn, val: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             active: torch.Tensor):
        """One damped Newton step of each active pair; returns ``(trial,
        val_new, accept)`` (``accept`` False for an inactive pair)."""
        lam = self.state["lam"]
        d = torch.diagonal(hess, dim1=1, dim2=2).abs()
        # Marquardt's scaling: damping along the Hessian's diagonal makes the
        # fallback a scaled gradient step (angles and translations differ in
        # scale)
        D = torch.maximum(d, 1e-8 * d.amax(dim=1, keepdim=True) + 1e-12)
        A = hess + lam[:, None, None] * torch.diag_embed(D)
        trial = self.param + cho_solve(cholesky(A), -grad)
        val_new = loss_fn(trial).to(torch.float32)
        accept = active & torch.isfinite(val_new) & (val_new < val)
        self.param.copy_(torch.where(accept[:, None], trial, self.param))
        lam.copy_(torch.where(active, torch.clamp(
            torch.where(accept, lam * LAM_DOWN, lam * LAM_UP), LAM_MIN, LAM_MAX), lam))
        return trial, val_new, accept


def lm_improved(best_loss: torch.Tensor, ref: torch.Tensor, stop_rel: float) -> torch.Tensor:
    """LM's plateau test: the best loss beats the reference by ``stop_rel``
    relative plus 1e-8 absolute (converged NCC losses hover near 0, where a
    relative test alone never settles); any finite loss beats an infinite
    reference. f32, as the JAX carry."""
    rel = float(np.float32(stop_rel))
    thr = torch.where(torch.isfinite(ref), ref - rel * ref.abs() - 1e-8,
                      torch.full_like(ref, float("inf")))
    return best_loss < thr


def optimize_lm(loss_fn: Callable[[torch.Tensor], torch.Tensor], params0: torch.Tensor,
                max_iters: int, stop_rel: float | None = 1e-4, patience: int = 3,
                lam0: float = 1.0):
    """One LM run of ``loss_fn`` from ``params0`` (``[n]``, or ``[B, n]``
    pairs with ``loss_fn`` giving ``[B]``); returns
    ``engines.common.optimize_scan``'s 6-tuple ``(final, best, best_loss,
    losses, param_history, steps)``."""
    from .common import optimize_scan

    return optimize_scan(loss_fn, params0, "lm", 0.0, max_iters, stop_rel, patience,
                         label="optimize_lm", lam0=lam0)
