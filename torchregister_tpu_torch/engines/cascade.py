"""Rigid -> affine -> flow cascade (counterpart of
``torchregister_tpu/engines/cascade.py:register_cascade``).

Coarse-to-fine: the matrix stages optimize a near-identity residual at each
pyramid level on an image warped once with the theta so far, and compose
(``theta <- theta ∘ residual``); one full-resolution re-warp hands the
result to the flow stage, which runs its own pyramid. In field mode the
levels warm-start the field (or, with ``flow_rebase``, fit zero-init
residual fields on a once-rebased input). In U-Net mode each finer level
warps its input once with the upsampled total flow, trains a fresh network
(zero head, weights from ``seed``) on the residual and composes ``total <-
residual ∘ total`` exactly (``flow_compose``; without it the levels
warm-start one network). A final flow warp gives the registered image. With
``final_warp='exact'`` the full-resolution matrix warp and the final flow
warp run on kernel K2 (``ops/blocked.py``) with ``grid_sample`` semantics.

:func:`make_cascade_fn` is the JAX package's single-program cascade: the same
program, with each engine level's step captured once as a CUDA graph and
replayed (``engines/graph.py``), equal to :func:`register_cascade` to the
bit. Each stage and level runs inside a :func:`utils.profiling.trace` span
(``rigid/level0``, ``flow/level2``, ...), which also names its step graph.

:func:`make_cascade_batch_fn` is the cascade over a batch of pairs (JAX's
``vmap`` of it): :func:`cascade_pairs` runs every level's engine loop on
the batch (``engines/common.fit_matrix``, ``flow.flow_pairs``: each pair's
loss, stop and trajectory its own), warps each pair by its own theta and
flow, and checks the windows with one host read naming the pairs.
:func:`register_cascade` is the same code on one pair. The JAX batch
sizes no window from a concrete theta (under ``vmap`` every theta is
traced); neither does this one: every window is static.

``matrix_optimizer='lm'`` runs the matrix stages with Levenberg-Marquardt
(``engines/second_order.py``): a level's step is one LM iteration (its
loss, gradient, n Hessian passes, Cholesky and trial), which the factories
capture and replay as they do Adam's step.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import NamedTuple, Optional, Sequence

import torch

from ..losses import pair_slices, resolve_criteria
from ..ops.blocked import warp_affine_fast, warp_flow_fast
from ..ops.resize import downsample_avg
from ..ops.separable import _warp_affine_separable, warp_flow_separable
from ..ops.transforms import compose_theta, identity_theta, rigid_theta
from ..models.attention_unet import max_depth_for
from ..utils.profiling import trace
from ..utils.pyramid import (build_pyramid, compose_flows, compose_flows_separable,
                             upsample_flow)
from . import graph
from .affine import affine_theta
from .common import check_sweep_windows, defaults_of, fit_matrix
from .flow import flow_pairs, flows_over
from .rigid import init_rigid_params


class CascadeResult(NamedTuple):
    warped: torch.Tensor  # final registered image
    theta: torch.Tensor  # composed rigid∘affine matrix [1, d, d+1]
    flow: Optional[torch.Tensor]  # dense field (None without a flow stage)
    rigid_losses: Optional[torch.Tensor]
    affine_losses: Optional[torch.Tensor]
    flow_losses: Optional[torch.Tensor]
    # executed optimizer steps per stage, one entry per pyramid level
    steps: Optional[dict] = None


def _level_warp(theta, moving_level, exact: bool = False):
    """Full-transform re-warp: exact on K2, or separable with a window that
    covers the whole displacement."""
    if exact:
        return warp_affine_fast(theta, moving_level)
    S = max(moving_level.shape[2:])
    with torch.no_grad():
        return _warp_affine_separable(theta, moving_level, max_shift=max(8, S // 3))


@contextlib.contextmanager
def _level(name: str):
    """A stage's level: a trace span, and the name of its step graph."""
    with trace(name), graph.level(name):
        yield


def register_cascade(
    moving: torch.Tensor,
    target: torch.Tensor,
    stages: Sequence[str] = ("rigid", "affine", "flow"),
    levels: int = 3,
    rigid_epochs: int = 500,
    rigid_lr: float = 1e-5,
    affine_epochs: int = 200,
    affine_lr: float = 1e-5,
    flow_epochs: int = 100,
    flow_lr: float = 1e-3,
    criterions=("mse", "ncc"),
    weights=None,
    optimizer: str = "adam",
    n: float = 8,
    flow_depth: int | None = None,
    seed: int = 0,
    residual_shift: int = 8,
    final_warp: str = "separable",
    flow_max_size: int = 160,
    flow_dtype: str = "float32",
    level_decay: float = 2.0,
    flow_remat: bool = False,
    flow_max_disp: int = 8,
    matrix_dtype: str = "float32",
    flow_attention: bool = True,
    flow_norm: bool = True,
    matrix_stop_rel: float | None = None,
    matrix_patience: int = 25,
    matrix_levels: int | None = None,
    matrix_optimizer: str | None = None,
    moment_init: bool | str = False,
    flow_model: str = "field",
    flow_smooth=None,
    flow_stop_rel: float | None = None,
    flow_patience: int = 25,
    flow_compose: bool = True,
    flow_levels: int | None = None,
    flow_criterions=None,
    flow_rebase: bool = False,
    flow_residual_disp: int = 4,
) -> CascadeResult:
    """Coarse-to-fine rigid→affine→flow registration of one pair
    ``[1, 1, *S]``; options as in the JAX package. ``criterions=None`` (and
    ``flow_criterions=None`` after it) is the reference's default stack, MSE
    + NCC(100) + NMI(1000) at weights 0.33, as in ``Register`` (the JAX
    package's cascade takes only a list, ``('mse', 'ncc', 'nmi')`` with those
    weights being the same stack).

    ``flow_model='unet'`` runs the U-Net flow stage: ``n`` divides its
    widths, ``flow_depth`` (default: ``max_depth_for`` the coarsest flow
    level, one depth for all levels) sets its depth, ``flow_remat``,
    ``flow_attention`` and ``flow_norm`` pass to ``flow_register``, and every
    level's fresh weights come from ``torch.Generator().manual_seed(seed)``
    (over a batch, every pair's: each pair trains its own net from them).
    ``flow_smooth=None`` resolves to 0.5 in field mode and 0.0 in U-Net mode.

    ``flow_rebase=True`` (field mode) optimizes each finer flow level as a zero-init
    residual under the ``flow_residual_disp`` window on an input warped once
    with the upsampled total field, and composes ``total <- residual ∘
    total``.
    """
    res = _cascade(pairs=1, **locals())
    return res._replace(
        **{k: None if v is None else v[0] for k, v in (
            ("rigid_losses", res.rigid_losses), ("affine_losses", res.affine_losses),
            ("flow_losses", res.flow_losses))},
        steps={k: [level[0] for level in v] for k, v in res.steps.items()})


def cascade_pairs(moving: torch.Tensor, target: torch.Tensor, **options) -> CascadeResult:
    """:func:`register_cascade` (its options and defaults) over the B
    independent pairs of ``[B, 1, *S]`` (:func:`make_cascade_batch_fn`),
    each registered on its own: every field gains a leading pair axis
    (``theta [B, 1, d, d+1]``, ``warped [B, 1, 1, *S]``, ``flow [B, 1, d,
    *S]``, losses ``[B, epochs]``), and ``steps[stage][b]`` holds pair b's
    steps per level."""
    res = _cascade(pairs=moving.shape[0], moving=moving, target=target,
                   **{**defaults_of(register_cascade), **options})
    return res._replace(
        warped=res.warped[:, None], theta=res.theta[:, None],
        flow=None if res.flow is None else res.flow[:, None],
        steps={k: [list(s) for s in zip(*v)] for k, v in res.steps.items()})


def _cascade(pairs, moving, target, stages, levels, rigid_epochs, rigid_lr, affine_epochs,
             affine_lr, flow_epochs, flow_lr, criterions, weights, optimizer, n, flow_depth,
             seed, residual_shift, final_warp, flow_max_size, flow_dtype, level_decay,
             flow_remat, flow_max_disp, matrix_dtype, flow_attention, flow_norm,
             matrix_stop_rel, matrix_patience, matrix_levels, matrix_optimizer, moment_init,
             flow_model, flow_smooth, flow_stop_rel, flow_patience, flow_compose, flow_levels,
             flow_criterions, flow_rebase, flow_residual_disp) -> CascadeResult:
    """The cascade over ``pairs`` pairs, each a slice of ``moving``'s
    leading axis (one pair: the whole of it): thetas ``[pairs, d, d+1]``,
    the losses ``[pairs, epochs]``, ``steps[stage][level]`` one a pair."""
    if flow_model not in ("unet", "field"):
        raise ValueError(f"flow_model must be 'unet' or 'field' (got {flow_model!r})")
    unet = flow_model == "unet"
    if final_warp not in ("separable", "exact"):
        raise ValueError(f"final_warp must be 'separable' or 'exact' (got {final_warp!r})")
    exact = final_warp == "exact"
    if moment_init not in (False, True, "com", "pa"):
        raise ValueError(f"moment_init must be False, True, 'com', or 'pa' "
                         f"(got {moment_init!r})")
    m_opt = optimizer if matrix_optimizer is None else matrix_optimizer
    if matrix_levels is not None and matrix_levels < 1:
        raise ValueError(f"matrix_levels must be >= 1 (got {matrix_levels})")

    moving = moving.to(torch.float32)
    target = target.to(torch.float32)
    ndim = moving.ndim - 2
    if flow_smooth is None:
        flow_smooth = 0.0 if unet else 0.5
    if flow_criterions is None:
        flow_criterions = criterions

    mov_pyr = build_pyramid(moving, levels)
    tgt_pyr = build_pyramid(target, levels)
    if matrix_dtype != "float32":
        # reduced-precision image side of the matrix stages; theta and the
        # optimizer state stay f32, the losses upcast before reducing
        mdt = getattr(torch, matrix_dtype)
        mov_pyr = [m.to(mdt) for m in mov_pyr]
        tgt_pyr = [t.to(mdt) for t in tgt_pyr]

    theta = identity_theta(ndim, device=moving.device)[None].repeat(pairs, 1, 1)
    rigid_losses = affine_losses = flow_losses = None
    steps: dict = {}
    m_levels = levels if matrix_levels is None else min(matrix_levels, levels)

    def level_shift(i, mov_l):
        if i == 0:  # the coarsest level sees the full initial misalignment
            S = max(mov_l.shape[2:])
            if moment_init == "pa" and "rigid" in stages:
                # principal axes seed large rotations: cover ~60-90 degrees
                return max(residual_shift, S // 2 + 4)
            if moment_init and ndim == 3 and "rigid" in stages:
                # the CoM init pre-matches the bulk translation; the bounded
                # 3D translation is <= S/8 voxels, plus rotation margin
                return max(residual_shift, S // 8 + 4)
            return max(residual_shift, S // 4)
        return residual_shift

    def level_budgets(total, nlevels):
        """Geometric epoch split favouring coarse levels (ratio level_decay)."""
        w = [level_decay ** (nlevels - 1 - i) for i in range(nlevels)]
        s = sum(w)
        return [max(1, int(round(total * x / s))) for x in w]

    if "rigid" in stages:
        from ..ops.moments import com_rigid_params, pa_rigid_params

        budgets = level_budgets(rigid_epochs, m_levels)
        losses, steps["rigid"] = [], []
        for i, (mov_l, tgt_l) in enumerate(zip(mov_pyr[:m_levels], tgt_pyr[:m_levels])):
            with _level(f"rigid/level{i}"):
                base = _level_warp(theta, mov_l) if i else mov_l
                if i == 0 and moment_init:
                    moments = pa_rigid_params if moment_init == "pa" else com_rigid_params
                    params0 = torch.stack([moments(m, t) for m, t in zip(
                        pair_slices(base, pairs), pair_slices(tgt_l, pairs))])
                else:
                    params0 = init_rigid_params(ndim, init="identity", device=base.device,
                                                pairs=pairs)
                res = _matrix_level(base, tgt_l, params0, rigid_theta, criterions, weights,
                                    m_opt, rigid_lr, budgets[i], level_shift(i, mov_l),
                                    matrix_stop_rel, matrix_patience, "rigid_register")
            theta = _compose(theta, res.best_theta[:, 0])
            losses.append(res.losses)
            steps["rigid"].append(res.steps)
        rigid_losses = torch.cat(losses, dim=-1)

    if "affine" in stages:
        budgets = level_budgets(affine_epochs, m_levels)
        losses, steps["affine"] = [], []
        for i, (mov_l, tgt_l) in enumerate(zip(mov_pyr[:m_levels], tgt_pyr[:m_levels])):
            with _level(f"affine/level{i}"):
                base = _level_warp(theta, mov_l)
                shift = level_shift(i if "rigid" not in stages else levels, mov_l)
                identity = identity_theta(ndim, device=base.device).reshape(1, -1)
                res = _matrix_level(base, tgt_l, identity.repeat(pairs, 1), affine_theta,
                                    criterions, weights, m_opt, affine_lr, budgets[i], shift,
                                    matrix_stop_rel, matrix_patience, "affine_register")
            theta = _compose(theta, res.best_theta[:, 0])
            losses.append(res.losses)
            steps["affine"].append(res.steps)
        affine_losses = torch.cat(losses, dim=-1)

    # one full-resolution resample through the composed matrix transform
    with trace("matrix/warp"):
        warped = _level_warp(theta, moving, exact)

    flow = None
    scale = 1
    if "flow" in stages:
        flow_in, flow_tgt = warped, target
        while max(flow_in.shape[2:]) > flow_max_size:
            flow_in = downsample_avg(flow_in, 2)
            flow_tgt = downsample_avg(flow_tgt, 2)
            scale *= 2
        if flow_levels is None:
            flow_levels = min(2, levels)
        if flow_levels < 1:
            raise ValueError(f"flow_levels must be >= 1 (got {flow_levels})")
        if flow_rebase and unet:
            raise ValueError("flow_rebase=True requires flow_model='field' (U-Net mode "
                             "composes residuals through flow_compose)")
        if flow_rebase and not 1 <= flow_residual_disp <= flow_max_disp:
            raise ValueError(f"flow_residual_disp must be in [1, flow_max_disp="
                             f"{flow_max_disp}] (got {flow_residual_disp})")
        # clamp the depth so the coarsest level keeps >= 8 voxels per axis
        min_s = min(flow_in.shape[2:])
        requested_levels = flow_levels
        flow_levels = min(flow_levels, max(1, int(math.log2(max(1, min_s // 8))) + 1))
        f_pyr_in = build_pyramid(flow_in, flow_levels)
        f_pyr_tgt = build_pyramid(flow_tgt, flow_levels)
        smooths = (tuple(flow_smooth) if isinstance(flow_smooth, (tuple, list))
                   else (float(flow_smooth),) * flow_levels)
        if len(smooths) == requested_levels and flow_levels < requested_levels:
            smooths = smooths[-flow_levels:]  # the clamp dropped coarse levels
        if len(smooths) != flow_levels:
            raise ValueError(f"flow_smooth tuple has {len(smooths)} entries for "
                             f"{flow_levels} flow levels")
        if unet and flow_depth is None:
            # one depth for every level: a warm start needs one structure
            flow_depth = max_depth_for(f_pyr_in[0].shape[2:])
        compose = unet and flow_compose
        budgets = level_budgets(flow_epochs, flow_levels)
        params = total_flow = None
        losses, steps["flow"] = [], []
        for li, ((f_in, f_tgt), eps) in enumerate(zip(zip(f_pyr_in, f_pyr_tgt), budgets)):
            base_in, level_disp = f_in, flow_max_disp
            if compose and total_flow is not None:
                # warp the level input once with the flow so far and fit a
                # fresh net to the residual; the window covers the composed
                # magnitude, each coarser level's doubled per upsample
                total_flow = upsample_flow(total_flow, f_in.shape[2:])
                with torch.no_grad():
                    base_in = warp_flow_separable(
                        f_in, total_flow, max_disp=flow_max_disp * (2 ** (li + 1) - 2))
                params = None
            elif not unet and params is not None:
                # warm start: upsample the field (voxel units rescaled)
                params = upsample_flow(params, f_in.shape[2:])
                if flow_rebase:
                    # one warp bakes the total so far into the level input; its
                    # window covers the worst-case upsampled composite (each
                    # upsample doubles voxel magnitudes), since what falls
                    # outside a one-shot warp is lost for good
                    total_flow = params
                    rebase_win = flow_max_disp * 2**li + flow_residual_disp * (2**li - 2)
                    with torch.no_grad():
                        base_in = warp_flow_separable(f_in, total_flow, max_disp=rebase_win)
                    params, level_disp = None, flow_residual_disp
            # every pair's fresh net from the config's seed, as JAX's vmap of
            # the cascade gives each pair the same key
            gens = [torch.Generator().manual_seed(seed) for _ in range(pairs)]
            with _level(f"flow/level{li}"):
                _, fres = flow_pairs(
                    base_in, f_tgt, pairs, lr=flow_lr, max_epochs=eps,
                    criterions=flow_criterions, weights=weights, n=n,
                    depth=flow_depth, generator=gens[0] if pairs == 1 else gens,
                    optimizer=optimizer, dtype=flow_dtype, init_params=params,
                    remat=flow_remat, max_disp=level_disp, use_attention=flow_attention,
                    use_norm=flow_norm, flow_model=flow_model, smooth=smooths[li],
                    stop_rel=flow_stop_rel, patience=flow_patience, zero_head=compose,
                    check_disp=False,  # one end-of-run check below
                )
            params = fres.params
            if compose:
                # applying total_flow then fres.flow == applying the composite
                total_flow = (fres.flow if total_flow is None
                              else compose_flows(total_flow, fres.flow))
            elif flow_rebase and total_flow is not None:
                # fold the residual into the total ("total, then residual"):
                # the resample displacement is the residual, so its window does
                with torch.no_grad():
                    total_flow = compose_flows_separable(total_flow, fres.flow,
                                                         max_disp=flow_residual_disp)
                params = total_flow
            losses.append(fres.losses)
            steps["flow"].append(fres.steps)
        flow = total_flow if total_flow is not None else fres.flow
        flow_losses = torch.cat(losses, dim=-1)
        if scale > 1:
            flow = upsample_flow(flow, warped.shape[2:])
        if compose:
            # level j contributes <= flow_max_disp * 2^(L-1-j) at the finest
            # flow grid: flow_max_disp * (2^L - 1) summed
            final_bound = flow_max_disp * scale * (2 ** flow_levels - 1)
        elif flow_rebase:
            # worst-case composed total at the finest flow grid: the coarse
            # window doubled per upsample plus each level's doubled residual
            final_bound = (flow_max_disp * 2 ** (flow_levels - 1)
                           + flow_residual_disp * (2 ** (flow_levels - 1) - 1)) * scale
        else:
            final_bound = flow_max_disp * scale
        with trace("flow/warp"):
            if exact:
                warped = warp_flow_fast(warped, flow)
            else:
                with torch.no_grad():
                    warped = warp_flow_separable(warped, flow, max_disp=final_bound)

    if not exact:  # an exact warp has no window to outgrow
        # end-of-run window checks (one host read of theta and of max |flow|)
        check_sweep_windows(theta, moving.shape[2:], max(8, max(moving.shape[2:]) // 3),
                            "register_cascade (composed theta)")
        if flow is not None:
            maxd = torch.stack([torch.max(torch.abs(f)) for f in pair_slices(flow, pairs)])
            what = flows_over(maxd, final_bound)
            if what:
                warnings.warn(
                    f"register_cascade: {what} but the final sweep window is {final_bound}; "
                    "displacements beyond it contribute zero. Raise flow_max_disp or use "
                    "final_warp='exact'.",
                    RuntimeWarning,
                    stacklevel=3,
                )
    return CascadeResult(warped=warped, theta=theta, flow=flow, rigid_losses=rigid_losses,
                         affine_losses=affine_losses, flow_losses=flow_losses, steps=steps)


def _matrix_level(base, target, params0, theta_of, criterions, weights, optimizer, lr,
                  epochs, shift, stop_rel, patience, label):
    """A matrix level: the engine's loop (``fit_matrix``) on the pairs of
    ``params0 [B, n]``, each on its own, at the level's window; thetas
    ``[B, 1, d, d+1]``."""
    criteria, w = resolve_criteria(criterions, weights)
    return fit_matrix(base, target, params0, theta_of, criteria, w, optimizer, lr, epochs,
                      shift, True, stop_rel, patience, None, label)


def _compose(theta: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``theta ∘ residual``, one pair at a time (each pair's product the
    single-pair one)."""
    return torch.cat([compose_theta(a[None], b[None])
                      for a, b in zip(torch.unbind(theta), torch.unbind(residual))])


class CascadeFn:
    """``fn(moving, target) -> CascadeResult``: :func:`register_cascade` with
    one config (``pairs``: :func:`cascade_pairs`, over a batch of pairs). On a CUDA device each
    engine level's step is captured once as a CUDA graph (``graphs``, one
    memory pool) and replayed; a later call with the same shapes copies its
    inputs into the captured buffers. On the CPU it runs the same loops
    without graphs."""

    def __init__(self, config: dict, pairs: bool = False):
        self.config = dict(config)
        self.pairs = pairs
        self.graphs = graph.StepGraphs()

    def __call__(self, moving: torch.Tensor, target: torch.Tensor) -> CascadeResult:
        run = cascade_pairs if self.pairs else register_cascade
        if not moving.is_cuda:
            return run(moving, target, **self.config)
        with graph.graphed(self.graphs):
            return run(moving, target, **self.config)


_CASCADE_CACHE: dict = {}
_BATCH_CACHE: dict = {}


def make_cascade_fn(**config) -> CascadeFn:
    """The cascade as one reusable program (counterpart of the JAX
    package's jitted ``make_cascade_fn``): ``fn(moving, target) ->
    CascadeResult``, cached on ``config`` (the keyword arguments of
    :func:`register_cascade`; all hashable, tuples for lists), so the same
    config returns the same ``fn``. Its results equal
    :func:`register_cascade`'s to the bit. Every criterion captures, the
    default stack ``criterions=None`` (MSE + NCC + NMI) included: NMI picks
    its density path on the device (``losses/nmi.py``), so each replay takes
    the branch of its own data. A failed capture raises, with no fallback."""
    key = tuple(sorted(config.items()))
    fn = _CASCADE_CACHE.get(key)
    if fn is None:
        fn = CascadeFn(config)
        _CASCADE_CACHE[key] = fn
    return fn


def make_cascade_batch_fn(mesh=None, spatial_axis=None, **config) -> CascadeFn:
    """The cascade over a batch of independent pairs (counterpart of the JAX
    package's ``make_cascade_batch_fn``, its ``vmap``):
    ``fn(movings [B, 1, *S], targets [B, 1, *S]) -> CascadeResult`` with a
    leading pair axis on every field (:func:`cascade_pairs`).
    Each pair stops at its own step; each pair's result is the one
    ``make_cascade_fn(**config)`` gives it alone, to the bit. On the card
    each engine level's batched step is captured once as a CUDA graph and
    replayed, as :func:`make_cascade_fn` does, NMI included (each pair's NMI
    call takes its own branch on the device, as JAX's ``vmap`` of the
    ``lax.cond`` keeps each pair's); a failed capture raises. Cached on
    ``config``. ``mesh`` and ``spatial_axis`` raise ``ValueError`` (the port
    runs a batch on one GPU)."""
    if mesh is not None or spatial_axis is not None:
        raise ValueError(
            "make_cascade_batch_fn: mesh and spatial_axis are not supported by the "
            "PyTorch port, which runs a batch of pairs on one GPU (the JAX package's "
            "parallel/mesh.py has no counterpart)")
    key = tuple(sorted(config.items()))
    fn = _BATCH_CACHE.get(key)
    if fn is None:
        fn = CascadeFn(config, pairs=True)
        _BATCH_CACHE[key] = fn
    return fn
