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
``make_cascade_batch_fn`` (cohorts, ROADMAP queue 1 item 12) and the LM
matrix optimizer (item 14) are not ported yet; the latter raises
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.blocked import warp_affine_fast, warp_flow_fast
from ..ops.resize import downsample_avg
from ..ops.separable import _warp_affine_separable, warp_flow_separable
from ..ops.transforms import compose_theta, identity_theta
from ..models.attention_unet import max_depth_for
from ..utils.profiling import trace
from ..utils.pyramid import (build_pyramid, compose_flows, compose_flows_separable,
                             upsample_flow)
from . import graph
from .affine import affine_register
from .common import check_sweep_windows
from .flow import flow_register
from .rigid import rigid_register


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


def _not_ported(option: str, item: str):
    raise NotImplementedError(f"register_cascade({option}) is not ported yet: "
                              f"ROADMAP queue 1 item {item}")


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
    ``[1, 1, *S]``; options as in the JAX package.

    ``flow_model='unet'`` runs the U-Net flow stage: ``n`` divides its
    widths, ``flow_depth`` (default: ``max_depth_for`` the coarsest flow
    level, one depth for all levels) sets its depth, ``flow_remat``,
    ``flow_attention`` and ``flow_norm`` pass to ``flow_register``, and every
    level's fresh weights come from ``torch.Generator().manual_seed(seed)``.
    ``flow_smooth=None`` resolves to 0.5 in field mode and 0.0 in U-Net mode.

    ``flow_rebase=True`` (field mode) optimizes each finer flow level as a zero-init
    residual under the ``flow_residual_disp`` window on an input warped once
    with the upsampled total field, and composes ``total <- residual ∘
    total``.
    """
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
    if m_opt == "lm":
        _not_ported("matrix_optimizer='lm'", "14 (engines/second_order.py)")
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

    theta = identity_theta(ndim, device=moving.device)[None]
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
                init_params = None
                if i == 0 and moment_init:
                    init_params = (pa_rigid_params(base, tgt_l) if moment_init == "pa"
                                   else com_rigid_params(base, tgt_l))
                _, res = rigid_register(
                    base, tgt_l, lr=rigid_lr, epochs=budgets[i],
                    criterions=list(criterions), weights=weights, grad_edges=False,
                    optimizer=m_opt, init="identity", init_params=init_params,
                    stop_rel=matrix_stop_rel, patience=matrix_patience,
                    max_shift=level_shift(i, mov_l),
                    check_window=False,  # one end-of-run check below
                )
            theta = compose_theta(theta, res.best_theta)
            losses.append(res.losses)
            steps["rigid"].append(res.steps)
        rigid_losses = torch.cat(losses)

    if "affine" in stages:
        budgets = level_budgets(affine_epochs, m_levels)
        losses, steps["affine"] = [], []
        for i, (mov_l, tgt_l) in enumerate(zip(mov_pyr[:m_levels], tgt_pyr[:m_levels])):
            with _level(f"affine/level{i}"):
                base = _level_warp(theta, mov_l)
                _, res = affine_register(
                    base, tgt_l, lr=affine_lr, epochs=budgets[i],
                    criterions=list(criterions), weights=weights, grad_edges=False,
                    optimizer=m_opt, stop_rel=matrix_stop_rel, patience=matrix_patience,
                    max_shift=level_shift(i if "rigid" not in stages else levels, mov_l),
                    check_window=False,
                )
            theta = compose_theta(theta, res.best_theta)
            losses.append(res.losses)
            steps["affine"].append(res.steps)
        affine_losses = torch.cat(losses)

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
            with _level(f"flow/level{li}"):
                _, fres = flow_register(
                    base_in, f_tgt, lr=flow_lr, max_epochs=eps,
                    criterions=list(flow_criterions), weights=weights, n=n,
                    depth=flow_depth, generator=torch.Generator().manual_seed(seed),
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
        flow_losses = torch.cat(losses)
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
            maxd = float(torch.max(torch.abs(flow)))
            if maxd > final_bound:
                warnings.warn(
                    f"register_cascade: recovered flow reaches {maxd:.1f} voxels but "
                    f"the final sweep window is {final_bound}; displacements beyond it "
                    "contribute zero. Raise flow_max_disp or use final_warp='exact'.",
                    RuntimeWarning,
                    stacklevel=2,
                )

    return CascadeResult(warped=warped, theta=theta, flow=flow,
                         rigid_losses=rigid_losses, affine_losses=affine_losses,
                         flow_losses=flow_losses, steps=steps)


def _check_capturable(config: dict) -> None:
    """Raise for a criterion whose step reads the host: the NMI term picks
    its KDE branch on the host each step (``losses/nmi.py``'s
    ``_binned_ok``), which a CUDA graph cannot capture."""
    from ..losses import resolve_criteria
    from ..losses.nmi import nmi, nmi_loss

    for key in ("criterions", "flow_criterions"):
        spec = config.get(key, ("mse", "ncc") if key == "criterions" else None)
        if spec is None and key == "flow_criterions":
            continue
        crits, _ = resolve_criteria(spec, config.get("weights"))
        if any(c in (nmi, nmi_loss) or getattr(c, "func", None) in (nmi, nmi_loss)
               for c in crits):
            raise ValueError(
                f"make_cascade_fn: {key} includes 'nmi', whose step reads the host to "
                "pick its KDE branch (losses/nmi.py), so a CUDA graph cannot capture it; "
                "run register_cascade, or leave NMI out (ROADMAP queue 1 item 16 moves "
                "the choice to the device)")


class CascadeFn:
    """``fn(moving, target) -> CascadeResult``: :func:`register_cascade` with
    one config. On a CUDA device each engine level's step is captured once
    as a CUDA graph (``graphs``, one memory pool) and replayed; a later call
    with the same shapes copies its inputs into the captured buffers. On
    the CPU it runs the same loops without graphs."""

    def __init__(self, config: dict):
        self.config = dict(config)
        self.graphs = graph.StepGraphs()

    def __call__(self, moving: torch.Tensor, target: torch.Tensor) -> CascadeResult:
        if not moving.is_cuda:
            return register_cascade(moving, target, **self.config)
        with graph.graphed(self.graphs):
            return register_cascade(moving, target, **self.config)


_CASCADE_CACHE: dict = {}


def make_cascade_fn(**config) -> CascadeFn:
    """The cascade as one reusable program (counterpart of the JAX
    package's jitted ``make_cascade_fn``): ``fn(moving, target) ->
    CascadeResult``, cached on ``config`` (the keyword arguments of
    :func:`register_cascade`; all hashable, tuples for lists), so the same
    config returns the same ``fn``. Its results equal
    :func:`register_cascade`'s to the bit. A criterion whose step reads the
    host (``'nmi'``, and the default stack ``criterions=None``) raises
    ``ValueError``; a failed capture raises too, with no fallback."""
    key = tuple(sorted(config.items()))
    fn = _CASCADE_CACHE.get(key)
    if fn is None:
        _check_capturable(config)
        fn = CascadeFn(config)
        _CASCADE_CACHE[key] = fn
    return fn
