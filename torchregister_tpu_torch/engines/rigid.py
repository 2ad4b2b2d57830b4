"""Rigid (SE(2)/SE(3)) registration engine (counterpart of
``torchregister_tpu/engines/rigid.py``): a 6-vector (3D) or 3-vector (2D) of
raw parameters mapped by :func:`rigid_theta` and optimized through the
separable warp (``method='separable'``) or the exact resampler (any other
``method``, as in the JAX package). ``grad_edges=True`` (the default)
registers the Sobel edge masks of both images (``ops/edge.py``) instead of
the images, and the returned image is the warped mask, as in the JAX
package."""
from __future__ import annotations

import torch

from ..losses import resolve_criteria
from ..ops.edge import edge_filter
from ..ops.transforms import rigid_theta, rigid_theta_np
from .common import (RegistrationResult, finish_matrix, first_pair, fit_matrix,
                     resolve_sweep_windows)


def init_rigid_params(ndim: int, generator: torch.Generator | None = None,
                      init: str = "random", device=None,
                      pairs: int | None = None) -> torch.Tensor:
    """Zero params (``'identity'``) or ``torch.rand`` draws (``'random'``);
    ``[pairs, n]`` for a cohort."""
    n = 6 if ndim == 3 else 3
    shape = (n,) if pairs is None else (pairs, n)
    if init == "identity":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)


def rigid_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-5,
    epochs: int = 1000,
    per: float = 0.1,
    criterions=None,
    weights=None,
    grad_edges: bool = True,
    optimizer: str = "sgd",
    init: str = "random",
    generator: torch.Generator | None = None,
    init_params: torch.Tensor | None = None,
    method: str = "separable",
    max_shift=None,
    check_window: bool = True,
    stop_rel: float | None = None,
    patience: int = 25,
    progress_every: int | None = None,
) -> tuple[torch.Tensor, RegistrationResult]:
    """Register ``moving [1,1,*S]`` onto ``target`` with a rigid transform;
    returns ``(warped_best, result)``. ``max_shift`` bounds the sweep;
    by default the windows cover the concrete init theta. Under
    ``method='exact'`` the loop warps with ``ops/resample.warp_affine`` and
    ``warped_best`` comes from K2 (``warp_affine_fast``).
    ``progress_every=N`` prints progress every N steps. ``per`` is accepted
    for the reference's signature and unused, as in the JAX package. The
    loop is ``engines/common.fit_matrix`` on one pair, which a cohort runs
    on B pairs.

    ``moving`` and ``target`` may be split into slabs over a mesh
    (``parallel.mesh.shard(x, volume_sharding(mesh))``, the ``space`` axis),
    as the JAX engine takes sharded arrays: the edge filter, the warp (K1's
    slab mode) and every criterion run slab by slab (LNCC with a halo of
    its window, NMI with each patch assembled on one slab: ``losses/``),
    the parameters on the mesh's first device, and ``warped_best`` comes
    back split alike;
    ``optimizer='lm'`` differentiates K1's slab mode twice
    (``sweep_slab_bwd2``); ``method='exact'`` warps each slab with the exact
    resampler on the fetched volume, ``warped_best`` with K2's slab mode."""
    del per
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    ndim = moving.ndim - 2
    spatial = tuple(moving.shape[2:])
    if init_params is None:
        init_params = init_rigid_params(ndim, generator, init, moving.device)
    separable = method == "separable"
    # the init theta is read on the host only to size windows not given
    windows = (resolve_sweep_windows(None if max_shift is not None
                                     else rigid_theta_np(init_params), spatial, max_shift)
               if separable else None)
    result = first_pair(fit_matrix(moving, target, init_params[None], rigid_theta, criteria, w,
                                   optimizer, lr, epochs, windows, separable, stop_rel,
                                   patience, progress_every, "rigid_register"))
    return finish_matrix(result, moving, spatial, windows, separable, check_window,
                         "rigid_register")
