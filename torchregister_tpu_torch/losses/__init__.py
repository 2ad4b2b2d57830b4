"""Similarity criteria and the weighted-sum combinator (counterpart of
``torchregister_tpu/losses/__init__.py``).

Criteria are called as ``criterion(target, warped)``. ``None`` stands for the
reference's default stack, MSE + NCC(100) + NMI(1000) with weights
``[0.33, 0.33, 0.33]``; a user's criterion list is used as given (the
reference discards it, warpings.py:36-40).

:func:`pair_loss` is the weighted sum over a batch of independent pairs
(the engines' loops, a cohort): ``[B]``, each criterion called on each
pair's own slice, so each pair's value and gradient are those of its own
call; on a batch split into slabs each pair's slabs, so a pair in a batch
equals the same pair alone on the same slabs to the bit.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Sequence

import torch

from .nmi import get_pdf, kde_pdf, nmi, nmi_loss
from .similarity import lncc, mse, ncc, ssd

Criterion = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY = {"mse": mse, "ssd": ssd, "ncc": ncc, "lncc": lncc, "nmi": nmi_loss}

DEFAULT_WEIGHTS = (0.33, 0.33, 0.33)


@lru_cache(maxsize=256)
def _cached_partial(name: str, kw_items: tuple) -> Criterion:
    return partial(_REGISTRY[name], **dict(kw_items))


def get_criterion(spec, **kwargs) -> Criterion:
    """Resolve a name (same (name, kwargs) -> same function object) or pass a
    callable through."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        key = spec.lower()
        if key not in _REGISTRY:
            raise KeyError(f"unknown criterion {spec!r}; known: {sorted(_REGISTRY)}")
        if not kwargs:
            return _REGISTRY[key]
        return _cached_partial(key, tuple(sorted(kwargs.items())))
    raise TypeError(f"criterion spec must be str or callable, got {type(spec)}")


def default_criteria() -> tuple[Criterion, ...]:
    """The reference default stack (warpings.py:37): MSE, NCC(100), NMI(1000)."""
    return (mse, ncc, nmi_loss)


def weighted_loss(criteria: Sequence[Criterion], weights: Sequence[float]) -> Criterion:
    """``sum_i w_i * crit_i(y, yp)``."""
    criteria = tuple(criteria)
    weights = tuple(float(w) for w in weights)
    if len(criteria) != len(weights):
        raise ValueError(f"{len(criteria)} criteria but {len(weights)} weights")

    def loss(y, yp):
        total = 0.0
        for w, c in zip(weights, criteria):
            total = total + w * c(y, yp)
        return total

    return loss


def pair_slices(x: torch.Tensor, pairs: int) -> tuple:
    """The ``pairs`` equal slices of ``x``'s leading axis, one a pair (one
    pair: ``x`` whole). A batch split into slabs (``parallel.mesh.Sharded``)
    gives each pair's slabs, so a criterion adds each pair's own slab
    partials in ascending slab order."""
    if not isinstance(x, torch.Tensor):
        return x.chunk(pairs)
    return torch.chunk(x, pairs)


def per_pair(criterion: Criterion, pairs: int) -> Callable:
    """``criterion`` over ``pairs`` pairs: ``(y, yp) -> [pairs]``, the
    criterion called on each pair's slice."""

    def each(y, yp):
        return torch.stack([torch.reshape(criterion(a, b), ())
                            for a, b in zip(pair_slices(y, pairs), pair_slices(yp, pairs))])

    return each


def pair_loss(criteria: Sequence[Criterion], weights: Sequence[float], pairs: int) -> Callable:
    """:func:`weighted_loss` of each of ``pairs`` pairs: ``(y, yp) ->
    [pairs]``."""
    return weighted_loss([per_pair(c, pairs) for c in criteria], weights)


def resolve_criteria(criterion, weight):
    """Normalize the public (criterion, weight) pair; ``None`` means the
    reference default stack."""
    if criterion is None:
        crits = default_criteria()
        w = tuple(weight) if weight is not None else DEFAULT_WEIGHTS
    else:
        if callable(criterion) or isinstance(criterion, str):
            criterion = [criterion]
        crits = tuple(get_criterion(c) for c in criterion)
        if weight is None:
            w = (1.0 / len(crits),) * len(crits)
        else:
            w = tuple(float(x) for x in weight)
    if len(crits) != len(w):
        raise ValueError(f"{len(crits)} criteria but {len(w)} weights")
    return crits, w


__all__ = ["get_criterion", "default_criteria", "weighted_loss", "pair_loss", "per_pair",
           "resolve_criteria",
           "mse", "ssd", "ncc", "lncc", "nmi", "nmi_loss", "get_pdf", "kde_pdf",
           "DEFAULT_WEIGHTS"]
