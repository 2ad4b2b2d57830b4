"""The comparison that decides ``correct``.

For each distinct pair registered in the window, the first result the
program returned for it (a pair's repeats are the same program on the same
input) is compared with the plain reference (``portbench/reference``). Five
gaps are measured a pair, each over the reference's value:

- ``warp_gap``: the largest gap between the registered image and the
  reference's warp of the moving image by the result's theta and field, over
  the moving image's largest value;
- ``rigid_loss_gap``: the largest gap between the first losses of
  ``rigid/level0`` and the reference's, from the pair alone, over the
  reference's largest;
- ``affine_end_gap``: the gap between the best loss the affine stage
  recorded on its last level and the reference's loss at the result's theta
  there (one resample where the program composed two);
- ``flow_loss_gap``: as ``rigid_loss_gap`` for ``flow/level0``, whose input
  the reference warps by the result's theta;
- ``flow_end_gap``: the gap between the last loss the last flow level
  recorded and the reference's at the result's field (one step later: the
  level returns its field after its last update).

A configuration's ``checks`` name the numbers compared: each is one gap
(``of``, by default its own name) over the first ``steps`` losses (at most
:data:`STEPS`), taken over the pairs by its largest (``over: max``, the
default) or its median, against its ``limit``. A non-finite gap reads
``inf``; a gap a configuration does not name is not computed.
"""
from __future__ import annotations

import math
import statistics

import torch

from .reference.cascade import (_recipe, final_warp, fine_loss, flow_start, level_budgets,
                                matrix_end_loss, rigid_start)

STEPS = 6  # the most losses followed from a checked level's start


def _rel(num, den) -> float:
    g = float(num) / float(den)
    return abs(g) if math.isfinite(g) else math.inf


def _gaps(prog: torch.Tensor, ref: torch.Tensor) -> list:
    """The gap over the first k losses, k = 1..len(ref), each over the
    reference's largest among them (a level that stops early records fewer;
    the program's masked steps after it are NaN)."""
    prog = prog[:len(ref)].to(ref.dtype)
    return [_rel(torch.max(torch.abs(prog[:k] - ref[:k])), torch.max(torch.abs(ref[:k])))
            for k in range(1, len(ref) + 1)]


def _warp_gap(warped: torch.Tensor, ref: torch.Tensor, moving: torch.Tensor) -> float:
    return _rel(torch.max(torch.abs(warped.to(torch.float32) - ref)),
                torch.max(torch.abs(moving)))


def _level(losses: torch.Tensor, steps: dict, stage: str, recipe: dict) -> torch.Tensor:
    """The losses a stage's last level recorded (its executed steps)."""
    r = _recipe(recipe)
    levels = sum(1 for k in steps if k.startswith(stage + "/"))
    budgets = level_budgets(r[f"{stage}_epochs"], levels, r["level_decay"])
    start = sum(budgets[:-1])
    return losses[start:start + steps[f"{stage}/level{levels - 1}"]]


def _select(gaps: dict, checks: dict) -> dict:
    """Each check's gap over its first ``steps`` losses."""
    out = {}
    for name, c in checks.items():
        g = gaps.get(c.get("of", name))
        if g is not None:
            out[name] = g[min(c.get("steps", STEPS), len(g)) - 1]
    return out


def gaps(pair, kept: dict, recipe: dict, wanted) -> dict:
    """The gaps named in ``wanted`` for one pair's kept result (``theta
    [3, 4]``, ``flow [1, 3, *S]``, ``warped [1, 1, *S]``, ``rigid`` its
    first :data:`STEPS` losses, ``affine`` and ``flow_losses`` every loss of
    the stage, ``steps`` ``{stage/levelI: executed steps}``): each a list,
    the loss gaps one a step."""
    out = {}
    with torch.no_grad():
        ref = final_warp(pair.moving, kept["theta"], kept["flow"], recipe)
        out["warp_gap"] = [_warp_gap(kept["warped"], ref, pair.moving)]
        if "flow_end_gap" in wanted:
            end = fine_loss(pair.target, ref, kept["flow"], recipe)
            last = _level(kept["flow_losses"], kept["steps"], "flow", recipe)[-1]
            out["flow_end_gap"] = [_rel(last - end, end)]
        if "affine_end_gap" in wanted:
            end = matrix_end_loss(pair.moving, pair.target, kept["theta"], recipe)
            best = torch.min(_level(kept["affine"], kept["steps"], "affine", recipe))
            out["affine_end_gap"] = [_rel(best - end, end)]
    del ref
    if "rigid_loss_gap" in wanted:
        out["rigid_loss_gap"] = _gaps(kept["rigid"], rigid_start(
            pair.moving, pair.target, recipe, STEPS))
    if "flow_loss_gap" in wanted:
        out["flow_loss_gap"] = _gaps(kept["flow_losses"], flow_start(
            pair.moving, pair.target, kept["theta"], recipe, STEPS))
    return out


def _wanted(checks: dict) -> set:
    return {c.get("of", name) for name, c in checks.items()}


def readings(pair, kept: dict, recipe: dict, checks: dict) -> dict:
    """Each check's gap for one pair's kept result (:func:`gaps`)."""
    return _select(gaps(pair, kept, recipe, _wanted(checks)), checks)


def control_gaps(pair, kept: dict, recipe: dict, wanted) -> dict:
    """The reference in the program's place, computed a precision below the
    configuration's, against the reference as stated: the final warp's
    images in bfloat16 (the recipe's f32 images), the matrix stages' images
    in float8 e4m3 (the recipe's bfloat16). The flow stage's control is the
    program's own bfloat16 path (``flow_dtype``), read by :func:`gaps`."""
    fp8 = torch.float8_e4m3fn
    out = {}
    with torch.no_grad():
        ref = final_warp(pair.moving, kept["theta"], kept["flow"], recipe)
        low = final_warp(pair.moving, kept["theta"], kept["flow"], recipe, torch.bfloat16)
        out["warp_gap"] = [_warp_gap(low, ref, pair.moving)]
        del ref, low
        if "affine_end_gap" in wanted:
            end = matrix_end_loss(pair.moving, pair.target, kept["theta"], recipe)
            low = matrix_end_loss(pair.moving, pair.target, kept["theta"], recipe, fp8)
            out["affine_end_gap"] = [_rel(low - end, end)]
    if "rigid_loss_gap" in wanted:
        out["rigid_loss_gap"] = _gaps(
            rigid_start(pair.moving, pair.target, recipe, STEPS, fp8),
            rigid_start(pair.moving, pair.target, recipe, STEPS))
    return out


def control_readings(pair, kept: dict, recipe: dict, checks: dict) -> dict:
    """Each check's control gap (:func:`control_gaps`)."""
    return _select(control_gaps(pair, kept, recipe, _wanted(checks)), checks)


def judge(per_pair: list, checks: dict) -> tuple:
    """``(correct, {number: {"value": reading, "limit": limit}})``: each
    number's reading over the pairs, their largest or their median."""
    out = {}
    for name, c in checks.items():
        values = [r[name] for r in per_pair]
        if not values:
            value = math.inf
        elif c.get("over", "max") == "median":
            value = statistics.median(values)
        else:
            value = max(values)
        out[name] = {"value": value, "limit": c["limit"]}
    return all(c["value"] <= c["limit"] for c in out.values()), out
