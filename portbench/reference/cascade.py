"""The checked stages of the rigid -> affine -> field cascade, from the
recipe's definition, in plain torch.

The cascade's plateau stops and Adam's sign-like first steps make a whole
registration part from any second computation of it within a few hundred
steps, so the reference does not rerun it. It computes on its own, from the
pair and the registration's answer (theta and the field), what the program
recorded or returned at five places:

- :func:`final_warp`: the registered image (the matrix warp at full
  resolution, then the field's warp);
- :func:`rigid_start`: the first losses of the rigid stage's coarsest level,
  from the pair alone (the pyramid, the centre-of-mass init, the affine
  warp and its gradient to theta, the criteria, Adam);
- :func:`matrix_end_loss`: the loss at the answer's theta on the last
  matrix level, which the affine stage's best step recorded;
- :func:`flow_start`: the first losses of the flow stage's coarsest level,
  from the pair and the answer's theta (the matrix warp, the pyramid, the
  field's warp and its gradient, the criteria, the diffusion term, Adam);
- :func:`fine_loss`: the last flow level's loss at the answer's field (the
  criteria and the diffusion term at full resolution).

Each takes one pair ``[1, 1, *S]`` and the recipe (``make_cascade_fn``'s
keyword arguments).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loss import Adam, criterion, diffusion
from .warp import affine_warp, flow_warp, hold, rigid_theta


# register_cascade's defaults of the options the checked stages read
DEFAULTS = {"levels": 3, "residual_shift": 8, "moment_init": False, "matrix_dtype": "float32",
            "flow_dtype": "float32", "flow_max_size": 160, "flow_levels": None,
            "flow_smooth": None, "flow_criterions": None, "flow_max_disp": 8,
            "flow_model": "field", "flow_rebase": False, "matrix_levels": None,
            "level_decay": 2.0, "affine_epochs": 200, "flow_epochs": 100}


# the flow engine stops a level once a recorded loss is at most this
# (flow_register's stop_crit, which the cascade leaves at its default)
FLOW_STOP_CRIT = 1e-4


def _recipe(recipe: dict) -> dict:
    return {**DEFAULTS, **recipe}


def pyramid(x: torch.Tensor, levels: int) -> list:
    """``[coarsest, ..., x]`` by repeated 2x average pooling."""
    out = [x]
    for _ in range(levels - 1):
        out.append(F.avg_pool3d(out[-1], 2, 2))
    return out[::-1]


def _matrix_window(S: int) -> int:
    """The full-resolution matrix warp's window: a third of the volume."""
    return max(8, S // 3)


def _first_rigid_window(recipe: dict, S: int) -> int:
    """The coarsest rigid level's window, which sees the whole initial
    misalignment."""
    rs = recipe["residual_shift"]
    if recipe["moment_init"] == "pa":
        return max(rs, S // 2 + 4)
    if recipe["moment_init"]:
        return max(rs, S // 8 + 4)
    return max(rs, S // 4)


def com_params(moving: torch.Tensor, target: torch.Tensor,
               max_translate: float = 0.25) -> torch.Tensor:
    """Rigid parameters with no rotation whose translation moves the
    moving image's centre of mass (of ``|image|``) onto the target's."""
    def com(img):
        w = torch.abs(img[0, 0]).to(torch.float32)
        total = torch.sum(w) + 1e-12
        out = []
        for a in range(3):
            idx = torch.arange(w.shape[a], dtype=torch.float32, device=w.device)
            other = tuple(i for i in range(3) if i != a)
            out.append(torch.sum(torch.sum(w, dim=other) * idx) / total)
        return torch.stack(out)

    sizes = torch.tensor(list(moving.shape[2:]), dtype=torch.float32, device=moving.device)
    t = torch.flip(2.0 * (com(moving) - com(target)) / sizes, dims=(0,))
    return torch.cat([torch.zeros(3, device=moving.device),
                      torch.atanh(torch.clamp(t / max_translate, -0.96, 0.96))])


def rigid_start(moving: torch.Tensor, target: torch.Tensor, recipe: dict, steps: int,
                image_dtype=None) -> torch.Tensor:
    """The first ``steps`` losses of ``rigid/level0``: its images are the
    pyramid's coarsest level held in the recipe's ``matrix_dtype`` (or
    ``image_dtype``)."""
    recipe = _recipe(recipe)
    dt = image_dtype or getattr(torch, recipe["matrix_dtype"])
    mov = hold(pyramid(moving.to(torch.float32), recipe["levels"])[0], dt)
    tgt = hold(pyramid(target.to(torch.float32), recipe["levels"])[0], dt)
    K = _first_rigid_window(recipe, max(mov.shape[2:]))
    params = (com_params(mov, tgt) if recipe["moment_init"]
              else torch.zeros(6, device=mov.device)).requires_grad_(True)
    return _descend(params, recipe["rigid_lr"], steps,
                    lambda p: criterion(recipe["criterions"])(
                        tgt, affine_warp(mov, rigid_theta(p), K, dt)))


def _flow_inputs(moving, target, theta, recipe):
    """The flow stage's images: the moving image warped by ``theta``, both
    pooled to at most ``flow_max_size``; and the pooling's scale."""
    S = max(moving.shape[2:])
    f_in = affine_warp(moving.to(torch.float32), theta, _matrix_window(S))
    f_tgt = target.to(torch.float32)
    scale = 1
    while max(f_in.shape[2:]) > recipe["flow_max_size"]:
        f_in, f_tgt = F.avg_pool3d(f_in, 2, 2), F.avg_pool3d(f_tgt, 2, 2)
        scale *= 2
    return f_in, f_tgt, scale


def _flow_levels(recipe: dict, min_size: int) -> int:
    """The flow pyramid's depth: the coarsest level keeps 8 voxels an axis."""
    levels = recipe["flow_levels"] or min(2, recipe["levels"])
    return min(levels, max(1, int(math.log2(max(1, min_size // 8))) + 1))


def flow_start(moving: torch.Tensor, target: torch.Tensor, theta: torch.Tensor,
               recipe: dict, steps: int, image_dtype=None) -> torch.Tensor:
    """The first ``steps`` losses of ``flow/level0``, its input warped by
    ``theta [3, 4]``; images in the recipe's ``flow_dtype`` (or
    ``image_dtype``), the field and Adam's state f32. Fewer where the level
    stops: after the first loss at most :data:`FLOW_STOP_CRIT`. The field
    starts at zero."""
    recipe = _recipe(recipe)
    if recipe["flow_model"] != "field":
        raise NotImplementedError("the reference follows the direct field only")
    f_in, f_tgt, _ = _flow_inputs(moving, target, theta, recipe)
    levels = _flow_levels(recipe, min(f_in.shape[2:]))
    dt = image_dtype or getattr(torch, recipe["flow_dtype"])
    mov = hold(pyramid(f_in, levels)[0], dt)
    tgt = hold(pyramid(f_tgt, levels)[0], dt)
    loss = criterion(recipe["flow_criterions"] or recipe["criterions"])
    K = recipe["flow_max_disp"]
    smooth = _smooths(recipe, levels)[0]
    field = torch.zeros((1, 3, *mov.shape[2:]), device=mov.device, requires_grad=True)

    def total(f):
        sim = loss(tgt, flow_warp(mov, f, K, dt))
        return sim + smooth * diffusion(f) if smooth > 0 else sim

    return _descend(field, recipe["flow_lr"], steps, total, FLOW_STOP_CRIT)


def _smooths(recipe: dict, levels: int) -> list:
    """Each flow level's diffusion weight, coarsest first."""
    smooth = recipe["flow_smooth"]
    smooth = 0.5 if smooth is None else smooth
    if isinstance(smooth, (list, tuple)):
        return list(smooth)[-levels:]
    return [smooth] * levels


def level_budgets(total: int, levels: int, decay: float) -> list:
    """Each level's epoch budget, coarsest first: ``total`` split in the
    ratio ``decay`` from level to level, the coarse ones the larger; a
    stage's losses are its levels' records one after the other."""
    w = [decay ** (levels - 1 - i) for i in range(levels)]
    return [max(1, int(round(total * x / sum(w)))) for x in w]


def matrix_end_loss(moving: torch.Tensor, target: torch.Tensor, theta: torch.Tensor,
                    recipe: dict, image_dtype=None) -> torch.Tensor:
    """The loss at ``theta [3, 4]`` on the last matrix level (the pyramid
    level ``matrix_levels - 1``): its moving image warped by ``theta`` in
    one resample (window a third of the level), images held in the
    recipe's ``matrix_dtype`` (or ``image_dtype``)."""
    recipe = _recipe(recipe)
    dt = image_dtype or getattr(torch, recipe["matrix_dtype"])
    i = min(recipe.get("matrix_levels") or recipe["levels"], recipe["levels"]) - 1
    mov = hold(pyramid(moving.to(torch.float32), recipe["levels"])[i], dt)
    tgt = hold(pyramid(target.to(torch.float32), recipe["levels"])[i], dt)
    K = _matrix_window(max(mov.shape[2:]))
    return criterion(recipe["criterions"])(tgt, affine_warp(mov, theta, K, dt))


def _descend(param: torch.Tensor, lr: float, steps: int, loss_of,
             stop_crit: float | None = None) -> torch.Tensor:
    """The losses of up to ``steps`` Adam steps of ``loss_of`` from
    ``param``, each recorded before its update; the last one recorded is
    the first at most ``stop_crit``."""
    opt = Adam(param, lr)
    out = []
    for _ in range(steps):
        val = loss_of(param)
        (g,) = torch.autograd.grad(val, param)
        out.append(val.detach())
        if stop_crit is not None and float(val.detach()) <= stop_crit:
            break
        opt.step(g)
    return torch.stack(out)


def final_warp(moving: torch.Tensor, theta: torch.Tensor, flow: torch.Tensor,
               recipe: dict, dtype=None) -> torch.Tensor:
    """The registered image: ``moving`` warped by ``theta`` (window a third
    of the volume), then by the field within the per-level window at the
    flow stage's scale; each pass in ``dtype``."""
    recipe = _recipe(recipe)
    if recipe["flow_rebase"] or recipe["flow_model"] != "field":
        raise NotImplementedError("the reference follows the direct field only")
    S = max(moving.shape[2:])
    scale = 1
    while S // scale > recipe["flow_max_size"]:
        scale *= 2
    out = affine_warp(moving, theta, _matrix_window(S), dtype)
    return flow_warp(out, flow, recipe["flow_max_disp"] * scale, dtype)


def fine_loss(target: torch.Tensor, warped: torch.Tensor, flow: torch.Tensor,
              recipe: dict) -> torch.Tensor:
    """The last flow level's loss at the field ``flow``, from the registered
    image ``warped`` (:func:`final_warp`: where the flow stage runs at full
    resolution, its last level warps the matrix warp's output by the field
    within the same window): the criteria and the level's diffusion term."""
    recipe = _recipe(recipe)
    if max(target.shape[2:]) > recipe["flow_max_size"]:
        raise NotImplementedError("the flow stage's last level is pooled")
    levels = _flow_levels(recipe, min(target.shape[2:]))
    smooth = _smooths(recipe, levels)[-1]
    sim = criterion(recipe["flow_criterions"] or recipe["criterions"])(
        target.to(torch.float32), warped)
    return sim + smooth * diffusion(flow) if smooth > 0 else sim
