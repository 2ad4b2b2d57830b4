"""Dense flow-field registration engine (counterpart of
``torchregister_tpu/engines/flow.py``), in both modes:

- ``flow_model='unet'``: an Attention U-Net (``models/attention_unet.py``,
  every 3D 3x3x3 convolution on kernel K3) predicts the displacement field of
  one pair and its weights are optimized (reference ``flow_register``,
  warpings.py:178-242);
- ``flow_model='field'``: the parameters ARE the field ``[1, d, *S]``
  (voxels), optimized against the similarity stack plus a diffusion
  regularizer.

The loop stops when the recorded loss is ``<= stop_crit``, after
``max_epochs``, or (with ``stop_rel``) after ``patience`` steps in which the
step's loss did not improve on the reference loss by ``stop_rel`` — the
step's loss, not the best loss as in the matrix engines. Its state lives on
the device as in ``engines/common.optimize_scan``: the host reads the stop
state where the plateau stop could first fire and, for ``stop_crit``, after
steps 1, 2, 4, ... (at most ``common.READ_EVERY`` apart), so the masked
steps after a ``stop_crit`` stop are fewer than the steps run. The U-Net's
weights are one flat f32 tensor (each weight a view of it at an aligned
offset: each ``nn.Parameter``'s storage is that view), so the optimizer runs
on one tensor in either mode.
``method='separable'`` warps by sweeps inside ``max_disp``; any other
``method`` warps with the exact ``ops/resample.warp_flow``, in the loop and
for the returned image, as in the JAX package. The returned flow is the
post-update model's (or field's).

:func:`flow_pairs` registers the B independent pairs of ``[B, 1, *S]`` in
one loop, a cohort: the field ``[B, d, *S]`` (field mode) or B U-Nets, one
weight set a pair (U-Net mode: the model's pair mode, its 3D convolutions
one K3 launch for all pairs; the flat weights ``[B, size]``, one row a
pair), each pair's loss, diffusion energy, ``stop_crit`` test, plateau and
``max_disp`` its own, so each pair stops at the step it would stop at alone
(``engines/common``). :func:`flow_register` is the same loop on one pair.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses import pair_loss, pair_slices, resolve_criteria
from ..models.attention_unet import AttentionUNet, max_depth_for
from ..ops.edge import edge_filter
from ..ops.resample import warp_flow
from ..ops.separable import warp_flow_separable
from . import common, graph
from .common import make_optimizer, run_pairs

_ALIGN = 128  # floats: each U-Net weight's offset in the flat tensor (512 bytes)


class FlowResult(NamedTuple):
    flow: torch.Tensor  # [1, d, *S] voxel-unit displacement field
    losses: torch.Tensor  # [max_epochs], NaN beyond the executed steps
    steps: int  # optimizer steps executed
    converged: bool  # stopped by stop_crit
    params: Any  # the U-Net's state dict, or the field itself
    max_disp: torch.Tensor | None = None  # max |flow| (scalar)


def _diffusion_energy(flow: torch.Tensor, pairs: int = 1) -> torch.Tensor:
    """Sum over axes of the mean squared forward difference of each pair's
    slice of ``flow``: ``[pairs]``."""
    f = flow.to(torch.float32)
    total = 0.0
    for a in range(2, flow.ndim):
        d = torch.diff(f, dim=a)
        total = total + torch.stack([torch.mean(x) for x in pair_slices(d * d, pairs)])
    return total


def _unet(moving, n, in_c, depth, use_attention, use_norm, dt, init_params, zero_head,
          generator, pairs=None) -> AttentionUNet:
    """The U-Net for ``moving`` (``pairs`` weight sets in pair mode):
    ``init_params`` loaded, or fresh flax-style weights from ``generator``
    (seed 0 without one; in pair mode drawn pair after pair, or one
    generator a pair from a sequence), the flow head zeroed under
    ``zero_head``."""
    spatial = tuple(moving.shape[2:])
    if depth is None:
        depth = max_depth_for(spatial)
        if depth == 0:
            raise ValueError(f"volume {spatial} too small for the U-Net")
    model = AttentionUNet(ndim=len(spatial), in_c=in_c, n=n, depth=depth,
                          use_attention=use_attention, use_norm=use_norm,
                          dtype=dt, pairs=pairs).to(moving.device)
    if init_params is not None:
        model.load_state_dict(init_params)
        return model
    model.reset_parameters(torch.Generator().manual_seed(0) if generator is None
                           else generator)
    if zero_head:
        # the net predicts an exactly-zero field at step 0, so a residual
        # level starts from the alignment it is handed
        with torch.no_grad():
            model.out_kernel.zero_()
            model.out_bias.zero_()
    return model


def _lead(model) -> tuple:
    """The pair axis of ``model``'s weights: ``(B,)`` in pair mode, else
    ``()``."""
    return () if model.pairs is None else (model.pairs,)


def _layout(model) -> list:
    """``(name, shape, offset)`` of each of ``model``'s weights (one pair's
    shape in pair mode) in one flat tensor (one row a pair), each offset a
    multiple of ``_ALIGN``; the flat size (of a row) last."""
    out, off, lead = [], 0, len(_lead(model))
    for name, p in model.named_parameters():
        shape = tuple(p.shape[lead:])
        out.append((name, shape, off))
        off += -(-math.prod(shape) // _ALIGN) * _ALIGN
    return out + [off]


def _flatten(model, layout) -> torch.Tensor:
    *weights, size = layout
    lead = _lead(model)
    flat = torch.zeros(lead + (size,), dtype=torch.float32,
                       device=next(model.parameters()).device)
    for (_, shape, off), p in zip(weights, model.parameters()):
        flat[..., off:off + math.prod(shape)] = p.detach().reshape(lead + (-1,))
    return flat


def _bind(model, flat, layout) -> None:
    """Point each of ``model``'s weights at its view of ``flat``: the
    optimizer's in-place updates of ``flat`` are the weights' updates."""
    lead = _lead(model)
    for (_, shape, off), p in zip(layout[:-1], model.parameters()):
        p.data = flat.detach().narrow(-1, off, math.prod(shape)).view(lead + shape)


def _flat_grad(grads, layout, lead: tuple = ()) -> torch.Tensor:
    """The weights' gradients in ``flat``'s layout (zeros between them; an
    unused weight's zeros keep the pair axis ``lead``)."""
    *weights, size = layout
    parts, end = [], 0
    zeros = grads[0].new_zeros(lead + (_ALIGN,))
    for g, (_, shape, off) in zip(grads, weights):
        if off > end:
            parts.append(zeros[..., :off - end])
        n = math.prod(shape)
        parts.append(zeros.new_zeros(lead + (n,)) if g is None else g.reshape(lead + (-1,)))
        end = off + n
    if size > end:
        parts.append(zeros[..., :size - end])
    return torch.cat(parts, dim=-1)


def flow_register(
    moving: torch.Tensor,
    target: torch.Tensor,
    lr: float = 1e-3,
    max_epochs: int = 2000,
    stop_crit: float = 1e-4,
    n: float = 1,
    in_c: int = 1,
    criterions=None,
    weights=None,
    grad_edges: bool = False,
    optimizer: str = "sgd",
    depth: int | None = None,
    generator: torch.Generator | None = None,
    method: str = "separable",
    max_disp: int = 8,
    dtype: str = "float32",
    init_params=None,
    remat: bool = False,
    check_disp: bool = True,
    use_attention: bool = True,
    use_norm: bool = True,
    flow_model: str = "unet",
    smooth: float = 0.0,
    stop_rel: float | None = None,
    patience: int = 25,
    zero_head: bool = False,
    progress_every: int | None = None,
) -> tuple[torch.Tensor, FlowResult]:
    """Deformable registration of ``moving [1, in_c, *S]`` onto ``target``;
    returns ``(warped, FlowResult)``.

    U-Net mode: ``n`` divides the widths (64/n at the top level), ``depth``
    defaults to ``max_depth_for`` the volume, ``dtype`` is the network's
    compute dtype (its parameters and the flow head stay f32), ``remat``
    recomputes the forward in the backward (``torch.utils.checkpoint``), and
    ``init_params`` (a ``FlowResult.params`` state dict) warm-starts the
    weights; otherwise they are drawn from ``generator`` (a CPU
    ``torch.Generator``). ``zero_head`` zeroes the fresh flow head.

    Field mode: ``dtype`` sets the image side of each step (sweeps and loss
    inputs); the field, the optimizer state and the returned final warp stay
    f32. ``init_params`` warm-starts the field (upsample it with
    ``utils.pyramid.upsample_flow`` across resolutions).

    With ``check_disp`` a RuntimeWarning fires when the field outgrows
    ``max_disp``. ``grad_edges=True`` registers the images' Sobel edge
    masks (``ops/edge.py``). ``progress_every=N`` prints the loss every N
    steps and the cause of an early stop.
    """
    warped, res = _flow(pairs=1, **locals())
    return warped, res._replace(losses=res.losses[0], steps=res.steps[0],
                                converged=res.converged[0], max_disp=res.max_disp[0])


def flow_pairs(moving: torch.Tensor, target: torch.Tensor, pairs: int | None = None,
               **options) -> tuple[torch.Tensor, FlowResult]:
    """:func:`flow_register` (its options and defaults) over the B
    independent pairs of ``[B, 1, *S]``, each registered on its own in one
    loop: the flow ``[B, d, *S]``, ``losses`` ``[B, max_epochs]``, ``steps``
    and ``converged`` lists, ``max_disp`` ``[B]``, a warning that names the
    pairs. Field mode: ``init_params [B, d, *S]``, ``params`` the field. U-Net
    mode: one net a pair, ``init_params`` and ``params`` a state dict whose
    tensors carry a leading pair axis (the JAX cohort's stacked ``params``);
    fresh weights are drawn from ``generator`` one pair after another, pair 0
    first (a sequence of B generators gives each pair its own). ``pairs=1``
    registers the whole batch as one pair (:func:`flow_register`, the pair
    axis kept)."""
    return _flow(pairs=moving.shape[0] if pairs is None else pairs, moving=moving,
                 target=target, **{**common.defaults_of(flow_register), **options})


def _flow(pairs, moving, target, lr, max_epochs, stop_crit, n, in_c, criterions, weights,
          grad_edges, optimizer, depth, generator, method, max_disp, dtype, init_params,
          remat, check_disp, use_attention, use_norm, flow_model, smooth, stop_rel,
          patience, zero_head, progress_every) -> tuple[torch.Tensor, FlowResult]:
    """The flow engine's loop over ``pairs`` pairs, each a slice of
    ``moving``'s leading axis (one pair: the whole of it); the records, the
    steps and ``max_disp`` with a leading pair axis."""
    if flow_model not in ("unet", "field"):
        raise ValueError(f"flow_model must be unet|field, got {flow_model!r}")
    if progress_every and pairs > 1:
        raise ValueError("progress_every prints one pair's progress")
    if grad_edges:
        moving = edge_filter(moving)
        target = edge_filter(target)
    criteria, w = resolve_criteria(criterions, weights)
    loss = pair_loss(criteria, w, pairs)
    ndim = moving.ndim - 2
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def warp(src, flow):
        if method == "separable":
            return warp_flow_separable(src, flow, max_disp=max_disp)
        return warp_flow(src, flow)

    sess = graph.session()
    unet = flow_model == "unet"
    if unet:
        model = _unet(moving, n, in_c, depth, use_attention, use_norm, dt, init_params,
                      zero_head, generator, pairs if pairs > 1 else None)
        layout = _layout(model)
        param0 = _flatten(model, layout)
        mov_s, tgt_s = moving, target  # the model's own dtype reduces compute

        def predict(x):
            return checkpoint(model, x, use_reentrant=False) if remat else model(x)
    else:
        if optimizer == "sgd" and lr <= 1e-2:
            warnings.warn(
                f"flow_register(flow_model='field') with optimizer='sgd' and lr={lr:g}: "
                "SGD at unet-scale learning rates barely moves a direct field. Use "
                "optimizer='adam' with lr~0.3, or raise lr substantially.",
                RuntimeWarning,
                stacklevel=3,
            )
        mov_s, tgt_s = moving.to(dt), target.to(dt)
        if init_params is None:
            init_params = torch.zeros((moving.shape[0], ndim) + tuple(moving.shape[2:]),
                                      dtype=torch.float32, device=moving.device)
        param0 = init_params.detach().to(torch.float32).clone()

    mov_s, tgt_s = sess.static("moving", mov_s), sess.static("target", tgt_s)
    param = sess.static("params", param0)
    if unet:
        _bind(model, param, layout)
        net_params = list(model.parameters())
    else:
        param.requires_grad_(True)
    opt = make_optimizer(optimizer, param, lr, max_epochs, pairs, second_order=False)
    opt.state = sess.statics(opt.state, "opt.")
    device = moving.device
    factor = None if stop_rel is None else float(np.float32(1.0 - stop_rel))
    st = sess.statics({
        "ref": torch.full((pairs,), float("inf"), dtype=torch.float32, device=device),
        "last": torch.full((pairs,), float("inf"), dtype=torch.float32, device=device),
        "since": torch.zeros((pairs,), dtype=torch.int64, device=device),
        "i": torch.zeros((pairs,), dtype=torch.int64, device=device),
        "stopped": torch.full((pairs,), max_epochs <= 0, dtype=torch.bool, device=device),
        # [:, max_epochs]: the masked steps' records
        "losses": torch.full((pairs, max_epochs + 1), float("nan"), dtype=torch.float32,
                             device=device)})

    def step():
        flow, wrt = (predict(mov_s), net_params) if unet else (param, [param])
        sim = loss(tgt_s, warp(mov_s, flow))
        total = sim + smooth * _diffusion_energy(flow, pairs) if smooth > 0.0 else sim
        grads = torch.autograd.grad(total.sum(), wrt, allow_unused=unet)
        grad = _flat_grad(grads, layout, _lead(model)) if unet else grads[0]
        with torch.no_grad():
            active = ~st["stopped"]
            val = total.detach().to(torch.float32)
            at = torch.where(active, st["i"], max_epochs)
            st["losses"].scatter_(1, at[:, None], val[:, None])
            opt.step(grad, active)
            halt = st["i"].add_(active.long()) >= max_epochs
            if factor is not None:
                improved = val < st["ref"] * factor
                st["ref"].copy_(torch.where(active & improved, val, st["ref"]))
                st["since"].copy_(torch.where(active, torch.where(improved, 0, st["since"] + 1),
                                              st["since"]))
                halt |= st["since"] >= patience
            st["last"].copy_(torch.where(active, val, st["last"]))
            st["stopped"].logical_or_(halt | ~(st["last"] > stop_crit))

    def line(i):
        print(f"[flow_register] epoch {i}/{max_epochs} loss={st['last'].item():.6g}",
              flush=True)

    def report(i, stopped, extra):
        if i % progress_every == 0 or i == max_epochs:
            line(i)
        if stopped and i < max_epochs:
            if i % progress_every:
                line(i)
            cause = (f"loss <= {stop_crit:g}" if extra[0]
                     else f"plateau (stop_rel={stop_rel}, patience={patience})")
            print(f"[flow_register] stopped at epoch {i} ({cause})", flush=True)

    # stop_crit can fire at any step: reads at steps 1, 2, 4, ... (at most
    # READ_EVERY apart) keep the masked steps after it fewer than those run
    steps, (converged,) = run_pairs(
        sess, step, st, max_epochs, None if factor is None else patience,
        lambda ran: min(common.READ_EVERY, max(1, ran)), "flow_register",
        lambda: (st["last"] <= stop_crit,), progress_every, report)
    with torch.no_grad():
        if unet:
            flow = predict(moving).detach()
            params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            flow = params = param.detach().clone()
        warped = warp(moving, flow)  # method-consistent final warp
    maxd = torch.stack([torch.max(torch.abs(f)) for f in pair_slices(flow, pairs)])
    if check_disp and method == "separable":
        what = flows_over(maxd, max_disp)  # one host read
        if what:
            warnings.warn(
                f"flow_register: {what} but the separable sweep window is "
                f"max_disp={max_disp}; displacements beyond it contribute zero. Raise "
                "max_disp.",
                RuntimeWarning,
                stacklevel=3,
            )
    return warped, FlowResult(
        flow=flow, losses=st["losses"][:, :max_epochs].clone(), steps=steps,
        converged=[bool(c) for c in converged], params=params, max_disp=maxd)


def flows_over(maxd: torch.Tensor, bound: float) -> str | None:
    """What outgrew ``bound`` of each pair's max |flow| ``maxd [B]`` (one
    host read), or None."""
    vals = maxd.tolist()
    over = [(b, m) for b, m in enumerate(vals) if m > bound]
    if not over:
        return None
    if len(vals) == 1:
        return f"recovered flow reaches {over[0][1]:.1f} voxels"
    return (f"{len(over)} of {len(vals)} recovered flows reach "
            + ", ".join(f"#{b}: {m:.1f}" for b, m in over[:5]) + " voxels")
