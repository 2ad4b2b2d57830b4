"""The entry points of the project's dry run (counterpart of
``__graft_entry__.py``): :func:`entry`, the flagship forward step, and
:func:`dryrun_multichip`, one training step of the U-Net on a batch split
over a ``data x space`` mesh, the product cascade over that mesh and the
separable warp on slabs.

The train step (``__graft_entry__.py:136-176``) trains one shared net on a
batch split over ``data`` (the pairs) and ``space`` (z-slabs), with the loss
``weighted_loss((mse, ncc), (0.5, 0.5))`` over the whole batch. Every weight
reaches every device of the mesh through one ``parallel.rows.replicate``
over the mesh's devices in mesh order (data-major, then slab), whose
backward adds the copies' gradients in that order: the data axis's gradient
sum. Each data position's row of slabs runs the net on its pairs' slabs
(``models/attention_unet.forward_slabs``, the U-Net's row partitions) and
the exact ``warp_flow`` on slabs; rows on distinct devices run in threads of
their own (``parallel/data.run_rows``). MSE and NCC add every block's
partial sums in mesh order (``Sharded.ordered_blocks``). The update is the
engines' tensor-op Adam (``engines/common.Adam``, optax's defaults) at lr
1e-3 on the weights laid out as one flat tensor (``engines/flow._layout``).
On a 1-D ``data`` mesh each position runs the whole net on its pairs.

One process drives every shard; a mesh may name one card several times
(``parallel/mesh.py``). By default the CUDA devices are used, named
round-robin when there are fewer than asked for; there is no fallback to
the CPU (the tests pass ``devices=['cpu'] * n``).

    python -m torchregister_tpu_torch.dryrun [n_devices]
"""
from __future__ import annotations

import sys

import torch
from torch.func import functional_call

from .engines import common
from .engines.flow import _bind, _flat_grad, _flatten, _layout
from .losses import weighted_loss
from .losses.similarity import mse, ncc
from .models.attention_unet import AttentionUNet, forward_slabs
from .ops.resample import warp_flow
from .ops.transforms import rigid_theta

# __graft_entry__.py:25-27, :119-121, :184-196, :218-220
ENTRY_NET = dict(ndim=3, in_c=1, n=32, depth=2)
ENTRY_SIZE = 40
TRAIN_NET = dict(ndim=3, in_c=1, n=64, depth=1)
TRAIN_SIZE = 24
TRAIN_LR = 1e-3
LOSS_WEIGHTS = (0.5, 0.5)
CASCADE = dict(stages=("rigid", "affine", "flow"), levels=2, rigid_epochs=6, rigid_lr=3e-3,
               affine_epochs=4, affine_lr=1e-3, flow_epochs=6, flow_lr=0.3,
               criterions=("mse", "ncc"), optimizer="adam", flow_model="field",
               flow_smooth=0.5, flow_max_disp=2, residual_shift=4, flow_levels=2)
WARP_PARAMS = (0.05, -0.04, 0.03, 0.1, -0.1, 0.05)
WARP_MAX_SHIFT = 4


def _card() -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device (pass device='cpu' or devices=['cpu'] * n to run "
                           "on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def _net(spec: dict, device, seed: int = 0) -> AttentionUNet:
    """The U-Net of ``spec`` on ``device``, flax-style weights drawn from
    ``seed`` (``AttentionUNet.reset_parameters``)."""
    model = AttentionUNet(**spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def entry(device=None):
    """``(fn, example_args)``: the flagship forward step, the Attention U-Net
    (``n=32``, depth 2) on a 40³ volume followed by the exact ``warp_flow``;
    ``fn(params, moving) -> (warped, flow)`` with ``params`` the net's
    weights by name (``convert.unet_params`` carries a JAX tree over). On the
    card unless ``device`` says otherwise."""
    device = _card() if device is None else torch.device(device)
    model = _net(ENTRY_NET, device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    moving = torch.zeros((1, 1) + (ENTRY_SIZE,) * 3, dtype=torch.float32, device=device)

    def fn(params, moving):
        flow = functional_call(model, params, (moving,))
        return warp_flow(moving, flow), flow

    return fn, (params, moving)


def init_train_state(model: AttentionUNet, steps: int = 1, lr: float = TRAIN_LR):
    """``(params, opt_state)`` for :func:`make_train_step`: ``model``'s
    weights as one flat f32 tensor on its device (the model's weights bound
    to views of it) and the tensor-op Adam over it, for up to ``steps``
    steps."""
    layout = _layout(model)
    params = _flatten(model, layout)
    _bind(model, params, layout)
    return params, common.Adam(params, lr, steps)


def _warped_on_mesh(model: AttentionUNet, moving):
    """The exact ``warp_flow`` of ``moving`` (a ``Sharded`` batch) by the
    net's flow, laid out as ``moving``."""
    from .parallel import halo
    from .parallel.data import run_rows, run_shards
    from .parallel.mesh import from_blocks, join_rows, row_meshes, space_rows
    from .parallel.rows import Rows, replicate

    mesh = moving.mesh
    # each weight's copy a mesh position; the copies' gradients summed in mesh order
    W = {name: replicate(p, mesh.device_list) for name, p in model.named_parameters()}
    if "space" not in mesh.axis_names:
        blocks = moving.shards

        def one(k):
            flow = functional_call(model, {n: c[k] for n, c in W.items()}, (blocks[k],))
            return warp_flow(blocks[k], flow)

        return from_blocks(run_shards(mesh.device_list, one), moving.sharding, moving.shape)
    rows = row_meshes(mesh)
    parts = space_rows(moving, rows)
    space = len(rows[0].device_list)

    def row(r):
        x = parts[r]
        dim, _ = x.slab_axis()
        w = {n: c[r * space:(r + 1) * space] for n, c in W.items()}
        flow = forward_slabs(model, Rows(x.shards, halo.equal(x.shape[dim], space), dim), w)
        shape = (x.shape[0], model.ndim, *x.shape[2:])
        return warp_flow(x, from_blocks(flow.blocks, x.sharding, shape))

    return join_rows(run_rows(rows, row), mesh)


def make_loss_and_grads(model: AttentionUNet):
    """``fn(params, moving, target) -> (loss, grads)``: the train step's
    loss (on the mesh's first device) and each weight's gradient by name at
    the weights ``params`` (see :func:`make_train_step`)."""
    layout = _layout(model)
    loss_fn = weighted_loss((mse, ncc), LOSS_WEIGHTS)

    def fn(params, moving, target):
        _bind(model, params, layout)
        if isinstance(moving, torch.Tensor):
            warped = warp_flow(moving, model(moving))
        else:
            warped = _warped_on_mesh(model, moving)
        loss = loss_fn(target, warped)
        names, weights = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, weights, allow_unused=True)
        return loss.detach(), dict(zip(names, grads))

    return fn


def make_train_step(model: AttentionUNet):
    """``train_step(params, opt_state, moving, target) -> (params,
    opt_state, loss)``: one step of ``__graft_entry__.py:136-176``'s training
    (see the module note) on ``moving`` and ``target`` split alike over a
    mesh (:func:`batch_layout`) or on whole tensors (the unsharded step).
    ``params`` and ``opt_state`` come from :func:`init_train_state`; the
    update is in place, as the engines' optimizers update, and ``params`` is
    returned updated. ``loss`` is on the mesh's first device."""
    layout = _layout(model)
    loss_and_grads = make_loss_and_grads(model)

    def train_step(params, opt_state, moving, target):
        if opt_state.param is not params:
            raise ValueError("train_step: opt_state is not the optimizer of params")
        loss, grads = loss_and_grads(params, moving, target)
        with torch.no_grad():
            opt_state.step(_flat_grad(list(grads.values()), layout),
                           torch.ones((1,), dtype=torch.bool, device=params.device))
        return params, opt_state, loss

    return train_step


def dryrun_mesh(n_devices: int, devices=None):
    """``(mesh, note)``: ``__graft_entry__.py:123-134``'s mesh, ``(n // 2,
    2)`` over ``("data", "space")`` for an even ``n >= 4``, else ``(n,)``
    over ``data``; ``devices`` default to the CUDA devices, named
    round-robin when fewer than ``n`` (``note`` says so)."""
    from .parallel.mesh import make_mesh

    note = ""
    if devices is None:
        _card()
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [cards[i % len(cards)] for i in range(n_devices)]
        if len(cards) < n_devices:
            note = (f" devices={n_devices} named round-robin over {len(cards)} CUDA "
                    f"device{'s' if len(cards) > 1 else ''}")
    if n_devices >= 4 and n_devices % 2 == 0:
        return make_mesh((n_devices // 2, 2), ("data", "space"), devices=devices), note
    return make_mesh((n_devices,), ("data",), devices=devices), note


def batch_layout(mesh):
    """The train step's input layout: the pairs over ``data`` and, on a
    ``data x space`` mesh, the first spatial dim over ``space``."""
    from .parallel.mesh import batch_sharding, cohort_sharding

    if "space" in mesh.axis_names:
        return cohort_sharding(mesh, 3, spatial_axis=0)
    return batch_sharding(mesh)


def blob_pair(B: int, S: int = TRAIN_SIZE, device="cpu"):
    """``__graft_entry__.py:204-209``'s pair: a smooth blob in every item,
    and the blob rolled by 2 along the first spatial axis."""
    ax = torch.linspace(-1.0, 1.0, S, dtype=torch.float32)
    blob = torch.exp(-(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                       + ax[None, None, :] ** 2) / 0.18)
    moving = blob.expand(B, 1, S, S, S).contiguous().to(device)
    return moving, torch.roll(moving, 2, dims=2)


def blob_batch(B: int, S: int = TRAIN_SIZE, device="cpu"):
    """:func:`blob_pair` with pairs that differ: pair ``b``'s blob scaled by
    ``1 + 0.1 b`` and rolled by ``b - 1`` along spatial axis ``b % 3``."""
    moving, _ = blob_pair(B, S, device)
    moving = torch.stack([torch.roll(moving[b] * (1.0 + 0.1 * b), b - 1, dims=1 + b % 3)
                          for b in range(B)])
    return moving, torch.roll(moving, 2, dims=2)


def _finite(x) -> bool:
    from .parallel.mesh import gather

    return bool(torch.isfinite(gather(x)).all())


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """``__graft_entry__.py:88``'s dry run on an ``n_devices`` mesh
    (:func:`dryrun_mesh`): one train step (:func:`make_train_step`, on
    ``__graft_entry__.py``'s constant batch), its loss finite; the tiny
    ``make_cascade_batch_fn`` cascade (``CASCADE``) over the mesh on the
    shifted blob pair, with ``__graft_entry__.py:206-209``'s checks; with a
    ``space`` axis, ``warp_affine_separable`` (``max_shift=4``) on the split
    blob batch, which must copy halo rows between slabs
    (``halo.copied_bytes``) and equal the unsharded warp to the bit. Prints
    and returns the ok line."""
    from .engines.cascade import make_cascade_batch_fn
    from .ops.separable import warp_affine_separable
    from .parallel import halo
    from .parallel.mesh import gather, row_meshes, shard, space_rows

    mesh, note = dryrun_mesh(n_devices, devices)
    space = mesh.shape.get("space", 1)
    B, S = mesh.size // space, TRAIN_SIZE
    first = mesh.device_list[0]
    sh = batch_layout(mesh)

    model = _net(TRAIN_NET, first)
    params, opt_state = init_train_state(model)
    moving = torch.ones((B, 1, S, S, S), dtype=torch.float32)
    target = torch.ones((B, 1, S, S, S), dtype=torch.float32) * 0.5
    params, opt_state, loss = make_train_step(model)(params, opt_state, shard(moving, sh),
                                                      shard(target, sh))
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"dryrun_multichip: the train step's loss is {float(loss)}")

    cascade = make_cascade_batch_fn(mesh=mesh, spatial_axis=0 if space > 1 else None,
                                    **CASCADE)
    cas_moving, cas_target = blob_pair(B, S)
    cas = cascade(cas_moving, cas_target)
    # per-pair results keep their [1, 1, *S] engine shape under the batch axis
    if tuple(cas.warped.shape) != (B, 1, 1, S, S, S):
        raise AssertionError(f"dryrun_multichip: cascade warped {tuple(cas.warped.shape)}")
    if not (_finite(cas.warped) and cas.flow is not None and _finite(cas.flow)
            and _finite(cas.rigid_losses)):
        raise AssertionError("dryrun_multichip: the cascade's results are not finite")

    halo_ok = ""
    if space > 1:
        theta = rigid_theta(torch.tensor(WARP_PARAMS, dtype=torch.float32))[None]
        blobs = shard(cas_moving, sh)
        halo.reset_counts()
        for r, part in enumerate(space_rows(blobs, row_meshes(mesh))):
            got = warp_affine_separable(theta.to(part.device), part, max_shift=WARP_MAX_SHIFT)
            whole = gather(part)
            want = warp_affine_separable(theta.to(whole.device), whole,
                                         max_shift=WARP_MAX_SHIFT)
            if not torch.equal(gather(got).view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"dryrun_multichip: row {r}'s warp on slabs differs "
                                     "from the unsharded warp")
        if halo.copied_bytes <= 0:
            raise AssertionError("dryrun_multichip: the warp on slabs copied no halo rows")
        halo_ok = " sweep-halo-exchange=ok"

    line = (f"dryrun_multichip ok: mesh={mesh.shape} loss={float(loss):.6f} "
            f"cascade-sharded=ok{halo_ok}{note}")
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    fn, args = entry()
    warped, flow = fn(*args)
    print("entry ok:", (tuple(warped.shape), tuple(flow.shape)), flush=True)
    dryrun_multichip(int(argv[0]) if argv else max(torch.cuda.device_count(), 1))


if __name__ == "__main__":
    main()
