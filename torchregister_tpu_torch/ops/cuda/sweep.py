"""K1: the sweep resampler kernels (``csrc/sweep.cu``) and their plain versions.

Counterpart of ``torchregister_tpu/ops/pallas/sweep.py``. A sweep linearly
resamples a tensor along one dimension at per-element coordinates ``q``
inside the static window ``[-K, K+1]`` (see the note at the top of
``csrc/sweep.cu`` for the exact tap semantics), differentiably in the source
and the coordinates. The kernels take ``q`` in one of three forms:

- dense: a ``q`` tensor (:func:`sweep`, :func:`sweep_fwd`, :func:`sweep_bwd`);
- affine: one pass of a separable affine warp, ``q = coef . o + offset``
  from one row of a ``[d, d+1]`` table, or of a table ``[N, d, d+1]`` with
  one per batch item (a cohort's pairs) (:func:`sweep_affine_passes`, a
  whole warp in one autograd Function; the gradient of each row is reduced
  in the kernel, each item's on its own, equal to the bit to a launch on
  that item alone);
- flow: one pass of a dense-flow warp, ``q = o_a + flow_a(o)``
  (:func:`sweep_flow_passes`; the field's gradient is written channel by
  channel into one buffer).

The affine form also runs on slabs (:func:`sweep_affine_slabs`, the slab
mode): a volume split along one spatial axis over a mesh
(``parallel/mesh.py``), each slab's passes launched on its own device with
positions and coordinates of the whole volume. The pass along the split
axis reads a halo of ``K + 1`` rows a side (``parallel/halo.py``); its
backward fetches the upstream gradient's halo and gathers locally, so the
warp and dsrc are the unsharded launch's to the bit, and each slab's row
gradient is summed over the slabs in ascending order on the mesh's first
device. The flow form runs on slabs too (:func:`sweep_flow_slabs`, a field
split like the volume): the passes across the split axis are each slab's
own flow launches, the pass along it reads the slab's buffer with the halo
and its backward the halos of the upstream gradient and of the field's
channel (``sweep_slab_flow_fwd`` / ``_bwd``), so the warp, dsrc and the
field's gradient are the unsharded launches'. So does the affine form's
second order (``sweep_slab_bwd2``, LM's Hessian on a split volume): the
chain :class:`_SlabPass` reads the halos of g, src and the cotangent of
dsrc, gbar and sbar equal to the unsharded launch's to the bit.

Dispatch is by device only: a CPU tensor takes the plain versions
(:func:`sweep_plain`, :func:`sweep_affine_plain`, :func:`sweep_flow_plain`),
a CUDA tensor launches the kernels (built from the package's own source at
first use) or raises. There is no fallback from the kernels to the plain
versions.

The affine form is also differentiable twice (:func:`sweep_affine_passes`
with ``twice=True``, the LM engines' Hessian): each pass is a Function
(:class:`_AffinePass`) whose backward is itself a Function
(:class:`_AffinePassBwd`) whose backward launches the second-order kernel
``sweep_bwd2`` (:func:`affine_bwd2`; plain version :func:`sweep_bwd2_plain`),
so autograd carries the second order across the passes and their
intermediates. Every other Function here is differentiable once: a second
derivative through it raises.

``fwd_launches``, ``bwd_launches`` and ``bwd2_launches`` count kernel
launches, and ``fwd_modes`` / ``bwd_modes`` / ``bwd2_modes`` split them by
the form of ``q`` (``pairs``: the affine form with a table per item), so a
run can show that its path went through the kernels and which form ran (a
CUDA graph's replays add the launches it captured, ``engines/graph.py``);
:func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "sweep.cu"

fwd_launches = 0
bwd_launches = 0
bwd2_launches = 0
fwd_modes = {"dense": 0, "affine": 0, "flow": 0, "pairs": 0, "slab": 0, "slab_flow": 0}
bwd_modes = {"dense": 0, "affine": 0, "flow": 0, "pairs": 0, "slab": 0, "slab_flow": 0}
bwd2_modes = {"affine": 0, "pairs": 0, "slab": 0}
native.count_launches(__name__, "fwd_launches", "bwd_launches", "bwd2_launches", "fwd_modes",
                      "bwd_modes", "bwd2_modes")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DENSE, _AFFINE, _FLOW = 0, 1, 2
_INT32 = 2**31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = native.Library(SOURCE, "sweep", {
    "sweep_fwd": (_I, [_I, _P, _P, _P, _P, _L, _I, _L] + [_I] * 8 + [_L, _P]),
    "sweep_bwd": (_I, [_I] + [_P] * 7 + [_L, _I, _L] + [_I] * 8 + [_L, _L, _L, _P]),
    "sweep_bwd_work": (_L, [_L, _I, _L, _I, _L]),
    "sweep_bwd2": (_I, [_P] * 9 + [_L, _I, _L] + [_I] * 8 + [_L, _P]),
    "sweep_slab_fwd": (_I, [_P] * 3 + [_L, _I, _L] + [_I] * 8 + [_L] + [_I] * 7 + [_P]),
    "sweep_slab_bwd_work": (_L, [_L, _I, _L, _I, _L, _I, _I]),
    "sweep_slab_bwd": (_I, [_P] * 6 + [_L, _I, _L] + [_I] * 8 + [_L] + [_I] * 7 + [_P]),
    "sweep_slab_bwd2": (_I, [_P] * 9 + [_L, _I, _L] + [_I] * 8 + [_L] + [_I] * 7 + [_P]),
    "sweep_slab_flow_fwd": (_I, [_P] * 3 + [_L, _I, _L] + [_I] * 7 + [_L] + [_I] * 4 + [_P]),
    "sweep_slab_flow_bwd": (_I, [_P] * 5 + [_L, _I, _L] + [_I] * 7 + [_L] * 3 + [_I] * 4
                            + [_P]),
})


def reset_counts() -> None:
    global fwd_launches, bwd_launches, bwd2_launches
    fwd_launches = 0
    bwd_launches = 0
    bwd2_launches = 0
    for modes in (fwd_modes, bwd_modes, bwd2_modes):
        for mode in modes:
            modes[mode] = 0


def _count(forward: bool, mode: str) -> None:
    if forward:
        native.bump(__name__, fwd_launches=1, fwd_modes={mode: 1})
    else:
        native.bump(__name__, bwd_launches=1, bwd_modes={mode: 1})


@functools.lru_cache(maxsize=256)
def _rows(shape, dim: int):
    """``(outer, L, inner)``: ``shape`` viewed in place as rows along ``dim``,
    as the kernels take it."""
    outer = inner = 1
    for s in shape[:dim]:
        outer *= s
    for s in shape[dim + 1:]:
        inner *= s
    if max(outer, shape[dim], inner) > _INT32:
        raise ValueError(f"K1 takes sizes below 2^31, got {tuple(shape)} along {dim}")
    return outer, shape[dim], inner


@functools.lru_cache(maxsize=256)
def _image(shape, axis: int):
    """The rows of an image ``[N, C, *S]`` along spatial ``axis``, then its
    ``(Z, Y, X)`` (a 2-D image has Z = 1) and that axis of ``(Z, Y, X)``."""
    S = tuple(shape[2:])
    zyx, vaxis = ((S, axis) if len(S) == 3 else ((1, *S), axis + 1))
    return (*_rows(shape, 2 + axis), *zyx, vaxis)


def _check_image(src: torch.Tensor) -> None:
    if src.dtype not in _DTYPES:
        raise TypeError(f"K1 takes float32 or bfloat16 images, got {src.dtype}")
    if src.ndim not in (4, 5):
        raise ValueError(f"K1 needs an image [N, C, *S] with 2 or 3 spatial axes, got "
                         f"{tuple(src.shape)}")


def _check_on(src: torch.Tensor, **others: torch.Tensor) -> None:
    """src and ``others`` contiguous on one CUDA device."""
    if not src.is_cuda:
        raise ValueError("K1 needs src on a CUDA device")
    for name, t in others.items():
        if not (t.is_cuda and t.device == src.device):
            raise ValueError(f"K1 needs src and {name} on the same CUDA device")
    if not all(t.is_contiguous() for t in (src, *others.values())):
        raise ValueError(f"K1 needs a contiguous src and {', '.join(others)}")


def _validate(src: torch.Tensor, q: torch.Tensor, K: int) -> None:
    if src.dtype not in _DTYPES:
        raise TypeError(f"K1 takes float32 or bfloat16 images, got {src.dtype}")
    if q.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 coordinates, got {q.dtype}")
    if q.shape != src.shape:
        raise ValueError(f"K1 needs q {tuple(q.shape)} == src {tuple(src.shape)}")
    if not (src.is_cuda and q.is_cuda and src.device == q.device):
        raise ValueError("K1 needs src and q on the same CUDA device")
    if not (src.is_contiguous() and q.is_contiguous()):
        raise ValueError("K1 needs contiguous src and q")
    if K < 0:
        raise ValueError(f"K1 window must be >= 0, got {K}")


def _validate_table(src: torch.Tensor, table: torch.Tensor, axes, windows) -> None:
    _check_image(src)
    d = src.ndim - 2
    if table.dtype != torch.float32:
        raise TypeError(f"K1 takes a float32 table, got {table.dtype}")
    if tuple(table.shape) not in ((d, d + 1), (src.shape[0], d, d + 1)):
        raise ValueError(f"K1 needs a table [{d}, {d + 1}] or [{src.shape[0]}, {d}, {d + 1}] "
                         f"for a {d}-D image of {src.shape[0]}, got {tuple(table.shape)}")
    if len(axes) != d or len(windows) != d or any(a not in range(d) for a in axes) or any(
            K < 0 for K in windows):
        raise ValueError(f"K1 needs an axis in range({d}) and a window >= 0 for each of "
                         f"{d} passes, got {axes}, {windows}")
    _check_on(src, table=table)


def _validate_flow(src: torch.Tensor, flow: torch.Tensor, K: int) -> None:
    _check_image(src)
    d = src.ndim - 2
    if flow.dtype != torch.float32:
        raise TypeError(f"K1 takes a float32 field, got {flow.dtype}")
    if flow.ndim != src.ndim or flow.shape[1] != d:
        raise ValueError(f"K1 needs a field with {d} channels, got {tuple(flow.shape)}")
    if flow.shape[0] != src.shape[0] or flow.shape[2:] != src.shape[2:]:
        raise ValueError(f"K1 needs a field [N, {d}, *S] of src {tuple(src.shape)}, got "
                         f"{tuple(flow.shape)}")
    if K < 0:
        raise ValueError(f"K1 window must be >= 0, got {K}")
    _check_on(src, flow=flow)


def _check_index(name: str, i: int, n: int) -> None:
    if i not in range(n):
        raise ValueError(f"K1 needs {name} in range({n}), got {i}")


def _row(t: torch.Tensor, p: int) -> int:
    """Address of ``t[..., p, :]`` of item 0 (a float32 table), without a
    view."""
    return t.data_ptr() + 4 * p * t.stride(-2)


def _items(table: torch.Tensor) -> tuple:
    """``(stride, items)`` of a table: ``(0, 1)`` for one table ``[d, d+1]``,
    the batch stride and count of a table per item ``[N, d, d+1]``."""
    return (table.stride(0), table.shape[0]) if table.ndim == 3 else (0, 1)


def _channel(t: torch.Tensor, a: int) -> int:
    """Address of ``t[:, a]`` (a float32 tensor), without a view."""
    return t.data_ptr() + 4 * a * t.stride(1)


# ------------------------------------------------------------ raw launches
# Each takes validated contiguous CUDA tensors.


def _fwd_dense(src, q, dim, K, diff=None):
    out = torch.empty_like(src)
    outer, L, inner = _rows(src.shape, dim)
    LIB.launch("sweep_fwd", src, _DENSE, src.data_ptr(), q.data_ptr(), out.data_ptr(),
               None if diff is None else diff.data_ptr(), outer, L, inner, K,
               _DTYPES[src.dtype], 0, 1, 1, 1, 0, 1, 0)
    _count(True, "dense")
    return out


def _bwd_dense(g, src, q, dim, K, dsrc, dq):
    outer, L, inner = _rows(src.shape, dim)
    LIB.launch("sweep_bwd", src, _DENSE, g.data_ptr(), src.data_ptr(), q.data_ptr(),
               None if dsrc is None else dsrc.data_ptr(),
               None if dq is None else dq.data_ptr(), None, None, outer, L, inner, K,
               _DTYPES[src.dtype], 0, 1, 1, 1, 0, 1, 0, 0, 0)
    _count(False, "dense")


def _fwd_affine(src, table, p, axis, K):
    out = torch.empty_like(src)
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    LIB.launch("sweep_fwd", src, _AFFINE, src.data_ptr(), _row(table, p), out.data_ptr(), None,
               outer, L, inner, K, _DTYPES[src.dtype], src.ndim - 2, Z, Y, X, vaxis,
               src.shape[1], _items(table)[0])
    _count(True, "pairs" if table.ndim == 3 else "affine")
    return out


@functools.lru_cache(maxsize=64)
def _work_floats(rows, K, items) -> int:
    n = LIB.fns()["sweep_bwd_work"](*rows, K, items)
    if n <= 0:
        raise ValueError(f"K1 has no backward tile for rows {rows}, window {K} and {items} "
                         "tables")
    return n


def _affine_work(src, axes, windows, items: int = 1):
    """The affine backward's workspace for passes of ``src`` along ``axes``
    with ``windows`` (one for every pass of a warp: the largest) and
    ``items`` tables (one per batch item, or 1), zeroed: its first words
    count each item's finished blocks, and each launch leaves them 0."""
    n = max(_work_floats(_rows(src.shape, 2 + a), K, items) for a, K in zip(axes, windows))
    return torch.zeros(n, dtype=torch.float32, device=src.device)


def _bwd_affine(g, src, table, p, axis, K, need_src, dtable, work=None):
    """dsrc (or None) of one affine pass; the gradient of the pass's table
    row goes into ``dtable[..., p, :]`` (``dtable`` contiguous like
    ``table``) when ``dtable`` is given (through ``work``, made here when
    not given)."""
    dsrc = torch.empty_like(src) if need_src else None
    stride, items = _items(table)
    if dtable is not None and work is None:
        work = _affine_work(src, (axis,), (K,), items)
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    LIB.launch("sweep_bwd", src, _AFFINE, g.data_ptr(), src.data_ptr(), _row(table, p),
               None if dsrc is None else dsrc.data_ptr(), None,
               None if work is None else work.data_ptr(),
               None if dtable is None else _row(dtable, p), outer, L, inner, K,
               _DTYPES[src.dtype], src.ndim - 2, Z, Y, X, vaxis, src.shape[1], stride, 0, 0)
    _count(False, "pairs" if table.ndim == 3 else "affine")
    return dsrc


def _bwd2_affine(g, src, table, p, axis, K, ubar, rbar, need_g, need_src, dtable,
                 work=None):
    """``(gbar, sbar)`` (either None when not needed) of one affine pass's
    backward, given the cotangents ``ubar`` of its dsrc (None: zeros) and
    ``rbar`` of its table gradient (shaped and laid out as ``table``; row
    ``p`` is read); the gradient of the pass's table row goes into
    ``dtable[..., p, :]`` when ``dtable`` is given (through ``work``, made
    here when not given)."""
    gbar = torch.empty_like(g) if need_g else None
    sbar = torch.empty_like(src) if need_src else None
    stride, items = _items(table)
    if dtable is not None and work is None:
        work = _affine_work(src, (axis,), (K,), items)
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    LIB.launch("sweep_bwd2", src, g.data_ptr(), src.data_ptr(), _row(table, p),
               None if ubar is None else ubar.data_ptr(), _row(rbar, p),
               None if gbar is None else gbar.data_ptr(),
               None if sbar is None else sbar.data_ptr(),
               None if work is None else work.data_ptr(),
               None if dtable is None else _row(dtable, p), outer, L, inner, K,
               _DTYPES[src.dtype], src.ndim - 2, Z, Y, X, vaxis, src.shape[1], stride)
    native.bump(__name__, bwd2_launches=1,
                bwd2_modes={"pairs" if table.ndim == 3 else "affine": 1})
    return gbar, sbar


def _fwd_flow(src, flow, axis, K):
    out = torch.empty_like(src)
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    LIB.launch("sweep_fwd", src, _FLOW, src.data_ptr(), _channel(flow, axis), out.data_ptr(),
               None, outer, L, inner, K, _DTYPES[src.dtype], 0, Z, Y, X, vaxis, src.shape[1],
               flow.stride(0))
    _count(True, "flow")
    return out


def _bwd_flow(g, src, flow, axis, K, need_src, dflow):
    """dsrc (or None) of one flow pass; the field's gradient goes into
    channel ``axis`` of ``dflow`` when given (summed over src's channels)."""
    C = src.shape[1]
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    dsrc = torch.empty_like(src) if need_src else None
    du, du_ptr, dqn, dqc = None, None, 0, 0
    if dflow is not None:
        if C == 1:  # straight into the field gradient's channel
            du_ptr, dqn = _channel(dflow, axis), dflow.stride(0)
        else:  # per channel, then summed over the channels
            du = torch.empty(src.shape, dtype=torch.float32, device=src.device)
            du_ptr, dqn, dqc = du.data_ptr(), du.stride(0), du.stride(1)
    LIB.launch("sweep_bwd", src, _FLOW, g.data_ptr(), src.data_ptr(), _channel(flow, axis),
               None if dsrc is None else dsrc.data_ptr(), du_ptr, None, None, outer, L, inner, K,
               _DTYPES[src.dtype], 0, Z, Y, X, vaxis, C, flow.stride(0), dqn, dqc)
    _count(False, "flow")
    if du is not None:
        dflow[:, axis].copy_(du.sum(1))
    return dsrc


# ------------------------------------------------------- validated launches


def sweep_fwd(src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
              with_diff: bool = False):
    """Launch the dense forward: ``(out, diff)`` with ``out`` in ``src``'s
    dtype and ``diff`` (f32, ceil - floor) only when ``with_diff``."""
    _validate(src, q, K)
    diff = torch.empty_like(q) if with_diff else None
    return _fwd_dense(src, q, dim, int(K), diff), diff


def sweep_bwd(g: torch.Tensor, src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
              need_src: bool = True, need_q: bool = True):
    """Launch the dense backward: ``(dsrc, dq)``; either may be skipped
    (returned as None) when its input needs no gradient."""
    _validate(src, q, K)
    if g.shape != src.shape or g.dtype != src.dtype or not g.is_contiguous():
        raise ValueError("K1 backward needs a contiguous g shaped and typed as src")
    dsrc = torch.empty_like(src) if need_src else None
    dq = torch.empty_like(q) if need_q else None
    _bwd_dense(g, src, q, dim, int(K), dsrc, dq)
    return dsrc, dq


def affine_fwd(src: torch.Tensor, table: torch.Tensor, p: int, axis: int,
               K: int) -> torch.Tensor:
    """One affine pass: ``src [N, C, *S]`` swept along spatial ``axis`` at
    ``q = table[p, :d] . o + table[p, d]``, or, with a table per item
    ``[N, d, d+1]``, item n at ``table[n, p]``."""
    _check_index("the row", p, table.shape[-2])
    _validate_table(src, table, [axis] * table.shape[-2], [K] * table.shape[-2])
    return _fwd_affine(src, table, p, axis, int(K))


def affine_bwd(g: torch.Tensor, src: torch.Tensor, table: torch.Tensor, p: int, axis: int,
               K: int, need_src: bool = True, need_table: bool = True):
    """The backward of :func:`affine_fwd`: ``(dsrc, drow)``, ``drow`` the
    gradient of ``table[..., p, :]`` (``[N, d+1]`` for a table per item);
    either may be skipped (None)."""
    _check_index("the row", p, table.shape[-2])
    _validate_table(src, table, [axis] * table.shape[-2], [K] * table.shape[-2])
    if g.shape != src.shape or g.dtype != src.dtype:
        raise ValueError("K1 backward needs a g shaped and typed as src")
    _check_on(src, g=g)
    dtable = torch.empty_like(table) if need_table else None
    dsrc = _bwd_affine(g, src, table, p, axis, int(K), need_src, dtable)
    return dsrc, None if dtable is None else dtable[..., p, :]


def affine_bwd2(g: torch.Tensor, src: torch.Tensor, table: torch.Tensor, p: int, axis: int,
                K: int, ubar: torch.Tensor | None, rbar: torch.Tensor, need_g: bool = True,
                need_src: bool = True, need_table: bool = True):
    """The second order of :func:`affine_fwd` (``sweep_bwd2``): given the
    backward's inputs ``g``, ``src`` and the table, the cotangent ``ubar`` of
    its dsrc (None: zeros) and ``rbar`` of its row gradient (``[d+1]``, or
    ``[N, d+1]`` for a table per item), returns ``(gbar, sbar, drow)``:
    ``A(q) ubar + v D(q)src``, ``D(q)^T (v g)`` and the row's gradient
    ``sum_e g_e (D(q) ubar)_e [n_e, 1]``, with ``v = rbar . [n, 1]``; each
    may be skipped (None)."""
    _check_index("the row", p, table.shape[-2])
    _validate_table(src, table, [axis] * table.shape[-2], [K] * table.shape[-2])
    for name, t in (("g", g), ("ubar", ubar)):
        if t is not None and (t.shape != src.shape or t.dtype != src.dtype):
            raise ValueError(f"K1's second order needs {name} shaped and typed as src")
    if rbar.dtype != torch.float32 or rbar.shape != table[..., p, :].shape:
        raise ValueError(f"K1's second order needs a float32 rbar of shape "
                         f"{tuple(table[..., p, :].shape)}, got {rbar.dtype} "
                         f"{tuple(rbar.shape)}")
    _check_on(src, g=g, rbar=rbar.contiguous(), **({} if ubar is None else {"ubar": ubar}))
    rtable = torch.zeros_like(table)
    rtable[..., p, :] = rbar
    dtable = torch.zeros_like(table) if need_table else None
    gbar, sbar = _bwd2_affine(g, src, table, p, axis, int(K), ubar, rtable, need_g, need_src,
                              dtable)
    return gbar, sbar, None if dtable is None else dtable[..., p, :]


def flow_fwd(src: torch.Tensor, flow: torch.Tensor, axis: int, K: int) -> torch.Tensor:
    """One flow pass: ``src [N, C, *S]`` swept along spatial ``axis`` at
    ``q = o_axis + flow[:, axis]`` (``flow [N, d, *S]`` f32)."""
    _check_index("the axis", axis, src.ndim - 2)
    _validate_flow(src, flow, K)
    return _fwd_flow(src, flow, axis, int(K))


def flow_bwd(g: torch.Tensor, src: torch.Tensor, flow: torch.Tensor, axis: int, K: int,
             need_src: bool = True, need_flow: bool = True):
    """The backward of :func:`flow_fwd`: ``(dsrc, du)``, ``du [N, *S]`` the
    gradient of ``flow[:, axis]``; either may be skipped (None)."""
    _check_index("the axis", axis, src.ndim - 2)
    _validate_flow(src, flow, K)
    if g.shape != src.shape or g.dtype != src.dtype:
        raise ValueError("K1 backward needs a g shaped and typed as src")
    _check_on(src, g=g)
    dflow = torch.empty_like(flow) if need_flow else None
    dsrc = _bwd_flow(g, src, flow, axis, int(K), need_src, dflow)
    return dsrc, None if dflow is None else dflow[:, axis]


# -------------------------------------------------------- autograd Functions


class _Sweep(torch.autograd.Function):
    """The dense kernels; q may broadcast against src (dq is summed back to
    q's shape, as JAX autodiff does for a broadcast operand)."""

    @staticmethod
    def forward(ctx, src, q, dim, K):
        shape = torch.broadcast_shapes(src.shape, q.shape)
        src_b = src.expand(shape).contiguous()
        q_b = q.to(torch.float32).expand(shape).contiguous()
        out, _ = sweep_fwd(src_b, q_b, dim, K)
        ctx.save_for_backward(src_b, q_b)
        ctx.dim, ctx.K = dim, K
        ctx.src_shape, ctx.q_shape, ctx.q_dtype = src.shape, q.shape, q.dtype
        return out

    @staticmethod
    @native.differentiable_once
    def backward(ctx, g):
        src_b, q_b = ctx.saved_tensors
        need_src, need_q = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dsrc, dq = sweep_bwd(g.to(src_b.dtype).contiguous(), src_b, q_b, ctx.dim,
                             ctx.K, need_src, need_q)
        if dsrc is not None:
            dsrc = dsrc.sum_to_size(ctx.src_shape)
        if dq is not None:
            dq = dq.sum_to_size(ctx.q_shape).to(ctx.q_dtype)
        return dsrc, dq, None, None


class _SeparableAffine(torch.autograd.Function):
    """A whole separable affine warp: one affine launch per pass forward and
    one per pass backward, in reverse; ``table`` [d, d+1] holds each pass's
    (coef, offset), or ``[N, d, d+1]`` each batch item's, and gets its
    gradient from the kernels. Differentiable once (the chain of
    :class:`_AffinePass` is differentiable twice)."""

    @staticmethod
    def forward(ctx, src, table, axes, windows):
        _validate_table(src, table, axes, windows)
        outs = [src]
        for p, (axis, K) in enumerate(zip(axes, windows)):
            outs.append(_fwd_affine(outs[-1], table, p, axis, K))
        ctx.save_for_backward(table, *outs[:-1])
        ctx.axes, ctx.windows = axes, windows
        return outs[-1]

    @staticmethod
    @native.differentiable_once
    def backward(ctx, g):
        table, *ins = ctx.saved_tensors
        need_src, need_table = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dtable = torch.empty_like(table) if need_table else None
        work = (_affine_work(ins[0], ctx.axes, ctx.windows, _items(table)[1]) if need_table
                else None)
        g = g.to(ins[0].dtype).contiguous()
        for p in reversed(range(len(ins))):
            want_src = p > 0 or need_src
            if not (want_src or need_table):
                break
            g = _bwd_affine(g, ins[p], table, p, ctx.axes[p], ctx.windows[p], want_src, dtable,
                            work)
        return g if need_src else None, dtable, None, None


class _SeparableFlow(torch.autograd.Function):
    """A whole separable flow warp, x-pass first: one flow launch per pass
    forward and one per pass backward, in reverse, each writing its channel
    of the field's gradient."""

    @staticmethod
    def forward(ctx, src, flow, K):
        _validate_flow(src, flow, K)
        d = src.ndim - 2
        outs = [src]
        for axis in range(d - 1, -1, -1):
            outs.append(_fwd_flow(outs[-1], flow, axis, K))
        ctx.save_for_backward(flow, *outs[:-1])
        ctx.K = K
        return outs[-1]

    @staticmethod
    @native.differentiable_once
    def backward(ctx, g):
        flow, *ins = ctx.saved_tensors
        need_src, need_flow = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        d = len(ins)
        dflow = torch.empty_like(flow) if need_flow else None
        g = g.to(ins[0].dtype).contiguous()
        for p in reversed(range(d)):  # pass p swept axis d - 1 - p
            want_src = p > 0 or need_src
            if not (want_src or need_flow):
                break
            g = _bwd_flow(g, ins[p], flow, d - 1 - p, ctx.K, want_src, dflow)
        return g if need_src else None, dflow, None


class _AffinePass(torch.autograd.Function):
    """One pass of a separable affine warp (row ``p`` of ``table``),
    differentiable twice: its backward is :class:`_AffinePassBwd`."""

    @staticmethod
    def forward(ctx, src, table, p, axis, K):
        ctx.save_for_backward(src, table)
        ctx.p, ctx.axis, ctx.K = p, axis, K
        return _fwd_affine(src, table, p, axis, K)

    @staticmethod
    def backward(ctx, g):
        src, table = ctx.saved_tensors
        need_src, need_table = ctx.needs_input_grad[:2]
        dsrc, dtable = _AffinePassBwd.apply(g, src, table, ctx.p, ctx.axis, ctx.K, need_src,
                                            need_table)
        return dsrc, dtable, None, None, None


class _AffinePassBwd(torch.autograd.Function):
    """The backward of one affine pass, ``(g, src, table) -> (dsrc,
    dtable)`` (``dtable`` zero but for row ``p``; either None when not
    needed); its backward launches ``sweep_bwd2``."""

    @staticmethod
    def forward(ctx, g, src, table, p, axis, K, need_src, need_table):
        g = g.to(src.dtype).contiguous()
        dtable = torch.zeros_like(table) if need_table else None
        dsrc = _bwd_affine(g, src, table, p, axis, K, need_src, dtable)
        ctx.save_for_backward(g, src, table)
        ctx.p, ctx.axis, ctx.K = p, axis, K
        ctx.set_materialize_grads(False)
        return dsrc, dtable

    @staticmethod
    @native.differentiable_once
    def backward(ctx, ubar, dtable_bar):
        g, src, table = ctx.saved_tensors
        need_g, need_src, need_table = ctx.needs_input_grad[:3]
        if ubar is not None:
            ubar = ubar.to(src.dtype).contiguous()
        rbar = (torch.zeros_like(table) if dtable_bar is None
                else dtable_bar.to(torch.float32).contiguous())
        dtable = torch.zeros_like(table) if need_table else None
        gbar, sbar = _bwd2_affine(g, src, table, ctx.p, ctx.axis, ctx.K, ubar, rbar, need_g,
                                  need_src, dtable)
        return gbar, sbar, dtable, None, None, None, None, None


# ------------------------------------------------------------ plain versions


def sweep_plain(src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
                with_diff: bool = False):
    """Plain PyTorch version of K1 (same semantics, autograd-differentiable):
    the two taps gathered from a zero-padded f32 source. Returns
    ``(out, diff)`` like :func:`sweep_fwd`."""
    shape = torch.broadcast_shapes(src.shape, q.shape)
    fr, mf, mc, fi, ci = _plain_taps(q.to(torch.float32).expand(shape), dim, K)
    vf, vc = _plain_gather(src.to(torch.float32).expand(shape), dim, mf, mc, fi, ci)
    out = torch.where(mf, vf * (1.0 - fr), 0.0) + torch.where(mc, vc * fr, 0.0)
    return out.to(src.dtype), (vc - vf) if with_diff else None


def _plain_taps(q: torch.Tensor, dim: int, K: int):
    """``(fr, mf, mc, fi, ci)`` of coordinates ``q`` along ``dim``: the
    weight, the masks of the floor and ceil taps, and their indices into the
    source padded with one zero at each end along ``dim`` (source index + 1;
    0 and X + 1 are the pads). A NaN coordinate counts no tap (the kernels'
    and the JAX sweep's zero), its indices those of 0."""
    X = q.shape[dim]
    q0 = torch.floor(q)
    view = [1] * q.ndim
    view[dim] = X
    k = q0 - torch.arange(X, dtype=torch.float32, device=q.device).view(view)
    mf = (k >= -K) & (k <= K + 1)
    mc = (k >= -K - 1) & (k <= K)
    q0i = torch.nan_to_num(q0, nan=0.0)
    fi = torch.clamp(q0i + 1.0, 0.0, X + 1.0).long()
    ci = torch.clamp(q0i + 2.0, 0.0, X + 1.0).long()
    return q - q0, mf, mc, fi, ci


def _plain_pad(dim: int, ndim: int) -> list:
    return [0, 0] * (ndim - 1 - dim) + [1, 1]


def _plain_gather(src, dim, mf, mc, fi, ci):
    """The floor and ceil taps of ``src`` (f32), zero where they do not
    count."""
    padded = torch.nn.functional.pad(src.to(torch.float32), _plain_pad(dim, src.ndim))
    vf = torch.where(mf, torch.gather(padded, dim, fi), 0.0)
    vc = torch.where(mc, torch.gather(padded, dim, ci), 0.0)
    return vf, vc


def _axis_coord_grid(coef: torch.Tensor, offset, spatial, starts=None) -> torch.Tensor:
    """``q[o] = coef . o + offset`` over the full grid, shape ``[1, 1, *S]``;
    with one row per pair (``coef [B, d]``, ``offset [B]``) ``[B, 1, *S]``,
    each pair's grid computed by the same ops as its own. ``starts``: the
    grid's first voxel in a larger volume (a slab's), each coordinate that
    volume's."""
    d = len(spatial)
    starts = (0,) * d if starts is None else tuple(starts)

    def iota(b):
        return torch.arange(starts[b], starts[b] + spatial[b], dtype=torch.float32,
                            device=coef.device).view(
            tuple(spatial[b] if i == b else 1 for i in range(d)))

    if coef.ndim == 2:
        lead = (coef.shape[0],) + (1,) * d
        q = torch.reshape(offset, lead)
        for b in range(d):
            q = q + coef[:, b].reshape(lead) * iota(b)
        return q[:, None]
    q = offset
    for b in range(d):
        q = q + coef[b] * iota(b)
    return q[None, None]


def sweep_affine_plain(src: torch.Tensor, coef: torch.Tensor, offset, axis: int,
                       K: int) -> torch.Tensor:
    """Plain version of one affine pass: the dense grid of
    ``q = coef . o + offset``, then :func:`sweep_plain` along ``axis``.
    ``coef [B, d]`` and ``offset [B]`` give each item of ``src [B, C, *S]``
    its own pass (the plain form of a table per item)."""
    q = _axis_coord_grid(coef, offset, tuple(src.shape[2:]))
    return sweep_plain(src, q, axis + 2, int(K))[0]


def sweep_bwd2_plain(g: torch.Tensor, src: torch.Tensor, ubar: torch.Tensor | None,
                     rbar: torch.Tensor, coef: torch.Tensor, offset, axis: int, K: int):
    """Plain version of :func:`affine_bwd2`, its three formulas in torch
    ops: for one affine pass at ``q = coef . o + offset`` (``coef [d]``, or
    ``[B, d]`` with ``offset [B]`` for a row per item) and the cotangents
    ``ubar`` (of dsrc; None: zeros) and ``rbar`` (of the row gradient,
    ``(coef, offset)`` layout), with ``v = rbar . [o, 1]`` and ``D(q)x =
    x[ceil] - x[floor]`` over the taps that count, returns ``(gbar, sbar,
    drow)``: ``A(q) ubar + v D(q)src`` (``g``'s dtype), ``D(q)^T (v g)``
    (``src``'s) and ``sum_e g_e (D(q) ubar)_e [o_e, 1]`` (f32, ``rbar``'s
    shape)."""
    spatial = tuple(src.shape[2:])
    dim = axis + 2
    q = _axis_coord_grid(coef.to(torch.float32), offset, spatial).expand(src.shape)
    v = _axis_coord_grid(rbar[..., :-1], rbar[..., -1], spatial).expand(src.shape)
    fr, mf, mc, fi, ci = _plain_taps(q, dim, int(K))
    sf, sc = _plain_gather(src, dim, mf, mc, fi, ci)
    uf, uc = (_plain_gather(ubar, dim, mf, mc, fi, ci) if ubar is not None
              else (torch.zeros_like(sf), torch.zeros_like(sf)))
    gf = g.to(torch.float32)
    gbar = (torch.where(mf, uf * (1.0 - fr), 0.0) + torch.where(mc, uc * fr, 0.0)
            + v * (sc - sf))
    # D^T: +v g into each ceil tap that counts, -v g into each floor tap
    w = v * gf
    padded = torch.zeros(torch.nn.functional.pad(sf, _plain_pad(dim, sf.ndim)).shape,
                         dtype=torch.float32, device=src.device)
    padded = padded.scatter_add(dim, ci, torch.where(mc, w, 0.0))
    padded = padded.scatter_add(dim, fi, torch.where(mf, -w, 0.0))
    sbar = padded.narrow(dim, 1, src.shape[dim])
    d = gf * (uc - uf)
    coords = [torch.arange(n, dtype=torch.float32, device=src.device).view(
        tuple(n if i == a else 1 for i in range(len(spatial)))) for a, n in enumerate(spatial)]
    terms = [d * c for c in coords] + [d]
    per_item = coef.ndim == 2
    drow = torch.stack([t.flatten(1).sum(1) if per_item else t.sum() for t in terms], dim=-1)
    return gbar.to(g.dtype), sbar.to(src.dtype), drow


def sweep_flow_plain(src: torch.Tensor, flow: torch.Tensor, axis: int,
                     K: int) -> torch.Tensor:
    """Plain version of one flow pass: ``q = flow[:, axis] + o_axis``, then
    :func:`sweep_plain` along ``axis``."""
    spatial = tuple(src.shape[2:])
    d = len(spatial)
    ident = torch.arange(spatial[axis], dtype=torch.float32, device=flow.device)
    ident = ident.view(tuple(spatial[axis] if i == axis else 1 for i in range(d)))
    q = flow[:, axis].to(torch.float32)[:, None] + ident
    return sweep_plain(src, q, axis + 2, int(K))[0]


# ---------------------------------------------------------------- dispatch


def _no_path(t: torch.Tensor):
    return RuntimeError(f"K1 has no path for device {t.device}")


def sweep(src: torch.Tensor, q: torch.Tensor, dim: int, K: int) -> torch.Tensor:
    """Resample ``src`` along ``dim`` at coordinates ``q`` (broadcastable to
    ``src``) within the window ``[-K, K+1]``; output in ``src``'s dtype."""
    if src.is_cuda:
        return _Sweep.apply(src, q, dim, int(K))
    if src.device.type == "cpu":
        return sweep_plain(src, q, dim, int(K))[0]
    raise _no_path(src)


def sweep_affine_passes(src: torch.Tensor, passes, windows: Sequence[int],
                        twice: bool = False) -> torch.Tensor:
    """A separable affine warp of ``src [N, C, *S]``: each pass
    ``(axis, (coef, offset))`` of ``passes`` (as ``factor_passes`` gives
    them) sweeps ``axis`` at ``q = coef . o + offset`` within its window.
    Passes of ``coef [N, d]`` and ``offset [N]`` warp each item by its own
    transform: on the card one launch a pass over a table ``[N, d, d+1]``.
    ``twice=True`` makes the warp differentiable twice on the card (a chain
    of :class:`_AffinePass`, the same launches forward and backward, and
    ``sweep_bwd2`` in a second derivative); the plain passes are anyway. A
    ``parallel.mesh.Sharded`` volume split along a spatial dim takes the
    slab mode (:func:`sweep_affine_slabs`, ``twice`` alike)."""
    from ...parallel.mesh import Sharded

    windows = tuple(int(K) for K in windows)
    if isinstance(src, Sharded):
        return sweep_affine_slabs(src, passes, windows, twice)
    if src.is_cuda:
        table, axes = pass_table(passes)
        if not twice:
            return _SeparableAffine.apply(src, table, axes, windows)
        return affine_chain(src, table, axes, windows)
    if src.device.type == "cpu":
        out = src
        for (axis, (coef, offset)), K in zip(passes, windows):
            out = sweep_affine_plain(out, coef, offset, axis, K)
        return out
    raise _no_path(src)


def pass_table(passes) -> tuple:
    """``(table, axes)`` of a separable affine warp's passes: the f32 table
    ``[d, d+1]`` of each pass's ``(coef, offset)`` row (``[N, d, d+1]`` for
    passes of ``coef [N, d]``) and each pass's axis."""
    if passes[0][1][0].ndim == 2:
        table = torch.stack([torch.cat([coef.to(torch.float32),
                                        offset.to(torch.float32)[:, None]], dim=1)
                             for _, (coef, offset) in passes], dim=1)
    else:
        table = torch.stack([torch.cat([coef.to(torch.float32),
                                        torch.reshape(offset, (1,)).to(torch.float32)])
                             for _, (coef, offset) in passes])
    return table, tuple(a for a, _ in passes)


def affine_chain(src: torch.Tensor, table: torch.Tensor, axes, windows) -> torch.Tensor:
    """The warp of ``table``'s passes as a chain of :class:`_AffinePass`,
    differentiable twice through the kernels."""
    _validate_table(src, table, axes, windows)
    out = src
    for p, (axis, K) in enumerate(zip(axes, windows)):
        out = _AffinePass.apply(out, table, p, axis, K)
    return out


def sweep_flow_passes(src: torch.Tensor, flow: torch.Tensor, K: int) -> torch.Tensor:
    """A separable flow warp of ``src [N, C, *S]`` by ``flow [N, d, *S]``
    (voxels), x-pass first, each pass within the window ``K``. A
    ``parallel.mesh.Sharded`` ``src`` and ``flow`` split alike into slabs
    take the slab mode (:func:`sweep_flow_slabs`)."""
    from ...parallel.mesh import Sharded

    if isinstance(src, Sharded) or isinstance(flow, Sharded):
        return sweep_flow_slabs(src, flow, K)
    if src.is_cuda:
        return _SeparableFlow.apply(src, flow.to(torch.float32).contiguous(), int(K))
    if src.device.type == "cpu":
        out = src
        for axis in range(src.ndim - 3, -1, -1):
            out = sweep_flow_plain(out, flow, axis, K)
        return out
    raise _no_path(src)


# -------------------------------------------------------------------- slabs


class SlabGeo(NamedTuple):
    """A slab of a volume split along spatial ``axis``: its first row ``lo``
    and the volume's extent along that axis."""

    axis: int
    lo: int
    extent: int


def slab_halo(K: int) -> int:
    """Rows a side that a pass along the split axis reads around a slab:
    its outputs' taps forward, the outputs that reach its rows backward."""
    return int(K) + 1


def _slab_args(shape, axis: int, K: int, geo: SlabGeo) -> tuple:
    """The slab mode's ``(oz, oy, ox, p0, b0, Lb, Xg)`` of a pass along
    spatial ``axis`` whose output is a slab of ``shape``: along the split
    axis the slab's rows and a buffer with a halo of ``slab_halo(K)`` rows
    a side; across it the slab's origin."""
    d = len(shape) - 2
    L = shape[2 + axis]
    origin = [0, 0, 0]
    if axis == geo.axis:
        h = slab_halo(K)
        return (*origin, geo.lo, geo.lo - h, L + 2 * h, geo.extent)
    origin[3 - d + geo.axis] = geo.lo
    return (*origin, 0, 0, L, L)


def _check_slab(buf: torch.Tensor, table: torch.Tensor, axis: int, K: int, geo: SlabGeo,
                shape) -> None:
    _check_image(buf)
    d = buf.ndim - 2
    if geo.axis not in range(d) or axis not in range(d) or K < 0:
        raise ValueError(f"K1's slab mode needs axes in range({d}) and K >= 0, got split axis "
                         f"{geo.axis}, pass axis {axis}, K {K}")
    Lb = _slab_args(shape, axis, K, geo)[5]
    want = tuple(Lb if i == 2 + axis else s for i, s in enumerate(shape))
    if tuple(buf.shape) != want:
        raise ValueError(f"K1's slab mode needs a source buffer {want} for a slab {tuple(shape)} "
                         f"along axis {axis} with K = {K}, got {tuple(buf.shape)}")
    L = shape[2 + geo.axis]
    if geo.lo < 0 or geo.lo + L > geo.extent:
        raise ValueError(f"K1's slab mode: a slab of {L} rows from {geo.lo} is not inside "
                         f"{geo.extent}")
    if tuple(table.shape) not in ((d, d + 1), (shape[0], d, d + 1)):
        raise ValueError(f"K1 needs a table [{d}, {d + 1}] or [{shape[0]}, {d}, {d + 1}], got "
                         f"{tuple(table.shape)}")


def affine_slab_fwd(buf: torch.Tensor, table: torch.Tensor, p: int, axis: int, K: int,
                    geo: SlabGeo, shape) -> torch.Tensor:
    """One affine pass on a slab (the slab mode): the slab ``shape``'s
    outputs of row ``p`` of ``table`` along spatial ``axis``, from ``buf``
    (the slab itself, or along the split axis the slab with
    ``slab_halo(K)`` rows of the volume a side, zeros past it)."""
    shape = tuple(shape)
    _check_slab(buf, table, axis, int(K), geo, shape)
    _check_on(buf, table=table)
    return _fwd_slab(buf, table, p, axis, int(K), geo, shape)


def _fwd_slab(buf, table, p, axis, K, geo, shape):
    out = torch.empty(shape, dtype=buf.dtype, device=buf.device)
    outer, L, inner, Z, Y, X, vaxis = _image(shape, axis)
    LIB.launch("sweep_slab_fwd", buf, buf.data_ptr(), _row(table, p), out.data_ptr(), outer, L,
               inner, K, _DTYPES[buf.dtype], len(shape) - 2, Z, Y, X, vaxis, shape[1],
               _items(table)[0], *_slab_args(shape, axis, K, geo))
    _count(True, "slab")
    return out


@functools.lru_cache(maxsize=64)
def _slab_work_floats(rows, K, items, Xg, Lb) -> int:
    n = LIB.fns()["sweep_slab_bwd_work"](*rows, K, items, Xg, Lb)
    if n <= 0:
        raise ValueError(f"K1 has no slab backward tile for rows {rows}, window {K}, "
                         f"{items} tables, extent {Xg} and a buffer of {Lb}")
    return n


def _slab_work(shape, axes, windows, geo, items, device) -> torch.Tensor:
    """The slab backward's (and ``sweep_slab_bwd2``'s) workspace for every
    pass of a warp (the largest), zeroed; each launch leaves its counters
    0."""
    n = max(_slab_work_floats(_rows(shape, 2 + a), K, items,
                              *_slab_args(shape, a, K, geo)[6:4:-1])
            for a, K in zip(axes, windows))
    return torch.zeros(n, dtype=torch.float32, device=device)


def _bwd_slab(gbuf, buf, table, p, axis, K, geo, shape, need_src, dtable, work=None):
    """dsrc (or None) of one slab pass, ``gbuf`` the upstream gradient laid
    out as ``buf``; the slab's share of the row gradient into
    ``dtable[..., p, :]`` when ``dtable`` is given."""
    dsrc = torch.empty(shape, dtype=buf.dtype, device=buf.device) if need_src else None
    stride, items = _items(table)
    outer, L, inner, Z, Y, X, vaxis = _image(shape, axis)
    args = _slab_args(shape, axis, K, geo)
    if dtable is not None and work is None:
        work = _slab_work(shape, (axis,), (K,), geo, items, buf.device)
    LIB.launch("sweep_slab_bwd", buf, gbuf.data_ptr(), buf.data_ptr(), _row(table, p),
               None if dsrc is None else dsrc.data_ptr(),
               None if work is None else work.data_ptr(),
               None if dtable is None else _row(dtable, p), outer, L, inner, K,
               _DTYPES[buf.dtype], len(shape) - 2, Z, Y, X, vaxis, shape[1], stride, *args)
    _count(False, "slab")
    return dsrc


def affine_slab_bwd(gbuf: torch.Tensor, buf: torch.Tensor, table: torch.Tensor, p: int,
                    axis: int, K: int, geo: SlabGeo, shape, need_src: bool = True,
                    need_table: bool = True):
    """The backward of :func:`affine_slab_fwd`: ``(dsrc, drow)``, ``gbuf``
    the upstream gradient laid out as ``buf`` (along the split axis with its
    halo), ``dsrc`` the slab's, ``drow`` the slab's share of the gradient of
    ``table[..., p, :]``; either may be skipped (None)."""
    shape = tuple(shape)
    _check_slab(buf, table, axis, int(K), geo, shape)
    if gbuf.shape != buf.shape or gbuf.dtype != buf.dtype:
        raise ValueError("K1's slab backward needs g laid out and typed as the source buffer")
    _check_on(buf, table=table, g=gbuf)
    dtable = torch.zeros_like(table) if need_table else None
    dsrc = _bwd_slab(gbuf, buf, table, p, axis, int(K), geo, shape, need_src, dtable)
    return dsrc, None if dtable is None else dtable[..., p, :]


def _slab_taps(q, dim, K, p0, b0, Lb, Xg):
    """:func:`_plain_taps` of coordinates at a slab's outputs (global
    positions from ``p0``) into a buffer of the volume's rows ``[b0, b0 +
    Lb)``: a tap counts within the window and the volume."""
    L = q.shape[dim]
    q0 = torch.floor(q)
    view = [1] * q.ndim
    view[dim] = L
    k = q0 - torch.arange(p0, p0 + L, dtype=torch.float32, device=q.device).view(view)
    mf = (k >= -K) & (k <= K + 1) & (q0 >= 0) & (q0 <= Xg - 1)
    mc = (k >= -K - 1) & (k <= K) & (q0 >= -1) & (q0 <= Xg - 2)
    q0i = torch.nan_to_num(q0, nan=0.0)
    fi = torch.clamp(q0i - b0, 0.0, Lb - 1.0).long()
    ci = torch.clamp(q0i + 1.0 - b0, 0.0, Lb - 1.0).long()
    return q - q0, mf, mc, fi, ci


def sweep_affine_slab_plain(buf: torch.Tensor, coef: torch.Tensor, offset, axis: int, K: int,
                            geo: SlabGeo, shape) -> torch.Tensor:
    """Plain version of the slab mode: :func:`sweep_affine_plain` of the
    slab ``shape``'s outputs with the slab's origin applied (each coordinate
    and tap position the volume's) on the buffer ``buf`` (as
    :func:`affine_slab_fwd` takes it); differentiable in ``buf``, ``coef``
    and ``offset``. Each output is the unsharded plain pass's to the bit."""
    shape = tuple(shape)
    d = len(shape) - 2
    dim = 2 + axis
    _, _, _, p0, b0, Lb, Xg = _slab_args(shape, axis, int(K), geo)
    starts = [geo.lo if b == geo.axis else 0 for b in range(d)]
    starts[axis] = p0
    q = _axis_coord_grid(coef, offset, shape[2:], starts).expand(shape)
    fr, mf, mc, fi, ci = _slab_taps(q, dim, int(K), p0, b0, Lb, Xg)
    src = buf.to(torch.float32)
    vf = torch.where(mf, torch.gather(src, dim, fi), 0.0)
    vc = torch.where(mc, torch.gather(src, dim, ci), 0.0)
    out = torch.where(mf, vf * (1.0 - fr), 0.0) + torch.where(mc, vc * fr, 0.0)
    return out.to(buf.dtype)


def _row_of(table: torch.Tensor, p: int) -> tuple:
    return table[..., p, :-1], table[..., p, -1]


def _slab_bwd_plain(gbuf, buf, table, p, axis, K, geo, shape, need_src, dtable):
    """The plain slab backward, in the kernel's way: dsrc gathered from the
    upstream gradient of every output that reaches the slab's rows (along the
    split axis those of the halo, on a zero canvas of the sources they
    reach), so each entry sums the unsharded pass's terms in its order; the
    row's gradient from the slab's own outputs."""
    dim = 2 + axis
    coef, offset = (t.detach() for t in _row_of(table, p))
    split = axis == geo.axis
    h = slab_halo(K)
    dsrc = None
    with torch.enable_grad():
        if dtable is not None:
            c, o = coef.clone().requires_grad_(True), offset.clone().requires_grad_(True)
            out = sweep_affine_slab_plain(buf.detach(), c, o, axis, K, geo, shape)
            g_own = gbuf.narrow(dim, h, shape[dim]) if split else gbuf
            dc, do = torch.autograd.grad(out, (c, o), g_own)
            dtable[..., p, :] = torch.cat([dc, do[..., None]], -1)
        if need_src:
            if split:  # the outputs of the halo reach rows [lo - 2h, hi + 2h)
                L = shape[dim]
                ext = tuple(L + 2 * h if i == dim else s for i, s in enumerate(shape))
                canvas = torch.zeros(tuple(L + 4 * h if i == dim else s
                                           for i, s in enumerate(shape)),
                                     dtype=buf.dtype, device=buf.device, requires_grad=True)
                out = sweep_affine_slab_plain(canvas, coef, offset, axis, K,
                                              geo._replace(lo=geo.lo - h), ext)
                (dc,) = torch.autograd.grad(out, canvas, gbuf)
                dsrc = dc.narrow(dim, 2 * h, L).contiguous()
            else:
                s = buf.detach().requires_grad_(True)
                out = sweep_affine_slab_plain(s, coef, offset, axis, K, geo, shape)
                (dsrc,) = torch.autograd.grad(out, s, gbuf)
    return dsrc


def _slab_pass(buf, table, p, axis, K, geo, shape):
    if buf.is_cuda:
        return _fwd_slab(buf, table, p, axis, K, geo, shape)
    if buf.device.type == "cpu":
        with torch.no_grad():
            return sweep_affine_slab_plain(buf, *_row_of(table, p), axis, K, geo, shape)
    raise _no_path(buf)


def _slab_pass_bwd(gbuf, buf, table, p, axis, K, geo, shape, need_src, dtable, work):
    if buf.is_cuda:
        return _bwd_slab(gbuf, buf, table, p, axis, K, geo, shape, need_src, dtable, work)
    return _slab_bwd_plain(gbuf, buf, table, p, axis, K, geo, shape, need_src, dtable)


class _SlabAffine(torch.autograd.Function):
    """A separable affine warp of a volume split into slabs, one launch a
    slab a pass forward and backward (on a CPU slab the plain versions):
    the pass along the split axis reads each slab's buffer with its halo,
    and its backward the upstream gradient's halo (``parallel/halo.py``).
    ``table`` (one, or one per batch item) lives on the mesh's first device
    and a copy goes to each slab's; the table's gradient is each slab's
    share summed in ascending slab order on the table's device."""

    @staticmethod
    def forward(ctx, table, axes, windows, geos, *slabs):
        from ...parallel import halo

        split = geos[0].axis
        tables = [table if s.device == table.device else table.to(s.device) for s in slabs]
        shape = tuple(slabs[0].shape)
        cur, saved = list(slabs), []
        for p, (axis, K) in enumerate(zip(axes, windows)):
            bufs = (halo.fetch(cur, 2 + axis, slab_halo(K), slab_halo(K)) if axis == split
                    else cur)
            cur = [_slab_pass(b, t, p, axis, K, geo, shape)
                   for b, t, geo in zip(bufs, tables, geos)]
            saved += bufs
        ctx.save_for_backward(table, *tables, *saved)
        ctx.axes, ctx.windows, ctx.geos, ctx.shape = axes, windows, geos, shape
        return tuple(cur)

    @staticmethod
    @native.differentiable_once
    def backward(ctx, *gs):
        from ...parallel import halo
        from ...parallel.mesh import ordered_sum

        n = len(gs)
        table, *rest = ctx.saved_tensors
        tables, saved = rest[:n], rest[n:]
        need_table = ctx.needs_input_grad[0]
        need_src = any(ctx.needs_input_grad[4:])
        split, shape = ctx.geos[0].axis, ctx.shape
        dtables = [torch.zeros_like(t) if need_table else None for t in tables]
        works = [None] * n
        if need_table and tables[0].is_cuda:
            items = _items(table)[1]
            works = [_slab_work(shape, ctx.axes, ctx.windows, geo, items, t.device)
                     for geo, t in zip(ctx.geos, tables)]
        g = [x.to(saved[0].dtype).contiguous() for x in gs]
        for p in reversed(range(len(ctx.axes))):
            want_src = p > 0 or need_src
            if not (want_src or need_table):
                break
            axis, K = ctx.axes[p], ctx.windows[p]
            gb = halo.fetch(g, 2 + axis, slab_halo(K), slab_halo(K)) if axis == split else g
            g = [_slab_pass_bwd(gb[k], saved[p * n + k], tables[k], p, axis, K, ctx.geos[k],
                                shape, want_src, dtables[k], works[k]) for k in range(n)]
        dtable = ordered_sum(dtables, table.device) if need_table else None
        return (dtable, None, None, None, *(g if need_src else [None] * n))


def _geos(src) -> tuple:
    """The :class:`SlabGeo` of each slab of a ``Sharded`` volume split along
    a spatial dim."""
    dim, _ = src.slab_axis()
    if dim < 2:
        raise ValueError(f"K1's slab mode splits a spatial dim, got a split along dim {dim}")
    m = src.shards[0].shape[dim]
    return tuple(SlabGeo(dim - 2, k * m, src.shape[dim]) for k in range(len(src.shards)))


def sweep_affine_slabs(src, passes, windows: Sequence[int], twice: bool = False):
    """:func:`sweep_affine_passes` on a volume split into slabs (``src`` a
    ``parallel.mesh.Sharded`` of ``[N, C, *S]`` split along one spatial
    dim): each slab's passes in the slab mode on its device (the kernels on
    the card, the plain versions on the CPU), the warp a ``Sharded`` laid
    out as ``src``, equal to the unsharded warp's to the bit; differentiable
    once in the slabs and the passes' rows, or with ``twice`` twice (a chain
    of :class:`_SlabPass`, whose second order is ``sweep_slab_bwd2``)."""
    from ...parallel.mesh import from_blocks

    geos = _geos(src)
    table, axes = pass_table(passes)
    windows = tuple(int(K) for K in windows)
    if twice:
        outs = tuple(src.shards)
        for p, (axis, K) in enumerate(zip(axes, windows)):
            outs = _SlabPass.apply(table, p, axis, K, geos, *outs)
    else:
        outs = _SlabAffine.apply(table, axes, windows, geos, *src.shards)
    return from_blocks(list(outs), src.sharding, src.shape)


# --------------------------------------------- slabs: the second order (LM)


def _bwd2_slab(gbuf, buf, ubuf, table, p, axis, K, geo, shape, rtable, need_g, need_src,
               dtable, work=None):
    """``(gbar, sbar)`` of one slab pass's backward (``sweep_slab_bwd2``):
    ``gbuf``, ``buf`` and ``ubuf`` (None: zeros) laid out as the pass's
    source buffer, the outputs the slab's; the slab's share of the row's
    gradient into ``dtable[..., p, :]`` when given."""
    gbar = torch.empty(shape, dtype=buf.dtype, device=buf.device) if need_g else None
    sbar = torch.empty(shape, dtype=buf.dtype, device=buf.device) if need_src else None
    stride, items = _items(table)
    outer, L, inner, Z, Y, X, vaxis = _image(shape, axis)
    if dtable is not None and work is None:
        work = _slab_work(shape, (axis,), (K,), geo, items, buf.device)
    LIB.launch("sweep_slab_bwd2", buf, gbuf.data_ptr(), buf.data_ptr(), _row(table, p),
               None if ubuf is None else ubuf.data_ptr(), _row(rtable, p),
               None if gbar is None else gbar.data_ptr(),
               None if sbar is None else sbar.data_ptr(),
               None if work is None else work.data_ptr(),
               None if dtable is None else _row(dtable, p), outer, L, inner, K,
               _DTYPES[buf.dtype], len(shape) - 2, Z, Y, X, vaxis, shape[1], stride,
               *_slab_args(shape, axis, K, geo))
    native.bump(__name__, bwd2_launches=1, bwd2_modes={"slab": 1})
    return gbar, sbar


def affine_slab_bwd2(gbuf: torch.Tensor, buf: torch.Tensor, ubuf: torch.Tensor | None,
                     table: torch.Tensor, p: int, axis: int, K: int, geo: SlabGeo, shape,
                     rbar: torch.Tensor, need_g: bool = True, need_src: bool = True,
                     need_table: bool = True):
    """The second order of :func:`affine_slab_fwd` on a slab (the slab mode
    of :func:`affine_bwd2`): ``gbuf``, ``buf`` and ``ubuf`` (the cotangent
    of dsrc; None: zeros) laid out as the source buffer, ``rbar`` the
    cotangent of the row's gradient; returns ``(gbar, sbar, drow)``, the
    slab's own, ``drow`` its share."""
    shape = tuple(shape)
    _check_slab(buf, table, axis, int(K), geo, shape)
    for name, t in (("g", gbuf), ("ubar", ubuf)):
        if t is not None and (t.shape != buf.shape or t.dtype != buf.dtype):
            raise ValueError(f"K1's slab second order needs {name} laid out and typed as the "
                             "source buffer")
    _check_on(buf, table=table, g=gbuf, **({} if ubuf is None else {"ubar": ubuf}))
    rtable = torch.zeros_like(table)
    rtable[..., p, :] = rbar
    dtable = torch.zeros_like(table) if need_table else None
    gbar, sbar = _bwd2_slab(gbuf, buf, ubuf, table, p, axis, int(K), geo, shape, rtable,
                            need_g, need_src, dtable)
    return gbar, sbar, None if dtable is None else dtable[..., p, :]


def sweep_bwd2_slab_plain(gbuf: torch.Tensor, buf: torch.Tensor, ubuf: torch.Tensor | None,
                          rbar: torch.Tensor, coef: torch.Tensor, offset, axis: int, K: int,
                          geo: SlabGeo, shape):
    """Plain version of :func:`affine_slab_bwd2` (one table): the formulas
    of :func:`sweep_bwd2_plain` at every position of the buffers (the
    volume's positions and coordinates, on a canvas with ``K + 1`` zero rows
    a side), then gbar and sbar at the slab's own rows and the row's
    gradient from its own outputs. gbar and sbar are the unsharded plain
    version's to the bit."""
    shape = tuple(shape)
    d = len(shape) - 2
    dim = 2 + axis
    K = int(K)
    _, _, _, p0, b0, Lb, Xg = _slab_args(shape, axis, K, geo)
    h = slab_halo(K)
    bshape = tuple(buf.shape)
    starts = [geo.lo if b == geo.axis else 0 for b in range(d)]
    starts[axis] = b0
    q = _axis_coord_grid(coef.to(torch.float32), offset, bshape[2:], starts).expand(bshape)
    v = _axis_coord_grid(rbar[:-1], rbar[-1], bshape[2:], starts).expand(bshape)
    fr, mf, mc, fi, ci = _slab_taps(q, dim, K, b0, b0 - h, Lb + 2 * h, Xg)
    pad = _plain_pad(dim, len(bshape))
    pad[-2:] = [h, h]

    def taps(x):
        x = torch.nn.functional.pad(x.to(torch.float32), pad)
        return (torch.where(mf, torch.gather(x, dim, fi), 0.0),
                torch.where(mc, torch.gather(x, dim, ci), 0.0))

    sf, sc = taps(buf)
    uf, uc = taps(ubuf) if ubuf is not None else (torch.zeros_like(sf), torch.zeros_like(sf))
    gf = gbuf.to(torch.float32)
    own = p0 - b0
    L = shape[dim]
    gbar = (torch.where(mf, uf * (1.0 - fr), 0.0) + torch.where(mc, uc * fr, 0.0)
            + v * (sc - sf)).narrow(dim, own, L)
    w = v * gf
    canvas = torch.zeros(tuple(Lb + 2 * h if i == dim else n for i, n in enumerate(bshape)),
                         dtype=torch.float32, device=buf.device)
    canvas = canvas.scatter_add(dim, ci, torch.where(mc, w, 0.0))
    canvas = canvas.scatter_add(dim, fi, torch.where(mf, -w, 0.0))
    sbar = canvas.narrow(dim, own + h, L)
    dd = (gf * (uc - uf)).narrow(dim, own, L)
    ostarts = [geo.lo if b == geo.axis else 0 for b in range(d)]
    coords = [torch.arange(ostarts[a], ostarts[a] + n, dtype=torch.float32,
                           device=buf.device).view(tuple(n if i == a else 1 for i in range(d)))
              for a, n in enumerate(shape[2:])]
    drow = torch.stack([t.sum() for t in [dd * c for c in coords] + [dd]])
    return gbar.to(gbuf.dtype), sbar.to(buf.dtype), drow


def _slab_bwd2(gbuf, buf, ubuf, table, p, axis, K, geo, shape, rtable, need_g, need_src,
               dtable, work):
    if buf.is_cuda:
        return _bwd2_slab(gbuf, buf, ubuf, table, p, axis, K, geo, shape, rtable, need_g,
                          need_src, dtable, work)
    if table.ndim == 3:  # a table per item: each item's own call, as a single table's
        one = tuple(shape[1:])
        outs = [_slab_bwd2(gbuf[b:b + 1], buf[b:b + 1], None if ubuf is None else ubuf[b:b + 1],
                           table[b], p, axis, K, geo, (1, *one), rtable[b], need_g, need_src,
                           None if dtable is None else dtable[b], work)
                for b in range(table.shape[0])]
        return tuple(torch.cat([o[i] for o in outs]) if outs[0][i] is not None else None
                     for i in range(2))
    gbar, sbar, drow = sweep_bwd2_slab_plain(gbuf, buf, ubuf, rtable[p], *_row_of(table, p),
                                             axis, K, geo, shape)
    if dtable is not None:
        dtable[p] = drow
    return gbar if need_g else None, sbar if need_src else None


def _halo_of(slabs, axis, K, geos):
    """The slabs' buffers for a pass along ``axis``: with ``slab_halo(K)``
    rows a side along the split axis, the slabs themselves across it."""
    from ...parallel import halo

    if axis != geos[0].axis:
        return [s.contiguous() for s in slabs]
    h = slab_halo(K)
    return halo.fetch([s.contiguous() for s in slabs], 2 + axis, h, h)


class _SlabPass(torch.autograd.Function):
    """One pass of a separable affine warp on slabs (row ``p`` of
    ``table``), differentiable twice: its backward is
    :class:`_SlabPassBwd`."""

    @staticmethod
    def forward(ctx, table, p, axis, K, geos, *slabs):
        shape = tuple(slabs[0].shape)
        tables = [table if s.device == table.device else table.to(s.device) for s in slabs]
        bufs = _halo_of(slabs, axis, K, geos)
        ctx.save_for_backward(table, *slabs)
        ctx.p, ctx.axis, ctx.K, ctx.geos = p, axis, K, geos
        return tuple(_slab_pass(b, t, p, axis, K, geo, shape)
                     for b, t, geo in zip(bufs, tables, geos))

    @staticmethod
    def backward(ctx, *gs):
        table, *slabs = ctx.saved_tensors
        need_table = ctx.needs_input_grad[0]
        need_src = any(ctx.needs_input_grad[5:])
        out = _SlabPassBwd.apply(table, ctx.p, ctx.axis, ctx.K, ctx.geos, need_src, need_table,
                                 len(slabs), *gs, *slabs)
        return (out[-1], None, None, None, None, *out[:-1])


class _SlabPassBwd(torch.autograd.Function):
    """The backward of one slab pass, ``(table, g slabs, src slabs) ->
    (dsrc slabs, dtable)`` (``dtable`` zero but for row ``p``, each slab's
    share summed in ascending slab order; either None when not needed); its
    backward launches ``sweep_slab_bwd2`` on each slab, with the halos of
    ``g``, ``src`` and ``ubar`` along the split axis."""

    @staticmethod
    def forward(ctx, table, p, axis, K, geos, need_src, need_table, n, *gs_slabs):
        from ...parallel.mesh import ordered_sum

        gs, slabs = gs_slabs[:n], gs_slabs[n:]
        shape = tuple(slabs[0].shape)
        tables = [table if s.device == table.device else table.to(s.device) for s in slabs]
        gs = [g.to(s.dtype).contiguous() for g, s in zip(gs, slabs)]
        bufs, gbufs = _halo_of(slabs, axis, K, geos), _halo_of(gs, axis, K, geos)
        dtables = [torch.zeros_like(t) if need_table else None for t in tables]
        dsrc = [_slab_pass_bwd(gb, b, t, p, axis, K, geo, shape, need_src, dt, None)
                for gb, b, t, geo, dt in zip(gbufs, bufs, tables, geos, dtables)]
        ctx.save_for_backward(table, *gs, *slabs)
        ctx.p, ctx.axis, ctx.K, ctx.geos, ctx.n = p, axis, K, geos, n
        ctx.set_materialize_grads(False)
        dtable = ordered_sum(dtables, table.device) if need_table else None
        return (*(dsrc if need_src else [None] * n), dtable)

    @staticmethod
    @native.differentiable_once
    def backward(ctx, *bars):
        from ...parallel.mesh import ordered_sum

        n, p, axis, K, geos = ctx.n, ctx.p, ctx.axis, ctx.K, ctx.geos
        table, *rest = ctx.saved_tensors
        gs, slabs = rest[:n], rest[n:]
        ubars, dtable_bar = bars[:n], bars[n]
        need_table = ctx.needs_input_grad[0]
        need_g = any(ctx.needs_input_grad[8:8 + n])
        need_src = any(ctx.needs_input_grad[8 + n:])
        shape = tuple(slabs[0].shape)
        tables = [table if s.device == table.device else table.to(s.device) for s in slabs]
        rbar = (torch.zeros_like(table) if dtable_bar is None
                else dtable_bar.to(torch.float32).contiguous())
        rtables = [rbar if s.device == rbar.device else rbar.to(s.device) for s in slabs]
        bufs, gbufs = _halo_of(slabs, axis, K, geos), _halo_of(gs, axis, K, geos)
        ubufs = [None] * n
        if any(u is not None for u in ubars):
            ubufs = _halo_of([torch.zeros_like(s) if u is None else u.to(s.dtype).contiguous()
                              for u, s in zip(ubars, slabs)], axis, K, geos)
        dtables = [torch.zeros_like(t) if need_table else None for t in tables]
        works = [None] * n
        if need_table and tables[0].is_cuda:
            works = [_slab_work(shape, (axis,), (K,), geo, _items(table)[1], t.device)
                     for geo, t in zip(geos, tables)]
        outs = [_slab_bwd2(gb, b, ub, t, p, axis, K, geo, shape, rt, need_g, need_src, dt, w)
                for gb, b, ub, t, geo, rt, dt, w in zip(gbufs, bufs, ubufs, tables, geos,
                                                         rtables, dtables, works)]
        dtable = ordered_sum(dtables, table.device) if need_table else None
        return (dtable, None, None, None, None, None, None, None,
                *[o[0] for o in outs], *[o[1] for o in outs])


# ----------------------------------------------------- slabs: the flow form


def _check_slab_flow(buf, flow, axis, K, geo, shape, fbuf=False) -> None:
    _check_image(buf)
    d = buf.ndim - 2
    if axis != geo.axis or K < 0:
        raise ValueError(f"K1's flow slab mode sweeps the split axis {geo.axis} with K >= 0, "
                         f"got axis {axis}, K {K}")
    Lb = _slab_args(shape, axis, K, geo)[5]
    want = tuple(Lb if i == 2 + axis else s for i, s in enumerate(shape))
    if tuple(buf.shape) != want:
        raise ValueError(f"K1's flow slab mode needs a source buffer {want} for a slab "
                         f"{tuple(shape)} with K = {K}, got {tuple(buf.shape)}")
    fwant = (shape[0], 1 if fbuf else d, *(want if fbuf else shape)[2:])
    if flow.dtype != torch.float32 or tuple(flow.shape) != fwant:
        raise ValueError(f"K1's flow slab mode needs a float32 field {fwant}, got "
                         f"{flow.dtype} {tuple(flow.shape)}")
    L = shape[2 + axis]
    if geo.lo < 0 or geo.lo + L > geo.extent:
        raise ValueError(f"K1's slab mode: a slab of {L} rows from {geo.lo} is not inside "
                         f"{geo.extent}")


def _fwd_slab_flow(buf, flow, axis, K, geo, shape):
    out = torch.empty(shape, dtype=buf.dtype, device=buf.device)
    outer, L, inner, Z, Y, X, vaxis = _image(shape, axis)
    LIB.launch("sweep_slab_flow_fwd", buf, buf.data_ptr(), _channel(flow, axis), out.data_ptr(),
               outer, L, inner, K, _DTYPES[buf.dtype], Z, Y, X, vaxis, shape[1],
               flow.stride(0), *_slab_args(shape, axis, K, geo)[3:])
    _count(True, "slab_flow")
    return out


def _bwd_slab_flow(gbuf, buf, ubuf, axis, K, geo, shape, need_src, dflow):
    """dsrc (or None) of one flow pass along the split axis, ``gbuf`` and
    ``ubuf`` (channel ``axis`` of the field, ``[N, 1, ...]``) laid out as
    ``buf``; the field's gradient into channel ``axis`` of ``dflow`` (the
    slab's) when given (summed over src's channels)."""
    C = shape[1]
    outer, L, inner, Z, Y, X, vaxis = _image(shape, axis)
    dsrc = torch.empty(shape, dtype=buf.dtype, device=buf.device) if need_src else None
    du, du_ptr, dqn, dqc = None, None, 0, 0
    if dflow is not None:
        if C == 1:
            du_ptr, dqn = _channel(dflow, axis), dflow.stride(0)
        else:
            du = torch.empty(shape, dtype=torch.float32, device=buf.device)
            du_ptr, dqn, dqc = du.data_ptr(), du.stride(0), du.stride(1)
    LIB.launch("sweep_slab_flow_bwd", buf, gbuf.data_ptr(), buf.data_ptr(), ubuf.data_ptr(),
               None if dsrc is None else dsrc.data_ptr(), du_ptr, outer, L, inner, K,
               _DTYPES[buf.dtype], Z, Y, X, vaxis, C, ubuf.stride(0), dqn, dqc,
               *_slab_args(shape, axis, K, geo)[3:])
    _count(False, "slab_flow")
    if du is not None:
        dflow[:, axis].copy_(du.sum(1))
    return dsrc


def flow_slab_fwd(buf: torch.Tensor, flow: torch.Tensor, axis: int, K: int, geo: SlabGeo,
                  shape) -> torch.Tensor:
    """One flow pass along the split axis on a slab (the flow form's slab
    mode): the slab ``shape``'s outputs at ``q = o_axis + flow[:, axis]``
    (``flow`` the slab's field ``[N, d, *slab]``, positions the volume's),
    from ``buf``, the slab with ``slab_halo(K)`` rows of the volume a side
    (zeros past it)."""
    shape = tuple(shape)
    _check_slab_flow(buf, flow, axis, int(K), geo, shape)
    _check_on(buf, flow=flow)
    return _fwd_slab_flow(buf, flow, axis, int(K), geo, shape)


def flow_slab_bwd(gbuf: torch.Tensor, buf: torch.Tensor, ubuf: torch.Tensor, axis: int, K: int,
                  geo: SlabGeo, shape, need_src: bool = True, need_flow: bool = True):
    """The backward of :func:`flow_slab_fwd`: ``(dsrc, du)``, the slab's,
    from ``gbuf`` (the upstream gradient) and ``ubuf`` (channel ``axis`` of
    the field, ``[N, 1, ...]``) laid out as ``buf`` (each with its halo: the
    halo's outputs reach the slab's rows), ``du [N, *slab]`` the gradient of
    the slab's ``flow[:, axis]``; either may be skipped (None)."""
    shape = tuple(shape)
    _check_slab_flow(buf, ubuf, axis, int(K), geo, shape, fbuf=True)
    if gbuf.shape != buf.shape or gbuf.dtype != buf.dtype:
        raise ValueError("K1's slab backward needs g laid out and typed as the source buffer")
    _check_on(buf, g=gbuf, flow=ubuf)
    d = len(shape) - 2
    dflow = (torch.empty((shape[0], d, *shape[2:]), dtype=torch.float32, device=buf.device)
             if need_flow else None)
    dsrc = _bwd_slab_flow(gbuf, buf, ubuf, axis, int(K), geo, shape, need_src, dflow)
    return dsrc, None if dflow is None else dflow[:, axis]


def sweep_flow_slab_plain(buf: torch.Tensor, flow: torch.Tensor, axis: int, K: int,
                          geo: SlabGeo, shape) -> torch.Tensor:
    """Plain version of the flow form's slab mode: :func:`sweep_flow_plain`
    of the slab ``shape``'s outputs at the volume's positions (``flow`` the
    field's channel ``axis`` at those outputs, ``[N, 1, *slab]``) on the
    buffer ``buf``; differentiable in ``buf`` and ``flow``. Each output is
    the unsharded plain pass's to the bit."""
    shape = tuple(shape)
    d = len(shape) - 2
    dim = 2 + axis
    _, _, _, p0, b0, Lb, Xg = _slab_args(shape, axis, int(K), geo)
    L = shape[dim]
    ident = torch.arange(p0, p0 + L, dtype=torch.float32, device=flow.device)
    ident = ident.view(tuple(L if i == axis else 1 for i in range(d)))
    q = (flow[:, 0].to(torch.float32)[:, None] + ident).expand(shape)
    fr, mf, mc, fi, ci = _slab_taps(q, dim, int(K), p0, b0, Lb, Xg)
    src = buf.to(torch.float32)
    vf = torch.where(mf, torch.gather(src, dim, fi), 0.0)
    vc = torch.where(mc, torch.gather(src, dim, ci), 0.0)
    out = torch.where(mf, vf * (1.0 - fr), 0.0) + torch.where(mc, vc * fr, 0.0)
    return out.to(buf.dtype)


def _flow_slab_bwd_plain(gbuf, buf, ubuf, axis, K, geo, shape, need_src, dflow):
    """The plain slab backward of a flow pass, in the kernel's way: dsrc
    gathered from the upstream gradient of every output that reaches the
    slab's rows (those of the halo, at the field's halo, on a zero canvas of
    the sources they reach), du from the slab's own outputs."""
    dim = 2 + axis
    h = slab_halo(K)
    L = shape[dim]
    dsrc = None
    with torch.enable_grad():
        if dflow is not None:
            u = ubuf.narrow(dim, h, L).detach().clone().requires_grad_(True)
            out = sweep_flow_slab_plain(buf.detach(), u, axis, K, geo, shape)
            (du,) = torch.autograd.grad(out, u, gbuf.narrow(dim, h, L))
            dflow[:, axis] = du[:, 0]
        if need_src:
            ext = tuple(L + 2 * h if i == dim else s for i, s in enumerate(shape))
            canvas = torch.zeros(tuple(L + 4 * h if i == dim else s for i, s in enumerate(shape)),
                                 dtype=buf.dtype, device=buf.device, requires_grad=True)
            out = sweep_flow_slab_plain(canvas, ubuf.detach(), axis, K,
                                        geo._replace(lo=geo.lo - h), ext)
            (dc,) = torch.autograd.grad(out, canvas, gbuf)
            dsrc = dc.narrow(dim, 2 * h, L).contiguous()
    return dsrc


def _flow_pass(src, flow, axis, K):
    """One flow pass across the split axis on a slab (slab-local: its
    positions along ``axis`` are the volume's)."""
    if src.is_cuda:
        return _fwd_flow(src, flow, axis, K)
    if src.device.type == "cpu":
        with torch.no_grad():
            return sweep_flow_plain(src, flow, axis, K)
    raise _no_path(src)


def _flow_pass_bwd(g, src, flow, axis, K, need_src, dflow):
    if src.is_cuda:
        return _bwd_flow(g, src, flow, axis, K, need_src, dflow)
    with torch.enable_grad():
        s = src.detach().requires_grad_(need_src)
        u = flow.detach().requires_grad_(dflow is not None)
        out = sweep_flow_plain(s, u, axis, K)
        wrt = [t for t in (s, u) if t.requires_grad]
        grads = list(torch.autograd.grad(out, wrt, g)) if wrt else []
    if dflow is not None:
        dflow[:, axis] = grads[-1][:, axis]
    return grads[0] if need_src else None


def _slab_flow_pass(buf, flow, axis, K, geo, shape):
    if buf.is_cuda:
        return _fwd_slab_flow(buf, flow, axis, K, geo, shape)
    if buf.device.type == "cpu":
        with torch.no_grad():
            return sweep_flow_slab_plain(buf, flow[:, axis:axis + 1], axis, K, geo, shape)
    raise _no_path(buf)


def _slab_flow_pass_bwd(gbuf, buf, ubuf, axis, K, geo, shape, need_src, dflow):
    if buf.is_cuda:
        return _bwd_slab_flow(gbuf, buf, ubuf, axis, K, geo, shape, need_src, dflow)
    return _flow_slab_bwd_plain(gbuf, buf, ubuf, axis, K, geo, shape, need_src, dflow)


class _SlabFlow(torch.autograd.Function):
    """A separable flow warp of a volume split into slabs by a field split
    alike, x-pass first: the passes across the split axis slab by slab, the
    pass along it in the flow form's slab mode (the slab's buffer with a
    halo of ``K + 1`` rows a side; its backward the halos of the upstream
    gradient and of the field's channel). One launch a slab a pass forward
    and backward (on a CPU slab the plain versions). The warp and dsrc equal
    the unsharded launch's to the bit; each slab's field gets its own
    gradient (no gradient flows through the field's halo)."""

    @staticmethod
    def forward(ctx, K, geos, n, *slabs_flows):
        slabs, flows = slabs_flows[:n], slabs_flows[n:]
        split = geos[0].axis
        shape = tuple(slabs[0].shape)
        d = len(shape) - 2
        cur, saved = list(slabs), []
        for axis in range(d - 1, -1, -1):
            if axis == split:
                bufs = _halo_of(cur, axis, K, geos)
                cur = [_slab_flow_pass(b, f, axis, K, geo, shape)
                       for b, f, geo in zip(bufs, flows, geos)]
            else:
                bufs = cur
                cur = [_flow_pass(c, f, axis, K) for c, f in zip(cur, flows)]
            saved += bufs
        ctx.save_for_backward(*flows, *saved)
        ctx.K, ctx.geos, ctx.n, ctx.shape = K, geos, n, shape
        return tuple(cur)

    @staticmethod
    @native.differentiable_once
    def backward(ctx, *gs):
        n, K, geos, shape = ctx.n, ctx.K, ctx.geos, ctx.shape
        flows, saved = ctx.saved_tensors[:n], ctx.saved_tensors[n:]
        split = geos[0].axis
        d = len(shape) - 2
        need_src = any(ctx.needs_input_grad[3:3 + n])
        need_flow = any(ctx.needs_input_grad[3 + n:])
        dflows = [torch.empty_like(f) if need_flow else None for f in flows]
        g = [x.to(saved[0].dtype).contiguous() for x in gs]
        for p in reversed(range(d)):  # pass p swept axis d - 1 - p
            axis = d - 1 - p
            want_src = p > 0 or need_src
            if not (want_src or need_flow):
                break
            bufs = saved[p * n:(p + 1) * n]
            if axis == split:
                gb = _halo_of(g, axis, K, geos)
                ub = _halo_of([f[:, axis:axis + 1] for f in flows], axis, K, geos)
                g = [_slab_flow_pass_bwd(gb[k], bufs[k], ub[k], axis, K, geos[k], shape,
                                         want_src, dflows[k]) for k in range(n)]
            else:
                g = [_flow_pass_bwd(g[k], bufs[k], flows[k], axis, K, want_src, dflows[k])
                     for k in range(n)]
        return (None, None, None, *(g if need_src else [None] * n),
                *(dflows if need_flow else [None] * n))


def sweep_flow_slabs(src, flow, K: int):
    """:func:`sweep_flow_passes` on a volume split into slabs: ``src`` and
    ``flow`` ``parallel.mesh.Sharded`` split alike along one spatial dim,
    each slab's passes on its device (the kernels on the card, the plain
    versions on the CPU); the warp a ``Sharded`` laid out as ``src``, equal
    to the unsharded warp's to the bit; differentiable once in the slabs and
    the field's."""
    from ...parallel.mesh import Sharded, from_blocks

    if not (isinstance(src, Sharded) and isinstance(flow, Sharded)) or (
            src.sharding.spec[2:] != flow.sharding.spec[2:] or src.mesh is not flow.mesh):
        raise ValueError("a flow warp on slabs needs the volume and the field split alike")
    geos = _geos(src)
    d = src.ndim - 2
    if flow.shape[1] != d or flow.shape[0] != src.shape[0] or flow.shape[2:] != src.shape[2:]:
        raise ValueError(f"K1 needs a field [N, {d}, *S] of src {tuple(src.shape)}, got "
                         f"{tuple(flow.shape)}")
    flows = [f.to(torch.float32).contiguous() for f in flow.shards]
    outs = _SlabFlow.apply(int(K), geos, len(geos), *src.shards, *flows)
    return from_blocks(list(outs), src.sharding, src.shape)
