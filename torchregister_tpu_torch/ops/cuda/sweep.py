"""K1: the sweep resampler kernels (``csrc/sweep.cu``) and their plain versions.

Counterpart of ``torchregister_tpu/ops/pallas/sweep.py``. A sweep linearly
resamples a tensor along one dimension at per-element coordinates ``q``
inside the static window ``[-K, K+1]`` (see the note at the top of
``csrc/sweep.cu`` for the exact tap semantics), differentiably in the source
and the coordinates. The kernels take ``q`` in one of three forms:

- dense: a ``q`` tensor (:func:`sweep`, :func:`sweep_fwd`, :func:`sweep_bwd`);
- affine: one pass of a separable affine warp, ``q = coef . o + offset``
  from one row of a ``[d, d+1]`` table (:func:`sweep_affine_passes`, a whole
  warp in one autograd Function; the gradient of each row is reduced in the
  kernel);
- flow: one pass of a dense-flow warp, ``q = o_a + flow_a(o)``
  (:func:`sweep_flow_passes`; the field's gradient is written channel by
  channel into one buffer).

Dispatch is by device only: a CPU tensor takes the plain versions
(:func:`sweep_plain`, :func:`sweep_affine_plain`, :func:`sweep_flow_plain`),
a CUDA tensor launches the kernels (built from the package's own source at
first use) or raises. There is no fallback from the kernels to the plain
versions.

``fwd_launches`` and ``bwd_launches`` count kernel launches, and
``fwd_modes`` / ``bwd_modes`` split them by the form of ``q``, so a run can
show that its path went through the kernels and which form ran (a CUDA
graph's replays add the launches it captured, ``engines/graph.py``);
:func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "sweep.cu"

fwd_launches = 0
bwd_launches = 0
fwd_modes = {"dense": 0, "affine": 0, "flow": 0}
bwd_modes = {"dense": 0, "affine": 0, "flow": 0}
native.count_launches(__name__, "fwd_launches", "bwd_launches", "fwd_modes", "bwd_modes")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DENSE, _AFFINE, _FLOW = 0, 1, 2
_INT32 = 2**31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = native.Library(SOURCE, "sweep", {
    "sweep_fwd": (_I, [_I, _P, _P, _P, _P, _L, _I, _L] + [_I] * 8 + [_L, _P]),
    "sweep_bwd": (_I, [_I] + [_P] * 7 + [_L, _I, _L] + [_I] * 8 + [_L, _L, _L, _P]),
    "sweep_bwd_work": (_L, [_L, _I, _L, _I]),
})


def reset_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0
    for modes in (fwd_modes, bwd_modes):
        for mode in modes:
            modes[mode] = 0


def _count(forward: bool, mode: str) -> None:
    global fwd_launches, bwd_launches
    if forward:
        fwd_launches += 1
        fwd_modes[mode] += 1
    else:
        bwd_launches += 1
        bwd_modes[mode] += 1


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
    if tuple(table.shape) != (d, d + 1):
        raise ValueError(f"K1 needs a table [{d}, {d + 1}] for a {d}-D image, got "
                         f"{tuple(table.shape)}")
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
    """Address of ``t[p]`` (a float32 tensor), without a view."""
    return t.data_ptr() + 4 * p * t.stride(0)


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
               outer, L, inner, K, _DTYPES[src.dtype], src.ndim - 2, Z, Y, X, vaxis, 1, 0)
    _count(True, "affine")
    return out


@functools.lru_cache(maxsize=64)
def _work_floats(rows, K) -> int:
    n = LIB.fns()["sweep_bwd_work"](*rows, K)
    if n <= 0:
        raise ValueError(f"K1 has no backward tile for rows {rows} and window {K}")
    return n


def _affine_work(src, axes, windows):
    """The affine backward's workspace for passes of ``src`` along ``axes``
    with ``windows`` (one for every pass of a warp: the largest), zeroed:
    its first word counts finished blocks, and each launch leaves it 0."""
    n = max(_work_floats(_rows(src.shape, 2 + a), K) for a, K in zip(axes, windows))
    return torch.zeros(n, dtype=torch.float32, device=src.device)


def _bwd_affine(g, src, table, p, axis, K, need_src, dtable, work=None):
    """dsrc (or None) of one affine pass; the gradient of the pass's table
    row goes into ``dtable[p]`` when ``dtable`` is given (through ``work``,
    made here when not given)."""
    dsrc = torch.empty_like(src) if need_src else None
    if dtable is not None and work is None:
        work = _affine_work(src, (axis,), (K,))
    outer, L, inner, Z, Y, X, vaxis = _image(src.shape, axis)
    LIB.launch("sweep_bwd", src, _AFFINE, g.data_ptr(), src.data_ptr(), _row(table, p),
               None if dsrc is None else dsrc.data_ptr(), None,
               None if work is None else work.data_ptr(),
               None if dtable is None else _row(dtable, p), outer, L, inner, K,
               _DTYPES[src.dtype], src.ndim - 2, Z, Y, X, vaxis, 1, 0, 0, 0)
    _count(False, "affine")
    return dsrc


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
    ``q = table[p, :d] . o + table[p, d]``."""
    _check_index("the row", p, table.shape[0])
    _validate_table(src, table, [axis] * table.shape[0], [K] * table.shape[0])
    return _fwd_affine(src, table, p, axis, int(K))


def affine_bwd(g: torch.Tensor, src: torch.Tensor, table: torch.Tensor, p: int, axis: int,
               K: int, need_src: bool = True, need_table: bool = True):
    """The backward of :func:`affine_fwd`: ``(dsrc, drow)``, ``drow`` the
    gradient of ``table[p]``; either may be skipped (None)."""
    _check_index("the row", p, table.shape[0])
    _validate_table(src, table, [axis] * table.shape[0], [K] * table.shape[0])
    if g.shape != src.shape or g.dtype != src.dtype:
        raise ValueError("K1 backward needs a g shaped and typed as src")
    _check_on(src, g=g)
    dtable = torch.empty_like(table) if need_table else None
    dsrc = _bwd_affine(g, src, table, p, axis, int(K), need_src, dtable)
    return dsrc, None if dtable is None else dtable[p]


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
    (coef, offset) and gets its gradient from the kernels."""

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
    def backward(ctx, g):
        table, *ins = ctx.saved_tensors
        need_src, need_table = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dtable = torch.empty_like(table) if need_table else None
        work = _affine_work(ins[0], ctx.axes, ctx.windows) if need_table else None
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


# ------------------------------------------------------------ plain versions


def sweep_plain(src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
                with_diff: bool = False):
    """Plain PyTorch version of K1 (same semantics, autograd-differentiable):
    the two taps gathered from a zero-padded f32 source. Returns
    ``(out, diff)`` like :func:`sweep_fwd`."""
    shape = torch.broadcast_shapes(src.shape, q.shape)
    X = shape[dim]
    q = q.to(torch.float32).expand(shape)
    q0 = torch.floor(q)
    fr = q - q0
    view = [1] * len(shape)
    view[dim] = X
    k = q0 - torch.arange(X, dtype=torch.float32, device=q.device).view(view)
    mf = (k >= -K) & (k <= K + 1)
    mc = (k >= -K - 1) & (k <= K)
    pad = [0, 0] * (len(shape) - 1 - dim) + [1, 1]
    padded = torch.nn.functional.pad(src.to(torch.float32).expand(shape), pad)
    # padded index = source index + 1; 0 and X+1 are the zero pads
    fi = torch.clamp(q0 + 1.0, 0.0, X + 1.0).long()
    ci = torch.clamp(q0 + 2.0, 0.0, X + 1.0).long()
    vf = torch.where(mf, torch.gather(padded, dim, fi), 0.0)
    vc = torch.where(mc, torch.gather(padded, dim, ci), 0.0)
    out = torch.where(mf, vf * (1.0 - fr), 0.0) + torch.where(mc, vc * fr, 0.0)
    return out.to(src.dtype), (vc - vf) if with_diff else None


def _axis_coord_grid(coef: torch.Tensor, offset, spatial) -> torch.Tensor:
    """``q[o] = coef . o + offset`` over the full grid, shape ``[1, 1, *S]``."""
    d = len(spatial)
    q = offset
    for b in range(d):
        iota = torch.arange(spatial[b], dtype=torch.float32, device=coef.device)
        q = q + coef[b] * iota.view(tuple(spatial[b] if i == b else 1 for i in range(d)))
    return q[None, None]


def sweep_affine_plain(src: torch.Tensor, coef: torch.Tensor, offset, axis: int,
                       K: int) -> torch.Tensor:
    """Plain version of one affine pass: the dense grid of
    ``q = coef . o + offset``, then :func:`sweep_plain` along ``axis``."""
    q = _axis_coord_grid(coef, offset, tuple(src.shape[2:]))
    return sweep_plain(src, q, axis + 2, int(K))[0]


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


def sweep_affine_passes(src: torch.Tensor, passes, windows: Sequence[int]) -> torch.Tensor:
    """A separable affine warp of ``src [N, C, *S]``: each pass
    ``(axis, (coef, offset))`` of ``passes`` (as ``factor_passes`` gives
    them) sweeps ``axis`` at ``q = coef . o + offset`` within its window."""
    windows = tuple(int(K) for K in windows)
    if src.is_cuda:
        table = torch.stack([torch.cat([coef.to(torch.float32),
                                        torch.reshape(offset, (1,)).to(torch.float32)])
                             for _, (coef, offset) in passes])
        return _SeparableAffine.apply(src, table, tuple(a for a, _ in passes), windows)
    if src.device.type == "cpu":
        out = src
        for (axis, (coef, offset)), K in zip(passes, windows):
            out = sweep_affine_plain(out, coef, offset, axis, K)
        return out
    raise _no_path(src)


def sweep_flow_passes(src: torch.Tensor, flow: torch.Tensor, K: int) -> torch.Tensor:
    """A separable flow warp of ``src [N, C, *S]`` by ``flow [N, d, *S]``
    (voxels), x-pass first, each pass within the window ``K``."""
    if src.is_cuda:
        return _SeparableFlow.apply(src, flow.to(torch.float32).contiguous(), int(K))
    if src.device.type == "cpu":
        out = src
        for axis in range(src.ndim - 3, -1, -1):
            out = sweep_flow_plain(out, flow, axis, K)
        return out
    raise _no_path(src)
