"""K1: the sweep resampler kernel pair (``csrc/sweep.cu``) and its plain version.

Counterpart of ``torchregister_tpu/ops/pallas/sweep.py``. :func:`sweep`
linearly resamples a tensor along one dimension at per-element coordinates
``q`` inside the static window ``[-K, K+1]`` (see the note at the top of
``csrc/sweep.cu`` for the exact tap semantics). It is differentiable in both
the source and the coordinates.

Dispatch is by device only: a CPU tensor takes :func:`sweep_plain`, a CUDA
tensor launches the kernel (built from the package's own source at first
use) or raises. There is no fallback from the kernel to the plain version.

``fwd_launches`` and ``bwd_launches`` count kernel launches, so a run can
show that its path went through the kernel; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "sweep.cu"

fwd_launches = 0
bwd_launches = 0

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def build() -> Path:
    """Compile ``csrc/sweep.cu`` into ``_build/`` and return its path."""
    return native.build_cuda(SOURCE, "sweep")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sweep_fwd.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i64, i32, i32, ptr]
        lib.sweep_fwd.restype = ctypes.c_int
        lib.sweep_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i64, i32, i32,
                                  ptr]
        lib.sweep_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"K1 {what} launch failed: cudaError {rc}")


def _geometry(x: torch.Tensor, dim: int):
    shape = x.shape
    outer = 1
    for s in shape[:dim]:
        outer *= s
    inner = 1
    for s in shape[dim + 1:]:
        inner *= s
    return outer, shape[dim], inner


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


def sweep_fwd(src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
              with_diff: bool = False):
    """Launch the forward kernel: ``(out, diff)`` with ``out`` in ``src``'s
    dtype and ``diff`` (f32, ceil - floor) only when ``with_diff``."""
    global fwd_launches
    _validate(src, q, K)
    outer, X, inner = _geometry(src, dim)
    out = torch.empty_like(src)
    diff = torch.empty_like(q) if with_diff else None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().sweep_fwd(src.data_ptr(), q.data_ptr(), out.data_ptr(),
                              diff.data_ptr() if with_diff else None,
                              outer, X, inner, int(K), _DTYPES[src.dtype], stream)
    _check(rc, "forward")
    fwd_launches += 1
    return out, diff


def sweep_bwd(g: torch.Tensor, src: torch.Tensor, q: torch.Tensor, dim: int, K: int,
              need_src: bool = True, need_q: bool = True):
    """Launch the backward kernel: ``(dsrc, dq)``; either may be skipped
    (returned as None) when its input needs no gradient."""
    global bwd_launches
    _validate(src, q, K)
    if g.shape != src.shape or g.dtype != src.dtype or not g.is_contiguous():
        raise ValueError("K1 backward needs a contiguous g shaped and typed as src")
    outer, X, inner = _geometry(src, dim)
    dsrc = torch.empty_like(src) if need_src else None
    dq = torch.empty_like(q) if need_q else None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().sweep_bwd(g.data_ptr(), src.data_ptr(), q.data_ptr(),
                              dsrc.data_ptr() if need_src else None,
                              dq.data_ptr() if need_q else None,
                              outer, X, inner, int(K), _DTYPES[src.dtype], stream)
    _check(rc, "backward")
    bwd_launches += 1
    return dsrc, dq


class _Sweep(torch.autograd.Function):
    """K1 forward and backward; q may broadcast against src (dq is summed
    back to q's shape, as JAX autodiff does for a broadcast operand)."""

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


def sweep(src: torch.Tensor, q: torch.Tensor, dim: int, K: int) -> torch.Tensor:
    """Resample ``src`` along ``dim`` at coordinates ``q`` (broadcastable to
    ``src``) within the window ``[-K, K+1]``; output in ``src``'s dtype."""
    if src.is_cuda:
        return _Sweep.apply(src, q, dim, int(K))
    if src.device.type == "cpu":
        return sweep_plain(src, q, dim, int(K))[0]
    raise RuntimeError(f"K1 has no path for device {src.device}")
