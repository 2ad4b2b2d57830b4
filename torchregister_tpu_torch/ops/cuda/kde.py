"""The NMI loss's exact KDE (``csrc/kde.cu``): its two kernels, their plain
versions, and the autograd Functions that make it differentiable twice.

For rows ``s [N, L]``, points ``xi [P]`` and bandwidth ``h``, with ``u =
(s_l - xi_k) / h`` and ``phi(u) = exp(-u^2/2) / (2 pi)`` (``phi' = -u phi``,
``phi'' = (u^2 - 1) phi``):

- ``kde_sum``: ``out[n, k] = sum_l w[n, l] psi(u)``, ``psi`` in ``{phi,
  phi'}``, ``w = 1`` when absent; with ``phi`` and no ``w`` it is the exact
  KDE's sum before the JAX package's ``acc / (h L)``
  (``torchregister_tpu/losses/nmi.py:_kde_accumulate``, ``kde_pdf``);
- ``kde_dot``: ``out[n, l] = sum_k g[n, k] psi(u)``, ``psi`` in ``{phi',
  phi''}``.

Each kernel computes only the terms whose value f32 can hold: a term with
``|s - xi| > CUT h`` (``CUT`` = 14, in ``u``) is below f32's smallest normal
for each of ``phi``, ``phi'`` and ``phi''``, and is not computed; a term
whose difference is NaN or infinite always is. ``kde_dot`` finds each
sample's window of points by binary search where the points are monotone
(``losses/nmi``'s are non-increasing) and takes every point where they are
not; ``kde_sum`` drops each (group of 8 points, tile of 512 samples) pair
whose ranges lie past the cut and, for the rest, lists the tile's samples
within the cut of the group's range. The sums stay in a fixed order, so two
launches agree to the bit and a row's result does not depend on the other
rows. :func:`kde_terms_needed` counts the pairs within the cut, the work
whose exponentials bound the kernels' time.

Both take a one-element int32 flag on the device, the NMI call's branch:
non-zero means the call is on the binned path, and the kernels write zeros
and return (``losses/nmi.nmi`` computes both densities and selects one on
the device, so a CUDA graph captures the step whatever the branch). Nothing
here reads the flag on the host for a CUDA tensor.

:func:`kde_acc` is the entry point: on a CUDA tensor the kernels through
:class:`_KDE`, whose backward ``ds = kde_dot(g, phi') / h`` is the Function
:class:`_KDEGrad`, whose own backward (the LM engines' Hessian) is
``gbar = kde_sum(w = ubar, phi') / h`` and ``sbar = ubar kde_dot(g, phi'') /
h^2``; a third derivative raises (``native.differentiable_once``). On a CPU
tensor it takes the plain version, :func:`kde_sum_plain`: the JAX package's
chunked sum in torch ops, each chunk recomputed in the backward, its
derivatives by autograd; there it reads the flag on the host. Any other
device raises. ``xi`` is detached, as in the JAX package.

``sum_launches`` and ``dot_launches`` count the kernels' launches (a CUDA
graph's replays add the launches it captured); :func:`reset_counts` zeroes
them.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.checkpoint import checkpoint

from ... import native

SOURCE = native.PKG / "csrc" / "kde.cu"
CHUNK = 4096  # samples a block of kde_sum's first stage (kChunk)
PLAIN_CHUNK = 8192  # samples a chunk of the plain version (the JAX package's kde_pdf)
CUT = 14.0  # |u| past which the kernels drop a term (kCut): |psi| < FLT_MIN there
_INV_2PI = 1.0 / (2.0 * math.pi)

sum_launches = 0
dot_launches = 0
native.count_launches(__name__, "sum_launches", "dot_launches")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
LIB = native.Library(SOURCE, "kde", {
    "kde_sum": (_I, [_P] * 6 + [_I, _L, _I, _I, _F, _I, _P]),
    "kde_dot": (_I, [_P] * 5 + [_I, _L, _I, _F, _I, _P]),
})


def reset_counts() -> None:
    global sum_launches, dot_launches
    sum_launches = 0
    dot_launches = 0


def _check(s: torch.Tensor, xis: torch.Tensor) -> None:
    if s.ndim != 2 or xis.ndim != 1:
        raise ValueError(f"the KDE takes rows s [N, L] and points xi [P], got "
                         f"{tuple(s.shape)} and {tuple(xis.shape)}")


def kde_sum_launch(s: torch.Tensor, xis: torch.Tensor, h: float, binned: torch.Tensor,
                   w: torch.Tensor | None = None, deriv: int = 0) -> torch.Tensor:
    """``[N, P]``: ``sum_l w psi(u)`` (``deriv`` 0: ``phi``, 1: ``phi'``) on
    contiguous f32 CUDA tensors of one device, ``binned`` one int32 (zeros
    when non-zero); the block partials' scratch is allocated here."""
    _check(s, xis)
    ops = [(s, torch.float32), (xis, torch.float32), (binned, torch.int32)]
    if w is not None:
        if w.shape != s.shape:
            raise ValueError(f"kde_sum takes w of s's shape, got {tuple(w.shape)}")
        ops.append((w, torch.float32))
    native.check_operands("kde_sum", *ops)
    N, L = s.shape
    P = xis.shape[0]
    nblk = -(-L // CHUNK)
    part = s.new_empty((N, nblk, P))
    out = s.new_empty((N, P))
    LIB.launch("kde_sum", s, s.data_ptr(), None if w is None else w.data_ptr(),
               xis.data_ptr(), binned.data_ptr(), part.data_ptr(), out.data_ptr(), N, L, P,
               nblk, float(h), int(deriv))
    native.bump(__name__, sum_launches=1)
    return out


def kde_dot_launch(g: torch.Tensor, s: torch.Tensor, xis: torch.Tensor, h: float,
                   binned: torch.Tensor, deriv: int = 1) -> torch.Tensor:
    """``[N, L]``: ``sum_k g psi(u)`` (``deriv`` 1: ``phi'``, 2: ``phi''``) on
    contiguous f32 CUDA tensors of one device, ``binned`` one int32 (zeros
    when non-zero)."""
    _check(s, xis)
    if g.shape != (s.shape[0], xis.shape[0]):
        raise ValueError(f"kde_dot takes g [N, P], got {tuple(g.shape)}")
    native.check_operands("kde_dot", (s, torch.float32), (g, torch.float32),
                          (xis, torch.float32), (binned, torch.int32))
    N, L = s.shape
    out = s.new_empty((N, L))
    LIB.launch("kde_dot", s, s.data_ptr(), g.data_ptr(), xis.data_ptr(), binned.data_ptr(),
               out.data_ptr(), N, L, xis.shape[0], float(h), int(deriv))
    native.bump(__name__, dot_launches=1)
    return out


# ------------------------------------------------------------ plain versions


def kde_terms_needed(s: torch.Tensor, xis: torch.Tensor, h: float) -> int:
    """The pairs (sample, point) of ``s [N, L]`` and ``xis [P]`` whose term
    the kernels must compute: ``|s - xi| <= CUT h`` in f64, and every pair
    with a sample or a point that is not finite (all ``N L P`` pairs for a
    bandwidth that is not positive and finite). Counted by sorting the
    points and searching each sample's ``[s - CUT h, s + CUT h]``: ``O(N L
    log P)``, no ``[N, L, P]`` tensor."""
    h = float(h)
    n_pairs = s.numel() * xis.numel()
    if not (0.0 < h < math.inf):
        return n_pairs
    x = xis.detach().reshape(-1).double()
    xf = torch.sort(x[torch.isfinite(x)]).values
    v = s.detach().reshape(-1).double()
    finite = torch.isfinite(v)
    sf = v[finite]
    r = CUT * h
    near = (torch.searchsorted(xf, sf + r, right=True)
            - torch.searchsorted(xf, sf - r, right=False))
    n_s = int(finite.sum())
    return (int(near.sum()) + (v.numel() - n_s) * xis.numel()
            + n_s * (xis.numel() - xf.numel()))



def _terms(s: torch.Tensor, xis: torch.Tensor, h: float, deriv: int) -> torch.Tensor:
    """``psi(u)`` for ``s [N, c]`` and ``xis [P]``: ``[N, c, P]``."""
    u = (s[:, :, None] - xis[None, None, :]) / h
    phi = _INV_2PI * torch.exp(-0.5 * u * u)
    if deriv == 0:
        return phi
    if deriv == 1:
        return -u * phi
    return (u * u - 1.0) * phi


def _sum_chunk(s, xis, h, w, deriv):
    t = _terms(s, xis, h, deriv)
    return torch.sum(t if w is None else w[:, :, None] * t, dim=1)


def kde_sum_plain(s: torch.Tensor, xis: torch.Tensor, h: float, w: torch.Tensor | None = None,
                  deriv: int = 0, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``kde_sum``: chunks of ``chunk`` samples added in
    order, each chunk's ``[N, chunk, P]`` terms recomputed in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``); the
    remainder last. With ``phi`` and no ``w``: the exact KDE's sum as the
    port computed it before the kernels, to the bit."""
    n, L = s.shape
    h = float(h)
    if L <= chunk:
        return _sum_chunk(s, xis, h, w, deriv)
    main = (L // chunk) * chunk
    acc = torch.zeros((n, xis.shape[0]), dtype=s.dtype, device=s.device)
    for a in range(0, main, chunk):
        acc = acc + checkpoint(_sum_chunk, s[:, a:a + chunk], xis, h,
                               None if w is None else w[:, a:a + chunk], deriv,
                               use_reentrant=False)
    if main < L:
        acc = acc + _sum_chunk(s[:, main:], xis, h, None if w is None else w[:, main:], deriv)
    return acc


def kde_dot_plain(g: torch.Tensor, s: torch.Tensor, xis: torch.Tensor, h: float,
                  deriv: int = 1, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``kde_dot``, ``chunk`` samples at a time."""
    h = float(h)
    return torch.cat([torch.sum(g[:, None, :] * _terms(s[:, a:a + chunk], xis, h, deriv), dim=2)
                      for a in range(0, s.shape[1], chunk)], dim=1)


# ------------------------------------------------------------ autograd


class _KDE(torch.autograd.Function):
    """``kde_sum(phi)``; backward :class:`_KDEGrad` (to ``s`` only)."""

    @staticmethod
    def forward(ctx, s, xis, h, binned):
        ctx.save_for_backward(s, xis, binned)
        ctx.h = h
        return kde_sum_launch(s, xis, h, binned)

    @staticmethod
    def backward(ctx, g):
        s, xis, binned = ctx.saved_tensors
        return _KDEGrad.apply(g, s, xis, ctx.h, binned), None, None, None


class _KDEGrad(torch.autograd.Function):
    """``ds = kde_dot(g, phi') / h``, whose backward is the second order:
    ``gbar = kde_sum(w = ubar, phi') / h``, ``sbar = ubar kde_dot(g, phi'') /
    h^2``."""

    @staticmethod
    def forward(ctx, g, s, xis, h, binned):
        g = g.to(torch.float32).contiguous()
        ctx.save_for_backward(g, s, xis, binned)
        ctx.h = h
        return kde_dot_launch(g, s, xis, h, binned, deriv=1) / h

    @staticmethod
    @native.differentiable_once
    def backward(ctx, ubar):
        g, s, xis, binned = ctx.saved_tensors
        h = ctx.h
        ubar = ubar.to(torch.float32).contiguous()
        gbar = sbar = None
        if ctx.needs_input_grad[0]:
            gbar = kde_sum_launch(s, xis, h, binned, w=ubar, deriv=1) / h
        if ctx.needs_input_grad[1]:
            sbar = ubar * kde_dot_launch(g, s, xis, h, binned, deriv=2) / (h * h)
        return gbar, sbar, None, None, None


def kde_acc(s: torch.Tensor, xis: torch.Tensor, h: float,
            binned: torch.Tensor | None = None, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """``sum_l phi((s_l - xi_k) / h)``: ``[N, P]`` from f32 ``s [N, L]`` and
    ``xis [P]``, differentiable (twice) in ``s``; zeros when ``binned`` (a
    one-element tensor on ``s``'s device; None: the exact path) is non-zero.
    ``chunk`` is the plain version's."""
    xis = xis.detach()
    if s.is_cuda:
        if binned is None:
            binned = torch.zeros((1,), dtype=torch.int32, device=s.device)
        binned = binned.reshape(1).to(torch.int32)
        return _KDE.apply(s.contiguous(), xis.contiguous(), float(h), binned)
    if s.device.type == "cpu":
        if binned is not None and bool(binned):
            return s.new_zeros((s.shape[0], xis.shape[0]))
        return kde_sum_plain(s, xis, h, chunk=chunk)
    raise RuntimeError(f"the KDE has no path for device {s.device}")
