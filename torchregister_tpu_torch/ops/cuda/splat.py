"""The binned NMI's splat (``csrc/splat.cu``): the kernel, its plain version,
the kernel's order written in torch ops, and the autograd Function.

For ``idx [N, L]`` (bins in ``[0, BINS - 2]``) and weights ``f [N, L]`` (f32)
the splat is ``H [N, BINS]`` with ``H[n, idx] += 1 - f`` and ``H[n, idx + 1]
+= f``: the linear splat of ``losses/nmi._binned_histogram``. The JAX
package writes it as one-hot products on the TPU's matrix unit
(``torchregister_tpu/losses/nmi.py:_binned_histogram``), which add in a fixed
order; a ``scatter_add`` on the card adds with float atomics in no fixed
order. The kernel adds each bin's terms in an order fixed by the samples'
positions (``csrc/splat.cu``), so a run repeats to the bit.

:func:`splat` dispatches by device: a CPU tensor takes :func:`splat_plain`
(``scatter_add`` a block of samples), a CUDA tensor the kernel through
:class:`_Splat`, whose backward is the gather ``dL/df = g[idx + 1] -
g[idx]`` (:func:`splat_grad`, what autograd computes through the plain
version); any other device raises.
``launches`` counts kernel launches; :func:`reset_counts` zeroes it.
:func:`splat_ordered` is the kernel's order of additions in torch ops, for
tests of the order on any device.
"""
from __future__ import annotations

import ctypes

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "splat.cu"
BINS = 1024  # the binned NMI's fine grid
WARPS, STEPS = 8, 64  # a block's warps; a warp's steps of 32 samples
CHUNK = WARPS * STEPS * 32  # samples a block of the kernel's first stage (kChunk)

launches = 0
native.count_launches(__name__, "launches")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "splat", {
    "splat": (_I, [_P, _P, _P, _P, _I, ctypes.c_longlong, _I, _P])})


def reset_counts() -> None:
    global launches
    launches = 0


def _check(idx: torch.Tensor, f: torch.Tensor) -> None:
    if f.ndim != 2 or idx.shape != f.shape:
        raise ValueError(f"the splat takes idx and f of one shape [N, L], got "
                         f"{tuple(idx.shape)} and {tuple(f.shape)}")


def splat_launch(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA ``idx`` (int32, every value in
    ``[0, BINS - 2]``) and ``f`` (f32), one device; the block partials'
    scratch is allocated here."""
    global launches
    _check(idx, f)
    native.check_operands("splat", (f, torch.float32), (idx, torch.int32))
    N, L = f.shape
    nblk = -(-L // CHUNK)
    part = f.new_empty((N, nblk, BINS))
    H = f.new_empty((N, BINS))
    LIB.launch("splat", f, idx.data_ptr(), f.data_ptr(), part.data_ptr(), H.data_ptr(), N, L,
               nblk)
    launches += 1
    return H


def splat_plain(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: two ``scatter_add``, each block of ``CHUNK``
    samples into its own histogram (on the CPU a serial f32 sum a block; on
    the card atomics in no fixed order), then the blocks' histograms added:
    one serial sum over a row of a million samples drifts from the exact
    sum much further than the kernel's blocks do, far enough to move the
    default NMI term by more than its card-against-CPU tolerance (PERF.md).
    A row of at most ``CHUNK`` samples is one block."""
    _check(idx, f)
    N, L = f.shape
    nblk = max(1, -(-L // CHUNK))
    k = idx.long() + BINS * (torch.arange(L, device=f.device) // CHUNK)
    out = torch.zeros((N, nblk * BINS), dtype=torch.float32, device=f.device)
    out = out.scatter_add(1, k, 1.0 - f).scatter_add(1, k + 1, f)
    return out.view(N, nblk, BINS).sum(dim=1)


def splat_grad(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dL/df`` from ``dL/dH``: ``g[idx + 1] - g[idx]``, a gather a sample
    in a fixed order (what autograd computes through :func:`splat_plain`:
    the blocks' sum passes ``g`` to each block unchanged)."""
    idx = idx.long()
    return g.gather(1, idx + 1) - g.gather(1, idx)


def splat_ordered(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The kernel's sums in torch ops, each add an f32 add of the kernel's,
    in its order: samples cut into blocks of ``CHUNK`` and warps of ``STEPS``
    steps of 32; each warp's histogram gets, step by step, the ``1 - f``
    terms and then the ``f`` terms in ascending lane order; a block's
    partial adds its warps' histograms in warp order, the result the row's
    partials in block order. Past the row's end the weights are 0 (the
    kernel skips those lanes; adding +0.0 to a sum of non-negative terms
    changes no bit)."""
    _check(idx, f)
    N, L = f.shape
    nblk = -(-L // CHUNK)
    pad = nblk * CHUNK - L
    bins = torch.nn.functional.pad(idx.long(), (0, pad)).reshape(N * nblk * WARPS, STEPS, 32)
    w = torch.nn.functional.pad(f.to(torch.float32), (0, pad))
    w = w.reshape(N * nblk * WARPS, STEPS, 32)
    one = torch.nn.functional.pad(1.0 - f.to(torch.float32), (0, pad))
    one = one.reshape(N * nblk * WARPS, STEPS, 32)
    hist = torch.zeros((N * nblk * WARPS, BINS), dtype=torch.float32, device=f.device)
    rows = torch.arange(hist.shape[0], device=f.device)
    for s in range(STEPS):
        for term, wt in ((0, one), (1, w)):
            for lane in range(32):
                b = bins[:, s, lane] + term
                hist[rows, b] = hist[rows, b] + wt[:, s, lane]
    hist = hist.reshape(N, nblk, WARPS, BINS)
    part = torch.zeros((N, nblk, BINS), dtype=torch.float32, device=f.device)
    for v in range(WARPS):
        part = part + hist[:, :, v]
    H = torch.zeros((N, BINS), dtype=torch.float32, device=f.device)
    for b in range(nblk):
        H = H + part[:, b]
    return H


class _Splat(torch.autograd.Function):
    """The kernel forward, :func:`splat_grad` backward (to ``f`` only)."""

    @staticmethod
    def forward(ctx, idx, f):
        ctx.save_for_backward(idx)
        return splat_launch(idx, f)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, splat_grad(g, idx)


def splat(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``H [N, BINS]``: ``H[n, idx] += 1 - f``, ``H[n, idx + 1] += f``, for
    integer ``idx [N, L]`` in ``[0, BINS - 2]`` and f32 ``f [N, L]``,
    differentiable in ``f``."""
    if f.is_cuda:
        return _Splat.apply(idx.to(torch.int32).contiguous(), f.contiguous())
    if f.device.type == "cpu":
        return splat_plain(idx, f)
    raise RuntimeError(f"the splat has no path for device {f.device}")
