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
version) as the Function :class:`_SplatGrad`, whose own backward (the LM
engines' Hessian) is the kernel's signed mode, ``H[idx] -= w``, ``H[idx +
1] += w``: the transpose of the gather, in the kernel's fixed order (a
``scatter_add`` on the card, autograd's transpose of ``gather``, adds with
atomics); any other device raises.
``launches`` and ``signed_launches`` count the kernel's launches in each
mode; :func:`reset_counts` zeroes them. :func:`splat_ordered` is the
kernel's order of additions in torch ops, for tests of the order on any
device.
"""
from __future__ import annotations

import ctypes

import torch

from ... import native

SOURCE = native.PKG / "csrc" / "splat.cu"
BINS = 1024  # the binned NMI's fine grid
WARPS, STEPS = 8, 64  # a block's warps; a warp's steps of 32 consecutive samples
CHUNK = WARPS * STEPS * 32  # samples a block of the kernel's first stage (kChunk)

launches = 0
signed_launches = 0
native.count_launches(__name__, "launches", "signed_launches")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "splat", {
    "splat": (_I, [_P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _P])})


def reset_counts() -> None:
    global launches, signed_launches
    launches = 0
    signed_launches = 0


def _check(idx: torch.Tensor, f: torch.Tensor) -> None:
    if f.ndim != 2 or idx.shape != f.shape:
        raise ValueError(f"the splat takes idx and f of one shape [N, L], got "
                         f"{tuple(idx.shape)} and {tuple(f.shape)}")


def splat_launch(idx: torch.Tensor, f: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA ``idx`` (int32, every value in
    ``[0, BINS - 2]``) and ``f`` (f32), one device; the block partials'
    scratch is allocated here. ``signed``: the signed mode (``-f`` into
    ``idx``, ``f`` into ``idx + 1``)."""
    _check(idx, f)
    native.check_operands("splat", (f, torch.float32), (idx, torch.int32))
    N, L = f.shape
    nblk = -(-L // CHUNK)
    part = f.new_empty((N, nblk, BINS))
    H = f.new_empty((N, BINS))
    LIB.launch("splat", f, idx.data_ptr(), f.data_ptr(), part.data_ptr(), H.data_ptr(), N, L,
               nblk, int(signed))
    native.bump(__name__, **{"signed_launches" if signed else "launches": 1})
    return H


def splat_plain(idx: torch.Tensor, f: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Plain PyTorch version: two ``scatter_add``, each block of ``CHUNK``
    samples into its own histogram (on the CPU a serial f32 sum a block; on
    the card atomics in no fixed order), then the blocks' histograms added:
    one serial sum over a row of a million samples drifts from the exact
    sum much further than the kernel's blocks do, far enough to move the
    default NMI term by more than its card-against-CPU tolerance (PERF.md).
    A row of at most ``CHUNK`` samples is one block. ``signed``: ``-f``
    into ``idx`` in place of ``1 - f``."""
    _check(idx, f)
    N, L = f.shape
    nblk = max(1, -(-L // CHUNK))
    k = idx.long() + BINS * (torch.arange(L, device=f.device) // CHUNK)
    out = torch.zeros((N, nblk * BINS), dtype=torch.float32, device=f.device)
    out = out.scatter_add(1, k, -f if signed else 1.0 - f).scatter_add(1, k + 1, f)
    return out.view(N, nblk, BINS).sum(dim=1)


def splat_grad(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dL/df`` from ``dL/dH``: ``g[idx + 1] - g[idx]``, a gather a sample
    in a fixed order (what autograd computes through :func:`splat_plain`:
    the blocks' sum passes ``g`` to each block unchanged)."""
    idx = idx.long()
    return g.gather(1, idx + 1) - g.gather(1, idx)


def run_sums(bins: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor) -> tuple:
    """The kernel's sums of each step ``[..., 32]`` (bins, both weights, by
    lane) in torch ops: the lanes sorted by ``bin * 32 + lane``, then the
    segmented inclusive scan at distances 1, 2, 4, 8, 16 (a lane adds what
    lies ``d`` lanes below it while that lane is in its run). Returns the
    sorted bins, both weights' scans and the mask of each run's last lane."""
    lane = torch.arange(32, device=bins.device)
    key, order = (bins * 32 + lane).sort(dim=-1)  # unique keys: a fixed permutation
    bins = torch.div(key, 32, rounding_mode="floor")
    w0, w1 = w0.gather(-1, order), w1.gather(-1, order)
    head = torch.ones_like(bins, dtype=torch.bool)
    head[..., 1:] = bins[..., 1:] != bins[..., :-1]
    start = torch.where(head, lane, 0).cummax(dim=-1).values
    for d in (1, 2, 4, 8, 16):
        take = lane - d >= start
        a0 = torch.nn.functional.pad(w0[..., :-d], (d, 0))
        a1 = torch.nn.functional.pad(w1[..., :-d], (d, 0))
        w0, w1 = torch.where(take, a0 + w0, w0), torch.where(take, a1 + w1, w1)
    last = torch.ones_like(head)
    last[..., :-1] = head[..., 1:]
    return bins, w0, w1, last


def splat_ordered(idx: torch.Tensor, f: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """The kernel's sums in torch ops, each add an f32 add of the kernel's,
    in its order: samples cut into blocks of ``CHUNK``, warps and steps of
    32 consecutive samples; each step's runs of equal bins summed by
    :func:`run_sums`, then, step by step, each run's ``1 - f`` sum (signed:
    ``-f``) added to its bin of the warp's histogram and after that each
    run's ``f`` sum to the next bin; a
    block's partial adds its warps' histograms in warp order, the result the
    row's partials in block order. Past the row's end the lanes hold the bin
    ``BINS``, which sorts last, runs alone and is never added (the kernel's
    ``kNone``)."""
    _check(idx, f)
    N, L = f.shape
    nblk = -(-L // CHUNK)
    pad = nblk * CHUNK - L
    rows = N * nblk * WARPS
    f32 = f.to(torch.float32)
    # a warp's steps: 32 consecutive samples each
    bins = torch.nn.functional.pad(idx.long(), (0, pad), value=BINS).reshape(rows, STEPS, 32)
    w0 = torch.nn.functional.pad(-f32 if signed else 1.0 - f32, (0, pad)).reshape(rows, STEPS, 32)
    w1 = torch.nn.functional.pad(f32, (0, pad)).reshape(rows, STEPS, 32)
    bins, w0, w1, last = run_sums(bins, w0, w1)
    live = last & (bins < BINS)
    # a lane that adds nothing writes the spare columns BINS and BINS + 1
    first = torch.where(live, bins, BINS)
    second = torch.where(live, bins + 1, BINS + 1)
    hist = torch.zeros((rows, BINS + 2), dtype=torch.float32, device=f.device)
    r = torch.arange(rows, device=f.device)[:, None]
    for s in range(STEPS):
        b = first[:, s]
        hist[r, b] = hist[r, b] + w0[:, s]
        b = second[:, s]
        hist[r, b] = hist[r, b] + w1[:, s]
    hist = hist[:, :BINS].reshape(N, nblk, WARPS, BINS)
    part = torch.zeros((N, nblk, BINS), dtype=torch.float32, device=f.device)
    for v in range(WARPS):
        part = part + hist[:, :, v]
    H = torch.zeros((N, BINS), dtype=torch.float32, device=f.device)
    for b in range(nblk):
        H = H + part[:, b]
    return H


class _Splat(torch.autograd.Function):
    """The kernel forward, :func:`splat_grad` backward (to ``f`` only), as
    :class:`_SplatGrad`, so differentiable twice."""

    @staticmethod
    def forward(ctx, idx, f):
        ctx.save_for_backward(idx)
        return splat_launch(idx, f)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, _SplatGrad.apply(g, idx)


class _SplatGrad(torch.autograd.Function):
    """:func:`splat_grad`, whose backward is the signed splat of the
    cotangent (the kernel's signed mode)."""

    @staticmethod
    def forward(ctx, g, idx):
        ctx.save_for_backward(idx)
        return splat_grad(g, idx)

    @staticmethod
    @native.differentiable_once
    def backward(ctx, w):
        (idx,) = ctx.saved_tensors
        return splat_launch(idx, w.to(torch.float32).contiguous(), signed=True), None


def splat(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``H [N, BINS]``: ``H[n, idx] += 1 - f``, ``H[n, idx + 1] += f``, for
    integer ``idx [N, L]`` in ``[0, BINS - 2]`` and f32 ``f [N, L]``,
    differentiable in ``f``."""
    if f.is_cuda:
        return _Splat.apply(idx.to(torch.int32).contiguous(), f.contiguous())
    if f.device.type == "cpu":
        return splat_plain(idx, f)
    raise RuntimeError(f"the splat has no path for device {f.device}")
