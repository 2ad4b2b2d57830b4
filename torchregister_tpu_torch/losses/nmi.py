"""KDE-based (normalized) mutual information loss (counterpart of
``torchregister_tpu/losses/nmi.py``, the reference's soft-histogram NMI stack,
utils.py:18-79 and ``NMILoss`` at utils.py:224-259).

Reference semantics, kept because they define the loss values:

- Gaussian kernel ``K(u) = exp(-u^2/2) / (2*pi)`` (the unnormalized constant
  cancels in the NMI ratio);
- ``steps`` sample points linspaced from the batch's *global* max down to its
  min (descending), with the bounds detached;
- the "joint histogram" is the KDE of the concatenated signals, a pooled
  marginal, not a 2D joint;
- entropies ``-sum(p * -log2(p + 1e-10))``, NMI ``= 2*MI/(E1+E2)``;
- ``nmi_loss`` resizes to ``(2*patch)^d`` by nearest and reshapes the raw
  buffer into ``2^d * B * C`` chunks of ``patch^d`` (a view, not spatial
  octants); loss ``mean(|NMI - 1|) * alpha``.

Two density paths, as in the JAX package: the exact per-voxel KDE
(:func:`kde_pdf`, chunked, each chunk recomputed in the backward) and the
binned KDE (:func:`kde_pdf_binned`), a linear splat onto 1024 fine bins and
one small kernel contraction. The JAX package writes the splat as two-level
one-hot MXU products with a split-bf16 custom VJP, because a scatter
serializes on a TPU; here it is one ``scatter_add_`` of the two splat weights,
whose autograd backward (a gather of the cotangent at each voxel's bins) is
the JAX VJP's f32 product. The auto dispatch (``bandwidth >= 4 * fine bin``)
depends on the data: JAX takes it with a ``lax.cond`` on the device, here it
is read on the host, one device sync per call (:func:`_binned_ok`), and
counted in ``branch_calls``.

Sums run in f32 whatever the input dtype (a bf16 KDE reduction loses the
density entirely).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.resize import nearest_resize

EPSILON = 1e-10
_INV_2PI = 1.0 / (2.0 * math.pi)
_FINE_BINS = 1024  # binned-KDE splat grid
# nmi() calls by the density path its host-read branch took
branch_calls = {"binned": 0, "exact": 0}


def _unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it, to the bit: ``iota``
    times the f32 reciprocal of ``n-1``, the last point exactly 1
    (``torch.linspace`` rounds its second half differently)."""
    if n == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    out = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    out[-1] = 1.0
    return out


def _sample_points(s: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` points from max(s) down to min(s), bounds detached (the
    reference reads them with ``.item()``)."""
    hi = torch.max(s).detach()
    lo = torch.min(s).detach()
    return _unit_linspace(steps, s.device) * (lo - hi) + hi


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum then a minimum, whose gradient at a tie is
    split in half like JAX's (``torch.clamp`` passes all of it)."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _kde_accumulate(signals: torch.Tensor, xis: torch.Tensor, h: float) -> torch.Tensor:
    """Sum over the voxel axis of ``K((signals - xi)/h)``: ``[N, L]``,
    ``[steps]`` -> ``[N, steps]``."""
    u = (signals[:, :, None] - xis[None, None, :]) / h
    return torch.sum(_INV_2PI * torch.exp(-0.5 * u * u), dim=1)


def kde_pdf(signals: torch.Tensor, xis: torch.Tensor, bandwidth: float,
            chunk: int = 8192) -> torch.Tensor:
    """Exact KDE density of each row of ``signals [N, L]`` at ``xis
    [steps]`` -> ``[N, steps]``, in voxel chunks accumulated in order; each
    chunk's ``[N, chunk, steps]`` kernel tensor is recomputed in the backward
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``)."""
    n, L = signals.shape
    h = float(bandwidth)
    if L <= chunk:
        acc = _kde_accumulate(signals, xis, h)
    else:
        main = (L // chunk) * chunk
        acc = torch.zeros((n, xis.shape[0]), dtype=signals.dtype, device=signals.device)
        for start in range(0, main, chunk):
            acc = acc + checkpoint(_kde_accumulate, signals[:, start:start + chunk], xis, h,
                                   use_reentrant=False)
        if main < L:
            acc = acc + _kde_accumulate(signals[:, main:], xis, h)
    return acc / (h * L)


def _binned_histogram(signals: torch.Tensor, x0: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """Linear-splat soft histogram of ``signals [N, L]`` onto ``_FINE_BINS``
    uniform bins from ``x0`` to ``xe`` (descending here: ``delta`` is
    negative). Differentiable in ``signals`` through the splat weight ``f``."""
    n, L = signals.shape
    G = _FINE_BINS
    den = xe - x0
    den = torch.where(torch.abs(den) > 0, den, torch.ones_like(den))
    delta = den / (G - 1)
    p = _clip((signals - x0) / delta, 0.0, G - 1.0)
    i0 = _clip(torch.floor(p), 0.0, G - 2.0)
    f = p - i0
    idx = i0.to(torch.int64)
    out = torch.zeros((n, G), dtype=torch.float32, device=signals.device)
    out = out.scatter_add(1, idx, 1.0 - f)
    return out.scatter_add(1, idx + 1, f)


def _density_from_hist(H: torch.Tensor, x0, xe, xis: torch.Tensor, bandwidth: float,
                       L: int) -> torch.Tensor:
    """KDE density at ``xis`` from a fine histogram ``H [N, G]`` splatted on
    the uniform grid from ``x0`` to ``xe``."""
    G = H.shape[1]
    grid = _unit_linspace(G, H.device) * (xe - x0) + x0
    u = (grid[:, None] - xis[None, :]) / bandwidth
    kmat = _INV_2PI * torch.exp(-0.5 * u * u)
    return H @ kmat / (bandwidth * L)


def kde_pdf_binned(signals: torch.Tensor, xis: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """Binned KDE: splat to the fine histogram, then one ``[G, steps]``
    kernel contraction; within O((fine bin / h)^2) of :func:`kde_pdf`."""
    h = float(bandwidth)
    x0, xe = xis[0], xis[-1]
    H = _binned_histogram(signals, x0, xe)
    return _density_from_hist(H, x0, xe, xis, h, signals.shape[1])


def _binned_ok(bandwidth: float, x0: torch.Tensor, xe: torch.Tensor) -> bool:
    """JAX's ``lax.cond`` predicate ``bandwidth >= 4 * |xe - x0| / (G-1)``,
    evaluated in f32 on the device and read on the host (one sync)."""
    fine = torch.abs(xe - x0) / (_FINE_BINS - 1)
    bw = torch.tensor(float(bandwidth), dtype=torch.float32, device=fine.device)
    return bool(bw >= 4.0 * fine)


def get_pdf(data: torch.Tensor, steps: int = 256, bandwidth: float = 2.0,
            method: str = "auto") -> torch.Tensor:
    """Reference ``get_pdf``: flatten ``[N, ...] -> [N, L]`` (f32), sample
    points over the global range, descending. ``method='auto'`` takes the
    binned KDE when the bandwidth resolves the fine grid, the exact one
    otherwise; ``'exact'`` and ``'binned'`` force a path."""
    if method not in ("auto", "exact", "binned"):
        raise ValueError(f"get_pdf method must be 'auto', 'exact', or 'binned' "
                         f"(got {method!r})")
    signals = data.reshape(data.shape[0], -1).to(torch.float32)
    hi = torch.max(signals).detach()
    lo = torch.min(signals).detach()
    xis = _unit_linspace(steps, signals.device) * (lo - hi) + hi
    if method == "binned" or (method == "auto" and _binned_ok(bandwidth, lo, hi)):
        return kde_pdf_binned(signals, xis, bandwidth)
    return kde_pdf(signals, xis, bandwidth)


def nmi(img1: torch.Tensor, img2: torch.Tensor, bins: int = 256,
        bandwidth: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference ``NMI``: returns ``(nmi [N], mi [N])``.

    The densities come from the binned path when the bandwidth resolves the
    fine grid of the *joint* range: both marginals are splatted once on that
    shared grid, and the pooled joint's histogram is their sum. Otherwise
    the exact KDE of each marginal and of the concatenation."""
    s1 = img1.reshape(img1.shape[0], -1).to(torch.float32)
    s2 = img2.reshape(img2.shape[0], -1).to(torch.float32)
    sj = torch.cat((s1, s2), dim=1)
    xis1, xis2, xisj = (_sample_points(s, bins) for s in (s1, s2, sj))
    binned = _binned_ok(bandwidth, xisj[-1], xisj[0])
    branch_calls["binned" if binned else "exact"] += 1
    if binned:
        x0, xe = xisj[0], xisj[-1]  # the joint range spans both marginals
        H1 = _binned_histogram(s1, x0, xe)
        H2 = _binned_histogram(s2, x0, xe)
        L = s1.shape[1]
        hist1 = _density_from_hist(H1, x0, xe, xis1, bandwidth, L)
        hist2 = _density_from_hist(H2, x0, xe, xis2, bandwidth, L)
        hist_joint = _density_from_hist(H1 + H2, x0, xe, xisj, bandwidth, 2 * L)
    else:
        hist1 = kde_pdf(s1, xis1, bandwidth)
        hist2 = kde_pdf(s2, xis2, bandwidth)
        hist_joint = kde_pdf(sj, xisj, bandwidth)

    p1 = hist1 / torch.sum(hist1, dim=1, keepdim=True)
    p2 = hist2 / torch.sum(hist2, dim=1, keepdim=True)
    pj = hist_joint / torch.sum(hist_joint, dim=1, keepdim=True)
    # the reference's double negation: entropies come out negative, all alike
    e1 = -torch.sum(p1 * -torch.log2(p1 + EPSILON), dim=1)
    e2 = -torch.sum(p2 * -torch.log2(p2 + EPSILON), dim=1)
    ej = -torch.sum(pj * -torch.log2(pj + EPSILON), dim=1)
    mi = e1 + e2 - ej
    return 2.0 * mi / (e1 + e2), mi


def nmi_loss(y: torch.Tensor, yp: torch.Tensor, alpha: float = 1000.0, bins: int = 256,
             patch_size: int = 100, bandwidth: float = 3.0) -> torch.Tensor:
    """Reference ``NMILoss.forward``: ``mean(|NMI(patches) - 1|) * alpha``."""
    p = patch_size
    d = y.ndim - 2

    def prep(x):
        x = nearest_resize(x, (2 * p,) * d)
        return x.reshape(((2**d) * x.shape[0] * x.shape[1],) + (p,) * d)

    n, _ = nmi(prep(y), prep(yp), bins=bins, bandwidth=bandwidth)
    return torch.mean(torch.abs(n - 1.0)) * alpha


def nmi_loss_checked(y: torch.Tensor, yp: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`nmi_loss` with the finiteness checks of the JAX package's
    checkified variant: raises ``FloatingPointError`` naming the failing
    stage instead of handing NaN to an optimizer. ``Register(debug=True)``
    runs it once before the loop."""
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(yp).all())):
        raise FloatingPointError("non-finite input to NMI")
    loss = nmi_loss(y, yp, **kw)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError("NMI loss is non-finite (KDE/log2 stage)")
    return loss
