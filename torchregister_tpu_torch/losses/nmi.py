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
(:func:`kde_pdf`: on the card the kernels of ``ops/cuda/kde``, on the CPU
their plain version, chunked, each chunk recomputed in the backward) and the
binned KDE (:func:`kde_pdf_binned`), a linear splat onto 1024 fine bins and
one small kernel contraction. The JAX package writes the splat as two-level
one-hot MXU products with a split-bf16 custom VJP, because a scatter
serializes on a TPU; here it is ``ops/cuda/splat.splat``: on the card a
hand-written kernel that adds each bin's terms in an order fixed by the
samples' positions, so a run repeats to the bit (a ``scatter_add`` there adds
with float atomics in no fixed order), and on the CPU ``scatter_add`` a
block of samples.
Its backward, a gather of the cotangent at each voxel's bins, is the JAX
VJP's f32 product. The auto dispatch (``bandwidth >= 4 * fine bin``)
depends on the data, and is made on the device for every call, as JAX's
``lax.cond`` makes it: :func:`_binned_ok` gives the predicate as a device
tensor, both densities are computed, and ``torch.where`` keeps the taken
branch's before any normalisation. The exact kernels read the flag and, on
the binned path, write zeros and return, so a step makes no host read and a
CUDA graph captures it whatever the branch; a replay does only the taken
branch's KDE work (the binned splat runs on both paths). Each call adds its
branch to the device counter ``branch_calls``.

Sums run in f32 whatever the input dtype (a bf16 KDE reduction loses the
density entirely).

On two volumes split alike into slabs (``parallel.mesh.Sharded``, the
``space`` axis) ``nmi_loss`` assembles each patch on one slab
(:func:`patch_owners`) and runs the owners' patches as row groups of one
call (:func:`nmi_groups`): each patch's NMI equals its unsharded value to
the bit, and no slab gathers the whole volume.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..ops.cuda import kde
from ..ops.cuda.splat import BINS, splat
from ..ops.resize import nearest_resize

EPSILON = 1e-10
_INV_2PI = kde._INV_2PI
_FINE_BINS = BINS  # binned-KDE splat grid, the splat kernel's
_BRANCHES = ("binned", "exact")


class BranchCalls(Mapping):
    """:func:`nmi`'s calls by the density path each took: ``{"binned": n,
    "exact": n}``, kept as an int64 counter on each device that each call
    adds its flag to (no host read in a step). Reading a count syncs with
    the device. A CUDA graph's replays add to it, a masked step after an
    engine's stop and a capture's warm-up steps included."""

    def __init__(self):
        self._counts: dict = {}

    def add(self, binned: torch.Tensor) -> None:
        c = self._counts.get(binned.device)
        if c is None:
            c = self._counts[binned.device] = torch.zeros(2, dtype=torch.int64,
                                                          device=binned.device)
        b = binned.to(torch.int64)
        c.add_(torch.stack((b, 1 - b)))

    def reset(self) -> None:
        for c in self._counts.values():
            c.zero_()

    def __getitem__(self, key: str) -> int:
        i = _BRANCHES.index(key)
        return sum(int(c[i]) for c in self._counts.values())

    def __iter__(self):
        return iter(_BRANCHES)

    def __len__(self) -> int:
        return len(_BRANCHES)


branch_calls = BranchCalls()


def _unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it, to the bit: ``iota``
    times the f32 reciprocal of ``n-1``, the last point exactly 1
    (``torch.linspace`` rounds its second half differently)."""
    if n == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    out = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    out[-1].fill_(1.0)  # a fill on the device (an indexed assignment copies from the host)
    return out


def _points(hi: torch.Tensor, lo: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` points from ``hi`` down to ``lo``."""
    return _unit_linspace(steps, hi.device) * (lo - hi) + hi


def _sample_points(s: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` points from max(s) down to min(s), bounds detached (the
    reference reads them with ``.item()``)."""
    return _points(torch.max(s).detach(), torch.min(s).detach(), steps)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum then a minimum, whose gradient at a tie is
    split in half like JAX's (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def kde_pdf(signals: torch.Tensor, xis: torch.Tensor, bandwidth: float,
            chunk: int = kde.PLAIN_CHUNK, binned: torch.Tensor | None = None) -> torch.Tensor:
    """Exact KDE density of each row of ``signals [N, L]`` at ``xis
    [steps]`` -> ``[N, steps]`` (``ops/cuda/kde.kde_acc``: on the card the
    kernels, on the CPU the plain version in voxel chunks of ``chunk``
    accumulated in order, each recomputed in the backward); zeros when the
    device flag ``binned`` is set."""
    h = float(bandwidth)
    return kde.kde_acc(signals, xis, h, binned, chunk) / (h * signals.shape[1])


def _splat_weights(signals: torch.Tensor, x0: torch.Tensor,
                   xe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each sample's lower fine bin ``idx`` (int32, in ``[0, G - 2]``) and
    its weight ``f`` on ``idx + 1`` for the splat onto ``_FINE_BINS``
    uniform bins from ``x0`` to ``xe`` (descending here: ``delta`` is
    negative); ``f`` carries the gradient (d floor = 0)."""
    G = _FINE_BINS
    den = xe - x0
    den = torch.where(torch.abs(den) > 0, den, torch.ones_like(den))
    delta = den / (G - 1)
    p = _clip((signals - x0) / delta, 0.0, G - 1.0)
    i0 = _clip(torch.floor(p), 0.0, G - 2.0)
    return i0.to(torch.int32), p - i0


def _binned_histogram(signals: torch.Tensor, x0: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """Linear-splat soft histogram of ``signals [N, L]`` onto ``_FINE_BINS``
    uniform bins from ``x0`` to ``xe``, differentiable in ``signals``
    through the splat weight. On the card the splat is the fixed-order
    kernel (``ops/cuda/splat``)."""
    return splat(*_splat_weights(signals, x0, xe))


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


def _binned_ok(bandwidth: float, x0: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """JAX's ``lax.cond`` predicate ``bandwidth >= 4 * |xe - x0| / (G-1)``,
    evaluated in f32 on the device: a 0-dim bool tensor, never read on the
    host here."""
    fine = torch.abs(xe - x0) / (_FINE_BINS - 1)
    return fine.new_full((), float(bandwidth)) >= 4.0 * fine


def get_pdf(data: torch.Tensor, steps: int = 256, bandwidth: float = 2.0,
            method: str = "auto") -> torch.Tensor:
    """Reference ``get_pdf``: flatten ``[N, ...] -> [N, L]`` (f32), sample
    points over the global range, descending. ``method='auto'`` takes the
    binned KDE when the bandwidth resolves the fine grid, the exact one
    otherwise, chosen on the device as in :func:`nmi`; ``'exact'`` and
    ``'binned'`` force a path."""
    if method not in ("auto", "exact", "binned"):
        raise ValueError(f"get_pdf method must be 'auto', 'exact', or 'binned' "
                         f"(got {method!r})")
    signals = data.reshape(data.shape[0], -1).to(torch.float32)
    hi = torch.max(signals).detach()
    lo = torch.min(signals).detach()
    xis = _points(hi, lo, steps)
    if method == "exact":
        return kde_pdf(signals, xis, bandwidth)
    if method == "binned":
        return kde_pdf_binned(signals, xis, bandwidth)
    binned = _binned_ok(bandwidth, lo, hi)
    return torch.where(binned, kde_pdf_binned(signals, xis, bandwidth),
                       kde_pdf(signals, xis, bandwidth, binned=binned))


def _global_range(groups: list, device) -> tuple:
    """The max and min over every row group (exact, whatever the order),
    detached, on ``device``."""
    his = [torch.max(s).detach().to(device) for s in groups]
    los = [torch.min(s).detach().to(device) for s in groups]
    if len(groups) == 1:
        return his[0], los[0]
    return torch.max(torch.stack(his)), torch.min(torch.stack(los))


def nmi_groups(groups1: list, groups2: list, bins: int = 256, bandwidth: float = 0.1,
               rows: list | None = None) -> list:
    """:func:`nmi` of rows given as groups, one a device (a volume's patches
    assembled on the slabs that own them, ``nmi_loss`` on slabs): groups
    ``k`` of ``groups1`` and ``groups2`` are ``[N_k, ...]`` on one device.
    The sample points span the range of every group's rows (an exact max
    and min over the groups, on the first group's device), the branch is
    chosen once there and counted once in ``branch_calls``, and each
    group's histograms (the splat, the exact KDE) run on its own device
    with copies of the points and the branch flag. ``rows`` gives each
    group's rows' places among all the rows: the densities' contraction,
    normalisation and entropies then run on a tensor of every row on each
    group's device (its own rows in place, the others detached copies of
    its first), since torch's matrix product and row reductions pick their
    order by the row count; each row's values then equal its values in one
    call of every row to the bit. Returns each group's ``(nmi [N_k], mi
    [N_k])``."""
    s1 = [g.reshape(g.shape[0], -1).to(torch.float32) for g in groups1]
    s2 = [g.reshape(g.shape[0], -1).to(torch.float32) for g in groups2]
    sj = [torch.cat((a, b), dim=1) for a, b in zip(s1, s2)]
    first = s1[0].device
    xis1, xis2, xisj = (_points(*_global_range(s, first), bins) for s in (s1, s2, sj))
    binned = _binned_ok(bandwidth, xisj[-1], xisj[0])
    branch_calls.add(binned)
    total = None if rows is None else sum(len(r) for r in rows)
    out = []
    for k, (a, b, j) in enumerate(zip(s1, s2, sj)):
        dev = a.device
        x1, x2, xj, flag = (t.to(dev) for t in (xis1, xis2, xisj, binned))
        at = None if rows is None else torch.as_tensor(rows[k], device=dev)
        out.append(_nmi_rows(a, b, j, x1, x2, xj, flag, bandwidth, at, total))
    return out


def _widen(t: torch.Tensor, at: torch.Tensor, total: int) -> torch.Tensor:
    """``t``'s rows at places ``at`` of ``total`` rows, the others detached
    copies of its first row (finite wherever ``t`` is)."""
    fill = t[:1].detach().expand(total, *t.shape[1:]).contiguous()
    return fill.index_copy(0, at, t)


def _nmi_rows(s1, s2, sj, xis1, xis2, xisj, binned, bandwidth, at=None, total=None):
    """Each row's ``(nmi, mi)`` from its flat f32 signals, the sample
    points and the branch (see :func:`nmi`); with ``at``, the row-wise tail
    on ``total`` rows (:func:`nmi_groups`)."""
    x0, xe = xisj[0], xisj[-1]  # the joint range spans both marginals
    L = s1.shape[1]
    H1 = _binned_histogram(s1, x0, xe)
    H2 = _binned_histogram(s2, x0, xe)
    flag = binned.to(torch.int32)
    exact = [kde_pdf(s, x, bandwidth, binned=flag)
             for s, x in ((s1, xis1), (s2, xis2), (sj, xisj))]
    if at is not None:
        H1, H2, *exact = (_widen(t, at, total) for t in (H1, H2, *exact))
    hists_binned = (_density_from_hist(H1, x0, xe, xis1, bandwidth, L),
                    _density_from_hist(H2, x0, xe, xis2, bandwidth, L),
                    _density_from_hist(H1 + H2, x0, xe, xisj, bandwidth, 2 * L))
    hist1, hist2, hist_joint = (torch.where(binned, b, e)
                                for b, e in zip(hists_binned, exact))

    p1 = hist1 / torch.sum(hist1, dim=1, keepdim=True)
    p2 = hist2 / torch.sum(hist2, dim=1, keepdim=True)
    pj = hist_joint / torch.sum(hist_joint, dim=1, keepdim=True)
    # the reference's double negation: entropies come out negative, all alike
    e1 = -torch.sum(p1 * -torch.log2(p1 + EPSILON), dim=1)
    e2 = -torch.sum(p2 * -torch.log2(p2 + EPSILON), dim=1)
    ej = -torch.sum(pj * -torch.log2(pj + EPSILON), dim=1)
    mi = e1 + e2 - ej
    n = 2.0 * mi / (e1 + e2)
    if at is not None:
        return n.index_select(0, at), mi.index_select(0, at)
    return n, mi


def nmi(img1: torch.Tensor, img2: torch.Tensor, bins: int = 256,
        bandwidth: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference ``NMI``: returns ``(nmi [N], mi [N])``.

    The densities come from the binned path when the bandwidth resolves the
    fine grid of the *joint* range: both marginals are splatted once on that
    shared grid, and the pooled joint's histogram is their sum. Otherwise
    the exact KDE of each marginal and of the concatenation. Both are
    computed (the exact kernels write zeros on the binned path) and the
    device predicate selects one with ``torch.where`` before the
    normalisation, so the other's zeros reach no division and its backward
    gets exact zeros."""
    return nmi_groups([img1], [img2], bins, bandwidth)[0]


def _patch_rows(x: torch.Tensor, p: int) -> torch.Tensor:
    """The reference's patches of ``x [B, C, *S]``: resized to ``(2p)^d``
    by nearest, the raw buffer cut into ``2^d B C`` chunks of ``p^d``."""
    d = x.ndim - 2
    x = nearest_resize(x, (2 * p,) * d)
    return x.reshape(((2**d) * x.shape[0] * x.shape[1],) + (p,) * d)


def nmi_loss(y: torch.Tensor, yp: torch.Tensor, alpha: float = 1000.0, bins: int = 256,
             patch_size: int = 100, bandwidth: float = 3.0) -> torch.Tensor:
    """Reference ``NMILoss.forward``: ``mean(|NMI(patches) - 1|) * alpha``.
    Two volumes split alike into slabs (``parallel.mesh.Sharded``) take
    their patches' NMI from :func:`patch_nmi_slabs`, averaged on the mesh's
    first device as the unsharded call averages them."""
    from .similarity import sharded_pair

    if sharded_pair(y, yp):
        n = patch_nmi_slabs(y, yp, bins, patch_size, bandwidth)
    else:
        n, _ = nmi(_patch_rows(y, patch_size), _patch_rows(yp, patch_size), bins=bins,
                   bandwidth=bandwidth)
    return torch.mean(torch.abs(n - 1.0)) * alpha


def patch_owners(S: tuple, dim: int, n: int, p: int) -> list:
    """Which of ``n`` equal slabs along spatial dim ``dim`` of a volume of
    spatial shape ``S`` assembles each of the ``2^d`` patches of one
    ``(b, c)`` block (:func:`nmi_loss`). Patch ``k`` is the flat elements
    ``[k p^d, (k+1) p^d)`` of the resized ``(2p)^d`` block, so it spans
    resized rows ``[k p^d // R, ceil((k+1) p^d / R))`` of the leading dim (``R
    = (2p)^(d-1)``). Split along the leading dim, its owner is the slab that
    holds the source row of its first resized row (a nearest resize reads
    source row ``(i * in) // out``); split along another dim, every patch
    reads every slab, and the patches are dealt out in order, ``k n // 2^d``
    (so no slab assembles the whole volume)."""
    d = len(S)
    P, R, K = p**d, (2 * p) ** (d - 1), 2**d
    if dim != 0:
        return [k * n // K for k in range(K)]
    m = S[0] // n
    return [((k * P // R) * S[0] // (2 * p)) // m for k in range(K)]


def _owner_patches(x, p: int, owners: list, dim: int) -> list:
    """Each owning slab's patches of ``x`` (a ``Sharded`` split along
    spatial dim ``dim``), on its device: ``(slab, [B C n_k, p^d], ks)``,
    ``ks`` the patches' indices in a ``(b, c)`` block, ascending. The
    source rows each owner's patches read come through ``halo.fetch_rows``
    (along the split dim, or, split along another dim, the whole split dim
    of the leading rows they read); the other dims are resized on the
    owner."""
    from ..parallel import halo
    from ..ops.resize import axis_nearest_resize, axis_take

    S = tuple(x.shape[2:])
    d, n = len(S), len(x.shards)
    P, R, out = p**d, (2 * p) ** (d - 1), 2 * p
    parts = halo.equal(S[dim], n)
    groups = {}
    for k, j in enumerate(owners):
        groups.setdefault(j, []).append(k)
    spans = {}
    for j, ks in groups.items():
        r0, r1 = ks[0] * P // R, -(-(ks[-1] + 1) * P // R)
        src = [(i * S[0]) // out for i in range(r0, r1)]
        spans[j] = (ks, r0, src)
    if dim == 0:
        wants = [(spans[j][2][0], spans[j][2][-1] + 1) if j in spans else (0, 0)
                 for j in range(n)]
        bufs = halo.fetch_rows(x.shards, parts, 2, wants)
    else:
        bufs = {}
        for j, (_, _, src) in spans.items():
            lead = [b.narrow(2, src[0], src[-1] + 1 - src[0]) for b in x.shards]
            wants = [(0, S[dim]) if i == j else (0, 0) for i in range(n)]
            bufs[j] = halo.fetch_rows(lead, parts, 2 + dim, wants)[j]
    result = []
    for j in sorted(spans):
        ks, r0, src = spans[j]
        t = axis_take(bufs[j], 2, [s - src[0] for s in src])
        for a in range(1, d):
            t = axis_nearest_resize(t, 2 + a, out)
        flat = t.reshape(t.shape[0], t.shape[1], -1)
        rows = torch.stack([flat.narrow(2, k * P - r0 * R, P) for k in ks], dim=2)
        result.append((j, rows.reshape((-1,) + (p,) * d), ks))
    return result


def patch_nmi_slabs(y, yp, bins: int = 256, patch_size: int = 100,
                    bandwidth: float = 3.0) -> torch.Tensor:
    """The NMI of each of :func:`nmi_loss`'s patches of two volumes split
    alike into slabs, in the unsharded call's patch order on the mesh's
    first device. Each patch is assembled on one owner
    (:func:`patch_owners`, :func:`_owner_patches`; no slab gathers the whole
    volume), and the owners' patches are one row group each of
    :func:`nmi_groups`, so each patch's NMI equals its unsharded value to
    the bit."""
    dim, _ = y.slab_axis()
    p = patch_size
    owners = patch_owners(tuple(y.shape[2:]), dim - 2, len(y.shards), p)
    g1 = _owner_patches(y, p, owners, dim - 2)
    g2 = _owner_patches(yp, p, owners, dim - 2)
    BC, K = y.shape[0] * y.shape[1], len(owners)
    rows = [[bc * K + k for bc in range(BC) for k in ks] for _, _, ks in g1]
    vals = nmi_groups([r for _, r, _ in g1], [r for _, r, _ in g2], bins, bandwidth, rows)
    first = y.device
    return torch.cat([v.to(first).reshape(BC, len(ks)) for (v, _), (_, _, ks) in zip(vals, g1)],
                     dim=1).reshape(-1)


def nmi_loss_checked(y: torch.Tensor, yp: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`nmi_loss` with the finiteness checks of the JAX package's
    checkified variant: raises ``FloatingPointError`` naming the failing
    stage instead of handing NaN to an optimizer. ``Register(debug=True)``
    runs it once before the loop. It reads the host, so it never runs inside
    a captured step."""
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(yp).all())):
        raise FloatingPointError("non-finite input to NMI")
    loss = nmi_loss(y, yp, **kw)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError("NMI loss is non-finite (KDE/log2 stage)")
    return loss
