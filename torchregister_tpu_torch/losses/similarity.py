"""Intensity similarity losses ``loss(y, yp) -> scalar`` (counterpart of
``torchregister_tpu/losses/similarity.py``): MSE, SSD, the reference's global
NCC and the local windowed NCC.

Each upcasts to f32 before reducing: a bf16 mean over millions of voxels
loses most of its mantissa. Each also takes two volumes split alike into
slabs (``parallel/mesh.py``'s ``Sharded``, the ``space`` axis): each slab's
partial sums in f32 on its device, added in ascending slab order on the
mesh's first device. LNCC's box filter reads, along the split dim, a halo of
the window's rows from the neighbouring slabs (``parallel/halo.py``). MSE,
SSD and NCC also take a batch split over a ``data`` axis and a spatial dim
over a ``space`` axis (a loss over a whole sharded batch): every block's
partial sums added batch-position-major, then slab.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPSILON = 1e-10


def _ordered_sum(parts, device) -> torch.Tensor:
    from ..parallel.mesh import ordered_sum

    return ordered_sum(parts, device)


def sharded_pair(y, yp) -> bool:
    """True for two volumes split alike over one mesh, False for two
    tensors; raises for anything else."""
    from ..parallel.mesh import Sharded

    if not isinstance(y, Sharded) and not isinstance(yp, Sharded):
        return False
    if not (isinstance(y, Sharded) and isinstance(yp, Sharded)) or y.shape != yp.shape or (
            y.sharding.spec != yp.sharding.spec or y.mesh is not yp.mesh):
        raise ValueError("a criterion of sharded volumes needs both split alike over one mesh")
    return True


def _slabs(y, yp):
    """The blocks of two volumes split alike in summing order
    (``Sharded.ordered_blocks``), or None for tensors."""
    if not sharded_pair(y, yp):
        return None
    return y.ordered_blocks(), yp.ordered_blocks()


def mse(y: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    slabs = _slabs(y, yp)
    if slabs is not None:
        parts = [torch.sum(((a - b).to(torch.float32)) ** 2) for a, b in zip(*slabs)]
        return _ordered_sum(parts, y.device) / y.numel()
    d = (y - yp).to(torch.float32)
    return torch.mean(d * d)


def ssd(y: torch.Tensor, yp: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    slabs = _slabs(y, yp)
    if slabs is not None:
        parts = [torch.sum(((a - b).to(torch.float32)) ** 2) for a, b in zip(*slabs)]
        return _ordered_sum(parts, y.device) * alpha
    d = (y - yp).to(torch.float32)
    return torch.sum(d * d) * alpha


def _ncc_slabs(ys, yps, n: int, device, alpha: float) -> torch.Tensor:
    ys = [a.to(torch.float32) for a in ys]
    yps = [b.to(torch.float32) for b in yps]
    my = _ordered_sum([torch.sum(a) for a in ys], device) / n
    mp = _ordered_sum([torch.sum(b) for b in yps], device) / n
    ys = [a - my.to(a.device) for a in ys]
    yps = [b - mp.to(b.device) for b in yps]
    num = _ordered_sum([torch.sum(a * b) for a, b in zip(ys, yps)], device)
    syy = _ordered_sum([torch.sum(a * a) for a in ys], device)
    spp = _ordered_sum([torch.sum(b * b) for b in yps], device)
    return (1.0 - num / torch.sqrt(syy * spp + EPSILON)) * alpha


def ncc(y: torch.Tensor, yp: torch.Tensor, alpha: float = 100.0) -> torch.Tensor:
    """Global NCC: ``(1 - sum(y_ yp_) / sqrt(sum(y_^2) sum(yp_^2) + eps)) * alpha``."""
    slabs = _slabs(y, yp)
    if slabs is not None:
        return _ncc_slabs(*slabs, y.numel(), y.device, alpha)
    y = y.to(torch.float32)
    yp = yp.to(torch.float32)
    y_ = y - torch.mean(y)
    yp_ = yp - torch.mean(yp)
    num = torch.sum(y_ * yp_)
    den = torch.sqrt(torch.sum(y_ * y_) * torch.sum(yp_ * yp_) + EPSILON)
    return (1.0 - num / den) * alpha


def _box_filter(x: torch.Tensor, win: int, halo_dim: int | None = None) -> torch.Tensor:
    """Sliding-window sum over the spatial dims of ``[N, C, *S]`` with the
    JAX ``reduce_window`` ``"SAME"`` padding: ``(win-1)//2`` zeros before and
    ``win//2`` after each axis (asymmetric for an even ``win``, which is why
    this is not ``avg_pool``). One axis at a time, summed in f32 (no
    convolution, so no TF32 on the card). Along ``halo_dim`` the rows are
    already padded (a slab's buffer with its halo): no pad there."""
    for axis in range(2, x.ndim):
        if axis != halo_dim:
            pad = [0, 0] * (x.ndim - 2)
            k = 2 * (x.ndim - 1 - axis)
            pad[k], pad[k + 1] = (win - 1) // 2, win // 2
            x = F.pad(x, pad)
        x = x.unfold(axis, win, 1).sum(-1)
    return x


def _lncc_terms(y: torch.Tensor, yp: torch.Tensor, win: int,
                halo_dim: int | None = None) -> torch.Tensor:
    """Each window's ``NCC^2`` from centred f32 images (or a slab's buffers
    of them with their halo along ``halo_dim``)."""
    n = float(win ** (y.ndim - 2))
    s_y = _box_filter(y, win, halo_dim)
    s_p = _box_filter(yp, win, halo_dim)
    s_yy = _box_filter(y * y, win, halo_dim)
    s_pp = _box_filter(yp * yp, win, halo_dim)
    s_yp = _box_filter(y * yp, win, halo_dim)
    cross = s_yp - s_y * s_p / n
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    # torch.maximum, not clamp: at a tie its gradient is split, as jnp.maximum's
    var_y = torch.maximum(s_yy - s_y * s_y / n, zero)
    var_p = torch.maximum(s_pp - s_p * s_p / n, zero)
    return (cross * cross) / (var_y * var_p + 1e-5)


def _mean64(sums: list, n: int, device) -> torch.Tensor:
    """The f32 mean from f64 partial sums added in order: the f64 sum of f32
    values rounds to the same f32 mean whatever the order of its parts, so
    the slabs centre on the whole volume's mean to the bit."""
    return (_ordered_sum(sums, device) / n).to(torch.float32)


def _lncc_slabs(y, yp, win: int, alpha: float) -> torch.Tensor:
    """:func:`lncc` of two volumes split alike into slabs: the global means
    from the slabs' f64 partial sums in ascending order (:func:`_mean64`),
    each slab centred, then each slab's windows from a buffer of its
    centred rows with
    ``(win-1)//2`` rows before and ``win//2`` after along the split dim
    (zeros past the volume, as the unsharded filter pads the centred image;
    the halo may span several neighbours), and the windows' sums added in
    ascending slab order."""
    from ..parallel import halo

    dim, _ = y.slab_axis()
    n, device = y.numel(), y.device
    ys = [a.to(torch.float32) for a in y.shards]
    yps = [b.to(torch.float32) for b in yp.shards]
    my, mp = (_mean64([torch.sum(a, dtype=torch.float64) for a in x], n, device)
              for x in (ys, yps))
    ys = halo.fetch([a - my.to(a.device) for a in ys], dim, (win - 1) // 2, win // 2)
    yps = halo.fetch([b - mp.to(b.device) for b in yps], dim, (win - 1) // 2, win // 2)
    cc = [torch.sum(_lncc_terms(a, b, win, dim)) for a, b in zip(ys, yps)]
    return (1.0 - _ordered_sum(cc, device) / n) * alpha


def lncc(y: torch.Tensor, yp: torch.Tensor, win: int = 9, alpha: float = 100.0) -> torch.Tensor:
    """Local NCC loss ``(1 - mean_w NCC_w(y, yp)) * alpha`` from five
    box-filtered moment maps. The images are centred on their global means
    first (the one-pass ``E[x^2] - E[x]^2`` form cancels catastrophically in
    f32 on a large DC offset; the means summed in f64, :func:`_mean64`), and
    the window variances are clamped at 0.
    Two volumes split alike into slabs take :func:`_lncc_slabs`."""
    if sharded_pair(y, yp):
        return _lncc_slabs(y, yp, win, alpha)
    y = y.to(torch.float32)
    yp = yp.to(torch.float32)
    n = y.numel()
    my, mp = (_mean64([torch.sum(x, dtype=torch.float64)], n, y.device) for x in (y, yp))
    cc = _lncc_terms(y - my, yp - mp, win)
    return (1.0 - torch.mean(cc)) * alpha
