"""Intensity similarity losses ``loss(y, yp) -> scalar`` (counterpart of
``torchregister_tpu/losses/similarity.py``): MSE, SSD, the reference's global
NCC and the local windowed NCC.

Each upcasts to f32 before reducing: a bf16 mean over millions of voxels
loses most of its mantissa. MSE, SSD and NCC also take two volumes split
alike into slabs (``parallel/mesh.py``'s ``Sharded``): each slab's partial
sums in f32 on its device, added in ascending slab order on the mesh's first
device. LNCC (and NMI, ``losses/nmi.py``) raise on slabs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPSILON = 1e-10


def _ordered_sum(parts, device) -> torch.Tensor:
    from ..parallel.mesh import ordered_sum

    return ordered_sum(parts, device)


def _slabs(y, yp):
    """The blocks of two volumes split alike, or None for tensors."""
    from ..parallel.mesh import Sharded

    if not isinstance(y, Sharded) and not isinstance(yp, Sharded):
        return None
    if not (isinstance(y, Sharded) and isinstance(yp, Sharded)) or y.shape != yp.shape or (
            y.sharding.spec != yp.sharding.spec or y.mesh is not yp.mesh):
        raise ValueError("a criterion of sharded volumes needs both split alike over one mesh")
    y.slab_axis()
    return y.shards, yp.shards


def refuse_slabs(name: str, y, yp) -> None:
    """Raise for a criterion that has no form on slabs yet."""
    if _slabs(y, yp) is not None:
        raise ValueError(f"{name} on a space-sharded volume is not ported yet: ROADMAP queue 1 "
                         "item 20. Under a space axis use mse, ssd or ncc (the data axis takes "
                         "every criterion)")


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


def _box_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Sliding-window sum over the spatial dims of ``[N, C, *S]`` with the
    JAX ``reduce_window`` ``"SAME"`` padding: ``(win-1)//2`` zeros before and
    ``win//2`` after each axis (asymmetric for an even ``win``, which is why
    this is not ``avg_pool``). One axis at a time, summed in f32 (no
    convolution, so no TF32 on the card)."""
    for axis in range(2, x.ndim):
        pad = [0, 0] * (x.ndim - 2)
        k = 2 * (x.ndim - 1 - axis)
        pad[k], pad[k + 1] = (win - 1) // 2, win // 2
        x = F.pad(x, pad).unfold(axis, win, 1).sum(-1)
    return x


def lncc(y: torch.Tensor, yp: torch.Tensor, win: int = 9, alpha: float = 100.0) -> torch.Tensor:
    """Local NCC loss ``(1 - mean_w NCC_w(y, yp)) * alpha`` from five
    box-filtered moment maps. The images are centred on their global means
    first (the one-pass ``E[x^2] - E[x]^2`` form cancels catastrophically in
    f32 on a large DC offset), and the window variances are clamped at 0."""
    refuse_slabs("lncc", y, yp)
    d = y.ndim - 2
    n = float(win**d)
    y = y.to(torch.float32)
    yp = yp.to(torch.float32)
    y = y - torch.mean(y)
    yp = yp - torch.mean(yp)
    s_y = _box_filter(y, win)
    s_p = _box_filter(yp, win)
    s_yy = _box_filter(y * y, win)
    s_pp = _box_filter(yp * yp, win)
    s_yp = _box_filter(y * yp, win)
    cross = s_yp - s_y * s_p / n
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    # torch.maximum, not clamp: at a tie its gradient is split, as jnp.maximum's
    var_y = torch.maximum(s_yy - s_y * s_y / n, zero)
    var_p = torch.maximum(s_pp - s_p * s_p / n, zero)
    cc = (cross * cross) / (var_y * var_p + 1e-5)
    return (1.0 - torch.mean(cc)) * alpha
