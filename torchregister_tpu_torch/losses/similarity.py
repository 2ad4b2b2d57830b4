"""Intensity similarity losses ``loss(y, yp) -> scalar`` (counterpart of
``torchregister_tpu/losses/similarity.py``): MSE, SSD, the reference's global
NCC and the local windowed NCC.

Each upcasts to f32 before reducing: a bf16 mean over millions of voxels
loses most of its mantissa.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPSILON = 1e-10


def mse(y: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    d = (y - yp).to(torch.float32)
    return torch.mean(d * d)


def ssd(y: torch.Tensor, yp: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    d = (y - yp).to(torch.float32)
    return torch.sum(d * d) * alpha


def ncc(y: torch.Tensor, yp: torch.Tensor, alpha: float = 100.0) -> torch.Tensor:
    """Global NCC: ``(1 - sum(y_ yp_) / sqrt(sum(y_^2) sum(yp_^2) + eps)) * alpha``."""
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
