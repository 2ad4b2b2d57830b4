"""Sobel edge pre-filter, the engines' ``grad_edges`` (counterpart of
``torchregister_tpu/ops/edge.py``, the reference's ``Edge3D``,
utils.py:130-183): nine 3x3x3 Sobel kernels (three axis gradients and six
diagonal ones), the gradient magnitude, a per-sample min-max normalization, a
band-pass to a binary {0, 1} mask, and no gradient (the reference
``.detach()``s).

As in the JAX package, the reference's reflect pad by ``a=5000`` and crop
is implemented as its effective semantics, a reflect pad by the kernel
radius, and a 2D variant (four kernels) exists beside the 3D one.

The filter bank is one valid 3x3x3 convolution, 1 -> 9 channels, on kernel
K3 (``ops/cuda/conv3d.py``; on a CPU tensor its plain version): K3 sums in
f32 FMAs and never in TF32, so the magnitude does not depend on cuDNN's TF32
switch, and the thresholded mask, which flips a voxel for a 1e-7 change of a
magnitude on a threshold, does not either. A 2D image is run as a volume of
three equal planes through a bank that is zero outside its middle plane.

On a volume split into slabs (``parallel/mesh.py``'s ``space`` axis) each
slab takes a one-row halo (``parallel/halo.py``) in place of the padding,
and the min and max are the volume's.

Epsilon bookkeeping as in utils.py:174-175: ``+EPSILON`` per channel element
before the channel sum and per filter element before the filter sum.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda.conv3d import conv3x3x3
from .pad import pad_nd

EPSILON = 1e-10


def sobel_kernels_3d(n1: float = 1, n2: float = 2, n3: float = 2) -> np.ndarray:
    """The nine 3D Sobel kernels as a ``[9, 3, 3, 3]`` bank: the derivative
    ``[-1, 0, 1]`` along one axis times the smoothing stencil over the other
    two (Sx along the last axis, Sy the middle, Sz the first), then the
    diagonal-gradient stencils with slab weighting and their
    transposes/negations (reference utils.py:112-127)."""
    smooth = np.array([[n1, n2, n1], [n2, n2 * n3, n2], [n1, n2, n1]], np.float64)
    deriv = np.array([-1.0, 0.0, 1.0])
    sx = np.einsum("ij,k->ijk", smooth, deriv)
    sy = np.einsum("ik,j->ijk", smooth, deriv)
    sz = np.einsum("jk,i->ijk", smooth, deriv)

    d0 = np.array([[0, n1, n2], [-n1, 0, n1], [-n2, -n1, 0]], np.float64)
    d1 = np.array([[0, n2, n2 * n3], [-n2, 0, n2], [-n2 * n3, -n2, 0]], np.float64)
    sd11 = np.stack([d0, d1, d0])
    e0 = np.array([[-n2, -n1, 0], [-n1, 0, n1], [0, n1, n2]], np.float64)
    e1 = np.array([[-n2 * n3, -n2, 0], [-n2, 0, n2], [0, n2, n2 * n3]], np.float64)
    sd12 = np.stack([e0, e1, e0])
    sd21 = sd11.T
    sd22 = sd12.T
    sd31 = np.asarray([-s.T for s in sd11.T])
    sd32 = np.asarray([s.T for s in sd12.T])
    return np.stack([sx, sy, sz, sd11, sd12, sd21, sd22, sd31, sd32]).astype(np.float32)


def sobel_kernels_2d(n1: float = 1, n2: float = 2) -> np.ndarray:
    """2D bank ``[4, 3, 3]``: Sx, Sy and the two diagonal gradients."""
    smooth = np.array([n1, n2, n1], np.float64)
    deriv = np.array([-1.0, 0.0, 1.0])
    sx = np.einsum("i,j->ij", smooth, deriv)
    sy = np.einsum("j,i->ij", smooth, deriv)
    d0 = np.array([[0, n1, n2], [-n1, 0, n1], [-n2, -n1, 0]], np.float64)
    e0 = np.array([[-n2, -n1, 0], [-n1, 0, n1], [0, n1, n2]], np.float64)
    return np.stack([sx, sy, d0, e0]).astype(np.float32)


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    """Min-max over each sample of ``[B, ...]`` (eps 1e-9, the reference's
    ``norm``): one high-dynamic-range volume must not push the other
    samples' gradients below the threshold."""
    axes = tuple(range(1, x.ndim))
    lo = torch.amin(x, dim=axes, keepdim=True)
    hi = torch.amax(x, dim=axes, keepdim=True)
    return (x - lo) / ((hi - lo) + 1e-9)


def _bank(d: int, img: torch.Tensor, n1: float, n2: float, n3: float) -> torch.Tensor:
    """The Sobel bank in K3's layout ``[dz, dy, dx, 1, nf]`` on ``img``'s
    device and dtype."""
    if d == 3:
        bank = torch.from_numpy(sobel_kernels_3d(n1, n2, n3))  # [9, 3, 3, 3]
    elif d == 2:
        bank = torch.zeros((4, 3, 3, 3))
        bank[:, 1] = torch.from_numpy(sobel_kernels_2d(n1, n2))
    else:
        raise ValueError(f"edge_filter supports 2D/3D, got {d} spatial dims")
    return bank.permute(1, 2, 3, 0)[:, :, :, None, :].to(img.device, img.dtype)


def _magnitude(padded: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The Sobel gradient magnitude ``[B, 1, *S]`` of ``padded [B, C, *(S +
    2)]`` (one voxel of padding a side), before the normalization."""
    B, C = padded.shape[:2]
    spatial = tuple(s - 2 for s in padded.shape[2:])
    d = len(spatial)
    nf = w.shape[-1]
    x = padded.reshape((B * C, 1) + tuple(padded.shape[2:]))
    if d == 2:
        x = x[:, :, None].expand(-1, -1, 3, -1, -1)
    resp = conv3x3x3(x.contiguous(), w)  # [B*C, nf, (1,) *S]
    resp = resp.reshape((B, C, nf) + spatial)
    chan_sum = torch.sum(resp + EPSILON, dim=1)  # [B, nf, *S]
    grad_mag = (1.0 / C) * torch.sqrt(torch.sum(chan_sum**2 + EPSILON, dim=1))
    return grad_mag.reshape((B, 1) + spatial)


def edge_magnitude(img, n1: float = 1, n2: float = 2, n3: float = 2):
    """Min-max normalized Sobel gradient magnitude ``[B, 1, *S]`` of ``img
    [B, C, *S]`` (2D or 3D), the quantity :func:`edge_filter` thresholds;
    no gradient. A volume split into slabs (a ``parallel.mesh.Sharded``)
    filters each slab on its device, a one-row halo in place of the reflect
    padding along the split axis (the volume's reflect rows at its edges),
    and normalizes by the volume's min and max: each voxel is the one of the
    whole volume's filter."""
    from ..parallel.mesh import Sharded

    if isinstance(img, Sharded):
        return _slab_magnitude(img, n1, n2, n3)
    spatial = tuple(img.shape[2:])
    w = _bank(len(spatial), img, n1, n2, n3)
    with torch.no_grad():
        padded = pad_nd(img, tuple(s + 2 for s in spatial), mode="reflect")
        return _minmax_norm(_magnitude(padded, w))


def _slab_magnitude(img, n1, n2, n3):
    from ..parallel import halo
    from ..parallel.mesh import from_blocks

    dim, _ = img.slab_axis()
    if dim < 2:
        raise ValueError(f"edge_filter filters slabs of a spatial dim, got a split along dim "
                         f"{dim}")
    with torch.no_grad():
        mags = []
        for buf in halo.fetch(img.shards, dim, 1, 1, mode="reflect"):
            target = tuple(s if 2 + i == dim else s + 2 for i, s in enumerate(buf.shape[2:]))
            padded = pad_nd(buf, target, mode="reflect")
            mags.append(_magnitude(padded, _bank(img.ndim - 2, buf, n1, n2, n3)))
        axes = tuple(range(1, img.ndim))
        dev = img.device
        lo = torch.amin(mags[0], dim=axes, keepdim=True).to(dev)
        hi = torch.amax(mags[0], dim=axes, keepdim=True).to(dev)
        for m in mags[1:]:
            lo = torch.minimum(lo, torch.amin(m, dim=axes, keepdim=True).to(dev))
            hi = torch.maximum(hi, torch.amax(m, dim=axes, keepdim=True).to(dev))
        out = [(m - lo.to(m.device)) / ((hi.to(m.device) - lo.to(m.device)) + 1e-9)
               for m in mags]
        shape = (img.shape[0], 1, *img.shape[2:])
        return from_blocks(out, img.sharding, shape)


def edge_filter(img, a: int = 5000, thresh: tuple[float, float] = (0.2, 0.9),
                n1: float = 1, n2: float = 2, n3: float = 2):
    """Binary Sobel edge mask of ``img [B, C, *S]`` (2D or 3D): ``[B, 1, *S]``
    f32 in {0, 1}, with no gradient. ``a`` is accepted for the reference's
    signature; the effective reflect pad by 1 is used. A ``Sharded`` volume
    gives a ``Sharded`` mask (:func:`edge_magnitude`)."""
    del a
    edges = edge_magnitude(img, n1, n2, n3)

    def band(e):
        return ((e > thresh[0]) & (e < thresh[1])).to(torch.float32)

    return band(edges) if isinstance(edges, torch.Tensor) else edges.map(band)
