"""Seeded registration pairs, made on the device in plain torch.

A pair is a moving image, a sum of 8 Gaussian blobs on ``[-1, 1]^3`` (centres
in ``[-0.5, 0.5]^3``, widths in ``[0.1, 0.35]``), and its target
``target(o) = moving(A (o + f(o)))`` (index space), sampled trilinearly with
zeros outside: a rigid transform ``A``, and for a deformable pair a
band-limited field ``f``, the tricubic upsample of a ``6^3`` normal draw
scaled so its largest component is ``max_disp`` voxels. The ranges are those
of the repo's synthetic pairs (angles up to 0.06 rad, raw translations up to
0.2). The small draws come from a host generator seeded with ``--seed``, so
a seed gives the same pairs on any device; the volumes are made on the
device.

A pool is ``deformable`` deformable pairs and ``rigid`` rigid-only ones; the
deformable pairs' largest displacements are the same evenly spaced set for
every seed (``max_disp`` range), in a seeded order, so seeds change the pairs
and not how much displacement the pool holds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .reference.warp import index_map, rigid_theta


@dataclass
class Pair:
    moving: torch.Tensor  # [1, 1, *S] f32
    target: torch.Tensor  # [1, 1, *S] f32
    theta: torch.Tensor  # [3, 4] true rigid theta
    coarse: torch.Tensor | None  # [3, 6, 6, 6] the field's draw (None: rigid-only)
    max_disp: float  # the field's largest component, voxels (0: rigid-only)

    def flow(self) -> torch.Tensor | None:
        """The true field ``[1, 3, *S]``, made again from its draw."""
        if self.coarse is None:
            return None
        return field(self.coarse, tuple(self.moving.shape[2:]), self.max_disp)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in, out]`` weights of a cubic upsample with half-pixel centres,
    renormalized over the taps inside the input."""
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def field(coarse: torch.Tensor, spatial, max_disp: float) -> torch.Tensor:
    """The tricubic upsample of ``coarse [3, c, c, c]`` to ``spatial`` (f64),
    scaled to a largest component of ``max_disp``: ``[1, 3, *S]`` f32."""
    y = coarse.to(torch.float64)
    for a, out in enumerate(spatial):
        w = torch.from_numpy(cubic_weights(y.shape[1 + a], out)).to(y.device)
        y = torch.movedim(torch.movedim(y, 1 + a, -1) @ w, -1, 1 + a)
    y = y.to(torch.float32)
    return (y * (max_disp / torch.max(torch.abs(y))))[None]


def blobs(centres: np.ndarray, widths: np.ndarray, spatial, device) -> torch.Tensor:
    """``sum_k exp(-|x - c_k|^2 / (2 w_k^2))`` on ``linspace(-1, 1)`` per
    axis, ``[1, 1, *S]`` f32 (each blob an outer product of three axes)."""
    axes = [torch.linspace(-1, 1, s, dtype=torch.float32, device=device) for s in spatial]
    vol = torch.zeros(tuple(spatial), dtype=torch.float32, device=device)
    for c, w in zip(centres, widths):
        z, y, x = (torch.exp(-(g - float(ci)) ** 2 / (2 * float(w) ** 2))
                   for g, ci in zip(axes, c))
        vol += z[:, None, None] * y[None, :, None] * x[None, None, :]
    return vol[None, None]


def warp_target(moving: torch.Tensor, theta: torch.Tensor, flow) -> torch.Tensor:
    """``moving(A (o + f(o)))``: one trilinear resample with zeros outside."""
    spatial = tuple(moving.shape[2:])
    axes = [torch.arange(s, dtype=torch.float32, device=moving.device) for s in spatial]
    o = torch.stack(torch.meshgrid(*axes, indexing="ij"))
    if flow is not None:
        o = o + flow[0]
    M, t = index_map(theta, spatial)
    s = torch.einsum("ij,j...->i...", M, o) + t.reshape(3, 1, 1, 1)
    sizes = torch.tensor(spatial, dtype=torch.float32, device=moving.device).reshape(3, 1, 1, 1)
    grid = ((2.0 * s + 1.0) / sizes - 1.0).flip(0).permute(1, 2, 3, 0)[None]
    return F.grid_sample(moving, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _signed(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    return rng.uniform(lo, hi, n) * rng.choice([-1.0, 1.0], n)


def make_pair(rng: np.random.Generator, spatial, max_disp: float, device) -> Pair:
    """One pair from ``rng``'s next draws (``max_disp`` 0: rigid-only)."""
    centres = rng.uniform(-0.5, 0.5, (8, 3))
    widths = rng.uniform(0.1, 0.35, 8)
    params = np.concatenate([_signed(rng, 0.03, 0.06, 3), _signed(rng, 0.08, 0.2, 3)])
    coarse = rng.normal(size=(3, 6, 6, 6)).astype(np.float32) if max_disp else None
    moving = blobs(centres, widths, spatial, device)
    theta = rigid_theta(torch.tensor(params, dtype=torch.float32, device=device))
    coarse = None if coarse is None else torch.from_numpy(coarse).to(device)
    pair = Pair(moving, None, theta, coarse, float(max_disp))
    pair.target = warp_target(moving, theta, pair.flow())
    return pair


def make_pool(seed: int, spatial, deformable: int, rigid: int, max_disp,
              device) -> list:
    """The pool of a traffic mix: ``deformable`` pairs whose largest
    displacements are ``linspace(*max_disp, deformable)`` in a seeded order,
    then ``rigid`` rigid-only pairs."""
    rng = np.random.default_rng(seed)
    disps = list(rng.permutation(np.linspace(*max_disp, deformable))) + [0.0] * rigid
    return [make_pair(rng, spatial, d, device) for d in disps]
