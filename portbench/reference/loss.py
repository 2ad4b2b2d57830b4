"""Plain-torch criteria, the diffusion term and Adam, from their definitions.

Each criterion takes ``(target, warped)`` and reduces in f32; a difference
of two images is taken in their own dtype first, as an image held in a lower
precision gives it.
"""
from __future__ import annotations

import torch

NCC_EPS = 1e-10


def mse(y: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    d = (y - yp).to(torch.float32)
    return torch.mean(d * d)


def ncc(y: torch.Tensor, yp: torch.Tensor, alpha: float = 100.0) -> torch.Tensor:
    """``alpha (1 - <y - mean y, yp - mean yp> / sqrt(|y_|^2 |yp_|^2 + eps))``."""
    y = y.to(torch.float32)
    yp = yp.to(torch.float32)
    y_ = y - torch.mean(y)
    yp_ = yp - torch.mean(yp)
    den = torch.sqrt(torch.sum(y_ * y_) * torch.sum(yp_ * yp_) + NCC_EPS)
    return (1.0 - torch.sum(y_ * yp_) / den) * alpha


CRITERIA = {"mse": mse, "ncc": ncc}


def criterion(names) -> callable:
    """The equal-weight sum of the named criteria (a list's weights are
    ``1 / len``)."""
    fns = [CRITERIA[n] for n in names]
    w = 1.0 / len(fns)

    def loss(y, yp):
        return sum(w * f(y, yp) for f in fns)

    return loss


def diffusion(flow: torch.Tensor) -> torch.Tensor:
    """Sum over the spatial axes of the mean squared forward difference."""
    f = flow.to(torch.float32)
    return sum(torch.mean(torch.diff(f, dim=a) ** 2) for a in range(2, f.ndim))


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) on one f32 tensor."""

    def __init__(self, param: torch.Tensor, lr: float):
        self.p, self.lr, self.t = param, lr, 0
        self.m = torch.zeros_like(param)
        self.v = torch.zeros_like(param)

    def step(self, g: torch.Tensor) -> None:
        b1, b2 = 0.9, 0.999
        self.t += 1
        self.m = b1 * self.m + (1 - b1) * g
        self.v = b2 * self.v + (1 - b2) * g * g
        denom = torch.sqrt(self.v) / (1 - b2 ** self.t) ** 0.5 + 1e-8
        with torch.no_grad():
            self.p -= (self.lr / (1 - b1 ** self.t)) * self.m / denom
