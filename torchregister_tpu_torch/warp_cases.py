"""K2's shared test inputs: the transforms and fields that ``chip_smoke.py``,
the tests and ``profile_warp.py`` warp with, in the kernel's view (``mt``
from :func:`torchregister_tpu_torch.ops.cuda.warp.pack_affine`, fields
``[3, Z, Y, X]`` in voxels)."""
from __future__ import annotations

import torch

from .ops.cuda.warp import pack_affine
from .ops.separable import affine_to_index_map
from .synthetic import cubic_resize

# the JAX bench selftest's rigid transform of the K2 check (bench.py:82)
SELFTEST_THETA = (0.15, -0.12, 0.1, 0.12, -0.08, 0.06)
# make_pair's true rigid transform (synthetic.make_pair)
PAIR_RIGID = (0.06, -0.04, 0.05, 0.2, -0.15, 0.1)


def index_map(theta: torch.Tensor, spatial) -> torch.Tensor:
    """K2's 12 floats for a normalized ``theta [1, d, d+1]``."""
    M, t = affine_to_index_map(theta[0], spatial)
    return pack_affine(M, t)


def smooth_flow(S: int, max_disp: float, seed: int, device) -> torch.Tensor:
    """A band-limited field (cubic upsample of a 6³ draw), |flow| <= max_disp."""
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.randn((3, 6, 6, 6), generator=gen, device=device)
    flow = cubic_resize(coarse, (S, S, S))
    return (flow * (max_disp / torch.max(torch.abs(flow)))).contiguous()


def zoom_grid(S: int, device) -> torch.Tensor:
    """``0.25 * (o - centre)``: added to a field, an outward zoom by 1.25."""
    o = torch.arange(S, dtype=torch.float32, device=device) - (S - 1) / 2
    return 0.25 * torch.stack(torch.meshgrid(o, o, o, indexing="ij"))


def rot90_zoom2() -> torch.Tensor:
    """A 90° rotation about z and a zoom by 2, as a normalized theta."""
    return torch.tensor([[[0.0, -2.0, 0.0, 0.0], [2.0, 0.0, 0.0, 0.0],
                          [0.0, 0.0, 2.0, 0.0]]])
