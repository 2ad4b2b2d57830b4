"""Cohort-scale registration driver (counterpart of
``examples/cohort_driver.py``): a synthetic cohort of pairs, each a blob
anatomy and a known rigid perturbation of it, registered as one batched loop
by ``parallel/cohort.register_cohort``, then re-warped exactly
(kernel K2) and checked: max |theta - true| < 0.05 and a lower RMSE, as the
JAX driver checks.

    python -m torchregister_tpu_torch.cohort_driver --batch 8
    python -m torchregister_tpu_torch.cohort_driver --batch 8 --size 240 --ndim 3
    python -m torchregister_tpu_torch.cohort_driver --device cpu   # plain versions

As the JAX driver, it splits the cohort over a ``data`` mesh of every CUDA
device when there is more than one (``parallel/mesh.make_mesh``; the batch
must then be a multiple of the device count), and runs it with no mesh on
one card or on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .ops.blocked import warp_affine_fast
from .ops.resample import warp_affine
from .ops.transforms import rigid_theta
from .parallel import make_mesh, register_cohort


def cohort(batch: int, shape, seed: int = 0, device="cpu"):
    """``(movings, targets, thetas)``: per-subject blob anatomy (five
    Gaussian blobs drawn from ``seed``, as the JAX driver draws them) and a
    rigid perturbation of up to 0.08 in each raw parameter; the targets are
    the exact warps (``grid_sample``). The volumes are built on ``device``."""
    rng = np.random.default_rng(seed)
    axes = [torch.linspace(-1.0, 1.0, s, device=device) for s in shape]
    grids = torch.meshgrid(*axes, indexing="ij")
    movings, thetas = [], []
    for _ in range(batch):
        vol = torch.zeros(shape, device=device)
        for _ in range(5):
            c = rng.uniform(-0.4, 0.4, len(shape))
            w = rng.uniform(0.15, 0.3)
            vol += torch.exp(-sum((g - float(ci)) ** 2 for g, ci in zip(grids, c))
                             / (2 * w**2))
        params = rng.uniform(-0.08, 0.08, 3 if len(shape) == 2 else 6).astype(np.float32)
        movings.append(vol[None, None])
        thetas.append(rigid_theta(torch.from_numpy(params).to(device))[None])
    movings, thetas = torch.cat(movings), torch.cat(thetas)
    return movings, warp_affine(thetas, movings), thetas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--ndim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--mode", default="rigid", choices=["rigid", "affine"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cohort_driver: no CUDA device (pass --device cpu for the CPU)")

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = make_mesh((n_dev,), ("data",)) if n_dev > 1 else None
    if mesh is not None and args.batch % n_dev:
        raise SystemExit(f"--batch {args.batch} is not divisible by the {n_dev}-device data "
                         f"mesh: the batch axis shards over all devices (pick a multiple of "
                         f"{n_dev})")
    movings, targets, trues = cohort(args.batch, (args.size,) * args.ndim, device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"cohort of {args.batch} pairs at {args.size}^{args.ndim} on {where} over "
          f"{n_dev} device(s)")
    t0 = time.perf_counter()
    res = register_cohort(movings, targets, mode=args.mode, mesh=mesh, lr=5e-3,
                          epochs=args.epochs, criterions=["mse"], optimizer="adam",
                          init="identity")
    thetas = res.best_theta[:, 0]  # [B, d, d+1]
    err = float(torch.max(torch.abs(thetas - trues)))
    print(f"registered in {time.perf_counter() - t0:.2f}s; steps {res.steps}; "
          f"max |theta - true| = {err:.4f}")
    warped = warp_affine_fast(thetas, movings)
    rmse0 = float(torch.sqrt(torch.mean((movings - targets) ** 2)))
    rmse1 = float(torch.sqrt(torch.mean((warped - targets) ** 2)))
    print(f"cohort RMSE {rmse0:.5f} -> {rmse1:.5f}")
    return 0 if err < 0.05 and rmse1 < rmse0 else 1


if __name__ == "__main__":
    sys.exit(main())
