"""README-parity driver on the PyTorch/CUDA port (``torchregister_tpu_torch``):
the reference's canonical usage script, the counterpart of
``examples/readme_driver.py``, importing no JAX.

Replicates the reference README pipeline (reference README.md:20-94): load a
brain volume, build a randomly-perturbed copy as the target, then register
rigid (500 ep) -> affine (200 ep) -> flow (100 ep), chaining each stage's
output into the next, and report the recovered transforms. Runs on a bundled
synthetic "brain-like" phantom (no data download; pass --nifti to use a real
volume via the native volio loader). Runs on the card; ``--device cpu`` runs
on the CPU.

    python examples/readme_driver_torch.py --dim 2 --size 96 --panel panel.png
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import torchregister_tpu_torch as tr


def phantom(shape=(96, 96, 96), seed=0) -> np.ndarray:
    """Synthetic brain-like volume: nested smooth ellipsoids + texture.
    Works for 2D shapes too (the reference's 2D showcase is the "ringo"
    image, reference README.md:4-8; any textured smooth image exercises the
    same path)."""
    rng = np.random.default_rng(seed)
    d = len(shape)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r2 = sum(g**2 * s for g, s in zip(grids, (1.3, 1.0, 1.1)[:d]))
    vol = np.clip(1.0 - r2, 0, None) ** 0.7  # head
    for _ in range(10):  # internal structure
        c = rng.uniform(-0.4, 0.4, d)
        w = rng.uniform(0.05, 0.2)
        vol += 0.5 * np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2))
    vol += 0.02 * rng.standard_normal(shape)
    return vol.astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_panel(path, moving, target, warped, flow_mag=None):
    """Qualitative golden: the reference showcases before/after result panels
    and loss curves as images (reference assets/, README.md:4-17). Renders the
    central axial slice of moving / target / |target-moving| / warped /
    |target-warped| (+ flow magnitude when present) to one PNG; the images
    are tensors (any device) or arrays ``[1, 1, *S]``.

    matplotlib is an optional dependency (same stance as the reference's
    debug plots); returns False when unavailable.
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        print("matplotlib unavailable; skipping panel render")
        return False

    def mid(x):
        x = _np(x)[0, 0]
        return x[x.shape[0] // 2] if x.ndim == 3 else x

    cols = [
        ("moving", mid(moving), "gray"),
        ("target", mid(target), "gray"),
        ("|target - moving|", np.abs(mid(target) - mid(moving)), "magma"),
        ("registered", mid(warped), "gray"),
        ("|target - registered|", np.abs(mid(target) - mid(warped)), "magma"),
    ]
    if flow_mag is not None:
        cols.append(("|flow|", mid(flow_mag), "viridis"))
    fig, axes = plt.subplots(1, len(cols), figsize=(3 * len(cols), 3.2))
    emax = max(cols[2][1].max(), cols[4][1].max(), 1e-6)
    for ax, (title, img, cmap) in zip(axes, cols):
        kw = {"vmin": 0.0, "vmax": emax} if cmap == "magma" else {}
        ax.imshow(img, cmap=cmap, **kw)
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nifti", help="optional .nii/.nii.gz volume to register")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--dim", type=int, default=3, choices=[2, 3],
                    help="2 = the reference's 2D showcase scenario")
    ap.add_argument("--panel", help="write a before/after/flow PNG panel here")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.nifti:
        from torchregister_tpu_torch.utils.volio import read_volume

        vol = read_volume(args.nifti)
        # Real NIfTI files commonly store 3D volumes as 4D with nt=1;
        # squeeze trailing singletons so the crop/theta dims agree.
        while vol.ndim > args.dim and vol.shape[-1] == 1:
            vol = vol[..., 0]
        if vol.ndim != args.dim:
            raise SystemExit(
                f"{args.nifti}: {vol.ndim}D volume but --dim {args.dim} "
                "(pass --dim matching the file)"
            )
        vol = vol[tuple(slice(0, min(s, 160)) for s in vol.shape)]
    else:
        vol = phantom((args.size,) * args.dim)

    device = torch.device(args.device)
    moving = tr.norm(torch.as_tensor(np.ascontiguousarray(vol), device=device)[None, None])

    # Perturb with a known rigid transform (the README uses torchio
    # RandomAffine; ground truth = the inverse is recoverable).
    if args.dim == 2:
        true_params = torch.tensor([0.1, 0.25, -0.15], device=device)
    else:
        true_params = torch.tensor([0.08, -0.05, 0.06, 0.3, -0.2, 0.15], device=device)
    target = tr.warp_affine(tr.rigid_theta(true_params)[None], moving)
    print(f"volume {tuple(moving.shape)}, perturbation params {_np(true_params)}")

    # --- rigid (README.md:59-66)
    warping = tr.Register(mode="rigid", optimizer="adam", init="identity", device=device)
    warping.optim(moving, target, lr=5e-3, max_epochs=500)
    warped = warping(moving)
    print("rigid theta:\n", _np(warping.theta[0]).round(4))
    print("true  theta:\n", _np(tr.rigid_theta(true_params)).round(4))

    # --- affine refinement (README.md:70-77)
    warping2 = tr.Register(mode="affine", optimizer="adam", device=device)
    warping2.optim(warped, target, lr=1e-3, max_epochs=200)
    warped = warping2(warped)

    # --- dense flow (README.md:81-88). lr=None resolves per flow model
    # (0.3 for the default direct field: Adam steps are in voxel units).
    warping3 = tr.Register(mode="flow", optimizer="adam", device=device)
    warping3.optim(warped, target, max_epochs=100, n=32)
    warped = warping3(warped)
    flow_mag = tr.norm(torch.abs(warping3.theta))  # README.md:90 idiom

    rmse0 = float(torch.sqrt(torch.mean((moving - target) ** 2)))
    rmse = float(torch.sqrt(torch.mean((warped - target) ** 2)))
    print(f"RMSE before {rmse0:.5f} -> after cascade {rmse:.5f} "
          f"({100 * (1 - rmse / rmse0):.1f}% reduction)")
    print("flow magnitude stats:", float(flow_mag.mean()), float(flow_mag.max()))

    if args.panel:
        # flow field [1, d, *S] -> per-voxel magnitude [1, 1, *S]
        mag = torch.linalg.vector_norm(warping3.theta, dim=1, keepdim=True)
        save_panel(args.panel, moving, target, warped, mag)
    return rmse0, rmse


if __name__ == "__main__":
    main()
