"""Command-line registration driver (counterpart of
``torchregister_tpu/__main__.py``).

    python -m torchregister_tpu_torch register moving.nii target.nii \\
        --mode cascade -o warped.nii --save-transform t.npz
    python -m torchregister_tpu_torch apply other.nii t.npz -o out.nii

Reads and writes NIfTI-1 volumes; runs rigid | affine | flow | cascade
registration on ``--device`` (default ``cuda``, which fails without a CUDA
device rather than moving to the CPU). The cascade's final warp and
``apply`` both run the exact warps of kernel K2, so applying the saved
transform to the moving volume reproduces the registered output bit for
bit. Transform files load in both packages.
"""
from __future__ import annotations

import argparse
import sys
import time
import zipfile

import numpy as np
import torch


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    return dev


def _load(path: str, device: torch.device) -> torch.Tensor:
    from .utils.volio import read_volume

    vol = read_volume(path).astype(np.float32)
    # 3D volumes stored as 4D with nt=1 (a trailing singleton) are common
    while vol.ndim > 2 and vol.shape[-1] == 1:
        vol = vol[..., 0]
    if vol.ndim not in (2, 3):
        raise SystemExit(f"{path}: expected a 2D/3D volume, got shape {vol.shape}")
    return torch.from_numpy(np.ascontiguousarray(vol[None, None])).to(device)


def cmd_register(args) -> int:
    from .api import Register
    from .engines.cascade import register_cascade
    from .utils.io import save_pytree
    from .utils.volio import write_volume

    device = _device(args.device)
    moving = _load(args.moving, device)
    target = _load(args.target, device)
    if moving.shape != target.shape:
        raise SystemExit(f"shape mismatch: {tuple(moving.shape)} vs {tuple(target.shape)}")

    # the matrix stages want ~1e-3..3e-3 with Adam; a direct per-voxel field
    # needs steps in voxel units (~0.3)
    matrix_lr = args.lr if args.lr is not None else 3e-3
    flow_lr = args.flow_lr if args.flow_lr is not None else 0.3

    t0 = time.perf_counter()
    if args.mode == "cascade":
        res = register_cascade(
            moving, target, levels=args.levels,
            rigid_epochs=args.epochs, affine_epochs=max(1, args.epochs // 2),
            flow_epochs=max(1, args.epochs // 5),
            rigid_lr=matrix_lr, affine_lr=matrix_lr, flow_lr=flow_lr,
            criterions=tuple(args.criterion) if args.criterion else ("mse", "ncc"),
            optimizer=args.optimizer, flow_dtype=args.flow_dtype,
            # exact final warp: `apply` with the saved transform reproduces it
            final_warp="exact",
        )
        warped = res.warped
        transform = {"mode": np.asarray("cascade"), "theta": res.theta}
        if res.flow is not None:
            transform["flow"] = res.flow
    else:
        reg = Register(mode=args.mode, device=device, criterion=args.criterion or None,
                       optimizer=args.optimizer, grad_edges=args.grad_edges,
                       init="identity")
        if args.mode == "flow":
            # --flow-lr wins, then --lr; neither -> the Register default (0.3)
            lr = args.flow_lr if args.flow_lr is not None else args.lr
        else:
            lr = matrix_lr
        reg.optim(moving, target, lr=lr, max_epochs=args.epochs, n=args.n)
        warped = reg(moving)
        # a flow is saved under the key `apply` dispatches on, with the mode
        key = "flow" if args.mode == "flow" else "theta"
        transform = {"mode": np.asarray(args.mode), key: reg.theta}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    rmse0 = float(torch.sqrt(torch.mean((moving - target) ** 2)))
    rmse1 = float(torch.sqrt(torch.mean((warped - target) ** 2)))
    print(f"registered in {elapsed:.2f}s | RMSE {rmse0:.5f} -> {rmse1:.5f} "
          f"({100 * (1 - rmse1 / max(rmse0, 1e-12)):.1f}% reduction)")
    if args.output:
        write_volume(args.output, warped[0, 0].cpu().numpy())
        print(f"wrote {args.output}")
    if args.save_transform:
        print(f"wrote {save_pytree(args.save_transform, transform)}")
    return 0


def cmd_apply(args) -> int:
    from .ops.blocked import warp_affine_fast, warp_flow_fast
    from .utils.io import load_pytree
    from .utils.volio import write_volume

    device = _device(args.device)
    moving = _load(args.moving, device)
    try:
        tr_ = load_pytree(args.transform)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        raise SystemExit(f"{args.transform}: not a torchregister-tpu transform file ({e})")
    if "theta" not in tr_ and "flow" not in tr_:
        raise SystemExit(f"{args.transform}: no theta/flow in transform file")
    base = moving
    if "theta" in tr_:  # cascade order: matrix first, then flow
        base = warp_affine_fast(torch.tensor(tr_["theta"], dtype=torch.float32,
                                             device=device), base)
    if "flow" in tr_:
        base = warp_flow_fast(base, torch.tensor(tr_["flow"], dtype=torch.float32,
                                                 device=device))
    write_volume(args.output, base[0, 0].cpu().numpy())
    print(f"wrote {args.output}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torchregister_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("register", help="register moving onto target")
    r.add_argument("moving")
    r.add_argument("target")
    r.add_argument("--mode", default="cascade",
                   choices=["rigid", "affine", "flow", "cascade"])
    r.add_argument("-o", "--output", help="write warped volume (.nii)")
    r.add_argument("--save-transform", help="write transform pytree (.npz)")
    r.add_argument("--epochs", type=int, default=500)
    r.add_argument("--levels", type=int, default=3)
    r.add_argument("--lr", type=float, default=None,
                   help="matrix-stage lr (default 3e-3 for Adam)")
    r.add_argument("--flow-lr", type=float, default=None,
                   help="flow-stage lr (default 0.3: direct-field steps are in voxels)")
    r.add_argument("--n", type=float, default=8, help="U-Net width divisor")
    r.add_argument("--criterion", nargs="*",
                   help="e.g. mse ncc nmi lncc ssd (default: mse ncc for the cascade, "
                        "the reference stack mse ncc nmi otherwise)")
    r.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    r.add_argument("--grad-edges", action="store_true")
    r.add_argument("--flow-dtype", default="float32", choices=["float32", "bfloat16"])
    r.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r.set_defaults(fn=cmd_register)

    a = sub.add_parser("apply", help="apply a saved transform to a volume")
    a.add_argument("moving")
    a.add_argument("transform")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("--device", default="cuda", help="torch device (default cuda)")
    a.set_defaults(fn=cmd_apply)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
