"""Public API: ``Register`` and ``norm`` (counterpart of
``torchregister_tpu/api.py``).

Construct with a mode, call ``.optim(moving, target, ...)``, then call the
object to warp images with the recovered transform: the best (lowest-loss)
theta for rigid/affine, the dense field for flow. ``__call__`` warps all
channels of ``[1, C, *S]`` at once through kernel K2 (``ops/blocked.py``), so
it is exact (``grid_sample`` semantics) whatever ``method`` the optimization
used.

``device`` is a torch device (or its name). ``None`` means the card,
``cuda``, as the JAX package's ``None`` means its default device, the
accelerator: without a CUDA device the constructor raises, and the CPU runs
only when asked for (``device='cpu'``). Every input moves to that device.
``init='random'`` and the U-Net's initial weights (``mode='flow',
flow_model='unet'``) draw from a ``torch.Generator`` seeded by ``seed`` (so
not the JAX package's numbers). ``criterion=None`` is the reference stack,
MSE + NCC(100) + NMI(1000). ``debug=True`` checks the NMI criterion on the
inputs before the loop, prints progress every tenth of the epochs and
reports after it.
"""
from __future__ import annotations

import numpy as np
import torch

from .engines.affine import affine_register
from .engines.flow import flow_register
from .engines.rigid import rigid_register
from .ops.blocked import warp_affine_fast, warp_flow_fast


def norm(x):
    """Min-max normalize to [0, 1] (eps 1e-9); returns None with a warning
    when ``x`` cannot be normalized."""
    try:
        x = torch.as_tensor(x)
        lo = torch.min(x)
        hi = torch.max(x)
        return (x - lo) / ((hi - lo) + 1e-9)
    except (TypeError, RuntimeError, ValueError):
        print("WARNING: Input could not be normalized!")
        return None


class Register:
    """Gradient-descent image registration (rigid | affine | flow); the JAX
    package's signature with a torch ``device``."""

    def __init__(
        self,
        mode: str = "rigid",
        device=None,
        criterion=None,
        weight=None,
        grad_edges: bool = False,
        debug: bool = False,
        optimizer: str | None = None,
        init: str = "random",
        seed: int = 0,
        method: str = "separable",
        max_shift=None,
        max_disp: int = 8,
        flow_model: str = "field",
        smooth: float | None = None,
    ):
        if mode not in ("rigid", "affine", "flow"):
            raise ValueError(f"mode must be rigid|affine|flow, got {mode!r}")
        if method not in ("separable", "exact"):
            raise ValueError(f"method must be separable|exact, got {method!r}")
        if flow_model not in ("unet", "field"):
            raise ValueError(f"flow_model must be unet|field, got {flow_model!r}")
        self.mode = mode
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Register(device={device!r}) runs on the card: no CUDA "
                               "device (pass device='cpu' to run on the CPU)")
        self.criterion = criterion
        self.weight = weight
        self.grad_edges = grad_edges
        self.debug = debug
        # SGD for the parity modes, Adam for a direct field (per-voxel
        # gradients are ~1/numel-scaled: SGD barely moves them)
        if optimizer is None:
            optimizer = "adam" if (mode == "flow" and flow_model == "field") else "sgd"
        self.optimizer = optimizer
        self.init = init
        self.seed = seed
        self.method = method
        self.max_shift = max_shift  # rigid/affine sweep bound (None = auto)
        self.max_disp = max_disp  # flow sweep bound in voxels
        self.flow_model = flow_model
        # diffusion weight: 0.5 for a direct field, 0 for the U-Net
        self.smooth = (0.5 if flow_model == "field" else 0.0) if smooth is None else smooth
        self.theta = None  # [1, d, d+1] matrix (rigid/affine) or [1, d, *S] flow
        self.losses = None
        self.result = None

    def optim(self, moving, target, lr: float | None = None, max_epochs: int = 1000,
              n: float = 32, per: float = 0.1, stop_crit: float = 1e-4) -> "Register":
        """Estimate the transform warping ``moving [1, 1, *S]`` onto
        ``target``; returns ``self``. ``lr=None`` is 1e-5, or 0.3 for a
        field-mode flow (Adam steps in voxels). ``n`` is the U-Net's width
        divisor (64/n channels at the top level); ``per`` is accepted for
        parity and unused."""
        del per
        if lr is None:
            lr = 0.3 if (self.mode == "flow" and self.flow_model == "field") else 1e-5
        moving = self._put(moving)
        target = self._put(target)
        if self.debug:
            self._preflight(moving, target)
        matrix_progress = max(1, max_epochs // 10) if self.debug else None
        flow_progress = min(100, max(1, max_epochs // 10)) if self.debug else None
        if self.mode == "flow":
            _, res = flow_register(
                moving, target, lr=lr, max_epochs=max_epochs, n=n, criterions=self.criterion,
                weights=self.weight, stop_crit=stop_crit, optimizer=self.optimizer,
                generator=torch.Generator().manual_seed(self.seed), method=self.method,
                max_disp=self.max_disp, flow_model=self.flow_model, smooth=self.smooth,
                progress_every=flow_progress)
            self.theta = res.flow
        elif self.mode == "affine":
            _, res = affine_register(
                moving, target, lr=lr, epochs=max_epochs, criterions=self.criterion,
                weights=self.weight, grad_edges=self.grad_edges, optimizer=self.optimizer,
                method=self.method, max_shift=self.max_shift, progress_every=matrix_progress)
            self.theta = res.best_theta
        else:
            _, res = rigid_register(
                moving, target, lr=lr, epochs=max_epochs, criterions=self.criterion,
                weights=self.weight, grad_edges=self.grad_edges, optimizer=self.optimizer,
                init=self.init,
                generator=torch.Generator(device=moving.device).manual_seed(self.seed),
                method=self.method, max_shift=self.max_shift, progress_every=matrix_progress)
            self.theta = res.best_theta
        self.result = res
        self.losses = res.losses
        if self.debug:
            self._report()
        return self

    def __call__(self, moving):
        """Warp ``moving [1, C, *S]`` with the stored transform (exact, K2)."""
        if self.theta is None:
            raise RuntimeError("call .optim(moving, target) before warping")
        moving = self._put(moving)
        theta = self.theta.to(moving.device)
        if self.mode == "flow":
            return warp_flow_fast(moving, theta)
        return warp_affine_fast(theta, moving)

    def _put(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        return x.to(device=self.device, dtype=torch.float32)

    def _preflight(self, moving, target) -> None:
        """Under ``debug``: evaluate each NMI criterion of the stack once on
        the inputs, with the user's own keywords (a custom bandwidth or bin
        count is what makes the KDE go non-finite), and raise naming the
        failing stage instead of optimizing on NaN. The loop stays unchecked."""
        from .losses import resolve_criteria
        from .losses.nmi import nmi_loss, nmi_loss_checked

        crits, _ = resolve_criteria(self.criterion, self.weight)
        for c in crits:
            if getattr(c, "func", c) is nmi_loss:
                with torch.no_grad():
                    nmi_loss_checked(moving, target, **(getattr(c, "keywords", None) or {}))

    def _report(self):
        """Debug report: first/last/best loss, 11 marks of the loss and
        parameter trajectory, and whether a flow converged."""
        raw = np.asarray(self.losses.detach().cpu())
        steps = getattr(self.result, "steps", None)
        raw = raw[:int(steps) if steps is not None else raw.size]
        losses = raw[np.isfinite(raw)]
        if losses.size:
            print(f"[torchregister-tpu-torch] mode={self.mode} epochs={losses.size} "
                  f"loss first={losses[0]:.6g} last={losses[-1]:.6g} "
                  f"best={losses.min():.6g}")
            fin_idx = np.flatnonzero(np.isfinite(raw))
            nan_at = np.flatnonzero(~np.isfinite(raw))
            if nan_at.size:
                print(f"  WARNING: non-finite loss first at epoch {nan_at[0]}")
            hist = getattr(self.result, "param_history", None)
            hist_np = None if hist is None else np.asarray(hist.detach().cpu())
            for m in sorted({*np.linspace(0, fin_idx.size - 1, 11).astype(int)}):
                e = int(fin_idx[m])
                line = f"  epoch {e:>6d}  loss {raw[e]:.6g}"
                if hist_np is not None:
                    line += "  params " + np.array2string(hist_np[e], precision=4,
                                                           separator=", ")
                print(line)
        if self.mode == "flow" and self.result is not None:
            steps = int(self.result.steps)
            if bool(self.result.converged):
                print(f"  flow converged at epoch {steps} (loss <= stop_crit)")
            else:
                print(f"  flow did not converge within {steps} epochs")
