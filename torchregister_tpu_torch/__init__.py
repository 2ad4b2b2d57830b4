"""PyTorch/CUDA port of torchregister-tpu.

The JAX package ``torchregister_tpu`` is the reference; this package mirrors
its module paths (``ops/pallas/sweep.py`` <-> ``ops/cuda/sweep.py``) and
imports no JAX. The public surface, for what is ported:

    import torchregister_tpu_torch as tr
    warping = tr.Register(mode='rigid')  # the card; MSE + NCC + NMI
    warping.optim(moving, target, lr=1e-5, max_epochs=500)
    warped = warping(moving)
    field = tr.norm(abs(warping.theta))
    fn = tr.CascadeConfig().jitted()  # the cascade, its steps as CUDA graphs
    result = fn(moving, target)
"""
from .api import Register, norm
from .config import AffineConfig, CascadeConfig, FlowConfig, RigidConfig
from .engines.affine import affine_register
from .engines.cascade import CascadeResult, make_cascade_fn, register_cascade
from .engines.common import RegistrationResult
from .engines.flow import FlowResult, flow_register
from .engines.rigid import rigid_register
from .losses import get_criterion, lncc, mse, ncc, nmi, nmi_loss, ssd
from .ops.blocked import warp_affine_fast, warp_flow_fast
from .ops.edge import edge_filter
from .ops.resample import grid_sample, warp_affine, warp_flow
from .ops.transforms import compose_theta, identity_theta, rigid_theta
from .utils.io import load_transform, save_transform

__version__ = "0.1.0"

__all__ = [
    "Register",
    "norm",
    "RigidConfig",
    "AffineConfig",
    "FlowConfig",
    "CascadeConfig",
    "rigid_register",
    "affine_register",
    "flow_register",
    "register_cascade",
    "make_cascade_fn",
    "CascadeResult",
    "RegistrationResult",
    "FlowResult",
    "warp_affine",
    "warp_flow",
    "warp_affine_fast",
    "warp_flow_fast",
    "grid_sample",
    "edge_filter",
    "rigid_theta",
    "identity_theta",
    "compose_theta",
    "mse",
    "ncc",
    "ssd",
    "lncc",
    "nmi",
    "nmi_loss",
    "get_criterion",
    "save_transform",
    "load_transform",
    "__version__",
]
